"""Fault-tolerant training runtime (twin of ``repro/runtime/ft.py`` on one
device).

``FaultTolerantLoop`` wraps a train step with:

* auto-resume from the latest checkpoint (params + optimizer state; the
  data stream is indexed by step, so the batches resume too);
* periodic async checkpoints with keep-N rotation (``checkpoint.manager``);
* SIGTERM/SIGINT handlers that write a checkpoint and stop (installed only
  on the main thread, for the length of ``run``: the caller's handlers are
  put back when it returns);
* a straggler and hang watchdog: EWMA step time; a step slower than
  ``factor`` x EWMA logs a warning, and a step that outlasts
  ``hang_timeout_s`` ends the process with code 42, so a scheduler
  restarts it;
* deterministic fault injection through ``runtime.faults``: the
  ``train.step`` point, and the ``ckpt.*`` points, which the loop hands to
  its ``CheckpointManager``;
* a JSONL metrics file, one line per step.

Metrics and events, the reference's: ``train_step_seconds``,
``train_steps_total``, ``train_tokens_total``, ``train_loss``,
``train_restarts_total``, the ``train.step`` span and the ``train.resumed``
event.  A step's metrics are read with one ``float()`` per value after the
step; the first of them waits for the step's device work, which is the
step's one host sync (the ``train.step`` span closes on it).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..checkpoint.manager import CheckpointManager
from ..obs import Obs
from .faults import FaultPlan


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, hang_timeout_s: float = 1800.0,
                 log=print):
        self.factor = factor
        self.hang_timeout_s = hang_timeout_s
        self.ewma = None
        self.log = log
        self._timer: Optional[threading.Timer] = None

    def arm(self, step: int):
        self.disarm()

        def _abort():
            self.log(f"[watchdog] step {step} exceeded hang timeout "
                     f"{self.hang_timeout_s}s — aborting for reschedule")
            os._exit(42)

        self._timer = threading.Timer(self.hang_timeout_s, _abort)
        self._timer.daemon = True
        self._timer.start()

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def observe(self, step: int, dt: float):
        self.disarm()
        if self.ewma is None:
            self.ewma = dt
        elif dt > self.factor * self.ewma:
            self.log(f"[watchdog] step {step} took {dt:.2f}s "
                     f"(> {self.factor:.1f}x EWMA {self.ewma:.2f}s) — "
                     "straggler")
        self.ewma = 0.9 * self.ewma + 0.1 * dt if self.ewma else dt


class FaultTolerantLoop:
    def __init__(
        self,
        train_step: Callable,  # (params, opt_state, batch) -> (p, o, metrics)
        data_stream,  # has .batch(step) -> host batch dict
        ckpt_dir: str,
        *,
        ckpt_every: int = 100,
        keep: int = 3,
        metrics_path: Optional[str] = None,
        faults: Optional[FaultPlan] = None,
        log=print,
        place_batch: Optional[Callable] = None,
        obs: Optional[Obs] = None,
        shardings=None,
        mesh=None,
    ):
        self.train_step = train_step
        self.data = data_stream
        self.faults = faults
        # one obs bundle for the loop, its checkpoint manager and the plan
        self.obs = obs if obs is not None else Obs()
        if faults is not None and faults.obs is None:
            faults.obs = self.obs
        self.manager = CheckpointManager(ckpt_dir, keep=keep, faults=faults,
                                         obs=self.obs)
        self._m_step_s = self.obs.histogram(
            "train_step_seconds", "wall-clock per optimizer step")
        self._m_steps = self.obs.counter(
            "train_steps_total", "completed optimizer steps")
        self._m_tokens = self.obs.counter(
            "train_tokens_total", "tokens consumed by completed steps")
        self._m_loss = self.obs.gauge("train_loss", "last step's loss")
        self._m_restarts = self.obs.counter(
            "train_restarts_total", "checkpoint auto-resumes on entry")
        self.ckpt_every = ckpt_every
        self.metrics_path = metrics_path
        self.log = log
        self.place_batch = place_batch or (lambda b: b)
        # on a mesh: where a resume re-places (params, opt_state)
        self.shardings, self.mesh = shardings, mesh
        self.watchdog = StragglerWatchdog(log=log)
        self._preempted = False

    def _install_signal_handlers(self):
        """Install the preemption handlers; returns the ones they replace."""
        def handler(signum, frame):
            self.log(f"[ft] received signal {signum}: checkpoint-and-exit")
            self._preempted = True

        old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread
        return old

    def run(self, params, opt_state, num_steps: int):
        """Run steps ``[start, num_steps)``, ``start`` being one past the
        latest checkpoint's step (0 without one).  Returns ``(params,
        opt_state, last step index)``."""
        old_handlers = self._install_signal_handlers()
        try:
            return self._run(params, opt_state, num_steps)
        finally:
            for sig, h in old_handlers.items():
                # None: the old handler was not set from Python
                signal.signal(sig, signal.SIG_DFL if h is None else h)

    def _run(self, params, opt_state, num_steps):
        start = 0
        if self.manager.latest_step() is not None:
            (params, opt_state), manifest = self.manager.restore(
                (params, opt_state), shardings=self.shardings,
                mesh=self.mesh)
            start = manifest["step"] + 1
            self._m_restarts.inc()
            self.obs.event("train.resumed", step=manifest["step"])
            self.log(f"[ft] resumed from step {manifest['step']}")

        mf = open(self.metrics_path, "a") if self.metrics_path else None
        step = start
        try:
            for step in range(start, num_steps):
                # hit index == step index on a fresh run from step 0; after
                # a resume the hits restart at 0 while the steps do not, so
                # FaultSpec(at=N) means "the Nth step THIS process runs"
                if self.faults is not None:
                    self.faults.raise_if("train.step")
                host_batch = self.data.batch(step)
                batch = self.place_batch(host_batch)
                self.watchdog.arm(step)
                t0 = time.time()
                # the span closes on the float() that reads the step's
                # metrics, the step's one sync
                with self.obs.span("train.step", step=step):
                    params, opt_state, metrics = self.train_step(
                        params, opt_state, batch)
                    metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                self.watchdog.observe(step, dt)
                self._m_step_s.observe(dt)
                self._m_steps.inc()
                if isinstance(host_batch, dict) and "tokens" in host_batch:
                    self._m_tokens.inc(
                        int(np.asarray(host_batch["tokens"]).size))
                if "loss" in metrics:
                    self._m_loss.set(metrics["loss"])
                metrics.update(step=step, step_time_s=round(dt, 4))
                if mf:
                    mf.write(json.dumps(metrics) + "\n")
                    mf.flush()
                if step % 10 == 0:
                    self.log(f"[train] step {step} loss "
                             f"{metrics.get('loss', 0):.4f} ({dt:.2f}s)")
                if (step + 1) % self.ckpt_every == 0 or self._preempted:
                    self.manager.save(step, (params, opt_state))
                if self._preempted:
                    self.log("[ft] preemption checkpoint written; exiting")
                    break
        finally:
            self.watchdog.disarm()
            self.manager.wait()
            if mf:
                mf.close()
        return params, opt_state, step
