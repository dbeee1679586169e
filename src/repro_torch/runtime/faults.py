"""Unified fault injection: named, deterministic injection points.

Own copy of ``repro/runtime/faults.py``, catalog whole.  One registry
serves every failure domain in the stack: the serving engine, its prefix
cache and its scheduler own the serving points; the checkpoint manager
(``checkpoint/manager.py``) owns ``ckpt.save`` and ``ckpt.corrupt``, and
the fault-tolerant training loop (``runtime/ft.py``) owns ``train.step``.

A component that owns an injection point calls ``plan.hit(point)`` (or
``plan.raise_if(point)``) exactly once per occurrence of the event the
point names; a ``FaultPlan`` decides — purely from a per-point hit
counter, never from wall clock or randomness — whether that occurrence
fires.  The same plan therefore produces the same failure schedule on
every run, which is what lets the chaos suite assert byte-identical
output for uninjected requests.

Catalog (``FAULT_POINTS``: point name -> owner's contract):

* ``drafter.propose``  — ``Engine._try_spec_round`` raises ``InjectedFault``
  in place of calling the drafter (a drafter crash; trips the engine's
  circuit breaker into plain block decode).
* ``engine.prefill``   — ``Engine.admit`` raises ``InjectedFault``
  before the prefill call (a per-request admission failure; ``run()``
  converts it to a ``GenResult.status == "error"``).
* ``engine.nan_state`` — ``Engine.step_block`` writes NaN into one
  slot's decode state before the block (``arg`` = slot index, default
  0); exercises poisoned-state quarantine.
* ``engine.slow_block``— ``Engine.step_block`` sleeps ``arg`` seconds
  (default 0.05) before the block; exercises request deadlines.
* ``cache.corrupt``    — the prefix/state cache flips bytes in one
  leaf of the entry a lookup is about to return; its checksum check
  must drop the entry and fall back to cold prefill
  (``serving/cache.py``).
* ``sched.stall``      — the scheduler refuses every admission for one
  drive-loop tick (``serving/scheduler.py``); exercises queue growth
  and queued-deadline expiry under scheduler pressure.
* ``ckpt.save``        — ``CheckpointManager``'s save work raises
  ``InjectedFault`` (in the async thread: surfaced on the next
  ``wait()``/``save()``).
* ``ckpt.corrupt``     — after an otherwise-successful save, bytes are
  flipped in one published leaf file; exercises manifest checksum
  verification on restore.
* ``train.step``       — ``FaultTolerantLoop`` raises ``InjectedFault``
  at the top of a training step (hit index == step index for a run
  starting from step 0 — the old ``fail_at_step`` semantics).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

FAULT_POINTS: Dict[str, str] = {
    "drafter.propose": "drafter crash during a speculative round",
    "engine.prefill": "admission prefill failure for one request",
    "engine.nan_state": "NaN written into one slot's decode state "
                        "(arg = slot index)",
    "engine.slow_block": "slow decode block (arg = sleep seconds)",
    "cache.corrupt": "byte corruption of a prefix-cache entry at lookup",
    "sched.stall": "scheduler admits nothing for one drive-loop tick",
    "ckpt.save": "checkpoint save failure (async thread)",
    "ckpt.corrupt": "byte corruption of a saved checkpoint leaf",
    "train.step": "training step failure (the old fail_at_step)",
}


class InjectedFault(RuntimeError):
    """Raised by a firing injection point.  Deliberately a plain runtime
    error: consumers must survive it through the same isolation paths
    that handle organic failures, not by catching this type specially."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at point {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire at hits ``at .. at + times - 1`` of
    ``point`` (``times=None`` = every hit from ``at`` on).  ``arg`` is
    the point-specific payload (slot index, sleep seconds, ...)."""

    point: str
    at: int = 0
    times: Optional[int] = 1
    arg: Optional[float] = None

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; registered points: "
                f"{sorted(FAULT_POINTS)}"
            )
        if self.at < 0 or (self.times is not None and self.times < 1):
            raise ValueError(f"need at >= 0 and times >= 1 (or None): {self}")

    def covers(self, hit: int) -> bool:
        return hit >= self.at and (
            self.times is None or hit < self.at + self.times
        )


def parse_fault(text: str) -> FaultSpec:
    """Parse the CLI syntax ``point[@at[+]][:arg]``.

    ``engine.nan_state@1:0``  — 2nd block, poison slot 0;
    ``drafter.propose@0+``    — crash every round from the first;
    ``engine.slow_block:0.2`` — sleep 0.2s at the first block only.
    """
    arg: Optional[float] = None
    if ":" in text:
        text, raw = text.split(":", 1)
        arg = float(raw)
    at, times = 0, 1
    if "@" in text:
        text, raw = text.split("@", 1)
        if raw.endswith("+"):
            times, raw = None, raw[:-1]
        at = int(raw)
    return FaultSpec(point=text, at=at, times=times, arg=arg)


class FaultPlan:
    """A deterministic failure schedule over the registered points.

    ``hit(point)`` records one occurrence and returns the ``FaultSpec``
    that fires at it (or None).  ``fired`` counts fires per point for
    test assertions.  Hitting (or scheduling) an unregistered point is a
    ``ValueError`` — typos fail loudly on both sides of the contract.

    When a component binds its ``obs`` bundle onto the plan (the engine
    and the training loop both do), every firing self-documents as a
    ``fault.fired`` event and a ``faults_fired_total{point=...}``
    counter — a chaos run's event log shows exactly which injections
    interleaved with which request lifecycles.
    """

    def __init__(self, *specs: FaultSpec, obs=None):
        self._by_point: Dict[str, List[FaultSpec]] = {}
        for spec in specs:
            if not isinstance(spec, FaultSpec):
                raise TypeError(f"expected FaultSpec, got {spec!r}")
            self._by_point.setdefault(spec.point, []).append(spec)
        self._hits: collections.Counter = collections.Counter()
        self.fired: collections.Counter = collections.Counter()
        self.obs = obs  # bound lazily by the consuming component

    def hit(self, point: str) -> Optional[FaultSpec]:
        if point not in FAULT_POINTS:
            raise ValueError(
                f"hit on unregistered fault point {point!r}; registered: "
                f"{sorted(FAULT_POINTS)}"
            )
        i = self._hits[point]
        self._hits[point] = i + 1
        for spec in self._by_point.get(point, ()):
            if spec.covers(i):
                self.fired[point] += 1
                if self.obs is not None:
                    self.obs.event("fault.fired", point=point, hit=i,
                                   arg=spec.arg)
                    self.obs.counter(
                        "faults_fired_total", "fired fault injections"
                    ).inc(point=point)
                return spec
        return None

    def raise_if(self, point: str) -> None:
        """``hit`` + raise ``InjectedFault`` when the hit fires."""
        if self.hit(point) is not None:
            raise InjectedFault(point, self._hits[point] - 1)

    def hits(self, point: str) -> int:
        return self._hits[point]

    def __repr__(self):
        scheduled: List[Tuple[str, int]] = [
            (p, len(s)) for p, s in sorted(self._by_point.items())
        ]
        return f"FaultPlan({scheduled}, fired={dict(self.fired)})"
