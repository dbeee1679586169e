"""Continuous-batching inference engine over the streaming-state model.

Twin of the plain path of ``repro/serving/engine.py``:

* **Admission = chunk-parallel prefill.**  A prompt runs through
  ``lm.lm_prefill`` (per layer ONE chunkwise kernel launch returning the
  exact streaming state), then its state is copied into a free slot of the
  ``StatePool``; no other slot is read or written.  One host sync per
  admission fetches the first token and the health flag together.
* **Decode = step-locked blocks.**  All slots advance together through
  ``block`` decode steps (per layer ONE batched decode-step launch that
  updates the pool in place) with device-side sampling; the block's tokens
  and the per-slot finiteness flags reach the host in ONE transfer per
  block, never an ``.item()`` per token.  Inactive slots ride along and
  their tokens are discarded; admission overwrites their state.
* **Failure domains.**  An invalid or failed admission, or a slot whose
  state went non-finite (quarantine: the slot is reset, its neighbours keep
  decoding), becomes a ``GenResult`` with ``status="error"``; ``run`` never
  raises out of its drive loop.

``run`` admits in arrival order (FIFO), as the reference does without a
scheduler config.  Speculative decoding, the prefix cache, the scheduler,
the async server, observability and fault injection are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import lm, seq_op
from .sampling import SamplingConfig, sample
from .state_pool import StatePool


@dataclasses.dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray  # (L,) int token ids
    max_new: int = 32
    eos_id: Optional[int] = None


@dataclasses.dataclass
class GenResult:
    rid: int
    tokens: List[int]
    ttft_s: float  # admission -> first sampled token
    prompt_len: int
    status: str = "ok"  # "ok" | "error"; errors keep the partial stream
    error: Optional[str] = None


def _finite(states) -> torch.Tensor:
    ok = torch.ones((), dtype=torch.bool, device=states[0].device)
    for x in states:
        ok &= x.isfinite().all()
    return ok


class Engine:
    """Slot-based continuous batching over a ``StatePool``.

    ``params`` is the fp32 parameter tree (``models.param``) on ``device``;
    the engine keeps the copy its forward reads (``lm.cast_params``).
    """

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 4096,
                 sampling: SamplingConfig = SamplingConfig(), block: int = 8,
                 seed: int = 0, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') needs a CUDA device")
        seq_op.op_for(cfg)  # unknown mixers fail here, not at admission
        self.cfg = cfg
        self.device = device
        self.params = lm.cast_params(params, cfg)
        self.sampling = sampling
        self.block = block
        self.max_len = max_len
        self.pool = StatePool(
            lambda n: lm.lm_init_states(cfg, n, device), slots)
        self.tokens = torch.zeros((slots, 1), dtype=torch.long, device=device)
        self.active = np.zeros(slots, bool)
        self._slot_req: List[Optional[GenRequest]] = [None] * slots
        self._slot_out: List[List[int]] = [[] for _ in range(slots)]
        self._slot_ttft: List[float] = [0.0] * slots
        self.results: Dict[int, GenResult] = {}
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.stats = self._zero_stats()

    @staticmethod
    def _zero_stats():
        return dict(prefill_s=0.0, decode_s=0.0, prompt_tokens=0,
                    generated_tokens=0, decode_steps=0, quarantined=0,
                    ttft_s=[])

    def reset_stats(self) -> None:
        """Start a fresh measurement epoch (after a warmup run)."""
        self.stats = self._zero_stats()

    # -- admission ----------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [s for s in range(self.pool.slots) if not self.active[s]]

    def _validate(self, req: GenRequest) -> np.ndarray:
        """Reject malformed requests before they touch the pool.  Returns
        the prompt as an int64 array."""
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"request {req.rid}: prompt must be a non-empty 1-D token "
                f"array, got shape {prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(f"request {req.rid}: prompt dtype "
                             f"{prompt.dtype} is not integer token ids")
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= self.cfg.vocab:
            raise ValueError(f"request {req.rid}: token ids [{lo}, {hi}] "
                             f"outside the vocab [0, {self.cfg.vocab})")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1")
        if len(prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(prompt)}) + max_new "
                f"({req.max_new}) exceeds the engine's max_len "
                f"{self.max_len}")
        return prompt.astype(np.int64)

    @torch.no_grad()
    def admit(self, slot: int, req: GenRequest) -> int:
        """Prefill ``req`` into ``slot``; returns the first sampled token.

        Everything that can raise happens before the slot is activated, so
        a failed admission leaves the engine as it was (``run`` turns the
        raise into a ``status="error"`` result).
        """
        if self.active[slot]:
            raise ValueError(f"slot {slot} is busy")
        prompt = self._validate(req)
        t0 = time.perf_counter()
        ids = torch.as_tensor(prompt[None], device=self.device)
        last, states = lm.lm_prefill(self.params, ids, self.cfg)
        first = sample(last, self.gen, self.sampling)[0]
        finite = _finite(states) & last.isfinite().all()
        self.pool.write_slot(slot, states)
        # sync-point: admission TTFT endpoint (token + health flag together)
        first_tok, ok = torch.stack([first, finite.long()]).tolist()
        if not ok:
            self.stats["quarantined"] += 1
            self.pool.reset_slot(slot)
            raise RuntimeError(f"request {req.rid}: admission prefill "
                               "produced a non-finite state; slot reset")
        ttft = time.perf_counter() - t0
        self.tokens[slot, 0] = first_tok
        self.active[slot] = True
        self._slot_req[slot] = req
        self._slot_out[slot] = []
        self._slot_ttft[slot] = ttft
        self.stats["prefill_s"] += ttft
        self.stats["prompt_tokens"] += len(prompt)
        self.stats["ttft_s"].append(ttft)
        # the first token goes through the one commit path, so max_new=1 or
        # a first-token EOS finishes here
        self._commit(slot, [first_tok])
        return first_tok

    def _commit(self, slot: int, toks) -> bool:
        """Append tokens to ``slot``'s stream with max_new/eos truncation;
        finish the slot when it stops.  Returns True when it finished."""
        req = self._slot_req[slot]
        out = self._slot_out[slot]
        for t in toks:
            if len(out) >= req.max_new or (
                    req.eos_id is not None and out and out[-1] == req.eos_id):
                break
            out.append(int(t))
        if len(out) >= req.max_new or (
                req.eos_id is not None and req.eos_id in out):
            self._finish(slot)
            return True
        return False

    def _finish(self, slot: int, status: str = "ok",
                error: Optional[str] = None) -> None:
        req = self._slot_req[slot]
        out = self._slot_out[slot][: req.max_new]
        if req.eos_id is not None and req.eos_id in out:
            out = out[: out.index(req.eos_id) + 1]
        self.results[req.rid] = GenResult(
            rid=req.rid, tokens=out, ttft_s=self._slot_ttft[slot],
            prompt_len=len(req.prompt), status=status, error=error)
        self.stats["generated_tokens"] += len(out)
        self.active[slot] = False
        self._slot_req[slot] = None

    def _fail(self, req: GenRequest, error: str) -> None:
        """Terminal error result for a request that never held a slot."""
        self.results[req.rid] = GenResult(
            rid=req.rid, tokens=[], ttft_s=0.0,
            prompt_len=len(np.atleast_1d(np.asarray(req.prompt))),
            status="error", error=error)

    def _quarantine(self, slot: int) -> None:
        """A slot's state went non-finite: reset it and fail only its
        request; the other slots keep decoding."""
        self.stats["quarantined"] += 1
        self.pool.reset_slot(slot)
        self._finish(slot, status="error", error="non-finite decode state: "
                     "slot quarantined and reset")

    # -- decode -------------------------------------------------------------

    @torch.no_grad()
    def step_block(self, n_steps: Optional[int] = None) -> None:
        """Advance every active slot by ``n_steps`` (default ``block``)
        tokens with one host transfer at the end."""
        n_steps = self.block if n_steps is None else n_steps
        if n_steps <= 0:
            return
        t0 = time.perf_counter()
        active = torch.as_tensor(self.active, device=self.device)
        tok = self.tokens
        steps = []
        for _ in range(n_steps):
            logits, _ = lm.lm_apply(self.params, tok, self.cfg,
                                    states=self.pool.states, mode="decode")
            nxt = sample(logits[:, -1], self.gen, self.sampling)
            tok = torch.where(active[:, None], nxt[:, None], tok)
            steps.append(nxt)
        self.tokens = tok
        finite = self.pool.finite_mask()
        # sync-point: the once-per-block transfer (tokens + quarantine flags)
        host = torch.cat([torch.stack(steps), finite[None].long()]).cpu()
        host = host.numpy()
        toks, finite_host = host[:-1], host[-1]
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += n_steps
        for s in range(self.pool.slots):
            if not self.active[s]:
                continue
            if not finite_host[s]:
                self._quarantine(s)
                continue
            self._commit(s, toks[:, s])

    # -- drive loop ---------------------------------------------------------

    def run(self, requests: List[GenRequest]) -> List[GenResult]:
        """Serve ``requests`` to completion, admitting in arrival order.

        Every request gets a terminal ``GenResult``; per-request failures
        (invalid admission, poisoned state, even a failed decode block)
        become ``status="error"`` results and the loop keeps serving."""
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("request rids must be unique")
        queue = collections.deque(requests)
        while queue or self.active.any():
            for s in self.free_slots():
                while queue:
                    req = queue.popleft()
                    try:
                        self.admit(s, req)
                        break
                    except Exception as e:  # the request fails, not the loop
                        self._fail(req, f"admission failed: {e}")
            if self.active.any():
                try:
                    self.step_block()
                except Exception as e:  # live slots fail, the loop goes on
                    for s in range(self.pool.slots):
                        if self.active[s]:
                            self._finish(s, status="error",
                                         error=f"decode block failed: {e!r}")
        return [self.results[r.rid] for r in requests]
