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

* **Speculative decode (``spec=``)** swaps the block for a draft -> verify
  -> accept round: a ``Drafter`` proposes k tokens per active slot, ONE
  chunk-parallel verify pass scores them all (``spec.verify``), accepted
  tokens commit in bulk (up to k+1 per slot per round), and a rejection
  rolls each slot back to plain decode over its accepted prefix.  A
  fully-accepted round makes one host transfer, a rejection round two.  A
  drafter failure (``propose``, ``admit``, ``commit``, resync) trips a
  circuit breaker to plain blocks, with a cooldown and a half-open probe;
  an exception of the target's verify or replay is never caught there (the
  drive loop fails the live requests, as for a plain block).

``run`` admits in arrival order (FIFO), as the reference does without a
scheduler config.  The prefix cache, the scheduler, the async server,
observability, fault injection, deadlines, cancellation and the
per-request sampling override are not ported yet.
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
from .spec import SpecConfig, build_drafter
from .spec.verify import make_spec_round
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
                 seed: int = 0, device="cuda",
                 spec: Optional[SpecConfig] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') needs a CUDA device")
        op = seq_op.op_for(cfg)  # unknown mixers fail here, not at admission
        if not op.streaming:
            raise ValueError(f"Engine serves streaming-state ops; op "
                             f"{op.name!r} has no constant-size slot state")
        if spec is not None and not op.spec_decodable:
            raise ValueError(
                f"op {op.name!r} is not registered spec_decodable: its state "
                "cannot be snapshot/rolled back for speculative verification")
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
        self.spec = spec
        self.breaker = dict(state="closed", cooldown=0, zero_rounds=0,
                            reason=None)
        self.drafter = None
        if spec is not None:
            self.drafter = build_drafter(spec, slots=slots, sampling=sampling,
                                         target_cfg=cfg, device=device)
            if self.drafter.vocab is not None and \
                    self.drafter.vocab != cfg.vocab:
                raise ValueError(
                    f"drafter vocab {self.drafter.vocab} != target vocab "
                    f"{cfg.vocab}: draft ids would index the target "
                    "embedding out of range")
            self._spec_round_fn = make_spec_round(
                cfg, sampling, draft_probs=self.drafter.emits_probs)

    @staticmethod
    def _zero_stats():
        """``decode_steps`` counts plain-block steps; a speculative round
        counts in ``spec_rounds`` (one verify pass), ``spec_drafted`` and
        ``spec_accepted`` (draft tokens over the active slots),
        ``spec_replays`` (rounds that rolled back) and
        ``spec_replay_steps`` (the decode steps those rollbacks ran)."""
        return dict(prefill_s=0.0, decode_s=0.0, prompt_tokens=0,
                    generated_tokens=0, decode_steps=0, quarantined=0,
                    ttft_s=[], spec_rounds=0, spec_drafted=0,
                    spec_accepted=0, spec_replays=0, spec_replay_steps=0,
                    breaker_trips=0)

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
        finished = self._commit(slot, [first_tok])
        if not finished and self.drafter is not None \
                and self.breaker["state"] == "closed":
            try:
                self.drafter.admit(slot, [int(t) for t in prompt]
                                   + [first_tok])
            except Exception as e:  # a drafter failure never fails admission
                self._trip_breaker(f"drafter.admit failed: {e!r}")
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
        if self.drafter is not None:
            self.drafter.evict(slot)

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
        tokens with one host transfer at the end, or, in speculative mode,
        by ONE draft -> verify -> accept round (up to ``spec.k + 1`` tokens).
        With the breaker open (or tripping on this call) a speculative
        engine runs a plain block instead."""
        if self.spec is not None and self._breaker_gate():
            if self._try_spec_round():
                return
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

    # -- circuit breaker (speculative -> plain fallback) --------------------

    def _trip_breaker(self, reason: str) -> None:
        self.breaker.update(state="open",
                            cooldown=self.spec.breaker_cooldown_blocks,
                            zero_rounds=0, reason=reason)
        self.stats["breaker_trips"] += 1

    def reset_breaker(self) -> None:
        """Close the breaker for a fresh traffic epoch (with the stats
        reset after a warmup, whose random-weight rounds may trip it)."""
        self.breaker.update(state="closed", cooldown=0, zero_rounds=0,
                            reason=None)

    def _breaker_gate(self) -> bool:
        """Advance the breaker once per block; True when this block may
        run a speculative round."""
        b = self.breaker
        if b["state"] == "open":
            if b["cooldown"] > 0:
                b["cooldown"] -= 1
                return False
            b["state"] = "half_open"
        return True  # closed, or half-open: probe this block

    def _resync_drafter(self) -> None:
        """Re-admit every live slot's committed context into the drafter
        (it went stale while the breaker was open)."""
        for s in range(self.pool.slots):
            if self.active[s]:
                req = self._slot_req[s]
                ctx = [int(t) for t in req.prompt] + self._slot_out[s]
                self.drafter.admit(s, ctx)

    def _try_spec_round(self) -> bool:
        """One breaker-supervised speculative round.  Returns False when a
        drafter failure tripped the breaker before anything was mutated
        (the caller runs a plain block instead).  Only the drafter's own
        calls are guarded: an exception of the target's verify or replay
        propagates."""
        b = self.breaker
        if b["state"] == "half_open":
            try:
                self._resync_drafter()
            except Exception as e:
                self._trip_breaker(f"drafter resync failed: {e!r}")
                return False
        slots_active = [s for s in range(self.pool.slots) if self.active[s]]
        if not slots_active:
            return True  # nothing to decode either way
        t0 = time.perf_counter()
        try:
            drafts, q = self.drafter.propose(slots_active, self.spec.k)
        except Exception as e:  # nothing was mutated: a plain block is exact
            self._trip_breaker(f"drafter crashed: {e!r}")
            return False
        accepted = self._spec_round(slots_active, drafts, q)
        self.stats["decode_s"] += time.perf_counter() - t0
        if b["state"] == "half_open":
            if accepted > 0:
                b.update(state="closed", zero_rounds=0, reason=None)
            else:
                self._trip_breaker("half-open probe round accepted nothing")
        elif b["state"] == "closed":
            if accepted == 0:
                b["zero_rounds"] += 1
                if b["zero_rounds"] >= self.spec.breaker_zero_rounds:
                    self._trip_breaker(f"{b['zero_rounds']} consecutive "
                                       "zero-acceptance rounds")
            else:
                b["zero_rounds"] = 0
        return True

    def _full_width(self, slots_active, drafts, q):
        """The drafter's proposals as ``(slots, k)`` device ids and, for a
        probs-emitting drafter, ``(slots, k, vocab)`` laws; rows of inactive
        slots are filler the round ignores (uniform laws)."""
        if self.drafter.full_width:
            return torch.as_tensor(drafts, device=self.device), q
        k, slots = self.spec.k, self.pool.slots
        ids = torch.as_tensor(slots_active, device=self.device)
        full = torch.zeros((slots, k), dtype=torch.long, device=self.device)
        full[ids] = torch.as_tensor(drafts, device=self.device).long()
        if q is not None:
            vocab = self.cfg.vocab
            q_full = torch.full((slots, k, vocab), 1.0 / vocab,
                                device=self.device)
            q_full[ids] = torch.as_tensor(q, device=self.device).float()
            q = q_full
        return full, q

    def _spec_round(self, slots_active, drafts, q) -> int:
        """Verify the drafts of every active slot in one chunk-parallel
        pass, commit the accepted tokens, roll rejected continuations back
        (``spec.verify.make_spec_round``).  Returns the number of accepted
        draft tokens, the breaker's health signal.  A drafter exception in
        ``commit`` trips the breaker here but loses no verified token."""
        k = self.spec.k
        drafts, q = self._full_width(slots_active, drafts, q)
        packed, finite, self.tokens, steps = self._spec_round_fn(
            self.params, self.pool, self.tokens, self.active, drafts,
            self.gen, q)
        st = self.stats
        st["spec_rounds"] += 1
        st["spec_replay_steps"] += steps
        st["spec_replays"] += steps > 0
        accepted = 0
        for s in slots_active:
            if not finite[s]:
                self._quarantine(s)
                continue
            m = int(packed[s, 0])
            committed = [int(t) for t in packed[s, 1:m + 2]]
            st["spec_drafted"] += k
            st["spec_accepted"] += m
            accepted += m
            if self._commit(s, committed):
                continue  # finished: its state is stale, the slot is free
            if self.breaker["state"] != "closed":
                continue  # the drafter already failed: skip its bookkeeping
            try:
                self.drafter.commit(s, committed)
            except Exception as e:
                self._trip_breaker(f"drafter.commit failed: {e!r}")
        return accepted

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
