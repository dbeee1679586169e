"""Continuous-batching inference engine over the streaming-state model.

Twin of ``repro/serving/engine.py`` on the port's in-place state pool:

* **Admission = chunk-parallel prefill.**  A prompt runs through
  ``lm.lm_prefill`` (per layer ONE chunkwise kernel launch returning the
  exact streaming state), then its state is copied into a free slot of the
  ``StatePool``; no other slot is read or written.  One host sync per
  admission fetches the first token and the health flag together.
* **Decode = step-locked blocks.**  All slots advance together through
  ``block`` decode steps (per layer ONE batched decode-step launch that
  updates the pool in place) with device-side sampling, each slot under
  its own ``SamplingConfig`` (``GenRequest.sampling``; one sampling call
  per distinct config a step); the block's tokens and the per-slot
  finiteness flags reach the host in ONE transfer per block, never an
  ``.item()`` per token.  Inactive slots ride along and their tokens are
  discarded; admission overwrites their state.
* **Prefix/state cache (``cache=``).**  An admission looks up the longest
  cached chunk-aligned prefix of its prompt, resumes from that host
  snapshot (copied to the card), advances the carry to the prompt's own
  chunk-aligned boundary (one extra ``lm_prefill(states=)`` call), prefills
  the rest from the carry, and fetches the boundary state to the host in
  the admission's one sync; once the admission passed its health check the
  boundary state becomes a cache entry.  Exact by the chunkwise carry
  identity: cached and cold streams agree token for token (fp32).
* **Scheduler (``sched=``).**  Requests queue in ``serving/scheduler.py``:
  priority class, deadline slack, tenant fair share, queued-deadline
  expiry and slot autoscaling.  Without a config the engine is a fixed-
  ``slots`` FIFO.  ``submit`` + ``_drive_tick`` is the drive loop that
  ``run`` and the async server (``serving/server.py``) share.
* **Speculative decode (``spec=``)** swaps the block for a draft -> verify
  -> accept round: a ``Drafter`` proposes k tokens per active slot, ONE
  chunk-parallel verify pass scores them all (``spec.verify``), accepted
  tokens commit in bulk (up to k+1 per slot per round), and a rejection
  rolls each slot back to plain decode over its accepted prefix.  A
  fully-accepted round makes one host transfer, a rejection round two.  A
  drafter failure (``propose``, ``admit``, ``commit``, resync) trips a
  circuit breaker to plain blocks, with a cooldown and a half-open probe;
  an exception of the target's verify or replay is never caught there (the
  drive loop fails the live requests, as for a plain block).  A spec
  engine verifies against ONE sampling law and refuses a per-request
  override.
* **Failure domains.**  Every per-request failure becomes a
  ``GenResult.status``: ``error`` (invalid or failed admission, a slot
  whose state went non-finite: quarantine resets that slot alone),
  ``timeout`` (``deadline_s`` expired, queued or mid-stream) or
  ``cancelled`` (``Engine.cancel``); ``run`` never raises out of its drive
  loop.  Failures are injectable deterministically through
  ``runtime.faults.FaultPlan`` (``engine.prefill``, ``engine.nan_state``,
  ``engine.slow_block``, ``drafter.propose``; the cache's
  ``cache.corrupt`` and the scheduler's ``sched.stall``).
* **Observability (``obs=``).**  Every number goes through one
  ``obs.Obs`` registry + tracer: the reference's metric names, spans
  (``engine.prefill``, ``engine.decode_block``, ``engine.spec_round``) and
  request lifecycle events.  The port's own: an admission's span is tiled
  by ``engine.prefill_dispatch`` (issue) and ``engine.prefill_sync`` (its
  one transfer), a block's by one ``engine.decode_step`` a step and
  ``engine.block_sync``; ``engine.queue_wait`` (recorded at admission)
  runs from ``submit`` to the admission's start.  ``serving_ttft_seconds``
  runs from submission to the first token (the scheduler's
  ``sched_queue_wait_seconds`` holds the part spent queued), and
  ``serving_inter_token_seconds`` takes one ``(last - first) / (n - 1)``
  a finished request.  Timings are host wall clock taken at syncs the
  engine already makes; observability adds no device round trip.
  ``Engine.stats`` is the reference's dict view over the registry, with
  two keys of the port's own: ``decode_steps`` and ``spec_replay_steps``.

* **Sharded serving** (``mesh=``, the reference's): the parameters are
  DTensors on the mesh (``distributed.sharding.distribute``), the slot
  states get ``distributed.steps.state_shardings_for`` placements (slots
  over "data", heads over "model"), and admission, the decode block and
  the speculative round run inside ``sharding.use_mesh``, where every HLA
  kernel call runs on each rank's own (batch, head) row block
  (``distributed.shard_ops.call_sharded``).  The tokens each step reads
  are batch-sharded; the logits are gathered before sampling, so every
  rank samples the same tokens from the same generator and holds the same
  streams, accept counts and committed tokens.  A speculative engine's
  ``HLADrafter`` places its own pool the same way; the verify pass runs
  on the pool's DTensor states and the rollback replays on them.  The
  prefix cache holds whole host states, the same on every rank (a
  snapshot gathers a slot's blocks), so its keys and checksums agree, and
  a hit is placed onto the pool's layout whatever mesh stored it.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import math
import time
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..distributed import sharding as shd
from ..distributed import steps as steps_mod
from ..models import lm, seq_op
from ..models.state_tree import leaves, tree_map
from ..obs import Obs
from ..runtime.faults import FaultPlan
from .cache import PrefixCache
from .sampling import SamplingConfig, sample
from .scheduler import Scheduler, SchedulerConfig
from .spec import SpecConfig, build_drafter
from .spec.verify import make_spec_round
from .state_pool import StatePool, all_finite, to_device

#: ``Engine.stats`` keys -> unlabeled registry counters.  The reference's
#: keys, and two of the port's: ``decode_steps`` (plain-block decode steps)
#: and ``spec_replay_steps`` (the decode steps rollbacks ran).
_STATS_COUNTERS = {
    "prefill_s": "serving_prefill_seconds_total",
    "decode_s": "serving_decode_seconds_total",
    "prompt_tokens": "serving_prompt_tokens_total",
    "generated_tokens": "serving_generated_tokens_total",
    "spec_rounds": "serving_spec_rounds_total",
    "spec_drafted": "serving_spec_drafted_total",
    "spec_accepted": "serving_spec_accepted_total",
    "spec_replays": "serving_spec_replay_rounds_total",
    "quarantined": "serving_quarantined_total",
    "breaker_trips": "serving_breaker_trips_total",
    "decode_steps": "serving_decode_steps_total",
    "spec_replay_steps": "serving_spec_replay_steps_total",
}
#: keys that are request-status tallies -> the status label on
#: ``serving_requests_total``
_STATS_STATUS = {"errors": "error", "timeouts": "timeout",
                 "cancelled": "cancelled"}
#: keys holding float seconds (every other key is an int count)
_STATS_FLOAT = frozenset(("prefill_s", "decode_s"))


class _StatsShim(collections.abc.MutableMapping):
    """Dict view of the engine's metrics: reads compute from the live
    metric series, writes forward to them.  ``stats["ttft_s"]`` is the TTFT
    histogram's bounded reservoir of recent samples.  ``engine.obs`` is the
    full interface; ``engine.obs.reset()`` starts a fresh epoch."""

    def __init__(self, obs: Obs):
        self._obs = obs

    def _keys(self):
        return list(_STATS_COUNTERS) + list(_STATS_STATUS) + ["ttft_s"]

    def __getitem__(self, key):
        if key == "ttft_s":
            return self._obs.registry.get("serving_ttft_seconds").recent()
        if key in _STATS_STATUS:
            return int(self._obs.registry.get("serving_requests_total")
                       .value(status=_STATS_STATUS[key]))
        total = self._obs.registry.get(_STATS_COUNTERS[key]).total()
        return total if key in _STATS_FLOAT else int(total)

    def __setitem__(self, key, value):
        if key == "ttft_s":
            hist = self._obs.registry.get("serving_ttft_seconds")
            hist.reset()
            for v in value:
                hist.observe(float(v))
            return
        if key in _STATS_STATUS:
            self._obs.registry.get("serving_requests_total")._set(
                float(value), status=_STATS_STATUS[key])
            return
        self._obs.registry.get(_STATS_COUNTERS[key])._set(float(value))

    def __delitem__(self, key):
        raise TypeError("Engine.stats keys are fixed")

    def __iter__(self):
        return iter(self._keys())

    def __len__(self):
        return len(self._keys())

    def __repr__(self):
        return f"EngineStats({dict(self)})"


@dataclasses.dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray  # (L,) int token ids
    max_new: int = 32
    eos_id: Optional[int] = None
    # wall-clock budget in seconds from submission (``submit``/``run``, or a
    # direct ``admit``); checked on the host once per tick and per block:
    # expiry finishes the request with status="timeout" and its partial
    # stream
    deadline_s: Optional[float] = None
    # per-request sampling override (None = the engine's default)
    sampling: Optional[SamplingConfig] = None
    # scheduler inputs: lower priority numbers drain first; tenants within
    # a priority class share slots fairly
    priority: int = 1
    tenant: str = "default"


@dataclasses.dataclass
class GenResult:
    rid: int
    tokens: List[int]
    ttft_s: float  # admission -> first sampled token
    prompt_len: int
    # "ok" | "error" | "timeout" | "cancelled"; a non-ok result keeps the
    # partial stream committed before the failure (possibly empty)
    status: str = "ok"
    error: Optional[str] = None


def _to(states, device, **kw):
    return tree_map(lambda x: x.to(device, **kw), states)


def check_servable(cfg, spec: Optional[SpecConfig] = None) -> None:
    """Raise ``ValueError`` unless ``Engine`` can serve ``cfg`` (with
    ``spec``): admissibility is the op record's capability.  A streaming
    op's per-slot state batches continuously; a KV cache's one length is
    shared by every row, and so is a hybrid stack's (its attention
    position may be a KV cache), so the engine refuses both, as the
    reference's does.  Callable before any parameter is allocated."""
    op = seq_op.op_for(cfg)  # unknown mixers fail here, not at admission
    if not op.streaming or cfg.group_size:
        raise ValueError(
            "Engine serves streaming-state ops "
            f"{seq_op.streaming_op_names()}; op {op.name!r} "
            f"(group_size={cfg.group_size}) decodes from a KV cache "
            "whose pooled scalar length is shared across slots — "
            "continuous batching needs per-slot lengths")
    if spec is not None and not op.spec_decodable:
        raise ValueError(
            f"op {op.name!r} is not registered spec_decodable: its state "
            "cannot be snapshot/rolled back for speculative verification")


class Engine:
    """Slot-based continuous batching over a ``StatePool``.

    ``params`` is the fp32 parameter tree (``models.param``) on ``device``;
    the engine keeps the copy its forward reads (``lm.cast_params``).
    """

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 4096,
                 sampling: SamplingConfig = SamplingConfig(), block: int = 8,
                 seed: int = 0, device="cuda",
                 spec: Optional[SpecConfig] = None,
                 faults: Optional[FaultPlan] = None,
                 obs: Optional[Obs] = None,
                 cache: Optional[PrefixCache] = None,
                 sched: Optional[SchedulerConfig] = None, mesh=None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') needs a CUDA device")
        check_servable(cfg, spec)
        self.cfg = cfg
        self.device = device
        self.mesh = mesh
        self.params = lm.cast_params(params, cfg)
        self.sampling = sampling
        self.block = block
        self.max_len = max_len
        self.spec = spec
        self.faults = faults
        # the pool is allocated at the scheduler's max_slots once; the
        # autoscaler varies how many of them admissions may fill.  Without
        # a config: a fixed-``slots`` FIFO.
        if sched is not None:
            slots = sched.max_slots
        self.sched_cfg = sched if sched is not None else SchedulerConfig(
            min_slots=slots, max_slots=slots)
        pool_pl = None
        if mesh is not None:
            pool_pl = steps_mod.state_shardings_for(
                cfg, mesh, lm.lm_init_states(cfg, slots, "meta"))
        self.pool = StatePool(
            lambda n: lm.lm_init_states(cfg, n, device), slots, mesh=mesh,
            placements=pool_pl)
        self.tokens = torch.zeros((slots, 1), dtype=torch.long, device=device)
        self.active = np.zeros(slots, bool)
        self._slot_req: List[Optional[GenRequest]] = [None] * slots
        self._slot_out: List[List[int]] = [[] for _ in range(slots)]
        self._slot_ttft: List[float] = [0.0] * slots
        # host times of each slot's first and latest committed tokens
        self._slot_first_t: List[float] = [0.0] * slots
        self._slot_last_t: List[float] = [0.0] * slots
        self._slot_scfg: List[SamplingConfig] = [sampling] * slots
        self._slot_deadline: List[float] = [math.inf] * slots
        self._enqueue_t: Dict[int, float] = {}
        self._cancelled: Set[int] = set()
        self._popped: Set[int] = set()  # rids holding a fair-share ticket
        self.results: Dict[int, GenResult] = {}
        # streaming hook (serving/server.py): called on the drive loop with
        # (rid, new_tokens, result-or-None) after every commit and once at
        # the terminal result.  Must not raise.
        self.on_stream = None
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.breaker = dict(state="closed", cooldown=0, zero_rounds=0,
                            reason=None)
        self.obs = obs if obs is not None else Obs()
        m = self.obs
        self._m_ttft = m.histogram(
            "serving_ttft_seconds", "submission -> first sampled token")
        self._m_itl = m.histogram(
            "serving_inter_token_seconds",
            "per finished request: (last - first token) / (tokens - 1), "
            "host times at the syncs that fetched them")
        self._m_prefill_s = m.counter(
            "serving_prefill_seconds_total", "wall-clock in admissions")
        self._m_decode_s = m.counter(
            "serving_decode_seconds_total",
            "wall-clock in decode blocks / spec rounds")
        self._m_prompt_toks = m.counter(
            "serving_prompt_tokens_total", "prompt tokens prefilled")
        self._m_gen_toks = m.counter(
            "serving_generated_tokens_total", "tokens in terminal streams")
        self._m_requests = m.counter(
            "serving_requests_total", "terminal results by status label")
        self._m_quarantined = m.counter(
            "serving_quarantined_total", "slots reset on non-finite state")
        self._m_breaker = m.counter(
            "serving_breaker_trips_total", "spec -> plain breaker trips")
        self._m_spec_rounds = m.counter(
            "serving_spec_rounds_total", "completed speculative rounds")
        self._m_spec_drafted = m.counter(
            "serving_spec_drafted_total", "draft tokens proposed")
        self._m_spec_accepted = m.counter(
            "serving_spec_accepted_total", "draft tokens accepted")
        self._m_spec_replays = m.counter(
            "serving_spec_replay_rounds_total", "rounds with a rollback")
        self._m_decode_steps = m.counter(
            "serving_decode_steps_total", "plain-block decode steps")
        self._m_replay_steps = m.counter(
            "serving_spec_replay_steps_total",
            "decode steps run by speculative rollbacks")
        self._m_queue = m.gauge(
            "serving_queue_depth", "requests waiting for a slot")
        self._m_slots = m.gauge(
            "serving_slots_active", "slots currently decoding")
        self.stats = _StatsShim(self.obs)
        # the cache is built with (or re-homed into) THIS engine's bundle so
        # its counters land in the same snapshot
        self.scheduler = Scheduler(self.sched_cfg, obs=self.obs,
                                   faults=faults)
        self.cache = cache
        if cache is not None and cache._own_obs:
            cache.bind_obs(self.obs)
        self._m_ttft_cold = m.histogram(
            "serving_ttft_cold_seconds", "TTFT of cache-miss admissions")
        self._m_ttft_hit = m.histogram(
            "serving_ttft_hit_seconds",
            "TTFT of admissions resumed from a cached prefix snapshot")
        self._m_ttft_saved = m.histogram(
            "serving_cache_ttft_saved_seconds",
            "estimated prefill wall-clock avoided per cache hit "
            "(cached prefix tokens x EWMA cold prefill s/token)")
        # EWMA of cold prefill seconds/token — the TTFT-saved estimator
        self._prefill_s_per_tok: Optional[float] = None
        self.drafter = None
        if spec is not None:
            self.drafter = build_drafter(spec, slots=slots, sampling=sampling,
                                         target_cfg=cfg, device=device,
                                         mesh=mesh)
            if self.drafter.vocab is not None and \
                    self.drafter.vocab != cfg.vocab:
                raise ValueError(
                    f"drafter vocab {self.drafter.vocab} != target vocab "
                    f"{cfg.vocab}: draft ids would index the target "
                    "embedding out of range")
            self._spec_round_fn = make_spec_round(
                cfg, sampling, draft_probs=self.drafter.emits_probs,
                mesh=mesh)

    def _mesh_ctx(self):
        """The engine's mesh as the current one (the mixers' row dispatch
        and the logical-axis constraints read it); off-mesh a no-op."""
        return shd.use_mesh(self.mesh)

    # -- fault injection ----------------------------------------------------

    def _bind_faults(self) -> Optional[FaultPlan]:
        """Fired injections document themselves through the engine's
        tracer (the plan may be attached after construction, e.g. after a
        warmup).  The scheduler (``sched.stall``) and the cache
        (``cache.corrupt``) share the engine's plan."""
        if self.faults is not None and self.faults.obs is None:
            self.faults.obs = self.obs
        self.scheduler.faults = self.faults
        if self.cache is not None and self.cache.faults is None:
            self.cache.faults = self.faults
        return self.faults

    def _raise_fault(self, point: str) -> None:
        if self._bind_faults() is not None:
            self.faults.raise_if(point)

    def _inject_block_faults(self) -> None:
        """Hit the once-per-block injection points (no-ops without a plan)."""
        if self._bind_faults() is None:
            return
        slow = self.faults.hit("engine.slow_block")
        if slow is not None:
            time.sleep(slow.arg if slow.arg is not None else 0.05)
        nan = self.faults.hit("engine.nan_state")
        if nan is not None:
            slot = int(nan.arg) if nan.arg is not None else 0
            for x in leaves(self.pool.states):
                if x.is_floating_point():
                    x[:, slot] = float("nan")

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

        Cold: ONE ``lm_prefill`` (one chunk launch per layer) and one copy
        into the slot.  With a cache: resume from the longest cached prefix,
        advance the carry to the prompt's chunk-aligned boundary when that
        lies beyond it (one more ``lm_prefill``), prefill the rest from the
        carry, and insert the boundary state (fetched in the same sync).
        Everything that can raise happens before the slot is activated, so
        a failed admission leaves the engine as it was (the drive loop turns
        the raise into a ``status="error"`` result).
        """
        if self.active[slot]:
            raise ValueError(f"slot {slot} is busy")
        prompt = self._validate(req)
        scfg = req.sampling if req.sampling is not None else self.sampling
        if self.spec is not None and scfg != self.sampling:
            raise ValueError(
                "speculative mode verifies against ONE sampling law; "
                "per-request overrides would need per-slot accept rules "
                f"(engine={self.sampling}, request={scfg})")
        t0 = time.perf_counter()
        L = len(prompt)
        with self.obs.span("engine.prefill", rid=req.rid, slot=slot,
                           prompt_len=L) as t_prefill:
            with self.obs.span("engine.prefill_dispatch"):
                flags, first, hit_len, insert_at, snap = \
                    self._prefill_dispatch(slot, prompt, scfg)
            with self.obs.span("engine.prefill_sync"):
                # sync-point: admission TTFT endpoint (token + health
                # flags, and the boundary snapshot queued before it)
                got = flags.tolist()
        first_tok = got[0]
        if not got[1]:
            self._m_quarantined.inc()
            self.pool.reset_slot(slot)
            raise RuntimeError(f"request {req.rid}: admission prefill "
                               "produced a non-finite state; slot reset")
        if insert_at and got[2]:
            # after the health gate: a poisoned boundary state never
            # becomes a cache entry
            self.cache.insert(prompt[:insert_at], snap)
        t_first = time.perf_counter()
        ttft = t_first - t0
        if hit_len:
            self._m_ttft_hit.observe(ttft)
            if self._prefill_s_per_tok is not None:
                self._m_ttft_saved.observe(hit_len * self._prefill_s_per_tok)
        else:
            self._m_ttft_cold.observe(ttft)
            rate = ttft / L
            self._prefill_s_per_tok = rate if \
                self._prefill_s_per_tok is None else (
                    0.9 * self._prefill_s_per_tok + 0.1 * rate)
        self.tokens[slot, 0] = first  # on the device: no host value to upload
        self.active[slot] = True
        self._slot_req[slot] = req
        self._slot_out[slot] = []
        self._slot_ttft[slot] = ttft
        self._slot_first_t[slot] = t_first
        self._slot_scfg[slot] = scfg
        t_submit = self._enqueue_t.pop(req.rid, None)
        if t_submit is not None:
            self.obs.tracer.interval("engine.queue_wait", t_submit,
                                     t_prefill, rid=req.rid)
        else:  # admitted directly, never queued
            t_submit = t0
        self._slot_deadline[slot] = (
            t_submit + req.deadline_s if req.deadline_s is not None
            else math.inf)
        self._m_prefill_s.inc(ttft)
        self._m_prompt_toks.inc(L)
        self._m_ttft.observe(t_first - t_submit)
        self._m_slots.set(float(self.active.sum()))
        self.obs.event("request.admitted", rid=req.rid, slot=slot,
                       prompt_len=L, cached_prefix=hit_len)
        self.obs.event("request.first_token", rid=req.rid,
                       ttft_s=round(ttft, 6))
        # the first token goes through the one commit path, so max_new=1 or
        # a first-token EOS finishes here
        finished = self._commit(slot, [first_tok], t_first)
        if not finished and self.drafter is not None \
                and self.breaker["state"] == "closed":
            try:
                self.drafter.admit(slot, [int(t) for t in prompt]
                                   + [first_tok])
            except Exception as e:  # a drafter failure never fails admission
                self._trip_breaker(f"drafter.admit failed: {e!r}")
        return first_tok

    def _prefill_dispatch(self, slot: int, prompt: np.ndarray,
                          scfg: SamplingConfig):
        """An admission's work up to its one sync: the prompt's ids to the
        device, ``lm_prefill`` (a second call first where the cache
        advances a carry to a boundary it will store), the first token,
        the health flags, and the state's copy into ``slot``.  Returns
        ``(flags, first, hit_len, insert_at, snap)``: the flags to fetch,
        the first token on the device, the cached prefix resumed from, the
        boundary to cache (0: none) and its host copy, queued."""
        self._raise_fault("engine.prefill")
        L = len(prompt)
        hit_len = insert_at = 0
        snap = None
        ids = to_device(prompt[None], self.device)
        done, carry = 0, None  # tokens already summarized into carry
        if self.cache is not None:
            self._bind_faults()  # cache.corrupt may fire in lookup
            found = self.cache.lookup(prompt, max_prefix=L - 1)
            if found is not None:
                hit_len, host_state = found
                done = hit_len
                # a whole host state: placed as the decode states
                carry = steps_mod.place_states(self.cfg, _to(
                    host_state, self.device, non_blocking=True), self.mesh)
            aligned = self.cache.aligned_len(L)
            if aligned > done:
                # advance to the chunk-aligned boundary first, so its state
                # can be cached; both calls together cover the prompt once
                with self._mesh_ctx():
                    _, carry = lm.lm_prefill(
                        self.params,
                        shd.batch_rows(ids[:, done:aligned], self.mesh),
                        self.cfg, states=carry)
                done = insert_at = aligned
        with self._mesh_ctx():
            last, states = lm.lm_prefill(
                self.params, shd.batch_rows(ids[:, done:], self.mesh),
                self.cfg, states=carry)
        last = shd.full(last)
        first = sample(last, self.gen, scfg)[0]
        flags = [first, (all_finite(states) & last.isfinite().all()).long()]
        if insert_at:
            flags.append(all_finite(carry).long())
            # the boundary state's host copy, queued before the admission's
            # sync so it rides it (pinned memory when from the card); on a
            # mesh the whole state, gathered from the ranks' blocks
            snap = tree_map(lambda x: shd.full(x).to(
                "cpu", non_blocking=True, copy=True), carry)
        self.pool.write_slot(slot, states)
        return torch.stack(flags), first, hit_len, insert_at, snap

    def _commit(self, slot: int, toks, at: float) -> bool:
        """Append tokens to ``slot``'s stream with max_new/eos truncation;
        finish the slot when it stops.  ``at``: the host time the tokens
        reached the host.  Returns True when it finished."""
        req = self._slot_req[slot]
        out = self._slot_out[slot]
        n_before = len(out)
        for t in toks:
            if len(out) >= req.max_new or (
                    req.eos_id is not None and out and out[-1] == req.eos_id):
                break
            out.append(int(t))
        if len(out) > n_before:
            self._slot_last_t[slot] = at
        self._emit_stream(req.rid, out[n_before:], None)
        if len(out) >= req.max_new or (
                req.eos_id is not None and req.eos_id in out):
            self._finish(slot)
            return True
        return False

    def _emit_stream(self, rid: int, toks: List[int],
                     result: Optional[GenResult]) -> None:
        """Feed the streaming hook.  A broken hook must not poison the
        drive loop: its error becomes an event and streaming stops."""
        if self.on_stream is None:
            return
        try:
            self.on_stream(rid, toks, result)
        except Exception as e:  # pragma: no cover - defensive
            self.obs.event("stream.hook_error", rid=rid, error=repr(e))
            self.on_stream = None

    def _finish(self, slot: int, status: str = "ok",
                error: Optional[str] = None) -> None:
        req = self._slot_req[slot]
        out = self._slot_out[slot][: req.max_new]
        if req.eos_id is not None and req.eos_id in out:
            out = out[: out.index(req.eos_id) + 1]
        self.results[req.rid] = GenResult(
            rid=req.rid, tokens=out, ttft_s=self._slot_ttft[slot],
            prompt_len=len(req.prompt), status=status, error=error)
        self._m_requests.inc(status=status)
        self._m_gen_toks.inc(len(out))
        if len(out) > 1:
            self._m_itl.observe((self._slot_last_t[slot]
                                 - self._slot_first_t[slot])
                                / (len(out) - 1))
        self.obs.event("request.done", rid=req.rid, status=status,
                       tokens=len(out),
                       ttft_s=round(self._slot_ttft[slot], 6))
        if req.rid in self._popped:
            self.scheduler.release(req)  # return the tenant's fair share
            self._popped.discard(req.rid)
        self._emit_stream(req.rid, [], self.results[req.rid])
        self.active[slot] = False
        self._m_slots.set(float(self.active.sum()))
        self._slot_req[slot] = None
        self._slot_deadline[slot] = math.inf
        # a freed slot stops adding its override to the block's config set
        self._slot_scfg[slot] = self.sampling
        if self.drafter is not None:
            self.drafter.evict(slot)

    def _fail(self, req: GenRequest, status: str, error: str) -> None:
        """Terminal result for a request that never held a slot (failed
        admission, expiry or cancellation before admission)."""
        self._enqueue_t.pop(req.rid, None)
        self.results[req.rid] = GenResult(
            rid=req.rid, tokens=[], ttft_s=0.0,
            prompt_len=len(np.atleast_1d(np.asarray(req.prompt))),
            status=status, error=error)
        self._m_requests.inc(status=status)
        self.obs.event("request.done", rid=req.rid, status=status,
                       tokens=0, ttft_s=0.0)
        if req.rid in self._popped:
            self.scheduler.release(req)
            self._popped.discard(req.rid)
        self._emit_stream(req.rid, [], self.results[req.rid])

    def _quarantine(self, slot: int) -> None:
        """A slot's state went non-finite: reset it and fail only its
        request; the other slots keep decoding."""
        self._m_quarantined.inc()
        self.pool.reset_slot(slot)
        self._finish(slot, status="error", error="non-finite decode state: "
                     "slot quarantined and reset")

    # -- lifecycle ----------------------------------------------------------

    def cancel(self, rid: int) -> bool:
        """Cancel a request: a live slot finishes at once with
        ``status="cancelled"`` and its partial stream; a queued rid leaves
        the queue and is finalized at once; an unknown rid is marked and
        refused at its admission.  Returns False when the request already
        finished."""
        for s in range(self.pool.slots):
            req = self._slot_req[s]
            if self.active[s] and req is not None and req.rid == rid:
                self._finish(s, status="cancelled",
                             error="cancelled while decoding")
                return True
        queued = self.scheduler.cancel(rid)
        if queued is not None:
            self._fail(queued, "cancelled", "cancelled while queued")
            return True
        if rid in self.results:
            return False
        self._cancelled.add(rid)
        return True

    def _expired(self, req: GenRequest) -> bool:
        if req.deadline_s is None:
            return False
        t0 = self._enqueue_t.get(req.rid)
        return t0 is not None and \
            time.perf_counter() - t0 > req.deadline_s

    def _sweep_deadlines(self) -> None:
        """Once-per-block deadline enforcement (host side, no sync)."""
        now = time.perf_counter()
        for s in range(self.pool.slots):
            if self.active[s] and now >= self._slot_deadline[s]:
                req = self._slot_req[s]
                self._finish(s, status="timeout",
                             error=f"deadline_s={req.deadline_s} exceeded")

    # -- decode -------------------------------------------------------------

    @torch.no_grad()
    def step_block(self, n_steps: Optional[int] = None) -> None:
        """Advance every active slot by ``n_steps`` (default ``block``)
        tokens with one host transfer at the end, or, in speculative mode,
        by ONE draft -> verify -> accept round (up to ``spec.k + 1`` tokens).
        With the breaker open (or tripping on this call) a speculative
        engine runs a plain block instead."""
        self._inject_block_faults()
        if self.spec is not None and self._breaker_gate():
            if self._try_spec_round():
                self._sweep_deadlines()
                return
        n_steps = self.block if n_steps is None else n_steps
        if n_steps <= 0:
            return
        active = to_device(self.active, self.device)
        # one sampling call per DISTINCT config; each slot takes its own
        uniq = sorted(set(self._slot_scfg), key=repr)
        sel = None if len(uniq) == 1 else to_device(
            [uniq.index(c) for c in self._slot_scfg], self.device)
        t0 = time.perf_counter()
        with self.obs.span("engine.decode_block", steps=n_steps,
                           slots_active=int(self.active.sum())):
            tok = self.tokens
            steps = []
            for _ in range(n_steps):
                with self.obs.span("engine.decode_step"):
                    with self._mesh_ctx():
                        logits, _, _ = lm.lm_apply(
                            self.params, shd.batch_rows(tok, self.mesh),
                            self.cfg, states=self.pool.states,
                            mode="decode")
                    logits = shd.full(logits)
                    if sel is None:
                        nxt = sample(logits[:, -1], self.gen, uniq[0])
                    else:
                        cand = torch.stack([sample(logits[:, -1], self.gen,
                                                   c) for c in uniq])
                        nxt = cand.gather(0, sel[None])[0]
                    tok = torch.where(active[:, None], nxt[:, None], tok)
                    steps.append(nxt)
            with self.obs.span("engine.block_sync"):
                self.tokens.copy_(tok)  # in place: the block donates them
                finite = self.pool.finite_mask()
                # sync-point: the once-per-block transfer (tokens +
                # quarantine flags); the span closes on it
                host = torch.cat([torch.stack(steps),
                                  finite[None].long()]).cpu()
        host = host.numpy()
        toks, finite_host = host[:-1], host[-1]
        t1 = time.perf_counter()
        self._m_decode_s.inc(t1 - t0)
        self._m_decode_steps.inc(n_steps)
        for s in range(self.pool.slots):
            if not self.active[s]:
                continue
            if not finite_host[s]:
                self._quarantine(s)
                continue
            self._commit(s, toks[:, s], t1)
        self._sweep_deadlines()

    # -- circuit breaker (speculative -> plain fallback) --------------------

    def _trip_breaker(self, reason: str) -> None:
        self.breaker.update(state="open",
                            cooldown=self.spec.breaker_cooldown_blocks,
                            zero_rounds=0, reason=reason)
        self._m_breaker.inc()
        self.obs.event("breaker.tripped", reason=reason)

    def reset_breaker(self) -> None:
        """Close the breaker for a fresh traffic epoch (with the obs reset
        after a warmup, whose random-weight rounds may trip it)."""
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
        drafter failure (or the ``drafter.propose`` fault point) tripped the
        breaker before anything was mutated: the caller runs a plain block
        instead.  Only the drafter's own calls are guarded: an exception of
        the target's verify or replay propagates."""
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
        # manual span: a propose-phase failure trips the breaker before the
        # round completes, so only completed rounds record one
        timer = self.obs.timer("engine.spec_round", k=self.spec.k,
                               slots_active=len(slots_active))
        try:
            self._raise_fault("drafter.propose")
            drafts, q = self.drafter.propose(slots_active, self.spec.k)
        except Exception as e:  # nothing was mutated: a plain block is exact
            self._trip_breaker(f"drafter crashed: {e!r}")
            return False
        accepted = self._spec_round(slots_active, drafts, q)
        timer.close(accepted=accepted)
        self._m_decode_s.inc(time.perf_counter() - t0)
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
            return to_device(drafts, self.device), q
        k, slots = self.spec.k, self.pool.slots
        ids = to_device(slots_active, self.device)
        full = torch.zeros((slots, k), dtype=torch.long, device=self.device)
        full[ids] = to_device(drafts, self.device).long()
        if q is not None:
            vocab = self.cfg.vocab
            q_full = torch.full((slots, k, vocab), 1.0 / vocab,
                                device=self.device)
            q_full[ids] = to_device(q, self.device).float()
            q = q_full
        return full, q

    def _spec_round(self, slots_active, drafts, q):
        """Verify the drafts of every active slot in one chunk-parallel
        pass, commit the accepted tokens, roll rejected continuations back
        (``spec.verify.make_spec_round``).  Returns the accepted draft
        tokens (the breaker's health signal).  A drafter exception in
        ``commit`` trips the breaker here but loses no verified token."""
        k = self.spec.k
        drafts, q = self._full_width(slots_active, drafts, q)
        packed, finite, new_tokens, steps = self._spec_round_fn(
            self.params, self.pool, self.tokens, self.active, drafts,
            self.gen, q)
        at = time.perf_counter()  # the round's transfers are done
        self.tokens.copy_(new_tokens)  # in place: the round donates them
        self._m_spec_rounds.inc()
        self._m_replay_steps.inc(steps)
        if steps:
            self._m_spec_replays.inc()  # the rollback ran
        accepted = 0
        for s in slots_active:
            if not finite[s]:
                self._quarantine(s)
                continue
            m = int(packed[s, 0])
            committed = [int(t) for t in packed[s, 1:m + 2]]
            self._m_spec_drafted.inc(k)
            self._m_spec_accepted.inc(m)
            accepted += m
            if self._commit(s, committed, at):
                continue  # finished: its state is stale, the slot is free
            if self.breaker["state"] != "closed":
                continue  # the drafter already failed: skip its bookkeeping
            try:
                self.drafter.commit(s, committed)
            except Exception as e:
                self._trip_breaker(f"drafter.commit failed: {e!r}")
        return accepted

    # -- drive loop ---------------------------------------------------------

    def submit(self, req: GenRequest) -> None:
        """Queue one request with the admission scheduler.  Safe between
        drive ticks (the async server submits as traffic arrives); the
        order of service is the scheduler's policy, not call order."""
        now = time.perf_counter()
        self._enqueue_t.setdefault(req.rid, now)
        self.scheduler.submit(req, now=now)
        self.obs.event("request.queued", rid=req.rid,
                       priority=req.priority, tenant=req.tenant)

    def _drive_tick(self) -> None:
        """One drive-loop iteration: expire queued deadlines, honor a
        ``sched.stall``, autoscale the usable slot count, admit scheduler
        winners into free slots, advance one decode block.  Never raises:
        every failure becomes a per-request status."""
        self._bind_faults()
        # queued-deadline expiry FIRST: an expired request never consumes a
        # prefill, and learns its fate this tick even with no slot free
        for req in self.scheduler.expire():
            self._fail(req, "timeout",
                       f"deadline_s={req.deadline_s} expired before "
                       "admission")
        self._m_queue.set(float(len(self.scheduler)))
        if not self.scheduler.stalled():
            target = self.scheduler.target_slots()
            for s in self.free_slots():
                if int(self.active.sum()) >= target:
                    break
                admitted = False
                while len(self.scheduler) and not admitted:
                    req = self.scheduler.pop()
                    if req is None:
                        break
                    self._popped.add(req.rid)
                    if req.rid in self._cancelled:
                        self._cancelled.discard(req.rid)
                        self._fail(req, "cancelled",
                                   "cancelled before admission")
                        continue
                    if self._expired(req):
                        self._fail(req, "timeout",
                                   f"deadline_s={req.deadline_s} expired "
                                   "before admission")
                        continue
                    try:
                        self.admit(s, req)
                        admitted = True
                    except Exception as e:  # the request fails, not the loop
                        self._fail(req, "error", f"admission failed: {e}")
        if self.active.any():
            try:
                self.step_block()
            except Exception as e:  # live slots fail, the loop goes on
                for s in range(self.pool.slots):
                    if self.active[s]:
                        self._finish(s, status="error",
                                     error=f"decode block failed: {e!r}")

    def run(self, requests: List[GenRequest]) -> List[GenResult]:
        """Serve ``requests`` to completion with continuous batching.

        Every request gets a terminal ``GenResult``; per-request failures
        become non-``ok`` statuses on their own results while the other
        slots keep decoding, and the drive loop never raises.  Equal-
        priority single-tenant no-deadline traffic is admitted in arrival
        order; priorities, deadlines and tenants reorder beyond that."""
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("request rids must be unique")
        for r in requests:
            self.submit(r)
        while len(self.scheduler) or self.active.any():
            self._drive_tick()
        self._m_queue.set(0.0)
        return [self.results[r.rid] for r in requests]
