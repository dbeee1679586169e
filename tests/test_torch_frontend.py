"""The port's serving front-end (prefix/state cache, scheduler, async server)
against the reference's, on the CPU: twins of ``tests/test_serving_frontend.py``.

Models are reduced hla-1b (2 layers, d_model 64, fp32) with the reference's
weights carried across by ``from_jax_params``.  Tolerance: everything here
is exact — rolling hashes, crc32 values, byte counts, scheduler order,
greedy streams and the prefix lengths cache hits resume from.
"""

import asyncio
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro.serving import Engine as RefEngine
from repro.serving import GenRequest as RefRequest
from repro.serving import PrefixCache as RefCache
from repro.serving import Scheduler as RefScheduler
from repro.serving import SchedulerConfig as RefSchedConfig
from repro.serving import state_bytes_for as ref_state_bytes_for
from repro.serving.cache import rolling_hashes as ref_rolling_hashes
from repro.serving.cache import tree_bytes as ref_tree_bytes
from repro.serving.cache import tree_checksum as ref_tree_checksum
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params
from repro_torch.runtime.faults import FaultPlan, FaultSpec
from repro_torch.serving import (
    Engine,
    GenRequest,
    PrefixCache,
    SamplingConfig,
    Scheduler,
    SchedulerConfig,
    SpecConfig,
    StatePool,
    state_bytes_for,
)
from repro_torch.serving.cache import rolling_hashes, tree_bytes, tree_checksum
from repro_torch.serving.server import AsyncServer, collect

_MODELS = {}


def _model(mixer="hla2"):
    """Reduced hla-1b with ``mixer``: (ref_cfg, ref_params, cfg, params)."""
    if mixer not in _MODELS:
        ref_cfg = ref_get_config("hla-1b", reduced=True, mixer=mixer)
        cfg = get_config("hla-1b", reduced=True, mixer=mixer)
        ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg),
                                     jax.random.key(0))
        params = from_jax_params(jax.device_get(ref_params),
                                 lm.lm_specs(cfg), device="cpu")
        _MODELS[mixer] = ref_cfg, ref_params, cfg, params
    return _MODELS[mixer]


def _engine(cfg, params, **kw):
    kw = {"slots": 1, "max_len": 64, "block": 4, "seed": 0, **kw}
    return Engine(cfg, params, device="cpu", **kw)


def _tree(nbytes, seed=0):
    """A fake host state snapshot of exactly ``nbytes`` bytes."""
    rng = np.random.RandomState(seed)
    return {"s": torch.from_numpy(rng.randn(nbytes // 8))}


def _req(rid, **kw):
    """A scheduler-facing request stub (no prompt needed)."""
    kw.setdefault("deadline_s", None)
    kw.setdefault("priority", 1)
    kw.setdefault("tenant", "default")
    return types.SimpleNamespace(rid=rid, **kw)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# --------------------------------------------------------------------------
# cache: keys, checksums and sizes against the reference
# --------------------------------------------------------------------------


def test_rolling_hashes_match_reference(rng):
    toks = rng.randint(0, 50304, 300)
    lengths = [8, 24, 128, 256, 300]
    got = rolling_hashes(toks, lengths)
    assert got == ref_rolling_hashes(toks, lengths)
    for n, h in zip(lengths, got):
        assert rolling_hashes(toks[:n], [n]) == [h]
    mut = toks.copy()
    mut[3] += 1
    assert rolling_hashes(mut, [8]) != rolling_hashes(toks, [8])


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_tree_checksum_matches_reference_on_a_prefill_state(rng, mixer):
    """The same state bytes in the same leaf order give the reference's
    crc32: the reference's own prefill state, carried into the port's state
    type field by field."""
    ref_cfg, ref_params, cfg, _ = _model(mixer)
    prompt = rng.randint(2, cfg.vocab, (1, 21))
    _, ref_states = ref_lm.lm_prefill(ref_params, jnp.asarray(prompt),
                                      ref_cfg)
    host = jax.device_get(ref_states)
    port_type = type(lm.lm_init_states(cfg, 1, "cpu"))
    assert port_type._fields == type(host)._fields
    port = port_type(*(torch.from_numpy(np.array(x)) for x in host))
    assert tree_checksum(port) == ref_tree_checksum(host)
    assert tree_bytes(port) == ref_tree_bytes(host) == 25_600


def test_tree_checksum_matches_reference_on_bf16_and_strided_leaves(rng):
    a = rng.randn(6, 10).astype(np.float32)
    b = (rng.randn(4, 8) * 100).astype(np.float32)
    bf = torch.from_numpy(b).bfloat16()
    ref_bf = np.asarray(jnp.asarray(b, jnp.bfloat16))
    port = {"a": torch.from_numpy(a).T, "b": bf}  # a strided view
    ref = {"a": a.T, "b": ref_bf}
    assert tree_checksum(port) == ref_tree_checksum(ref)
    assert tree_bytes(port) == ref_tree_bytes(ref)


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_state_bytes_for_matches_reference(mixer, reduced):
    cfg = get_config("hla-1b", reduced=reduced, mixer=mixer)
    ref_cfg = ref_get_config("hla-1b", reduced=reduced, mixer=mixer)
    got = state_bytes_for(cfg)
    assert got == ref_state_bytes_for(ref_cfg)
    assert got == (25_600 if reduced else 75_890_688)


def test_state_bytes_for_is_a_real_snapshot_size():
    cfg = get_config("hla-1b", reduced=True)
    pool = StatePool(lambda n: lm.lm_init_states(cfg, n, "cpu"), slots=2)
    assert tree_bytes(pool.snapshot_slot(1, host=True)) == \
        state_bytes_for(cfg)


# --------------------------------------------------------------------------
# cache: lookup, eviction, integrity (twins of the reference's cases)
# --------------------------------------------------------------------------


def test_cache_longest_prefix_lookup(rng):
    cache = PrefixCache(granularity=4, budget_bytes=1 << 20)
    toks = rng.randint(0, 100, 16)
    assert cache.lookup(toks) is None  # empty cache: miss
    cache.insert(toks[:4], _tree(64, 1))
    cache.insert(toks[:12], _tree(64, 2))
    n, state = cache.lookup(toks)
    assert n == 12 and state["s"][0] == _tree(64, 2)["s"][0]
    n, _ = cache.lookup(toks, max_prefix=11)
    assert n == 4
    other = toks.copy()
    other[5] += 1
    n, _ = cache.lookup(other)
    assert n == 4
    assert cache.stats()["hits"] == 3


def test_cache_insert_rejects_misaligned_and_oversize():
    cache = PrefixCache(granularity=4, budget_bytes=256)
    assert not cache.insert(np.arange(6), _tree(64))  # 6 % 4 != 0
    assert not cache.insert(np.arange(4), _tree(512))  # > whole budget
    assert len(cache) == 0 and cache.bytes == 0


def test_cache_hash_collision_never_returns_wrong_state(rng):
    cache = PrefixCache(granularity=4, budget_bytes=1 << 20)
    a = rng.randint(0, 100, 4)
    b = (a + 1) % 100
    cache.insert(a, _tree(64, 1))
    entry = next(iter(cache._entries.values()))
    forged_key = (4, (rolling_hashes(b, [4])[0] + cache._ns_seed())
                  % ((1 << 61) - 1))
    cache._entries[forged_key] = entry
    cache._lengths[4] += 1
    assert cache.lookup(b) is None  # the token guard rejects the forgery
    n, _ = cache.lookup(a)
    assert n == 4


def test_cache_eviction_respects_byte_budget():
    cache = PrefixCache(granularity=4, budget_bytes=200)
    for i in range(4):  # 80 bytes each: the 4th insert must evict
        cache.insert(np.arange(i * 4, i * 4 + 4), _tree(80, i))
    assert cache.bytes <= 200
    assert len(cache) == 2
    assert cache.stats()["evicted_bytes"] == 160.0
    assert cache.lookup(np.arange(0, 4)) is None
    assert cache.lookup(np.arange(8, 12)) is not None
    # a lookup refreshes recency: entry 2 now outlives a newer insert
    cache.insert(np.arange(100, 104), _tree(80, 9))
    assert cache.lookup(np.arange(8, 12)) is not None
    assert cache.lookup(np.arange(12, 16)) is None  # 3 was LRU, evicted


def test_cache_namespace_scopes_keys(rng):
    toks = rng.randint(0, 100, 4)
    a = PrefixCache(granularity=4, namespace="model-a")
    b = PrefixCache(granularity=4, namespace="model-b")
    a.insert(toks, _tree(64))
    assert a.lookup(toks) is not None
    assert b.lookup(toks) is None
    a2 = PrefixCache(granularity=4, namespace="model-a")
    a2.insert(toks, _tree(64))
    assert next(iter(a2._entries)) == next(iter(a._entries))
    ref = RefCache(granularity=4, namespace="model-a")
    ref.insert(toks, {"s": np.zeros(8)})
    assert next(iter(ref._entries)) == next(iter(a._entries))


def test_cache_checksum_drops_corrupt_entry(rng):
    plan = FaultPlan(FaultSpec(point="cache.corrupt", at=0))
    cache = PrefixCache(granularity=4, budget_bytes=1 << 20, faults=plan)
    toks = rng.randint(0, 100, 8)
    tree = _tree(64)
    cache.insert(toks, tree)
    assert cache.lookup(toks) is None  # corrupted on the first probe
    assert plan.fired["cache.corrupt"] == 1
    assert len(cache) == 0 and cache.stats()["hits"] == 0
    assert torch.equal(tree["s"], _tree(64)["s"])  # a copy was corrupted

    cache2 = PrefixCache(granularity=4, budget_bytes=1 << 20)
    cache2.insert(toks, _tree(64))
    next(iter(cache2._entries.values())).state["s"][0] += 1.0  # bit rot
    assert cache2.lookup(toks) is None
    assert len(cache2) == 0


# --------------------------------------------------------------------------
# scheduler
# --------------------------------------------------------------------------


def test_scheduler_fifo_within_class():
    s = Scheduler(SchedulerConfig(), clock=_Clock())
    for i in range(3):
        s.submit(_req(i))
    assert [s.pop().rid for _ in range(3)] == [0, 1, 2]
    assert s.pop() is None
    assert s.obs.registry.get("sched_promotions_total").total() == 0


def test_scheduler_priority_classes_and_promotion():
    s = Scheduler(SchedulerConfig(), clock=_Clock())
    s.submit(_req(0, priority=2))
    s.submit(_req(1, priority=0))
    s.submit(_req(2, priority=1))
    assert [s.pop().rid for _ in range(3)] == [1, 2, 0]
    assert s.obs.registry.get("sched_promotions_total").total() == 2
    assert [e["rid"] for e in s.obs.events("sched.promote")] == [1, 2]


def test_scheduler_deadline_slack_and_fair_share():
    s = Scheduler(SchedulerConfig(), clock=_Clock())
    s.submit(_req(0))
    s.submit(_req(1, deadline_s=5.0))
    s.submit(_req(2, deadline_s=1.0))
    assert [s.pop().rid for _ in range(3)] == [2, 1, 0]
    f = Scheduler(SchedulerConfig(), clock=_Clock())
    for i in range(3):
        f.submit(_req(i, tenant="chatty"))
    f.submit(_req(3, tenant="quiet"))
    first, second = f.pop(), f.pop()
    assert (first.rid, second.rid) == (0, 3)
    f.release(first)
    f.release(second)
    assert [f.pop().rid for _ in range(2)] == [1, 2]


def test_scheduler_expiry_cancel_and_stall():
    clk = _Clock()
    s = Scheduler(SchedulerConfig(), clock=clk)
    s.submit(_req(0, deadline_s=1.0))
    s.submit(_req(1, deadline_s=10.0))
    s.submit(_req(2))
    assert s.expire() == []
    clk.t = 2.0
    assert [r.rid for r in s.expire()] == [0]
    assert s.cancel(1).rid == 1 and s.cancel(1) is None
    assert s.pop().rid == 2 and len(s) == 0
    clk.t = 20.0
    assert s.expire() == []
    assert s.obs.registry.get("sched_expired_total").total() == 1
    plan = FaultPlan(FaultSpec(point="sched.stall", at=1))
    st = Scheduler(SchedulerConfig(), faults=plan)
    assert [st.stalled() for _ in range(3)] == [False, True, False]
    assert st.obs.registry.get("sched_stall_ticks_total").total() == 1
    with pytest.raises(ValueError, match="min_slots"):
        SchedulerConfig(min_slots=3, max_slots=2)
    with pytest.raises(ValueError, match="scale_down_ticks"):
        SchedulerConfig(scale_down_ticks=0)
    st.submit(_req(7))
    with pytest.raises(ValueError, match="already queued"):
        st.submit(_req(7))


def test_scheduler_autoscaler_hysteresis():
    cfg = SchedulerConfig(min_slots=1, max_slots=4, scale_down_ticks=3,
                          quarantine_cap=2)
    s = Scheduler(cfg, clock=_Clock())
    assert s.target_slots() == 1
    for i in range(8):
        s.submit(_req(i))
    assert s.target_slots() == 4
    for _ in range(8):
        s.pop()
    assert [s.target_slots() for _ in range(3)] == [4, 4, 3]
    s.submit(_req(99))
    assert s.target_slots() == 4
    s.pop()
    s.note_quarantine(2)
    assert s.target_slots() == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_order_matches_reference_on_a_random_trace(seed):
    """Submits (priorities, tenants, deadlines), pops, releases, expiries,
    cancels and autoscaler ticks drawn from one seed: both schedulers give
    the same outputs and the same counters."""
    rng = np.random.RandomState(seed)
    cfg = dict(min_slots=1, max_slots=6, scale_down_ticks=2,
               quarantine_cap=2)
    clocks = _Clock(), _Clock()
    scheds = (Scheduler(SchedulerConfig(**cfg), clock=clocks[0]),
              RefScheduler(RefSchedConfig(**cfg), clock=clocks[1]))
    held = [[], []]
    logs = [[], []]
    next_rid = 0
    for _ in range(300):
        op = rng.choice(["submit", "submit", "pop", "release", "expire",
                         "cancel", "tick", "advance"])
        arg = dict(priority=int(rng.randint(0, 3)),
                   tenant=f"t{rng.randint(0, 3)}",
                   deadline_s=None if rng.rand() < 0.5
                   else float(rng.uniform(0.5, 5.0)))
        pick = int(rng.randint(0, 1 << 30))
        for i, (s, clk, log) in enumerate(zip(scheds, clocks, logs)):
            if op == "submit":
                s.submit(_req(next_rid, **arg))
            elif op == "pop":
                r = s.pop()
                log.append(None if r is None else r.rid)
                if r is not None:
                    held[i].append(r)
            elif op == "release" and held[i]:
                s.release(held[i].pop(pick % len(held[i])))
            elif op == "expire":
                log.append([r.rid for r in s.expire()])
            elif op == "cancel" and next_rid:
                r = s.cancel(pick % next_rid)
                log.append(None if r is None else r.rid)
            elif op == "tick":
                if pick % 5 == 0:
                    s.note_quarantine(2)
                log.append(s.target_slots())
            elif op == "advance":
                clk.t += 0.4
        next_rid += op == "submit"
    assert logs[0] == logs[1]
    assert len(logs[0]) > 100
    for name in ("sched_expired_total", "sched_promotions_total"):
        assert scheds[0].obs.registry.get(name).total() == \
            scheds[1].obs.registry.get(name).total()
    assert scheds[0].obs.registry.get("sched_queue_wait_seconds").count() \
        == scheds[1].obs.registry.get("sched_queue_wait_seconds").count()


# --------------------------------------------------------------------------
# engine + cache: cached-prefix decode equals cold decode and the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_cached_prefix_decode_matches_cold_and_reference(rng, mixer):
    """Cache-hit decode == cold-start decode == the reference engine with a
    cache, token for token, across resume points at the cached boundary,
    mid-chunk and on a granularity multiple; a long prompt also advances
    the carry to the next boundary and inserts it; hits resume at the same
    prefix lengths as the reference's."""
    ref_cfg, ref_params, cfg, params = _model(mixer)
    prefix = rng.randint(2, cfg.vocab, 12)
    prompts = [np.concatenate([prefix, rng.randint(2, cfg.vocab, n)])
               for n in (1, 2, 4, 9)] + [rng.randint(2, cfg.vocab, 3)]

    def reqs(make):
        return [make(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]

    cold = _engine(cfg, params).run(reqs(GenRequest))
    warm = _engine(cfg, params, cache=PrefixCache(granularity=4,
                                                  budget_bytes=1 << 26))
    got = warm.run(reqs(GenRequest))
    ref = RefEngine(ref_cfg, ref_params, slots=1, max_len=64, block=4,
                    seed=0, cache=RefCache(granularity=4,
                                           budget_bytes=1 << 26))
    want = ref.run(reqs(RefRequest))
    assert [r.status for r in got] == ["ok"] * len(prompts)
    assert [r.tokens for r in got] == [r.tokens for r in cold]
    assert [r.tokens for r in got] == [r.tokens for r in want]

    def hits(eng):
        return {e["rid"]: e["cached_prefix"]
                for e in eng.obs.events("request.admitted")}

    assert hits(warm) == hits(ref) == {0: 0, 1: 12, 2: 12, 3: 12, 4: 0}
    keys = ("hits", "misses", "entries", "bytes")
    assert {k: warm.cache.stats()[k] for k in keys} == \
        {k: ref.cache.stats()[k] for k in keys}
    for name in ("cache_insertions_total", "serving_ttft_hit_seconds",
                 "serving_ttft_cold_seconds"):
        a, b = warm.obs.registry.get(name), ref.obs.registry.get(name)
        assert (a.count() if hasattr(a, "count") else a.total()) == \
            (b.count() if hasattr(b, "count") else b.total()), name


def test_cache_corrupt_falls_back_to_cold_prefill(rng):
    _, _, cfg, params = _model()
    prompt = rng.randint(2, cfg.vocab, 13)
    plan = FaultPlan(FaultSpec(point="cache.corrupt", at=0))
    eng = _engine(cfg, params, faults=plan,
                  cache=PrefixCache(granularity=4, budget_bytes=1 << 26))
    (r0,) = eng.run([GenRequest(rid=0, prompt=prompt, max_new=6)])
    (r1,) = eng.run([GenRequest(rid=1, prompt=prompt, max_new=6)])
    (r2,) = eng.run([GenRequest(rid=2, prompt=prompt, max_new=6)])
    assert r1.tokens == r0.tokens == r2.tokens
    assert plan.fired["cache.corrupt"] == 1
    reg = eng.obs.registry
    assert reg.get("cache_corrupt_dropped_total").total() == 1
    assert reg.get("cache_hits_total").total() == 1  # only r2 hits


def test_cache_insertion_gated_on_finite_state(rng):
    _, _, cfg, params = _model()

    def nan(tree):
        if isinstance(tree, dict):
            return {k: nan(v) for k, v in tree.items()}
        return torch.full_like(tree, float("nan"))

    cache = PrefixCache(granularity=4, budget_bytes=1 << 26)
    eng = _engine(cfg, nan(params), cache=cache)
    (r,) = eng.run([GenRequest(rid=0, prompt=rng.randint(2, cfg.vocab, 13),
                               max_new=4)])
    assert r.status == "error"
    assert len(cache) == 0


# --------------------------------------------------------------------------
# engine + scheduler: expiry, priority, cancellation, sampling override
# --------------------------------------------------------------------------


def test_expired_queued_request_never_spends_a_prefill(rng):
    _, _, cfg, params = _model()
    plan = FaultPlan(  # every decode block sleeps 30ms
        FaultSpec(point="engine.slow_block", at=0, times=None, arg=0.03))
    eng = _engine(cfg, params, faults=plan)
    admitted = []
    real_admit = eng.admit
    eng.admit = lambda s, r: (admitted.append(r.rid), real_admit(s, r))[1]
    terminal = []
    eng.on_stream = lambda rid, toks, res: (
        terminal.append(rid) if res is not None else None)
    long = GenRequest(rid=0, prompt=rng.randint(2, cfg.vocab, 8),
                      max_new=24, priority=0)
    doomed = GenRequest(rid=1, prompt=rng.randint(2, cfg.vocab, 8),
                        max_new=4, deadline_s=0.05)
    r0, r1 = eng.run([long, doomed])
    assert r0.status == "ok" and len(r0.tokens) == 24
    assert r1.status == "timeout" and r1.tokens == []
    assert admitted == [0]
    assert terminal[0] == 1  # learned its fate before rid 0 ended
    assert eng.obs.registry.get("sched_expired_total").total() == 1


def test_priority_reorders_single_slot_admissions(rng):
    _, _, cfg, params = _model()
    eng = _engine(cfg, params)
    terminal = []
    eng.on_stream = lambda rid, toks, res: (
        terminal.append(rid) if res is not None else None)
    low = GenRequest(rid=0, prompt=rng.randint(2, cfg.vocab, 6), max_new=4,
                     priority=2)
    high = GenRequest(rid=1, prompt=rng.randint(2, cfg.vocab, 6), max_new=4,
                      priority=0)
    r_low, r_high = eng.run([low, high])
    assert r_low.status == r_high.status == "ok"
    assert terminal == [1, 0]
    assert eng.obs.registry.get("sched_promotions_total").total() == 1


def test_cancel_queued_request_finalizes_immediately(rng):
    _, _, cfg, params = _model()
    eng = _engine(cfg, params)
    eng.submit(GenRequest(rid=5, prompt=rng.randint(2, cfg.vocab, 6),
                          max_new=4))
    assert eng.cancel(5)
    assert eng.results[5].status == "cancelled"
    assert len(eng.scheduler) == 0
    assert not eng.cancel(5)


def test_per_request_sampling_override(rng, monkeypatch):
    """A sampled slot beside a greedy one: the greedy stream is the solo
    greedy (and the reference's) stream, and the mixed block still makes one
    host transfer.  A speculative engine refuses the override."""
    ref_cfg, ref_params, cfg, params = _model()
    prompts = [rng.randint(2, cfg.vocab, n) for n in (7, 5)]
    (want,) = RefEngine(ref_cfg, ref_params, slots=2, max_len=64,
                        block=4).run([RefRequest(rid=0, prompt=prompts[0],
                                                 max_new=10)])
    hot = SamplingConfig(method="temperature", temperature=1.5)
    eng = _engine(cfg, params, slots=2)
    eng.admit(0, GenRequest(rid=0, prompt=prompts[0], max_new=10))
    eng.admit(1, GenRequest(rid=1, prompt=prompts[1], max_new=10,
                            sampling=hot))
    calls = {"cpu": 0}
    orig = torch.Tensor.cpu

    def counted(self, *a, **k):
        calls["cpu"] += 1
        return orig(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    eng.step_block()
    monkeypatch.undo()
    assert calls["cpu"] == 1
    while eng.active.any():
        eng.step_block()
    assert eng.results[0].tokens == want.tokens
    assert len(eng.results[1].tokens) == 10
    spec = _engine(cfg, params, slots=2, spec=SpecConfig(k=2))
    (bad,) = spec.run([GenRequest(rid=0, prompt=prompts[0], max_new=4,
                                  sampling=hot)])
    assert bad.status == "error" and "ONE sampling law" in bad.error


# --------------------------------------------------------------------------
# host snapshots
# --------------------------------------------------------------------------


def test_host_snapshot_roundtrip():
    cfg = get_config("hla-1b", reduced=True)
    pool = StatePool(lambda n: lm.lm_init_states(cfg, n, "cpu"), slots=2)
    vals = type(pool.states)(*(
        torch.arange(x.numel(), dtype=torch.float32).reshape(x.shape)
        for x in pool.empty_slot_state()))
    pool.write_slot(1, vals)
    snap = pool.snapshot_slot(1, host=True)
    assert all(x.device.type == "cpu" for x in snap)
    before = tree_checksum(snap)
    pool.reset_slot(1)
    assert tree_checksum(pool.read_slot(1)) != before
    pool.restore_slot(1, snap)
    assert tree_checksum(pool.read_slot(1)) == before
    for a, b in zip(snap, pool.read_slot(1)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# async streaming server
# --------------------------------------------------------------------------


def test_async_server_streams_match_results(rng):
    _, _, cfg, params = _model()
    eng = _engine(cfg, params, slots=2)
    reqs = [GenRequest(rid=i, prompt=rng.randint(2, cfg.vocab, 6),
                       max_new=5) for i in range(3)]

    async def main():
        async with AsyncServer(eng) as srv:
            return await asyncio.gather(*[collect(srv, r) for r in reqs])

    outs = asyncio.run(main())
    solo = _engine(cfg, params, slots=2).run(
        [GenRequest(rid=r.rid, prompt=r.prompt, max_new=5) for r in reqs])
    for req, (toks, res), want in zip(reqs, outs, solo):
        assert res.status == "ok"
        assert toks == res.tokens == eng.results[req.rid].tokens
        assert toks == want.tokens
    reg = eng.obs.registry
    assert reg.get("server_streams_total").total() == 3
    assert reg.get("server_stream_tokens_total").total() == 15
    assert eng.on_stream is None  # drain uninstalled the hook


def test_async_server_drain_refuses_new_streams(rng):
    _, _, cfg, params = _model()
    eng = _engine(cfg, params)

    async def main():
        srv = AsyncServer(eng)
        async with srv:
            toks, res = await collect(
                srv, GenRequest(rid=0, prompt=rng.randint(2, cfg.vocab, 6),
                                max_new=4))
            assert res.status == "ok" and len(toks) == 4
        with pytest.raises(RuntimeError, match="draining"):
            await srv.generate(
                GenRequest(rid=1, prompt=rng.randint(2, cfg.vocab, 6),
                           max_new=4)).__anext__()

    asyncio.run(main())


def test_async_server_backpressure_pauses_drive_loop(rng):
    _, _, cfg, params = _model()
    eng = _engine(cfg, params)
    req = GenRequest(rid=0, prompt=rng.randint(2, cfg.vocab, 6), max_new=12)

    async def main():
        async with AsyncServer(eng, max_buffered_tokens=2) as srv:
            toks = []
            async for t in srv.generate(req):
                toks.append(t)
                await asyncio.sleep(0.005)  # slow reader
            return toks

    assert len(asyncio.run(main())) == 12
    assert eng.obs.registry.get(
        "server_backpressure_waits_total").total() >= 1
