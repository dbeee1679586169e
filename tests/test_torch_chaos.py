"""Deterministic fault injection on the port's serve path, against the
reference engine under the same ``FaultPlan``: twins of
``tests/test_chaos.py`` for every fault point the serve path owns
(``engine.prefill``, ``engine.nan_state``, ``engine.slow_block``,
``drafter.propose``, ``cache.corrupt``, ``sched.stall``), the request
lifecycle (validation, cancellation, deadlines), the circuit breaker and
the combined chaos run.

Configs are the reference tests' tiny ``_cfg`` (1 layer, d_model 32, 2
heads, vocab 64; fp32), with the reference's weights carried across by
``from_jax_params``.  All runs are greedy, so streams are invariant to when
a slot was (re)admitted; statuses, streams and the fault counters must
equal the reference's exactly.  The one timing-driven case (slow blocks
against a deadline) holds statuses exactly and streams as prefixes of the
fault-free streams.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro.runtime.faults import FaultPlan as RefPlan
from repro.runtime.faults import FaultSpec as RefFaultSpec
from repro.runtime.faults import parse_fault as ref_parse_fault
from repro.serving import Engine as RefEngine
from repro.serving import GenRequest as RefRequest
from repro.serving import PrefixCache as RefCache
from repro.serving import SpecConfig as RefSpec
from repro.serving.spec.drafters import Drafter as RefDrafter
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params
from repro_torch.runtime.faults import (
    FAULT_POINTS,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    parse_fault,
)
from repro_torch.serving import Engine, GenRequest, PrefixCache, SpecConfig
from repro_torch.serving.spec import Drafter

TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab=64)


@pytest.fixture(scope="module")
def model():
    ref_cfg = ref_get_config("hla-1b", reduced=True).replace(mixer="hla2")
    ref_cfg = ref_cfg.replace(**TINY, hla=dataclasses.replace(ref_cfg.hla,
                                                              chunk=16))
    cfg = get_config("hla-1b", reduced=True).replace(**TINY)
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


def _requests(make, lens=(5, 11, 7, 9), max_new=10, **kw):
    return [make(rid=i, prompt=np.random.RandomState(10 + i).randint(
        2, TINY["vocab"], n), max_new=max_new, **kw)
        for i, n in enumerate(lens)]


def _engines(model, faults=(), spec=None, cache=None, **kw):
    """The port's and the reference's engines, each with its own plan of
    the same ``faults`` (FaultSpec field tuples) and the same options."""
    ref_cfg, ref_params, cfg, params = model
    kw = {"slots": 2, "max_len": 96, "block": 4, **kw}
    port = Engine(cfg, params, device="cpu",
                  faults=FaultPlan(*(FaultSpec(*f) for f in faults))
                  if faults else None,
                  spec=None if spec is None else SpecConfig(**spec),
                  cache=None if cache is None else PrefixCache(**cache), **kw)
    ref = RefEngine(ref_cfg, ref_params,
                    faults=RefPlan(*(RefFaultSpec(*f) for f in faults))
                    if faults else None,
                    spec=None if spec is None else RefSpec(**spec),
                    cache=None if cache is None else RefCache(**cache), **kw)
    return port, ref


def _run_both(model, reqs=None, **kw):
    """Run the same requests through both engines: ``(port results, ref
    results, port engine, ref engine)``, results in request order."""
    port, ref = _engines(model, **kw)
    reqs = reqs or {}
    got = port.run(_requests(GenRequest, **reqs))
    want = ref.run(_requests(RefRequest, **reqs))
    return got, want, port, ref


def _same(got, want):
    assert [r.status for r in got] == [r.status for r in want]
    assert [r.tokens for r in got] == [r.tokens for r in want]


FAULT_STATS = ("errors", "timeouts", "cancelled", "quarantined",
               "breaker_trips", "spec_rounds", "spec_drafted",
               "spec_accepted")


def _same_stats(port, ref, keys=FAULT_STATS):
    assert {k: port.stats[k] for k in keys} == {k: ref.stats[k] for k in keys}
    assert dict(port.faults.fired if port.faults else {}) == \
        dict(ref.faults.fired if ref.faults else {})


@pytest.fixture(scope="module")
def reference(model):
    """Fault-free greedy streams of the port: the byte-identity oracle."""
    _, _, cfg, params = model
    res = Engine(cfg, params, slots=2, max_len=96, block=4,
                 device="cpu").run(_requests(GenRequest))
    assert all(r.status == "ok" for r in res)
    return {r.rid: r.tokens for r in res}


class _WrongDrafter(Drafter):
    def admit(self, slot, tokens):
        pass

    def commit(self, slot, tokens):
        pass

    def propose(self, slot_ids, k):
        return np.ones((len(slot_ids), k), np.int64), None


class _RefWrongDrafter(RefDrafter):
    def admit(self, slot, tokens):
        pass

    def commit(self, slot, tokens):
        pass

    def propose(self, slot_ids, k):
        return np.ones((len(slot_ids), k), np.int32), None


# --------------------------------------------------------------------------
# the fault registry itself
# --------------------------------------------------------------------------


def test_fault_catalog_matches_reference():
    from repro.runtime.faults import FAULT_POINTS as REF_POINTS

    assert FAULT_POINTS == REF_POINTS


def test_fault_registry_basics():
    plan = FaultPlan(FaultSpec("train.step", at=2, times=2))
    ref = RefPlan(RefFaultSpec("train.step", at=2, times=2))
    fired = [plan.hit("train.step") is not None for _ in range(6)]
    assert fired == [False, False, True, True, False, False]
    assert fired == [ref.hit("train.step") is not None for _ in range(6)]
    assert plan.fired["train.step"] == 2 and plan.hits("train.step") == 6
    forever = FaultPlan(FaultSpec("ckpt.save", at=1, times=None))
    assert [forever.hit("ckpt.save") is not None for _ in range(4)] == \
        [False, True, True, True]
    with pytest.raises(InjectedFault, match="drafter.propose"):
        FaultPlan(FaultSpec("drafter.propose")).raise_if("drafter.propose")
    with pytest.raises(ValueError, match="unknown fault point"):
        FaultSpec("engine.nonexistent")
    with pytest.raises(ValueError, match="unregistered"):
        FaultPlan().hit("engine.nonexistent")
    with pytest.raises(ValueError):
        FaultSpec("train.step", at=-1)
    with pytest.raises(ValueError):
        FaultSpec("train.step", times=0)


@pytest.mark.parametrize("text", ["engine.nan_state@1:0", "drafter.propose@2+",
                                  "engine.slow_block:0.2", "ckpt.save",
                                  "cache.corrupt@3", "sched.stall@0+"])
def test_parse_fault_matches_reference(text):
    got, want = parse_fault(text), ref_parse_fault(text)
    assert (got.point, got.at, got.times, got.arg) == \
        (want.point, want.at, want.times, want.arg)


def test_parse_fault_rejects_unknown_points():
    with pytest.raises(ValueError):
        parse_fault("bogus.point")


# --------------------------------------------------------------------------
# request lifecycle: admission validation, statuses, cancel, deadlines
# --------------------------------------------------------------------------


def test_admission_validation_statuses(model, reference):
    bad = [
        dict(rid=10, prompt=np.array([TINY["vocab"] + 5, 1]), max_new=4),
        dict(rid=11, prompt=np.array([], np.int64), max_new=4),
        dict(rid=12, prompt=np.array([0.5, 1.5]), max_new=4),
        dict(rid=13, prompt=np.arange(2, 6), max_new=0),
        dict(rid=14, prompt=np.arange(2, 6), max_new=10_000),
    ]
    port, ref = _engines(model)
    got = port.run(_requests(GenRequest)[:2] + [GenRequest(**b) for b in bad])
    want = ref.run(_requests(RefRequest)[:2] + [RefRequest(**b) for b in bad])
    _same(got, want)
    by = {r.rid: r for r in got}
    for rid in (0, 1):
        assert by[rid].status == "ok" and by[rid].tokens == reference[rid]
    assert all(by[b["rid"]].status == "error" for b in bad)
    assert "vocab" in by[10].error and "max_new" in by[13].error
    assert "max_len" in by[14].error
    _same_stats(port, ref)


def test_admission_token_reaches_commit(model):
    prompt = _requests(GenRequest)[0].prompt
    port, ref = _engines(model)
    first = port.run([GenRequest(rid=9, prompt=prompt, max_new=2)])[0] \
        .tokens[0]
    got = port.run([GenRequest(rid=0, prompt=prompt, max_new=1),
                    GenRequest(rid=1, prompt=prompt, max_new=1,
                               eos_id=first)])
    want = ref.run([RefRequest(rid=0, prompt=prompt, max_new=1),
                    RefRequest(rid=1, prompt=prompt, max_new=1,
                               eos_id=first)])
    _same(got, want)
    assert [r.tokens for r in got] == [[first], [first]]


def test_duplicate_rids_still_raise(model):
    port, _ = _engines(model)
    reqs = _requests(GenRequest)[:2]
    reqs[1] = dataclasses.replace(reqs[1], rid=reqs[0].rid)
    with pytest.raises(ValueError, match="unique"):
        port.run(reqs)


def test_cancel_lifecycle(model):
    port, ref = _engines(model)
    outs = []
    for eng, make in ((port, GenRequest), (ref, RefRequest)):
        reqs = _requests(make)
        assert eng.cancel(reqs[3].rid) is True  # pre-cancel a queued rid
        eng.admit(0, reqs[0])
        eng.step_block()
        assert eng.cancel(reqs[0].rid) is True  # cancel a live slot
        assert not eng.active[0]
        res = [eng.results[0]] + eng.run(reqs[1:])
        assert eng.cancel(reqs[1].rid) is False  # already finished
        outs.append(res)
    _same(*outs)
    got = {r.rid: r for r in outs[0]}
    assert got[0].status == "cancelled" and 0 < len(got[0].tokens) <= 10
    assert got[3].status == "cancelled" and got[3].tokens == []
    assert got[1].status == got[2].status == "ok"
    assert port.stats["cancelled"] == ref.stats["cancelled"] == 2


def test_deadline_expiry_mid_stream(model):
    port, ref = _engines(model)
    outs = []
    for eng, make in ((port, GenRequest), (ref, RefRequest)):
        reqs = _requests(make, max_new=20)
        eng.admit(0, dataclasses.replace(reqs[0], deadline_s=0.0))
        eng.admit(1, reqs[1])
        eng.step_block()
        outs.append((eng.results[0], bool(eng.active[1]),
                     bool(eng.active[0])))
    (r0, live1, live0), (want, _, _) = outs
    assert (r0.status, r0.tokens) == (want.status, want.tokens)
    assert r0.status == "timeout" and 0 < len(r0.tokens) < 20
    assert "deadline" in r0.error and live1 and not live0
    assert port.stats["timeouts"] == ref.stats["timeouts"] == 1


def test_deadline_expiry_before_admission(model, reference):
    port, ref = _engines(model)
    reqs = _requests(GenRequest)
    reqs[1] = dataclasses.replace(reqs[1], deadline_s=0.0)
    ref_reqs = _requests(RefRequest)
    ref_reqs[1] = dataclasses.replace(ref_reqs[1], deadline_s=0.0)
    got, want = port.run(reqs), ref.run(ref_reqs)
    _same(got, want)
    assert got[1].status == "timeout" and got[1].tokens == []
    for rid in (0, 2, 3):
        assert got[rid].tokens == reference[rid]


def test_slow_block_plus_deadline(model, reference):
    """engine.slow_block makes every block overshoot a small budget: every
    request times out with a prefix of its fault-free stream, both
    engines."""
    faults = [("engine.slow_block", 0, None, 0.05)]
    got, want, port, ref = _run_both(
        model, faults=faults,
        reqs=dict(lens=(5, 11), max_new=50, deadline_s=0.04))
    assert [r.status for r in got] == [r.status for r in want] == \
        ["timeout"] * 2
    for r in got:
        n = min(len(r.tokens), 10)
        assert r.tokens[:n] == reference[r.rid][:n] and len(r.tokens) < 50
    assert len(got[0].tokens) > 0  # admitted at once, timed out mid-stream


# --------------------------------------------------------------------------
# per-request failure isolation, one fault point at a time
# --------------------------------------------------------------------------


def test_injected_prefill_failure_isolates(model, reference):
    got, want, port, ref = _run_both(model,
                                     faults=[("engine.prefill", 1)])
    _same(got, want)
    failed = [r for r in got if r.status == "error"]
    assert len(failed) == 1 and "injected fault" in failed[0].error
    for r in got:
        if r.status == "ok":
            assert r.tokens == reference[r.rid]
    _same_stats(port, ref)
    assert port.stats["errors"] == 1


@pytest.mark.parametrize("spec", [None, dict(k=3, drafter="ngram")],
                         ids=["plain", "spec"])
def test_nan_quarantine_isolates(model, reference, spec):
    got, want, port, ref = _run_both(
        model, faults=[("engine.nan_state", 1, 1, 1)], spec=spec)
    _same(got, want)
    bad = [r for r in got if r.status == "error"]
    assert len(bad) == 1 and "quarantined" in bad[0].error
    assert len(bad[0].tokens) < 10
    for r in got:
        if r.status == "ok":
            assert r.tokens == reference[r.rid], r.rid
    _same_stats(port, ref)
    assert port.stats["quarantined"] == port.stats["errors"] == 1


def test_decode_block_crash_fails_open(model, monkeypatch):
    """A crash of the decode step itself stays inside run(): every live
    request errors, and the engine serves the next batch."""
    port, _ = _engines(model)
    reqs = _requests(GenRequest)

    def boom(*a, **k):
        raise RuntimeError("simulated kernel failure")

    with monkeypatch.context() as m:
        m.setattr(lm, "lm_apply", boom)
        res = port.run(reqs[:2])
    assert all(r.status == "error" for r in res)
    assert all("decode block failed" in r.error for r in res)
    assert all(len(r.tokens) == 1 for r in res)  # the admission token
    assert all(r.status == "ok" for r in port.run(reqs[2:]))


def test_cache_corrupt_matches_reference(model, reference):
    """``cache.corrupt`` on the first hit: the entry is dropped, that
    admission goes cold, and every stream equals the reference's."""
    rng = np.random.RandomState(3)
    prefix = rng.randint(2, TINY["vocab"], 12)
    prompts = [np.concatenate([prefix, rng.randint(2, TINY["vocab"], n)])
               for n in (1, 2, 5, 1)]
    port, ref = _engines(model, faults=[("cache.corrupt", 0)],
                         cache=dict(granularity=4, budget_bytes=1 << 26))
    got = port.run([GenRequest(rid=i, prompt=p, max_new=8)
                    for i, p in enumerate(prompts)])
    want = ref.run([RefRequest(rid=i, prompt=p, max_new=8)
                    for i, p in enumerate(prompts)])
    _same(got, want)
    cold = Engine(model[2], model[3], slots=2, max_len=96, block=4,
                  device="cpu").run([GenRequest(rid=i, prompt=p, max_new=8)
                                     for i, p in enumerate(prompts)])
    assert [r.tokens for r in got] == [r.tokens for r in cold]
    for name in ("cache_hits_total", "cache_misses_total",
                 "cache_corrupt_dropped_total", "cache_insertions_total"):
        assert port.obs.registry.get(name).total() == \
            ref.obs.registry.get(name).total(), name
    _same_stats(port, ref)
    assert port.obs.registry.get("cache_corrupt_dropped_total").total() == 1
    assert port.obs.registry.get("cache_hits_total").total() >= 1


def test_sched_stall_matches_reference(model):
    """Stalled ticks admit nothing, and a queued request whose deadline
    passes meanwhile times out before it spends a prefill."""
    faults = [("sched.stall", 0, 3)]
    port, ref = _engines(model, faults=faults)
    outs = []
    for eng, make in ((port, GenRequest), (ref, RefRequest)):
        reqs = _requests(make)
        reqs[2] = dataclasses.replace(reqs[2], deadline_s=0.0)
        outs.append(eng.run(reqs))
    _same(*outs)
    assert [r.status for r in outs[0]] == ["ok", "ok", "timeout", "ok"]
    _same_stats(port, ref)
    for name in ("sched_stall_ticks_total", "sched_expired_total"):
        assert port.obs.registry.get(name).total() == \
            ref.obs.registry.get(name).total() > 0


# --------------------------------------------------------------------------
# circuit breaker: spec -> plain fallback
# --------------------------------------------------------------------------


def test_drafter_crash_falls_back_to_plain(model, reference):
    got, want, port, ref = _run_both(
        model, spec=dict(k=3, drafter="ngram"),
        faults=[("drafter.propose", 0, None)])
    _same(got, want)
    assert all(r.status == "ok" for r in got)
    assert all(r.tokens == reference[r.rid] for r in got)
    _same_stats(port, ref)
    assert port.stats["breaker_trips"] >= 1 and port.stats["spec_rounds"] == 0
    assert port.breaker["state"] == ref.breaker["state"] == "open"


def test_breaker_half_open_recovery(model, reference):
    spec = dict(k=3, drafter="ngram", breaker_cooldown_blocks=1,
                breaker_zero_rounds=100)
    got, want, port, ref = _run_both(model, spec=spec,
                                     faults=[("drafter.propose", 0, 1)])
    _same(got, want)
    assert all(r.tokens == reference[r.rid] for r in got)
    _same_stats(port, ref)
    assert port.stats["breaker_trips"] == 1 and port.stats["spec_rounds"] > 0
    assert port.breaker["state"] == ref.breaker["state"] == "closed"


def test_breaker_zero_acceptance_trip(model, reference):
    ref_cfg, ref_params, cfg, params = model
    kw = dict(k=3, breaker_zero_rounds=2, breaker_cooldown_blocks=100)
    port = Engine(cfg, params, slots=2, max_len=96, block=4, device="cpu",
                  spec=SpecConfig(drafter=_WrongDrafter(), **kw))
    ref = RefEngine(ref_cfg, ref_params, slots=2, max_len=96, block=4,
                    spec=RefSpec(drafter=_RefWrongDrafter(), **kw))
    got = port.run(_requests(GenRequest))
    _same(got, ref.run(_requests(RefRequest)))
    assert all(r.tokens == reference[r.rid] for r in got)
    _same_stats(port, ref)
    assert port.stats["breaker_trips"] >= 1 and port.stats["spec_rounds"] >= 2
    assert port.breaker["state"] == "open"


# --------------------------------------------------------------------------
# combined chaos (the acceptance criterion)
# --------------------------------------------------------------------------


def test_combined_chaos_run(model, reference):
    """Drafter crash + NaN slot + expired deadline in ONE spec run:
    uninjected requests byte-identical to the fault-free run, the injected
    ones with the reference's statuses, nothing raises."""
    faults = [("drafter.propose", 0, None), ("engine.nan_state", 2, 1, 1)]
    port, ref = _engines(model, faults=faults,
                         spec=dict(k=3, drafter="ngram"))
    outs = []
    for eng, make in ((port, GenRequest), (ref, RefRequest)):
        reqs = _requests(make)
        reqs[0] = dataclasses.replace(reqs[0], deadline_s=0.0)
        outs.append(eng.run(reqs))
    _same(*outs)
    got = outs[0]
    assert got[0].status == "timeout" and got[0].tokens == []
    assert sorted(r.status for r in got).count("error") == 1
    for r in got:
        if r.status == "ok":
            assert r.tokens == reference[r.rid], r.rid
    assert len([r for r in got if r.status == "ok"]) == 2
    _same_stats(port, ref)
    assert port.stats["quarantined"] == 1 and port.stats["breaker_trips"] >= 1
