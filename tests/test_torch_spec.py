"""The port's speculative decoding (``repro_torch.serving.spec``) against the
reference's and against the port's own plain decode, on the CPU.

Configs are the reference tests' tiny ``_cfg`` (1 layer, d_model 32, 2
heads, vocab 64; fp32), with the reference's weights carried across by
``from_jax_params``.  Tolerances:

* greedy streams, accept counts and rollback states: exact (token for
  token, bit for bit);
* ``probs``: 1e-6 absolute (fp32 softmax on both sides);
* ``lm_score_block``: fp64 activations on both sides, 1e-6 relative to the
  largest value: both packages still take the RMS norms and the per-head
  output norm in fp32, which bounds their agreement near fp32's 6e-8;
* the speculative-sampling law: a chi-square test of the first committed
  token's frequencies against p at level 1e-3 (seeded, so deterministic).
"""

import collections
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro.serving import Engine as RefEngine
from repro.serving import GenRequest as RefRequest
from repro.serving import SamplingConfig as RefSampling
from repro.serving import SpecConfig as RefSpec
from repro.serving.sampling import probs as ref_probs
from repro.serving.spec import HLADrafter as RefHLADrafter
from repro.serving.spec import NGramDrafter as RefNGram
from repro.serving.spec.drafters import Drafter as RefDrafter
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import lm, seq_op
from repro_torch.models.param import from_jax_params
from repro_torch.serving.engine import Engine, GenRequest
from repro_torch.serving.sampling import SamplingConfig, probs
from repro_torch.serving.spec import (
    Drafter, HLADrafter, NGramDrafter, SpecConfig, make_spec_round,
    make_verify)
from repro_torch.serving.state_pool import StatePool


def _cfgs(mixer="hla2", decay="learned", normalize=False, vocab=64):
    """The reference tests' ``_cfg`` and its port twin."""
    tiny = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                vocab=vocab)
    ref = ref_get_config("hla-1b", reduced=True).replace(mixer=mixer)
    ref = ref.replace(**tiny, hla=dataclasses.replace(
        ref.hla, decay=decay, normalize=normalize, chunk=16))
    cfg = get_config("hla-1b", reduced=True, mixer=mixer)
    cfg = cfg.replace(**tiny, hla=dataclasses.replace(
        cfg.hla, decay=decay, normalize=normalize))
    return ref, cfg


def _weights(ref_cfg, cfg, seed=0):
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg),
                                 jax.random.key(seed))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    return ref_params, params


def _requests(make, seed, lens=(5, 11, 7), max_new=10, vocab=64):
    rng = np.random.RandomState(seed)
    return [make(rid=i, prompt=rng.randint(2, vocab, n), max_new=max_new)
            for i, n in enumerate(lens)]


def _engine(cfg, params, spec=None, **kw):
    return Engine(cfg, params, slots=2, max_len=96, block=4, device="cpu",
                  spec=spec, **kw)


def _ref_engine(ref_cfg, ref_params, spec=None):
    return RefEngine(ref_cfg, ref_params, slots=2, max_len=96, block=4,
                     spec=spec)


def _tokens(results):
    return [r.tokens for r in results]


SPEC_STATS = ("spec_rounds", "spec_drafted", "spec_accepted", "spec_replays",
              "breaker_trips")


class _WrongDrafter(Drafter):
    """Always proposes token 1: near-certain rejections."""

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
# sampling.probs
# --------------------------------------------------------------------------


LAWS = [SamplingConfig(),
        SamplingConfig(method="temperature", temperature=0.7),
        SamplingConfig(method="top_k", top_k=3, temperature=1.3),
        SamplingConfig(method="top_p", top_p=0.6)]


@pytest.mark.parametrize("scfg", LAWS, ids=lambda c: c.method)
def test_probs_match_reference(rng, scfg):
    logits = rng.randn(3, 5, 32).astype(np.float32) * 2
    want = ref_probs(jnp.asarray(logits), RefSampling(
        method=scfg.method, temperature=scfg.temperature, top_k=scfg.top_k,
        top_p=scfg.top_p))
    got = probs(torch.from_numpy(logits), scfg)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# --------------------------------------------------------------------------
# lm_score_block
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_lm_score_block_matches_reference(rng, mixer):
    """Logits of every position and the new states, resumed from prefill
    states, in fp64; the states passed in are left as they were (the
    chunk kernels read their carry, and AHLA's R is a new tensor)."""
    ref_cfg, cfg = _cfgs(mixer)
    ref_cfg, cfg = ref_cfg.replace(dtype="float64"), cfg.replace(
        dtype="float64")
    ref_params, params = _weights(ref_cfg, cfg, seed=3)
    toks = rng.randint(0, cfg.vocab, (2, 14))
    _, ref_st = ref_lm.lm_prefill(ref_params, jnp.asarray(toks[:, :9]),
                                  ref_cfg)
    want, ref_new = ref_lm.lm_score_block(
        ref_params, jnp.asarray(toks[:, 9:]), ref_cfg, states=ref_st,
        positions=jnp.asarray(np.arange(9, 14)[None].repeat(2, 0)))
    _, st = lm.lm_prefill(params, torch.from_numpy(toks[:, :9]), cfg)
    before = [x.clone() for x in st]
    got, new = lm.lm_score_block(params, torch.from_numpy(toks[:, 9:]), cfg,
                                 states=st)
    assert got.shape == (2, 5, cfg.vocab) and got.dtype == torch.float64

    def rel(a, b):
        b = np.asarray(b)
        return np.abs(np.asarray(a) - b).max() / np.abs(b).max()

    assert rel(got.numpy(), want) <= 1e-6
    for a, b in zip(new, ref_new):
        assert rel(a.numpy(), b) <= 1e-6
    assert all(torch.equal(a, b) for a, b in zip(st, before))
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(new, st))


# --------------------------------------------------------------------------
# StatePool snapshot / restore
# --------------------------------------------------------------------------


_Leaves = collections.namedtuple("_Leaves", "a b c")


def test_snapshot_restore_roundtrip_property():
    """For random pools and slots, restore(snapshot) after overwriting the
    slot gives the pool back exactly, and no other slot moves."""
    rng = np.random.RandomState(0)
    for _ in range(5):
        slots = int(rng.randint(1, 5))
        shapes = [tuple(int(n) for n in rng.randint(1, 4, rng.randint(0, 3)))
                  for _ in range(3)]

        def make(n, shapes=shapes):
            return _Leaves(*(torch.zeros((2, n) + s) for s in shapes))

        pool = StatePool(make, slots)
        pool.states = _Leaves(*(torch.from_numpy(rng.randn(*x.shape))
                                for x in pool.states))
        slot = int(rng.randint(slots))
        snap = pool.snapshot_slot(slot)
        before = [x.clone() for x in pool.states]
        garbage = tuple(torch.from_numpy(rng.randn(*x.shape))
                        for x in pool.empty_slot_state())
        pool.write_slot(slot, garbage)
        for s in range(slots):
            if s != slot:
                assert all(torch.equal(a[:, s], b[:, s])
                           for a, b in zip(pool.states, before))
        pool.restore_slot(slot, snap)
        assert all(torch.equal(a, b) for a, b in zip(pool.states, before))


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_snapshot_is_a_copy_that_survives_in_place_decode(rng, mixer):
    _, cfg = _cfgs(mixer)
    _, params = _weights(*_cfgs(mixer))
    pool = StatePool(lambda n: lm.lm_init_states(cfg, n, "cpu"), 2)
    for s in range(2):
        _, st = lm.lm_prefill(params, torch.from_numpy(
            rng.randint(0, cfg.vocab, (1, 7 + s))), cfg)
        pool.write_slot(s, st)
    snap = pool.snapshot_slot(1)
    kept = [x.clone() for x in snap]
    assert type(snap) is type(pool.states)
    lm.lm_apply(params, torch.tensor([[3], [4]]), cfg, states=pool.states,
                mode="decode")
    assert all(torch.equal(a, b) for a, b in zip(snap, kept))
    assert not torch.equal(pool.states[0][:, 1], snap[0][:, 0])
    pool.restore_slot(1, snap)
    assert all(torch.equal(a[:, 1], b[:, 0])
               for a, b in zip(pool.states, kept))


# --------------------------------------------------------------------------
# drafters
# --------------------------------------------------------------------------


def test_ngram_drafter_matches_reference():
    rng = np.random.RandomState(0)
    for trial in range(40):
        ctx = list(rng.randint(0, 6, rng.randint(1, 30)))
        k = int(rng.randint(1, 6))
        mx = int(rng.randint(1, 4))
        mn = int(rng.randint(1, mx + 1))
        ours, ref = NGramDrafter(mx, mn), RefNGram(mx, mn)
        ours.admit(0, ctx)
        ref.admit(0, ctx)
        for _ in range(3):
            got, q = ours.propose([0], k)
            want, _ = ref.propose([0], k)
            assert q is None
            assert got.tolist() == np.asarray(want).tolist(), (trial, ctx)
            step = list(rng.randint(0, 6, rng.randint(1, 4)))
            ours.commit(0, step)
            ref.commit(0, step)


def test_ngram_drafter_prompt_lookup():
    d = NGramDrafter(max_n=3, min_n=1)
    d.admit(0, [1, 2, 3, 4, 9, 1, 2, 3])
    assert d.propose([0], 3)[0].tolist() == [[4, 9, 1]]
    d.commit(0, [4, 9])
    assert d.propose([0], 4)[0].tolist() == [[1, 2, 3, 4]]
    d.admit(1, [7, 8])
    assert d.propose([1], 2)[0].tolist() == [[8, 8]]
    with pytest.raises(ValueError):
        NGramDrafter(max_n=1, min_n=2)


def test_hla_drafter_draft_steps_do_not_leak_into_its_pool(rng):
    """The k draft steps run on a copy: after ``propose`` the draft pool
    holds the caught-up committed context only, equal to a prefill of it."""
    _, cfg = _cfgs()
    drafter = HLADrafter(cfg, None, slots=2, k=3, seed=4, device="cpu")
    ctx = list(rng.randint(2, cfg.vocab, 8))
    drafter.admit(0, ctx)
    before = [x.clone() for x in drafter.pool.states]
    drafts, q = drafter.propose([0], 3)
    assert q is None and drafts.shape == (2, 3)
    assert all(torch.equal(a, b) for a, b in
               zip(drafter.pool.states, before))
    committed = [int(drafts[0, 0]), 5]
    drafter.commit(0, committed)
    drafter.propose([0], 3)
    assert drafter.stats == dict(admissions=1, steps=3 + 2 + 3)
    # the pool caught up over [ctx[-1], drafts[0, 0]]: it now holds the
    # state of the whole committed context but its newest token
    full = ctx + committed
    _, want = lm.lm_prefill(drafter.params, torch.tensor([full[:-1]]), cfg)
    for a, b in zip(drafter.pool.states, want):
        torch.testing.assert_close(a[:, :1], b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="built for k=3"):
        drafter.propose([0], 2)


# --------------------------------------------------------------------------
# greedy exactness
# --------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("decay", ["none", "learned"])
@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_spec_greedy_matches_plain_and_reference(mixer, decay, normalize):
    """n-gram drafter, k = 3, ragged prompts: the speculative streams equal
    the port's plain greedy streams and the reference's speculative engine
    token for token, and the rounds, accept counts, replays and breaker
    trips equal the reference's."""
    ref_cfg, cfg = _cfgs(mixer, decay, normalize)
    ref_params, params = _weights(ref_cfg, cfg)
    plain = _engine(cfg, params).run(_requests(GenRequest, 1))
    eng = _engine(cfg, params, SpecConfig(k=3, drafter="ngram"))
    got = eng.run(_requests(GenRequest, 1))
    ref = _ref_engine(ref_cfg, ref_params, RefSpec(k=3, drafter="ngram"))
    want = ref.run(_requests(RefRequest, 1))
    assert [r.status for r in got] == ["ok"] * 3
    assert _tokens(got) == _tokens(plain) == _tokens(want)
    assert eng.stats["spec_rounds"] > 0
    assert [eng.stats[k] for k in SPEC_STATS] == \
        [ref.stats[k] for k in SPEC_STATS]


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_spec_exact_under_constant_rejection(mixer):
    """Every round rolls back; the streams stay those of plain decode and
    of the reference's speculative engine under the same drafter."""
    ref_cfg, cfg = _cfgs(mixer)
    ref_params, params = _weights(ref_cfg, cfg)
    spec = dict(k=4, breaker_zero_rounds=10**6)
    plain = _engine(cfg, params).run(_requests(GenRequest, 2))
    eng = _engine(cfg, params, SpecConfig(drafter=_WrongDrafter(), **spec))
    got = eng.run(_requests(GenRequest, 2))
    ref = _ref_engine(ref_cfg, ref_params,
                      RefSpec(drafter=_RefWrongDrafter(), **spec))
    want = ref.run(_requests(RefRequest, 2))
    assert _tokens(got) == _tokens(plain) == _tokens(want)
    assert eng.stats["spec_replays"] > 0
    assert eng.stats["spec_replays"] == eng.stats["spec_rounds"]
    assert eng.stats["spec_accepted"] <= eng.stats["spec_drafted"] // 2
    assert eng.stats["breaker_trips"] == 0


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_spec_exact_with_random_hla_drafter(mixer):
    """A draft LM with its own random weights and pool leaves the streams
    as plain decode and the reference's engine with the same draft
    weights give them."""
    ref_cfg, cfg = _cfgs(mixer)
    ref_params, params = _weights(ref_cfg, cfg)
    ref_dcfg, dcfg = _cfgs("hla2")
    ref_dparams, dparams = _weights(ref_dcfg, dcfg, seed=9)
    plain = _engine(cfg, params).run(_requests(GenRequest, 3, max_new=8))
    # no zero-acceptance trips: every round drafts, so the drafter's work
    # is exact (3 admissions)
    spec = dict(k=3, breaker_zero_rounds=10**6)
    drafter = HLADrafter(dcfg, dparams, slots=2, k=3, device="cpu")
    eng = _engine(cfg, params, SpecConfig(drafter=drafter, **spec))
    got = eng.run(_requests(GenRequest, 3, max_new=8))
    ref_drafter = RefHLADrafter(ref_dcfg, ref_dparams, slots=2, max_len=96,
                                k=3)
    ref = _ref_engine(ref_cfg, ref_params,
                      RefSpec(drafter=ref_drafter, **spec))
    want = ref.run(_requests(RefRequest, 3, max_new=8))
    assert _tokens(got) == _tokens(plain) == _tokens(want)
    assert [eng.stats[k] for k in SPEC_STATS] == \
        [ref.stats[k] for k in SPEC_STATS]
    assert drafter.stats["admissions"] == 3


def test_self_draft_accepts_everything():
    """Drafting with the target's own weights: every draft is the target's
    argmax, so every round accepts its whole block and never rolls back."""
    ref_cfg, cfg = _cfgs()
    _, params = _weights(ref_cfg, cfg)
    plain = _engine(cfg, params).run(_requests(GenRequest, 3, max_new=8))
    drafter = HLADrafter(cfg, params, slots=2, k=3, device="cpu")
    eng = _engine(cfg, params, SpecConfig(k=3, drafter=drafter))
    got = eng.run(_requests(GenRequest, 3, max_new=8))
    assert _tokens(got) == _tokens(plain)
    assert eng.stats["spec_accepted"] == eng.stats["spec_drafted"] > 0
    assert eng.stats["spec_replays"] == eng.stats["spec_replay_steps"] == 0


def test_spec_continuous_batching_mid_admission(rng):
    """A slot admitted mid-stream does not change a live slot's stream."""
    _, cfg = _cfgs()
    _, params = _weights(*_cfgs())
    pa, pb = rng.randint(2, cfg.vocab, 6), rng.randint(2, cfg.vocab, 9)
    spec = SpecConfig(k=3, breaker_zero_rounds=10**6)
    (solo,) = _engine(cfg, params, spec).run(
        [GenRequest(rid=0, prompt=pa, max_new=12)])
    eng = _engine(cfg, params, spec)
    eng.admit(0, GenRequest(rid=0, prompt=pa, max_new=12))
    eng.step_block()
    eng.admit(1, GenRequest(rid=1, prompt=pb, max_new=8))
    while eng.active.any():
        eng.step_block()
    assert eng.results[0].tokens == solo.tokens
    assert len(eng.results[1].tokens) == 8


# --------------------------------------------------------------------------
# rollback over in-place decode state
# --------------------------------------------------------------------------


def _admitted_pool(cfg, params, prompts):
    pool = StatePool(lambda n: lm.lm_init_states(cfg, n, "cpu"),
                     len(prompts))
    last = []
    for s, p in enumerate(prompts):
        lg, st = lm.lm_prefill(params, torch.from_numpy(p[None]), cfg)
        pool.write_slot(s, st)
        last.append(int(lg.argmax()))
    return pool, torch.tensor(last)[:, None]


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_rollback_equals_plain_decode_bit_for_bit(rng, mixer):
    """A rejection round leaves every slot's state equal, bit for bit, to
    the port's plain decode steps over its committed prefix from the
    pre-verify state (run at the pool's batch, as plain decode runs); the
    verify pass alone leaves the pool untouched."""
    _, cfg = _cfgs(mixer)
    _, params = _weights(*_cfgs(mixer))
    k, slots = 4, 3
    prompts = [rng.randint(2, cfg.vocab, n) for n in (6, 9, 4)]
    pool, tokens = _admitted_pool(cfg, params, prompts)
    pre = [x.clone() for x in pool.states]
    # slot 0 gets its own greedy continuation (accepts all k), the others
    # random drafts (reject early)
    drafts = torch.from_numpy(rng.randint(2, cfg.vocab, (slots, k)))
    own = type(pool.states)(*(x.clone() for x in pool.states))
    tok = tokens
    for j in range(k):
        lg, _, _ = lm.lm_apply(params, tok, cfg, states=own, mode="decode")
        tok = lg[:, -1].argmax(-1, keepdim=True)
        drafts[0, j] = tok[0, 0]
    tok_block = torch.cat([tokens, drafts], 1)

    gen = torch.Generator().manual_seed(0)
    packed, _ = make_verify(cfg, SamplingConfig())(params, pool.states,
                                                   tok_block, gen)
    assert all(torch.equal(a, b) for a, b in zip(pool.states, pre))

    active = np.array([True, True, True])
    round_fn = make_spec_round(cfg, SamplingConfig())
    packed_h, finite, new_tokens, steps = round_fn(
        params, pool, tokens, active, drafts, gen)
    assert np.array_equal(packed_h, packed.numpy())
    n_comm = packed_h[:, 0] + 1
    assert n_comm[0] == k + 1 and (n_comm[1:] < k + 1).all()
    assert steps == k + 1 and finite.all()
    assert new_tokens[:, 0].tolist() == [
        int(packed_h[s, n_comm[s]]) for s in range(slots)]
    for s in range(slots):
        oracle = type(pool.states)(*(x.clone() for x in pre))
        for j in range(n_comm[s]):
            lm.lm_apply(params, tok_block[:, j:j + 1], cfg, states=oracle,
                        mode="decode")
        for a, b in zip(pool.states, oracle):
            assert torch.equal(a[:, s], b[:, s]), (mixer, s)


def test_fully_accepted_round_keeps_verify_states(rng):
    """When every active slot accepts its block the pool becomes the
    verify pass's states (no replay), which equal plain decode within
    fp32 summation order."""
    _, cfg = _cfgs()
    _, params = _weights(*_cfgs())
    pool, tokens = _admitted_pool(
        cfg, params, [rng.randint(2, cfg.vocab, n) for n in (5, 8)])
    oracle = type(pool.states)(*(x.clone() for x in pool.states))
    tok, drafts = tokens, []
    for _ in range(3):
        lg, _, _ = lm.lm_apply(params, tok, cfg, states=oracle, mode="decode")
        tok = lg[:, -1].argmax(-1, keepdim=True)
        drafts.append(tok)
    lm.lm_apply(params, tok, cfg, states=oracle, mode="decode")
    packed, finite, _, steps = make_spec_round(cfg, SamplingConfig())(
        params, pool, tokens, np.array([True, True]), torch.cat(drafts, 1),
        torch.Generator())
    assert (packed[:, 0] == 3).all() and steps == 0 and finite.all()
    for a, b in zip(pool.states, oracle):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# speculative sampling law
# --------------------------------------------------------------------------


@pytest.mark.parametrize("with_q", [False, True])
def test_speculative_sampling_preserves_the_target_law(with_q):
    """The first committed token of a round is distributed as the target's
    warped law p at that position, whether the drafter is deterministic (q
    one-hot) or draws its drafts from a given q.  4000 rows with the same
    context and state make 4000 independent rounds in one verify call."""
    _, cfg = _cfgs(vocab=8)
    _, params = _weights(*_cfgs(vocab=8), seed=5)
    scfg = SamplingConfig(method="temperature", temperature=3.0)
    rows, k = 4000, 3
    _, st = lm.lm_prefill(params, torch.tensor([[1, 5, 2, 7, 3]]), cfg)
    states = type(st)(*(x.expand((-1, rows) + x.shape[2:]).contiguous()
                        for x in st))
    gen = torch.Generator().manual_seed(1)
    last = torch.full((rows, 1), 4)
    if with_q:
        q = torch.distributions.Dirichlet(torch.ones(8)).sample((k,))
        q = q[None].expand(rows, -1, -1)
        drafts = torch.multinomial(q.reshape(-1, 8), 1, generator=gen)
        drafts = drafts.reshape(rows, k)
    else:
        q, drafts = None, torch.full((rows, k), 6)
    verify = make_verify(cfg, scfg, draft_probs=with_q)
    packed, _ = verify(params, states, torch.cat([last, drafts], 1), gen, q)
    logits, _, _ = lm.lm_apply(params, last[:1], cfg, states=st, mode="prefill")
    p = probs(logits[0, 0], scfg).double()
    counts = torch.bincount(packed[:, 1], minlength=8).double()
    chi2 = float(((counts - rows * p) ** 2 / (rows * p)).sum())
    assert chi2 <= sps.chi2.ppf(1 - 1e-3, df=7), (chi2, counts, rows * p)
    assert 0 < int((packed[:, 0] > 0).sum()) < rows  # both paths taken


# --------------------------------------------------------------------------
# breaker and failure domains
# --------------------------------------------------------------------------


class _RaisingDrafter(NGramDrafter):
    def propose(self, slot_ids, k):
        raise RuntimeError("drafter down")


def test_raising_drafter_trips_the_breaker_and_streams_stay_exact():
    _, cfg = _cfgs()
    _, params = _weights(*_cfgs())
    plain = _engine(cfg, params).run(_requests(GenRequest, 4))
    eng = _engine(cfg, params, SpecConfig(k=3, drafter=_RaisingDrafter(),
                                          breaker_cooldown_blocks=1))
    got = eng.run(_requests(GenRequest, 4))
    assert _tokens(got) == _tokens(plain)
    assert [r.status for r in got] == ["ok"] * 3
    # each half-open probe fails again: one trip per cooldown cycle
    assert eng.stats["breaker_trips"] >= 2
    assert eng.stats["spec_rounds"] == 0 and eng.stats["decode_steps"] > 0
    assert "drafter crashed" in eng.breaker["reason"]
    eng.reset_breaker()
    assert eng.breaker["state"] == "closed"


def test_exception_in_verify_propagates(rng, monkeypatch):
    """Only the drafter's calls are guarded: a failure of the target's
    verify pass is not turned into a breaker trip."""
    _, cfg = _cfgs()
    _, params = _weights(*_cfgs())
    eng = _engine(cfg, params, SpecConfig(k=3))
    eng.admit(0, GenRequest(rid=0, prompt=rng.randint(2, cfg.vocab, 5),
                            max_new=10))

    def broken(*a, **kw):
        raise RuntimeError("verify kernel failed")

    monkeypatch.setattr(lm, "lm_score_block", broken)
    with pytest.raises(RuntimeError, match="verify kernel failed"):
        eng.step_block()
    assert eng.stats["breaker_trips"] == 0
    assert eng.breaker["state"] == "closed"


def test_engine_refuses_bad_spec_setups():
    _, cfg = _cfgs()
    _, params = _weights(*_cfgs())
    other = HLADrafter(cfg.replace(vocab=32), None, slots=2, k=3,
                       device="cpu")
    with pytest.raises(ValueError, match="drafter vocab 32"):
        _engine(cfg, params, SpecConfig(k=3, drafter=other))
    with pytest.raises(ValueError, match="unknown drafter"):
        _engine(cfg, params, SpecConfig(drafter="oracle"))
    op = seq_op.op_for(cfg)
    assert op.streaming and op.spec_decodable
    monkey = dataclasses.replace(op, spec_decodable=False)
    seq_op._REGISTRY[cfg.mixer] = monkey
    try:
        with pytest.raises(ValueError, match="spec_decodable"):
            _engine(cfg, params, SpecConfig())
        _engine(cfg, params)  # plain serving still fine
    finally:
        seq_op._REGISTRY[cfg.mixer] = op


def test_lm_drafter_takes_the_target_vocab():
    """``"lm"`` builds reduced hla-1b with the target's vocabulary; this
    target (1 layer of 32) is smaller than it, so the draft warns."""
    _, cfg = _cfgs()
    _, params = _weights(*_cfgs())
    with pytest.warns(UserWarning, match="not smaller than the target"):
        eng = _engine(cfg, params, SpecConfig(k=2, drafter="lm"))
    assert isinstance(eng.drafter, HLADrafter)
    assert eng.drafter.cfg.vocab == cfg.vocab
    assert (eng.drafter.cfg.n_layers, eng.drafter.cfg.d_model) == (2, 64)


# --------------------------------------------------------------------------
# host transfers
# --------------------------------------------------------------------------


def _count_transfers(monkeypatch):
    calls = {"cpu": 0, "item": 0, "tolist": 0}
    for name in calls:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _n=name, _o=orig, **k):
            calls[_n] += 1
            return _o(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return calls


@pytest.mark.parametrize("accepted", [True, False])
def test_host_transfers_per_round(rng, monkeypatch, accepted):
    """A fully-accepted round moves its results to the host in ONE
    transfer, a rejection round in two (the replayed states' health)."""
    _, cfg = _cfgs()
    _, params = _weights(*_cfgs())
    drafter = HLADrafter(cfg, params, slots=2, k=3, device="cpu") \
        if accepted else _WrongDrafter()
    eng = _engine(cfg, params, SpecConfig(k=3, drafter=drafter))
    eng.admit(0, GenRequest(rid=0, prompt=rng.randint(2, cfg.vocab, 4),
                            max_new=20))
    calls = _count_transfers(monkeypatch)
    eng.step_block()
    assert eng.stats["spec_rounds"] == 1
    assert eng.stats["spec_replays"] == (0 if accepted else 1)
    assert calls == {"cpu": 1 if accepted else 2, "item": 0, "tolist": 0}


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


@pytest.mark.filterwarnings("ignore:draft model")  # reduced vs reduced
@pytest.mark.parametrize("drafter", ["ngram", "lm"])
def test_serve_cli_spec_on_cpu(capsys, drafter):
    results = serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                          "--gen-len", "6", "--prompt-len", "9", "--spec",
                          drafter, "--spec-k", "3"])
    out = capsys.readouterr().out
    assert re.search(
        r"\[serve\] 3 requests, 18 generated tokens in [\d.]+s \| TTFT p50 "
        r"[\d.]+ms p99 [\d.]+ms \(queued p50 [\d.]+ms p99 [\d.]+ms\) \| "
        r"decode [\d.]+ tok/s \| prefill [\d.]+ tok/s", out), out
    assert re.search(r"\[serve\] spec: \d+ rounds, acceptance [\d.]+, \d+ "
                     r"rollbacks, [\d.]+ committed tok/round", out), out
    assert "statuses: ok=3" in out and "breaker_trips=" in out
    assert all(len(r.tokens) == 6 for r in results)
