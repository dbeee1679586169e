"""Reduced hla-1b with the rest of the HLA family (``--mixer hla3``,
``hla3_paper``, ``linattn``) and with ``HLAConfig.impl = "scan"``, the port
against the reference with the reference's own weights
(``from_jax_params``): prefill and decode logits and states (leaf for leaf,
``HLA3ExactState`` nested), the loss and every gradient, greedy ``Engine``
streams, and a speculative rollback and a prefix-cache hit against their
plain streams.

Tolerance: fp32 on both sides, ``TOL = 1e-4`` relative to max|want| (as
``tests/test_torch_model.py``).
"""

import dataclasses
import functools

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
from repro_torch.configs import get_config
from repro_torch.kernels.ops import LAUNCHES
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params, leaf_paths, tree_map
from repro_torch.models.state_tree import leaves
from repro_torch.serving import PrefixCache, state_bytes_for
from repro_torch.serving.engine import Engine, GenRequest
from repro_torch.serving.spec import Drafter, SpecConfig

TOL = 1e-4
MIXERS = ("hla3", "hla3_paper", "linattn")


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's reduced hla-1b weights and their port copy: every
    HLA record has the same parameter layout, so one set serves all."""
    ref_cfg = ref_get_config("hla-1b", reduced=True)
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    params = from_jax_params(jax.device_get(ref_params),
                             lm.lm_specs(get_config("hla-1b", reduced=True)),
                             device="cpu")
    return ref_params, params


def _model(mixer, impl="chunkwise"):
    """(ref_cfg, ref_params, cfg, params) for reduced hla-1b."""
    ref_cfg = ref_get_config("hla-1b", reduced=True).replace(mixer=mixer)
    ref_cfg = ref_cfg.replace(hla=dataclasses.replace(ref_cfg.hla, impl=impl))
    cfg = get_config("hla-1b", reduced=True, mixer=mixer)
    cfg = cfg.replace(hla=dataclasses.replace(cfg.hla, impl=impl))
    ref_params, params = _weights()
    return ref_cfg, ref_params, cfg, params


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _same_states(st, ref_st):
    ref = jax.tree.leaves(ref_st)
    assert type(st).__name__ == type(ref_st).__name__
    assert len(leaves(st)) == len(ref)
    for a, b in zip(leaves(st), ref):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("mixer", MIXERS)
def test_prefill_and_decode_match_reference(rng, mixer):
    """prefill (ragged against the chunk) then two decode steps: logits and
    every state leaf; decode updates the port's states in place."""
    ref_cfg, ref_params, cfg, params = _model(mixer)
    n = 19
    toks = rng.randint(0, cfg.vocab, (2, n + 2))
    want, st_ref = ref_lm.lm_prefill(ref_params, jnp.asarray(toks[:, :n]),
                                     ref_cfg)
    got, st = lm.lm_prefill(params, torch.from_numpy(toks[:, :n]), cfg)
    assert _rel(got, want) <= TOL
    _same_states(st, st_ref)
    for t in range(n, n + 2):
        want, st_ref, _ = ref_lm.lm_apply(
            ref_params, jnp.asarray(toks[:, t:t + 1]), ref_cfg,
            states=st_ref, positions=jnp.full((2, 1), t), mode="decode")
        got, st2, _ = lm.lm_apply(params, torch.from_numpy(toks[:, t:t + 1]),
                                  cfg, states=st, mode="decode")
        assert st2 is st
        assert _rel(got, want) <= TOL
    _same_states(st, st_ref)


@pytest.mark.parametrize("mixer", MIXERS)
def test_loss_and_grads_match_reference(rng, mixer):
    """``hla3_paper`` runs at gamma = 1, so its ``decay_a`` gets a zero
    gradient on both sides."""
    ref_cfg, ref_params, cfg, params = _model(mixer)
    toks = rng.randint(0, cfg.vocab, (2, 40))
    labels = rng.randint(0, cfg.vocab, (2, 40))
    labels[0, :5] = -1

    def ref_loss(p):
        return ref_lm.lm_loss(p, jnp.asarray(toks), jnp.asarray(labels),
                              ref_cfg)

    (want, _), ref_grads = jax.value_and_grad(ref_loss, has_aux=True)(
        ref_params)
    tree = tree_map(lambda x: x.clone().requires_grad_(True), params)
    live = dict(leaf_paths(tree))
    loss, _ = lm.lm_loss(tree, torch.from_numpy(toks),
                         torch.from_numpy(labels), cfg)
    assert _rel(loss, want) <= TOL
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    want_g = {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
              for p, v in jax.tree_util.tree_leaves_with_path(ref_grads)}
    assert set(live) == set(want_g)
    for path, g in zip(live, grads):
        if g is None:  # a leaf the loss does not reach
            assert mixer == "hla3_paper" and path[-1] == "decay_a"
            assert not want_g[path].any()
            continue
        assert _rel(g, want_g[path]) <= TOL, path


def _requests(make, cfg, max_new=(3, 6, 6), seed=0):
    """Three 9-token prompts (one prefill shape for the reference to
    compile); the first finishes early, so the third is admitted while the
    second decodes."""
    rng = np.random.RandomState(seed)
    return [make(rid=i, prompt=rng.randint(2, cfg.vocab, 9), max_new=m)
            for i, m in enumerate(max_new)]


def _engine(cfg, params, **kw):
    kw = {"slots": 2, "max_len": 64, "block": 4, "seed": 0, **kw}
    return Engine(cfg, params, device="cpu", **kw)


@pytest.mark.parametrize("mixer", MIXERS)
def test_engine_streams_match_reference(mixer):
    """Greedy continuous batching equals the reference engine token for
    token, and launches none of the hand-written kernels' plain versions'
    counters (the plain records run no kernel)."""
    ref_cfg, ref_params, cfg, params = _model(mixer)
    want = RefEngine(ref_cfg, ref_params, slots=2, max_len=64, block=4,
                     seed=0).run(_requests(RefRequest, cfg))
    before = dict(LAUNCHES)
    got = _engine(cfg, params).run(_requests(GenRequest, cfg))
    assert [r.status for r in got] == ["ok"] * 3
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert dict(LAUNCHES) == before


class _WrongDrafter(Drafter):
    """Always proposes token 1: every round rolls back."""

    def admit(self, slot, tokens):
        pass

    def commit(self, slot, tokens):
        pass

    def propose(self, slot_ids, k):
        return np.ones((len(slot_ids), k), np.int64), None


@pytest.mark.parametrize("mixer", MIXERS)
def test_spec_rollback_and_cache_hit_equal_plain(rng, mixer):
    """Speculative greedy with an always-wrong drafter (every round rolls
    the state back, nested for hla3) and a prefix-cache hit both give the
    plain streams; a cache entry holds ``state_bytes_for(cfg)`` bytes."""
    _, _, cfg, params = _model(mixer)
    plain = _engine(cfg, params).run(_requests(GenRequest, cfg))
    spec = _engine(cfg, params, spec=SpecConfig(
        k=3, drafter=_WrongDrafter(), breaker_zero_rounds=10**6))
    got = spec.run(_requests(GenRequest, cfg))
    assert [r.tokens for r in got] == [r.tokens for r in plain]
    assert spec.stats["spec_replays"] == spec.stats["spec_rounds"] > 0

    prefix = rng.randint(2, cfg.vocab, 12)
    prompts = [np.concatenate([prefix, rng.randint(2, cfg.vocab, n)])
               for n in (1, 5)]

    def reqs():
        return [GenRequest(rid=i, prompt=p, max_new=5)
                for i, p in enumerate(prompts)]

    cold = _engine(cfg, params, slots=1).run(reqs())
    cache = PrefixCache(granularity=4, budget_bytes=1 << 26)
    warm = _engine(cfg, params, slots=1, cache=cache)
    assert [r.tokens for r in warm.run(reqs())] == [r.tokens for r in cold]
    hits = {e["rid"]: e["cached_prefix"]
            for e in warm.obs.events("request.admitted")}
    assert hits == {0: 0, 1: 12}
    stats = cache.stats()
    assert stats["bytes"] == stats["entries"] * state_bytes_for(cfg)


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_impl_scan_matches_reference(rng, mixer):
    """``HLAConfig.impl = "scan"``: prefill logits and states through the
    token-level scan equal the reference's scan, prefill and train logits
    equal the port's chunkwise path, and decode after a scan prefill equals
    the reference's."""
    ref_cfg, ref_params, cfg, params = _model(mixer, impl="scan")
    _, _, chunk_cfg, _ = _model(mixer)
    toks = rng.randint(0, cfg.vocab, (2, 14))
    want, st_ref = ref_lm.lm_prefill(ref_params, jnp.asarray(toks[:, :13]),
                                     ref_cfg)
    got, st = lm.lm_prefill(params, torch.from_numpy(toks[:, :13]), cfg)
    assert _rel(got, want) <= TOL
    _same_states(st, st_ref)
    chunked, _ = lm.lm_prefill(params, torch.from_numpy(toks[:, :13]),
                               chunk_cfg)
    assert _rel(got, chunked) <= TOL
    want, _, _ = ref_lm.lm_apply(ref_params, jnp.asarray(toks[:, 13:]),
                                 ref_cfg, states=st_ref,
                                 positions=jnp.full((2, 1), 13),
                                 mode="decode")
    got, _, _ = lm.lm_apply(params, torch.from_numpy(toks[:, 13:]), cfg,
                            states=st, mode="decode")
    assert _rel(got, want) <= TOL
    got, _, _ = lm.lm_apply(params, torch.from_numpy(toks), cfg)
    chunked, _, _ = lm.lm_apply(params, torch.from_numpy(toks), chunk_cfg)
    assert _rel(got, chunked) <= TOL


def test_contracts_hold_for_the_nested_hla3_state():
    """The entry points' run-time contracts (``analysis/contracts.py``)
    hold for a plain record with a nested state: one host transfer per
    admission, block and accepting round, two per rejecting round, none
    per train step; every donated leaf (7 of ``HLA3ExactState`` + tokens)
    keeps its storage; no fp64 op; no kernel."""
    from repro_torch.analysis import contracts

    reports = contracts.check_entry_points(contracts.default_config("hla3"),
                                           device="cpu")
    for r in reports:
        assert r.ok, (r.name, r.violations)
        assert r.kept == r.donated and r.launches == {}
    assert [r.syncs for r in reports] == [1, 1, 1, 2, 0]
    assert [r.donated for r in reports] == [0, 8, 8, 8, 42]
