"""The port's hla-1b stack vs the reference, reduced config, fp32, with the
reference's own weights carried across by ``from_jax_params``.

Tolerance: atol = rtol = 1e-4 — fp32 on both sides; the port's prefill
runs chunk width 64 where the reference runs the config's 128, and the
two sum the projections in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params, init_params, leaf_paths

TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    ref_cfg = ref_get_config("hla-1b", reduced=True)
    cfg = get_config("hla-1b", reduced=True)
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    ref_cfg = ref_get_config("hla-1b", reduced=reduced)
    cfg = get_config("hla-1b", reduced=reduced)
    for f in dataclasses.fields(cfg):
        if f.name == "hla":
            for hf in dataclasses.fields(cfg.hla):
                assert getattr(cfg.hla, hf.name) == getattr(ref_cfg.hla,
                                                            hf.name)
        else:
            assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    assert cfg.head_dim == ref_cfg.head_dim


def test_specs_match_reference():
    ref_cfg = ref_get_config("hla-1b")
    cfg = get_config("hla-1b")
    ref_specs = jax.tree.map(
        lambda s: s.shape, ref_lm.lm_specs(ref_cfg),
        is_leaf=lambda x: hasattr(x, "axes"))
    got = {p: s.shape for p, s in leaf_paths(lm.lm_specs(cfg))}
    want = {tuple(str(getattr(k, "key", k)) for k in p): tuple(v)
            for p, v in jax.tree_util.tree_leaves_with_path(
                ref_specs, is_leaf=lambda x: isinstance(x, tuple))}
    assert got == want


@pytest.mark.parametrize("n", [1, 9, 21])
def test_train_logits_match(model, rng, n):
    ref_cfg, ref_params, cfg, params = model
    toks = rng.randint(0, cfg.vocab, (2, n))
    want, _, _ = ref_lm.lm_apply(ref_params, jnp.asarray(toks), ref_cfg)
    got, st, _ = lm.lm_apply(params, torch.from_numpy(toks), cfg)
    assert st is None
    _close(got, want)


@pytest.mark.parametrize("n", [1, 13, 70])
def test_prefill_logits_and_states_match(model, rng, n):
    ref_cfg, ref_params, cfg, params = model
    toks = rng.randint(0, cfg.vocab, (2, n))
    want, st_ref = ref_lm.lm_prefill(ref_params, jnp.asarray(toks), ref_cfg)
    got, st = lm.lm_prefill(params, torch.from_numpy(toks), cfg)
    _close(got, want)
    for a, b in zip(st, st_ref):
        _close(a, b)


@pytest.mark.parametrize("n", [4, 17])
def test_prefill_then_decode_matches(model, rng, n):
    ref_cfg, ref_params, cfg, params = model
    toks = rng.randint(0, cfg.vocab, (2, n + 2))
    _, st_ref = ref_lm.lm_prefill(ref_params, jnp.asarray(toks[:, :n]),
                                  ref_cfg)
    _, st = lm.lm_prefill(params, torch.from_numpy(toks[:, :n]), cfg)
    for t in range(n, n + 2):
        want, st_ref, _ = ref_lm.lm_apply(
            ref_params, jnp.asarray(toks[:, t:t + 1]), ref_cfg,
            states=st_ref, positions=jnp.full((2, 1), t), mode="decode")
        got, st2, _ = lm.lm_apply(params, torch.from_numpy(toks[:, t:t + 1]),
                                  cfg, states=st, mode="decode")
        assert st2 is st  # decode updates the states in place
        _close(got, want)
    for a, b in zip(st, st_ref):
        _close(a, b)


def test_init_params_scheme_and_seeding():
    cfg = get_config("hla-1b", reduced=True)
    specs = lm.lm_specs(cfg)
    p0 = init_params(specs, 0, "cpu")
    p1 = init_params(specs, 0, "cpu")
    p2 = init_params(specs, 1, "cpu")
    for (path, s), (_, a), (_, b), (_, c) in zip(
            leaf_paths(specs), leaf_paths(p0), leaf_paths(p1),
            leaf_paths(p2)):
        assert tuple(a.shape) == s.shape and a.dtype == torch.float32
        assert torch.equal(a, b), path
        if s.init == "normal":
            fan_in = int(np.prod(s.shape[:-1]))
            assert a.abs().max() <= 2.0 / np.sqrt(fan_in) + 1e-6, path
            assert not torch.equal(a, c), path
    mix = p0["layers"]["mixer"]
    assert (mix["decay_a"] == 3.0).all() and (mix["out_scale"] == 1.0).all()
    emb = p0["embed"]["embedding"]
    assert abs(float(emb.std()) - 0.02) < 0.002


def test_from_jax_params_rejects_mismatched_trees(model):
    _, ref_params, cfg, _ = model
    tree = jax.device_get(ref_params)
    bad = dict(tree)
    del bad["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(bad, lm.lm_specs(cfg), device="cpu")
    wrong = lm.lm_specs(cfg.replace(vocab=cfg.vocab + 1))
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(tree, wrong, device="cpu")


def test_unknown_mixer_is_rejected():
    cfg = get_config("hla-1b", reduced=True).replace(mixer="softmx")
    with pytest.raises(KeyError, match="unknown sequence op"):
        lm.lm_specs(cfg)



VARIANTS = {
    "gqa": (dict(n_kv_heads=2), {}),
    "no_decay": ({}, dict(decay="none")),
    "fixed_decay": ({}, dict(decay="fixed", fixed_gamma=0.9)),
    "normalize_lam": ({}, dict(normalize=True, lam=0.2)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_config_variants_prefill_and_decode_match(rng, variant):
    """The mixer options hla-1b does not use (GQA repeat, decay none/fixed,
    ratio normalization + ridge) match the reference through the model."""
    top, hla = VARIANTS[variant]
    ref_cfg = ref_get_config("hla-1b", reduced=True)
    ref_cfg = ref_cfg.replace(hla=dataclasses.replace(ref_cfg.hla, **hla),
                              **top)
    cfg = get_config("hla-1b", reduced=True)
    cfg = cfg.replace(hla=dataclasses.replace(cfg.hla, **hla), **top)
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(1))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    toks = rng.randint(0, cfg.vocab, (2, 12))
    want, st_ref = ref_lm.lm_prefill(ref_params, jnp.asarray(toks[:, :11]),
                                     ref_cfg)
    got, st = lm.lm_prefill(params, torch.from_numpy(toks[:, :11]), cfg)
    _close(got, want)
    want, _, _ = ref_lm.lm_apply(
        ref_params, jnp.asarray(toks[:, 11:]), ref_cfg, states=st_ref,
        positions=jnp.full((2, 1), 11), mode="decode")
    got, _, _ = lm.lm_apply(params, torch.from_numpy(toks[:, 11:]), cfg,
                            states=st, mode="decode")
    _close(got, want)
