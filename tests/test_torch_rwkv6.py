"""RWKV-6 (``repro_torch/models/rwkv6.py``), the port against the reference
(``repro/models/rwkv6.py``) with the reference's weights
(``from_jax_params``) on the same numpy inputs:

* ``rwkv6_time_mix``, ``rwkv6_channel_mix`` and ``rwkv6_layer_apply``,
  from zero and resumed from a state (every state leaf too), over a ragged
  length (a padded tail chunk); the layer token by token (the record's
  step, in place) equals it;
* reduced ``rwkv6-7b``: the loss and every gradient leaf;
* the twins of ``tests/test_spec_decode.py::test_spec_greedy_exact_rwkv6``
  (speculative greedy equals plain greedy on reduced rwkv6-7b, fp32
  activations) and of
  ``tests/test_serving_frontend.py::test_cached_prefix_decode_exact[rwkv6]``
  (cache-hit decode equals cold decode, token for token).

Tolerance: fp32 on both sides, 1e-4 relative to max|want|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models import rwkv6 as ref_rwkv6
from repro.models.param import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.distributed.steps import accumulate_grads
from repro_torch.models import lm, rwkv6, seq_op
from repro_torch.models.param import from_jax_params, leaf_paths
from repro_torch.serving import Engine, GenRequest, PrefixCache
from repro_torch.serving.spec import SpecConfig

TOL = 1e-4


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_constants_match_reference():
    assert (rwkv6.LOGW_MIN, rwkv6.RWKV_CHUNK) == (ref_rwkv6.LOGW_MIN,
                                                  ref_rwkv6.RWKV_CHUNK)


@functools.lru_cache(maxsize=None)
def _layer():
    """Reduced rwkv6-7b's layer, with the mix ratios, decay base, bonus,
    GroupNorm and LayerNorm leaves drawn at random (the reference's init
    makes them constants), so every term is exercised."""
    ref_cfg = ref_get_config("rwkv6-7b", reduced=True)
    cfg = get_config("rwkv6-7b", reduced=True)
    tree = jax.device_get(ref_init_params(ref_rwkv6.rwkv6_specs(ref_cfg),
                                          jax.random.key(0)))
    rs = np.random.RandomState(11)
    for sub, key in (("tm", "mu_r"), ("tm", "mu_k"), ("tm", "mu_v"),
                     ("tm", "mu_g"), ("tm", "mu_w"), ("cm", "mu_k"),
                     ("cm", "mu_r")):
        tree[sub][key] = rs.uniform(0, 1, tree[sub][key].shape).astype(
            np.float32)
    tree["tm"]["w0"] = rs.uniform(-3, 0, tree["tm"]["w0"].shape).astype(
        np.float32)
    for sub, key in (("tm", "gn_scale"), ("tm", "gn_bias"), ("ln1", "scale"),
                     ("ln1", "bias"), ("ln2", "scale"), ("ln2", "bias")):
        tree[sub][key] = (rs.randn(*tree[sub][key].shape) * 0.3 + (
            1.0 if key.endswith("scale") else 0.0)).astype(np.float32)
    ref_p = jax.tree.map(jnp.asarray, tree)
    return ref_cfg, ref_p, cfg, from_jax_params(
        tree, rwkv6.rwkv6_specs(cfg), device="cpu")


def _x(seed, B=2, n=45, d=64):
    return np.random.RandomState(seed).randn(B, n, d).astype(np.float32) * 0.5


def _state(seed, cfg, B=2):
    rs = np.random.RandomState(seed)
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    return [rs.randn(B, 1, d).astype(np.float32) * 0.5,
            rs.randn(B, 1, d).astype(np.float32) * 0.5,
            rs.randn(B, d // dh, dh, dh).astype(np.float32) * 0.3]


def _states(seed, cfg, resume):
    if not resume:
        return None, None
    arrs = _state(seed, cfg)
    return (ref_rwkv6.RWKVState(*map(jnp.asarray, arrs)),
            rwkv6.RWKVState(*map(torch.from_numpy, arrs)))


@pytest.mark.parametrize("resume", [False, True], ids=["zero", "state"])
def test_time_and_channel_mix_match_reference(resume):
    ref_cfg, ref_p, cfg, p = _layer()
    ref_st, st = _states(1, cfg, resume)
    x = _x(0)
    want, want_st = ref_rwkv6.rwkv6_time_mix(ref_p["tm"], jnp.asarray(x),
                                             ref_cfg, ref_st)
    got, got_st = rwkv6.rwkv6_time_mix(p["tm"], torch.from_numpy(x), cfg, st)
    assert _rel(got, want) <= TOL
    for a, b in zip(got_st, want_st):
        assert _rel(a, b) <= TOL
    want, want_prev = ref_rwkv6.rwkv6_channel_mix(ref_p["cm"], jnp.asarray(x),
                                                  ref_cfg, ref_st)
    got, got_prev = rwkv6.rwkv6_channel_mix(p["cm"], torch.from_numpy(x), cfg,
                                            st)
    assert _rel(got, want) <= TOL and _rel(got_prev, want_prev) <= TOL


@pytest.mark.parametrize("resume", [False, True], ids=["zero", "state"])
def test_layer_apply_matches_reference(resume):
    """The whole layer from zero or from a state (which stays as it was),
    and the record token by token from the same start (in place)."""
    ref_cfg, ref_p, cfg, p = _layer()
    ref_st, st = _states(2, cfg, resume)
    x = _x(3)
    want, want_st = ref_rwkv6.rwkv6_layer_apply(ref_p, jnp.asarray(x),
                                                ref_cfg, ref_st)
    kept = None if st is None else [t.clone() for t in st]
    got, got_st = rwkv6.rwkv6_layer_apply(p, torch.from_numpy(x), cfg, st)
    assert _rel(got, want) <= TOL
    for a, b in zip(got_st, want_st):
        assert _rel(a, b) <= TOL
    if st is not None:
        assert all(torch.equal(a, b) for a, b in zip(st, kept))
    op = seq_op.get_op("rwkv6")
    run = st if st is not None else op.init_state(cfg, 2, "cpu")
    pieces = []
    for t in range(x.shape[1]):
        yt, st2 = op.step(p, torch.from_numpy(x[:, t:t + 1]), run, cfg)
        assert st2 is run
        pieces.append(yt)
    assert _rel(torch.cat(pieces, 1), want) <= TOL
    for a, b in zip(run, want_st):
        assert _rel(a, b) <= TOL


@functools.lru_cache(maxsize=None)
def _model():
    ref_cfg = ref_get_config("rwkv6-7b", reduced=True)
    cfg = get_config("rwkv6-7b", reduced=True)
    tree = jax.device_get(ref_init_params(ref_lm.lm_specs(ref_cfg),
                                          jax.random.key(0)))
    return (ref_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            from_jax_params(tree, lm.lm_specs(cfg), device="cpu"))


def test_lm_loss_and_grads_match_reference():
    ref_cfg, ref_params, cfg, params = _model()
    rs = np.random.RandomState(3)
    toks = rs.randint(1, cfg.vocab, (2, 40))
    labels = rs.randint(1, cfg.vocab, (2, 40))
    labels[1, :5] = -1
    (want, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.lm_loss(p, jnp.asarray(toks), jnp.asarray(labels),
                                 ref_cfg), has_aux=True))(ref_params)
    loss, _, aux, grads = accumulate_grads(
        params, {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labels)}, cfg)
    assert _rel(loss, want) <= TOL and float(aux) == 0.0
    want_g = dict(leaf_paths(jax.device_get(ref_grads)))
    got_g = dict(leaf_paths(grads))
    assert set(got_g) == set(want_g)
    assert ("layers", "tm", "u") in got_g and ("layers", "ln1", "bias") in \
        got_g
    for path, g in got_g.items():
        assert _rel(g, want_g[path]) <= TOL, "/".join(path)


def _requests(cfg, rs, lens=(5, 11, 7), max_new=8):
    return [GenRequest(rid=i, prompt=rs.randint(2, cfg.vocab, n),
                       max_new=max_new) for i, n in enumerate(lens)]


def test_spec_greedy_exact_rwkv6():
    """Reduced rwkv6-7b (fp32 activations, whose token-shift leaves take
    the activation dtype): speculative greedy equals plain greedy."""
    _, _, cfg, params = _model()
    plain = Engine(cfg, params, slots=2, max_len=96, block=4,
                   device="cpu").run(_requests(cfg,
                                               np.random.RandomState(6)))
    eng = Engine(cfg, params, slots=2, max_len=96, block=4, device="cpu",
                 spec=SpecConfig(k=3, drafter="ngram"))
    got = eng.run(_requests(cfg, np.random.RandomState(6)))
    assert [r.tokens for r in got] == [r.tokens for r in plain]
    assert eng.stats["spec_rounds"] > 0


def test_cached_prefix_decode_exact_rwkv6():
    """hla-1b with ``rwkv6`` (as the reference's parametrisation): a
    cache-hit decode equals a cold one, token for token, across ragged
    prefix lengths and boundary / mid-chunk splits."""
    cfg = get_config("hla-1b", reduced=True, mixer="rwkv6")
    ref_cfg = ref_get_config("hla-1b", reduced=True, mixer="rwkv6")
    tree = jax.device_get(ref_init_params(ref_lm.lm_specs(ref_cfg),
                                          jax.random.key(0)))
    params = from_jax_params(tree, lm.lm_specs(cfg), device="cpu")
    rng = np.random.RandomState(0)
    prefix = rng.randint(2, cfg.vocab, 12)
    ps = [np.concatenate([prefix, rng.randint(2, cfg.vocab, s)])
          for s in (1, 2, 4, 9)] + [rng.randint(2, cfg.vocab, 3)]

    def reqs():
        return [GenRequest(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(ps)]

    cold = Engine(cfg, params, slots=1, max_len=64, block=4, seed=0,
                  device="cpu").run(reqs())
    cache = PrefixCache(granularity=4, budget_bytes=1 << 26)
    warm = Engine(cfg, params, slots=1, max_len=64, block=4, seed=0,
                  device="cpu", cache=cache)
    got = warm.run(reqs())
    for r_cold, r_got in zip(cold, got):
        assert r_got.status == "ok"
        assert r_got.tokens == r_cold.tokens, r_got.rid
    assert cache.stats()["hits"] > 0
