"""Gated linear attention (``repro_torch/models/gla.py``), the port against
the reference (``repro/models/gla.py``) on the same numpy inputs and, for
the record and the model, the reference's own weights
(``from_jax_params``):

* ``gla_chunkwise`` (ragged n, with and without a carry) and ``gla_step``;
* the ``gla`` record: forward, forward then per-token steps (in place),
  and forward resumed from a carry (the carry left as it was);
* reduced ``hla-1b --mixer gla``: the loss and every gradient leaf;
* the twins of ``tests/test_seq_op_registry.py``'s gla cells: it trains
  with finite gradients, the engine's streams equal a greedy loop of
  ``lm_prefill`` and decode steps, and speculative greedy equals plain
  greedy (no gla-specific code in ``lm.py``, ``serving/`` or
  ``distributed/``).

Tolerance: fp32 on both sides, 1e-4 relative to max|want| (the reference
registry test's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import gla as ref_gla
from repro.models import lm as ref_lm
from repro.models import seq_op as ref_seq_op
from repro.models.param import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.distributed.steps import accumulate_grads
from repro_torch.models import gla, lm, seq_op
from repro_torch.models.param import from_jax_params, leaf_paths
from repro_torch.serving.engine import Engine, GenRequest
from repro_torch.serving.spec import SpecConfig

TOL = 1e-4


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _qkva(seed, B=2, H=3, n=45, d=8):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, n, d).astype(np.float32) * 0.5
               for _ in range(3))
    log_a = np.clip(rs.randn(B, H, n, d).astype(np.float32) * 0.5 - 0.3,
                    gla.LOG_A_MIN, -1e-6)
    return q, k, v, log_a


def test_constants_match_reference():
    assert (gla.LOG_A_MIN, gla.GLA_CHUNK, gla.GATE_TAU) == (
        ref_gla.LOG_A_MIN, ref_gla.GLA_CHUNK, ref_gla.GATE_TAU)


@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carry"])
def test_chunkwise_matches_reference(carry):
    """A ragged n = 45 (a padded tail chunk), from zero or from a carry."""
    q, k, v, log_a = _qkva(0)
    S0 = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32) \
        if carry else None
    want_o, want_st = ref_gla.gla_chunkwise(
        *map(jnp.asarray, (q, k, v, log_a)),
        state=None if S0 is None else ref_gla.GLAState(S=jnp.asarray(S0)))
    st = None if S0 is None else gla.GLAState(S=torch.from_numpy(S0))
    o, new = gla.gla_chunkwise(*map(torch.from_numpy, (q, k, v, log_a)),
                               state=st)
    assert _rel(o, want_o) <= TOL and _rel(new.S, want_st.S) <= TOL
    if carry:
        assert torch.equal(st.S, torch.from_numpy(S0))  # only read


def test_step_matches_reference():
    q, k, v, log_a = (x[:, :, 0] for x in _qkva(2, n=1))
    S0 = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    want_st, want_o = ref_gla.gla_step(ref_gla.GLAState(S=jnp.asarray(S0)),
                                       *map(jnp.asarray, (q, k, v, log_a)))
    new, o = gla.gla_step(gla.GLAState(S=torch.from_numpy(S0)),
                          *map(torch.from_numpy, (q, k, v, log_a)))
    assert _rel(o, want_o) <= TOL and _rel(new.S, want_st.S) <= TOL


def _record():
    ref_cfg = ref_get_config("hla-1b", reduced=True).replace(mixer="gla")
    cfg = get_config("hla-1b", reduced=True, mixer="gla")
    ref_op, op = ref_seq_op.get_op("gla"), seq_op.get_op("gla")
    ref_p = ref_init_params(ref_op.specs(ref_cfg), jax.random.key(0))
    p = from_jax_params(jax.device_get(ref_p), op.specs(cfg), device="cpu")
    return ref_cfg, ref_op, ref_p, cfg, op, p


def _x(seed, B=2, n=40, d=64):
    return np.random.RandomState(seed).randn(B, n, d).astype(np.float32) * 0.5


def test_record_flags_and_state_match_reference():
    ref_cfg, ref_op, _, cfg, op, _ = _record()
    for flag in ("streaming", "spec_decodable", "has_fused_kernels",
                 "needs_positions", "self_contained", "prealloc_state",
                 "param_key"):
        assert getattr(op, flag) == getattr(ref_op, flag), flag
    ref_st = jax.eval_shape(lambda: ref_op.init_state(ref_cfg, 3))
    st = op.init_state(cfg.replace(dtype="bfloat16"), 3,
                       torch.device("meta"))
    assert tuple(st.S.shape) == ref_st.S.shape
    assert st.S.dtype == torch.float32  # fp32 whatever cfg.dtype


def test_record_forward_then_step_matches_reference():
    """forward == the reference's; a prefix forward + per-token steps (in
    place) == one forward over the whole sequence."""
    ref_cfg, ref_op, ref_p, cfg, op, p = _record()
    x = _x(0)
    want, want_st = ref_op.forward(ref_p, jnp.asarray(x), ref_cfg,
                                   want_state=True)
    tx = torch.from_numpy(x)
    y, st = op.forward(p, tx, cfg, want_state=True)
    assert _rel(y, want) <= TOL and _rel(st.S, want_st.S) <= TOL
    t = 13
    y1, st = op.forward(p, tx[:, :t], cfg, want_state=True)
    pieces = [y1]
    for j in range(t, x.shape[1]):
        yj, st2 = op.step(p, tx[:, j:j + 1], st, cfg)
        assert st2 is st  # decode updates the state in place
        pieces.append(yj)
    assert _rel(torch.cat(pieces, 1), want) <= TOL
    assert _rel(st.S, want_st.S) <= TOL


def test_record_forward_resumes_from_carry():
    ref_cfg, ref_op, ref_p, cfg, op, p = _record()
    x = _x(1)
    tx = torch.from_numpy(x)
    y_full, st_full = op.forward(p, tx, cfg, want_state=True)
    _, st1 = op.forward(p, tx[:, :21], cfg, want_state=True)
    kept = st1.S.clone()
    y2, st2 = op.forward(p, tx[:, 21:], cfg, state=st1, want_state=True)
    assert torch.equal(st1.S, kept)  # the carry is only read
    assert _rel(y2, y_full[:, 21:]) <= TOL
    assert _rel(st2.S, st_full.S) <= TOL
    _, ref_st1 = ref_op.forward(ref_p, jnp.asarray(x[:, :21]), ref_cfg,
                                want_state=True)
    want, _ = ref_op.forward(ref_p, jnp.asarray(x[:, 21:]), ref_cfg,
                             state=ref_st1, want_state=True)
    assert _rel(y2, want) <= TOL


@functools.lru_cache(maxsize=None)
def _model():
    ref_cfg = ref_get_config("hla-1b", reduced=True).replace(mixer="gla")
    cfg = get_config("hla-1b", reduced=True, mixer="gla")
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


def test_lm_loss_and_grads_match_reference():
    ref_cfg, ref_params, cfg, params = _model()
    rs = np.random.RandomState(3)
    toks = rs.randint(1, cfg.vocab, (2, 40))
    labels = rs.randint(1, cfg.vocab, (2, 40))
    labels[1, :5] = -1
    (want, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.lm_loss(p, jnp.asarray(toks), jnp.asarray(labels),
                                 ref_cfg), has_aux=True))(ref_params)
    loss, ce, aux, grads = accumulate_grads(
        params, {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labels)}, cfg)
    assert _rel(loss, want) <= TOL and float(aux) == 0.0
    assert torch.equal(loss, ce)
    want_g = dict(leaf_paths(jax.device_get(ref_grads)))
    got_g = dict(leaf_paths(grads))
    assert set(got_g) == set(want_g)
    assert any(p[-2:] == ("gla", "a0") for p in got_g)
    for path, g in got_g.items():
        assert _rel(g, want_g[path]) <= TOL, "/".join(path)


def test_gla_trains_with_finite_grads():
    _, _, cfg, params = _model()
    rs = np.random.RandomState(3)
    batch = {"tokens": torch.from_numpy(rs.randint(1, cfg.vocab, (2, 24))),
             "labels": torch.from_numpy(rs.randint(1, cfg.vocab, (2, 24)))}
    loss, _, _, grads = accumulate_grads(params, batch, cfg)
    assert bool(loss.isfinite())
    gnorm = sum(float(g.square().sum()) for _, g in leaf_paths(grads))
    assert np.isfinite(gnorm) and gnorm > 0.0


def test_gla_serving_end_to_end():
    """Engine (prefill admission, continuous-batching block decode) over
    gla equals a greedy loop of ``lm_prefill`` + per-token decode steps."""
    _, _, cfg, params = _model()
    rs = np.random.RandomState(4)
    prompts = [rs.randint(2, cfg.vocab, 10) for _ in range(3)]
    max_new = 8
    eng = Engine(cfg, params, slots=2, max_len=40, block=4, seed=0,
                 device="cpu")
    results = eng.run([GenRequest(rid=i, prompt=p, max_new=max_new)
                       for i, p in enumerate(prompts)])
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            lg, st = lm.lm_prefill(params, torch.from_numpy(prompt[None]),
                                   cfg)
            out = [int(lg[0].argmax())]
            while len(out) < max_new:
                lg, st, _ = lm.lm_apply(params, torch.tensor([[out[-1]]]),
                                        cfg, states=st, mode="decode")
                out.append(int(lg[0, -1].argmax()))
            assert results[i].status == "ok"
            assert results[i].tokens == out, (i, results[i].tokens, out)


def test_gla_rejected_nowhere():
    """gla is spec-decodable: the speculative engine accepts it and greedy
    speculative decoding equals plain greedy."""
    _, _, cfg, params = _model()
    rs = np.random.RandomState(5)
    prompt = np.tile(rs.randint(2, cfg.vocab, 4), 5)  # the n-gram drafts

    def reqs():
        return [GenRequest(rid=0, prompt=prompt, max_new=10)]

    plain = Engine(cfg, params, slots=1, max_len=64, block=4, seed=0,
                   device="cpu").run(reqs())
    spec = Engine(cfg, params, slots=1, max_len=64, block=4, seed=0,
                  device="cpu", spec=SpecConfig(drafter="ngram", k=3))
    assert spec.run(reqs())[0].tokens == plain[0].tokens
    assert spec.stats["spec_rounds"] > 0
