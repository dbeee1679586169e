"""The port's AHLA path vs the reference, on the same numpy inputs.

Tolerances, each relative to max|reference|:
- fp64, 1e-10: ``core/ahla.py`` and ``core/linear_attn.py`` against the
  reference's serial and chunkwise forms.  Both run the same algebra in
  fp64; the reference pads a ragged tail and divides gamma^pad back out,
  the port runs a shorter last chunk: they differ by fp64 rounding.
- fp32, 1e-5: the kernels' plain versions against the Pallas kernels in
  interpret mode, and the per-chunk math against the reference's.  Both
  sum in fp32, in other orders and with other chunk widths.
- fp32, 1e-4 (atol and rtol): reduced hla-1b with ``mixer="ahla"`` and the
  reference's own weights; the projections sum in other orders too.
- Greedy token streams of the two engines: equal.

Normalized cases use positive inputs so the denominators stay away from 0.
"""

import importlib
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels.ahla_chunk import ahla_chunk_pallas
from repro.kernels.decode_step import ahla_step_pallas
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro.serving import Engine as RefEngine
from repro.serving import GenRequest as RefRequest
from repro_torch.configs import get_config
from repro_torch.core import ahla as port
from repro_torch.core import linear_attn as port_lin
from repro_torch.kernels import _build, ops
from repro_torch.kernels import chunk_math as port_cm
from repro_torch.kernels.ahla_chunk import W, ahla_chunk_bwd, ahla_chunk_fwd
from repro_torch.kernels.decode_step import ahla_step
from repro_torch.launch import serve
from repro_torch.models import lm, seq_op
from repro_torch.models.param import from_jax_params, leaf_paths
from repro_torch.serving.engine import Engine, GenRequest

ref = importlib.import_module("repro.core.ahla")
ref_lin = importlib.import_module("repro.core.linear_attn")
ref_cm = importlib.import_module("repro.kernels.chunk_math")

B, H, D, DV = 2, 2, 6, 5
BH, KD, KDV = 3, 8, 6  # the kernels' rows and head dims


def _close(got, want, name, tol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f"{name}: {err}"


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x).copy())


def _j(x):
    return None if x is None else jnp.asarray(x)


def _mk(rng, shape, n, positive=False, dtype=np.float64, d=D, dv=DV):
    def r(*s):
        x = rng.randn(*s) * 0.5
        return (np.abs(x) if positive else x).astype(dtype)

    return (r(*shape, n, d), r(*shape, n, d), r(*shape, n, dv),
            rng.uniform(0.85, 0.99, shape).astype(dtype))


# --------------------------------------------------------------------------
# core, fp64
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 16, 37])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("resume", [False, True])
def test_chunkwise_matches_reference(rng, n, use_gamma, normalize, resume):
    q, k, v, g = _mk(rng, (B, H), n, positive=normalize)
    gamma = g if use_gamma else None
    state = None
    if resume:
        qp, kp, vp, _ = _mk(rng, (B, H), 11, positive=normalize)
        _, state = ref.ahla_chunkwise(_j(qp), _j(kp), _j(vp), _j(gamma),
                                      chunk=4)
    o_ref, st_ref = ref.ahla_chunkwise(
        _j(q), _j(k), _j(v), _j(gamma), chunk=16, normalize=normalize,
        state=state)
    o, st = port.ahla_chunkwise(
        _t(q), _t(k), _t(v), _t(gamma), chunk=16, normalize=normalize,
        state=None if state is None else port.AHLAState(*map(_t, state)))
    assert o.dtype == torch.float64
    _close(o, o_ref, "o", 1e-10)
    for got, want, name in zip(st, st_ref, "RPmEn"):
        _close(got, want, name, 1e-10)


@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_step_and_chunkwise_match_reference_serial(rng, use_gamma,
                                                   normalize):
    """Algorithm 2 token by token, resumed from a prior state, against the
    reference's ``ahla_serial``; the port's chunkwise form (ragged tail)
    against the same."""
    q, k, v, g = _mk(rng, (B, H), 23, positive=normalize)
    gamma = g if use_gamma else None
    qp, kp, vp, _ = _mk(rng, (B, H), 5, positive=normalize)
    _, st0 = ref.ahla_serial(_j(qp), _j(kp), _j(vp), _j(gamma))
    o_ref, st_ref = ref.ahla_serial(_j(q), _j(k), _j(v), _j(gamma),
                                    normalize=normalize, state=st0)
    st = port.AHLAState(*map(_t, st0))
    for t in range(23):
        st, o = port.ahla_step(st, _t(q[:, :, t]), _t(k[:, :, t]),
                               _t(v[:, :, t]), _t(gamma),
                               normalize=normalize)
        _close(o, np.asarray(o_ref)[:, :, t], f"o[{t}]", 1e-10)
    for got, want, name in zip(st, st_ref, "RPmEn"):
        _close(got, want, name, 1e-10)
    o_c, st_c = port.ahla_chunkwise(
        _t(q), _t(k), _t(v), _t(gamma), chunk=8, normalize=normalize,
        state=port.AHLAState(*map(_t, st0)))
    _close(o_c, o_ref, "chunkwise o", 1e-10)
    for got, want, name in zip(st_c, st_ref, "RPmEn"):
        _close(got, want, name, 1e-10)


@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("resume", [False, True])
def test_linattn_chunkwise_matches_reference(rng, n, use_gamma, normalize,
                                             resume):
    q, k, v, g = _mk(rng, (B, H), n, positive=normalize)
    gamma = g if use_gamma else None
    state = None
    if resume:
        qp, kp, vp, _ = _mk(rng, (B, H), 9, positive=normalize)
        _, state = ref_lin.linattn_chunkwise(_j(qp), _j(kp), _j(vp),
                                             _j(gamma), chunk=4)
    o_ref, st_ref = ref_lin.linattn_chunkwise(
        _j(q), _j(k), _j(v), _j(gamma), chunk=16, normalize=normalize,
        state=state)
    o, st = port_lin.linattn_chunkwise(
        _t(q), _t(k), _t(v), _t(gamma), chunk=16, normalize=normalize,
        state=None if state is None else port_lin.LinAttnState(
            *map(_t, state)))
    _close(o, o_ref, "o", 1e-10)
    for got, want, name in zip(st, st_ref, "Pm"):
        _close(got, want, name, 1e-10)


@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_linattn_step_matches_reference(rng, use_gamma, normalize):
    q, k, v, g = _mk(rng, (B, H), 7, positive=normalize)
    gamma = g if use_gamma else None
    st_ref = ref_lin.linattn_init_state((B, H), D, DV, jnp.float64)
    st = port_lin.linattn_init_state((B, H), D, DV, torch.float64)
    for t in range(7):
        st_ref, o_ref = ref_lin.linattn_step(
            st_ref, _j(q[:, :, t]), _j(k[:, :, t]), _j(v[:, :, t]),
            _j(gamma), normalize=normalize)
        st, o = port_lin.linattn_step(
            st, _t(q[:, :, t]), _t(k[:, :, t]), _t(v[:, :, t]), _t(gamma),
            normalize=normalize)
        _close(o, o_ref, f"o[{t}]", 1e-10)
    for got, want, name in zip(st, st_ref, "Pm"):
        _close(got, want, name, 1e-10)


@pytest.mark.parametrize("w", [1, 8, 13])
@pytest.mark.parametrize("normalize", [False, True])
def test_chunk_math_matches_reference(rng, w, normalize):
    """One chunk on one tile: the reference math is fp32 by construction,
    and the port's writes the E update without the d x d product."""
    q, k, v, _ = _mk(rng, (1,), w, positive=normalize, dtype=np.float32)
    st = [rng.randn(D, DV + 1).astype(np.float32) * 0.3 for _ in range(2)]
    if normalize:
        st = [np.abs(x) for x in st]
    g = np.float32(0.93)
    o_ref, st_ref = ref_cm.ahla_chunk_math(
        jnp.asarray(q[0]), jnp.asarray(k[0]), jnp.asarray(v[0]),
        tuple(map(jnp.asarray, st)), jnp.float32(g), normalize=normalize,
        eps=1e-6)
    o, st_new = port_cm.ahla_chunk_math(
        _t(q[0]), _t(k[0]), _t(v[0]), tuple(map(_t, st)), torch.tensor(g),
        normalize=normalize, eps=1e-6)
    _close(o, o_ref, "o", 1e-5)
    for got, want, name in zip(st_new, st_ref, ["P|m", "E|n"]):
        _close(got, want, name, 1e-5)


# --------------------------------------------------------------------------
# kernels' plain versions vs the Pallas kernels (interpret mode), fp32
# --------------------------------------------------------------------------


def _kernel_inputs(rng, n, positive=False):
    return _mk(rng, (BH,), n, positive, np.float32, d=KD, dv=KDV)


def _prior_state(rng, gamma, positive):
    """A carry ``(R, P, m, E, n)`` from a previous 20-token prefill
    (reference chunkwise)."""
    q, k, v, _ = _kernel_inputs(rng, 20, positive)
    _, st = ref.ahla_chunkwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               _j(gamma), chunk=8)
    return tuple(np.asarray(x, np.float32) for x in st)


@pytest.mark.parametrize("n", [1, W, W + 13])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("resume", [False, True])
def test_chunk_matches_pallas(rng, n, use_gamma, normalize, resume):
    q, k, v, g = _kernel_inputs(rng, n, positive=normalize)
    gamma = g if use_gamma else None
    init = _prior_state(rng, gamma, normalize)[1:] if resume else None
    o_ref, st_ref = ahla_chunk_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _j(gamma), chunk=W,
        normalize=normalize, interpret=True,
        initial_state=None if init is None else tuple(map(jnp.asarray, init)))
    init_t = None if init is None else tuple(map(_t, init))
    o, st = ahla_chunk_fwd(_t(q), _t(k), _t(v), _t(gamma),
                           initial_state=init_t, normalize=normalize)
    assert o.dtype == torch.float32
    _close(o, o_ref, "o", 1e-5)
    for got, want, name in zip(st, st_ref, "PmEn"):
        assert got.is_contiguous()
        _close(got, want, name, 1e-5)
    if init is not None:  # the carry it resumed from is left as it was
        for a, b in zip(init_t, init):
            assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_step_matches_pallas_in_place(rng, use_gamma, normalize):
    g = rng.uniform(0.85, 0.99, BH).astype(np.float32)
    gamma = g if use_gamma else None
    st0 = _prior_state(rng, gamma, normalize)
    q, k, v, _ = _kernel_inputs(rng, 1, positive=normalize)
    st_ref, o_ref = ahla_step_pallas(
        tuple(map(jnp.asarray, st0)), jnp.asarray(q[:, 0]),
        jnp.asarray(k[:, 0]), jnp.asarray(v[:, 0]), _j(gamma),
        normalize=normalize, interpret=True)
    state = tuple(map(_t, st0))
    o = ahla_step(state, _t(q[:, 0]), _t(k[:, 0]), _t(v[:, 0]), _t(gamma),
                  normalize=normalize)
    _close(o, o_ref, "o", 1e-5)
    for got, want, name in zip(state, st_ref, "RPmEn"):  # mutated in place
        _close(got, want, name, 1e-5)


@pytest.mark.parametrize("n", [5, W - 1, W, 2 * W + 3])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_prefill_then_step_equals_longer_prefill(rng, n, use_gamma,
                                                 normalize):
    """The carry identity inside the port: prefill(n) + step == prefill(n+1)
    on the last output and on every state leaf."""
    q, k, v, g = (_t(x) for x in _kernel_inputs(rng, n + 1, normalize))
    gamma = g if use_gamma else None
    o_full, st_full = ops.ahla_prefill(q[None], k[None], v[None], gamma,
                                       normalize=normalize)
    _, st = ops.ahla_prefill(q[None, :, :n], k[None, :, :n], v[None, :, :n],
                             gamma, normalize=normalize)
    st, o_t = ops.ahla_decode_step(st, q[None, :, n], k[None, :, n],
                                   v[None, :, n], gamma, normalize=normalize)
    _close(o_t, o_full[:, :, n], "o", 1e-5)
    for got, want, name in zip(st, st_full, "RPmEn"):
        _close(got, want, name, 1e-5)


@pytest.mark.parametrize("resume", [False, True])
def test_prefill_matches_reference_ops(rng, resume):
    """``ops.ahla_prefill`` (one kernel launch + R outside it) against the
    reference's (the Pallas kernel in interpret mode + its einsum), on
    ``(B, H, n, d)`` with a per-head gamma, resumed or not."""
    q, k, v, g = _mk(rng, (1, BH), 77, dtype=np.float32, d=KD, dv=KDV)
    state = None
    if resume:
        state = tuple(x[None] for x in _prior_state(rng, g[0], False))
    o_ref, st_ref = ref_ops.ahla_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
        chunk=W,
        state=None if state is None else ref.AHLAState(
            *map(jnp.asarray, state)))
    st_in = None if state is None else port.AHLAState(*map(_t, state))
    o, st = ops.ahla_prefill(_t(q), _t(k), _t(v), _t(g), state=st_in)
    assert type(st) is port.AHLAState
    _close(o, o_ref, "o", 1e-5)
    for got, want, name in zip(st, st_ref, "RPmEn"):
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want, name, 1e-5)
    if state is not None:
        for a, b in zip(st_in, state):
            assert np.array_equal(a.numpy(), b)


def test_attention_on_cpu_is_the_differentiable_plain_path(rng):
    """``ops.ahla_attention`` on CPU tensors: the chunkwise outputs, and
    gradients through its plain backward (against the reference's VJP of
    its chunkwise form), in fp64."""
    q, k, v, g = _mk(rng, (B, H), 19)
    tq, tk, tv, tg = (_t(x).requires_grad_(True) for x in (q, k, v, g))
    o = ops.ahla_attention(tq, tk, tv, tg)
    o_c, _ = port.ahla_chunkwise(_t(q), _t(k), _t(v), _t(g))
    _close(o.detach(), o_c, "o", 1e-10)
    w = rng.randn(*o.shape)
    (o * _t(w)).sum().backward()

    def f(q_, k_, v_, g_):
        out, _ = ref.ahla_chunkwise(q_, k_, v_, g_, chunk=8)
        return (out * w).sum()

    grads = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, g)))
    for x, want, name in zip((tq, tk, tv, tg), grads, "qkvg"):
        _close(x.grad, want, f"d{name}", 1e-10)


# --------------------------------------------------------------------------
# the model: reduced hla-1b with mixer="ahla", fp32, the reference's weights
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    ref_cfg = ref_get_config("hla-1b", reduced=True, mixer="ahla")
    cfg = get_config("hla-1b", reduced=True, mixer="ahla")
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


def _model_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("reduced", [False, True])
def test_get_config_mixer_override_matches_reference(reduced):
    ref_cfg = ref_get_config("hla-1b", reduced=reduced, mixer="ahla")
    cfg = get_config("hla-1b", reduced=reduced, mixer="ahla")
    assert cfg.mixer == ref_cfg.mixer == "ahla"
    assert seq_op.op_for(cfg).name == "ahla"
    assert get_config("hla-1b", reduced=reduced, mixer="hla2") == \
        get_config("hla-1b", reduced=reduced)
    bad = get_config("hla-1b", reduced=reduced, mixer="softmx")
    with pytest.raises(KeyError, match="unknown sequence op"):
        seq_op.op_for(bad)


def test_ahla_parameters_are_hla2_layout_and_carry_across(model):
    """The ``ahla`` record has the ``hla2`` record's parameter layout, so
    ``from_jax_params`` carries the reference's AHLA weights unchanged."""
    _, ref_params, cfg, params = model

    def shapes(c):
        return {p: s.shape for p, s in leaf_paths(lm.lm_specs(c))}

    assert shapes(cfg) == shapes(cfg.replace(mixer="hla2"))
    mix = params["layers"]["mixer"]
    want = jax.device_get(ref_params)["layers"]["mixer"]
    for name in ("wq", "wk", "wv", "wo"):  # fp32 copies of the same weights
        assert np.array_equal(mix[name]["kernel"].numpy(),
                              np.asarray(want[name]["kernel"], np.float32))
    assert np.array_equal(mix["decay_a"].numpy(),
                          np.asarray(want["decay_a"], np.float32))


@pytest.mark.parametrize("n", [1, 21])
def test_train_logits_match(model, rng, n):
    ref_cfg, ref_params, cfg, params = model
    toks = rng.randint(0, cfg.vocab, (2, n))
    want, _, _ = ref_lm.lm_apply(ref_params, jnp.asarray(toks), ref_cfg)
    got, st, _ = lm.lm_apply(params, torch.from_numpy(toks), cfg)
    assert st is None
    _model_close(got, want)


@pytest.mark.parametrize("n", [1, 13, 70])
def test_prefill_logits_and_states_match(model, rng, n):
    ref_cfg, ref_params, cfg, params = model
    toks = rng.randint(0, cfg.vocab, (2, n))
    want, st_ref = ref_lm.lm_prefill(ref_params, jnp.asarray(toks), ref_cfg)
    got, st = lm.lm_prefill(params, torch.from_numpy(toks), cfg)
    assert type(st) is port.AHLAState
    _model_close(got, want)
    for a, b in zip(st, st_ref):
        assert tuple(a.shape) == b.shape
        _model_close(a, b)


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
        _model_close(got, want)
    for a, b in zip(st, st_ref):
        _model_close(a, b)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lens,max_new", [([3, 9, 9, 17], 6),
                                          ([1, 30, 5], 9)])
def test_greedy_streams_match_reference_engine(model, rng, lens, max_new):
    ref_cfg, ref_params, cfg, params = model
    prompts = [rng.randint(2, cfg.vocab, n) for n in lens]
    ref_res = RefEngine(ref_cfg, ref_params, slots=2, max_len=64,
                        block=4).run([
        RefRequest(rid=i, prompt=p, max_new=max_new)
        for i, p in enumerate(prompts)])
    res = Engine(cfg, params, slots=2, max_len=64, block=4,
                 device="cpu").run([
        GenRequest(rid=i, prompt=p, max_new=max_new)
        for i, p in enumerate(prompts)])
    assert [r.status for r in res] == ["ok"] * len(lens)
    assert [r.tokens for r in res] == [r.tokens for r in ref_res]


def test_nan_slot_is_quarantined_with_ahla_state(model, rng):
    _, _, cfg, params = model
    prompts = [rng.randint(2, cfg.vocab, 6) for _ in range(2)]

    def engine():
        return Engine(cfg, params, slots=2, max_len=64, block=4,
                      device="cpu")

    (solo,) = engine().run([GenRequest(rid=1, prompt=prompts[1],
                                       max_new=10)])
    eng = engine()
    eng.admit(0, GenRequest(rid=0, prompt=prompts[0], max_new=10))
    eng.admit(1, GenRequest(rid=1, prompt=prompts[1], max_new=10))
    eng.pool.states.E[:, 0] = float("nan")  # poison slot 0
    while eng.active.any():
        eng.step_block()
    assert eng.results[0].status == "error"
    assert eng.results[1].tokens == solo.tokens
    assert eng.stats["quarantined"] == 1


def test_serve_cli_with_ahla_on_cpu(capsys):
    results = serve.main(["--reduced", "--device", "cpu", "--mixer", "ahla",
                          "--requests", "3", "--gen-len", "5",
                          "--prompt-len", "9"])
    out = capsys.readouterr().out
    assert re.search(
        r"\[serve\] 3 requests, 15 generated tokens in [\d.]+s \| TTFT p50 "
        r"[\d.]+ms p99 [\d.]+ms \(queued p50 [\d.]+ms p99 [\d.]+ms\) \| "
        r"decode [\d.]+ tok/s \| prefill [\d.]+ tok/s", out), out
    assert "statuses: ok=3" in out
    assert all(len(r.tokens) == 5 for r in results)


# --------------------------------------------------------------------------
# guards
# --------------------------------------------------------------------------


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: reaches the wrappers' CUDA
    branch on a machine with no card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_attention_on_cuda_refuses_grad_before_any_launch(rng, monkeypatch):
    """On the card the raw forward kernel still refuses inputs that need a
    gradient, before any launch, and points at ``ops.ahla_attention``;
    ``ops.ahla_attention`` itself hands the kernel detached rows and asks
    for the chunk checkpoints its backward kernel walks."""
    q, k, v, g = (torch.Tensor._make_subclass(_FakeCuda, _t(x), True)
                  for x in _mk(rng, (B, H), 9, dtype=np.float32))
    ops.LAUNCHES.clear()
    with pytest.raises(RuntimeError, match=r"ops\.ahla_attention"):
        ahla_chunk_fwd(q[0], k[0], v[0], g[0])
    assert sum(ops.LAUNCHES.values()) == 0 and not _build._libs

    class Reached(Exception):
        pass

    def kernel(*rows, save_chunk_states=False, **kw):
        assert save_chunk_states and rows[3] is None
        assert not any(x.requires_grad for x in rows[:3])
        raise Reached

    monkeypatch.setattr(ops, "ahla_chunk_fwd", kernel)
    with pytest.raises(Reached):  # gamma None: no tensor is moved
        ops.ahla_attention(q, k, v)
    assert sum(ops.LAUNCHES.values()) == 0 and not _build._libs


@pytest.mark.parametrize("wrapper", [ahla_chunk_fwd, ahla_chunk_bwd,
                                     ahla_step])
def test_cuda_branch_refuses_grad_before_launch(wrapper):
    # read the CUDA branch: the guard runs on every tensor the kernel reads,
    # before the library is loaded
    src = inspect.getsource(wrapper)
    cuda = src[src.index('if q.device.type != "cuda"'):]
    assert 0 < cuda.index(f'_build.refuse_grad("{wrapper.__name__}", '
                          "tensors)") < cuda.index("_build.load(")


def test_refuse_grad_names_each_operator():
    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="ops.hla2_attention"):
        _build.refuse_grad("hla2_chunk_fwd", [w])
    for name in ("ahla_chunk_fwd", "ahla_chunk_bwd", "ahla_step"):
        with pytest.raises(RuntimeError, match="ops.ahla_attention"):
            _build.refuse_grad(name, [w])


def test_launch_counters_stay_zero_on_cpu(rng):
    ops.LAUNCHES.clear()
    q, k, v, g = (_t(x) for x in _kernel_inputs(rng, 9))
    _, st = ops.ahla_prefill(q[None], k[None], v[None], g)
    ops.ahla_decode_step(st, q[None, :, 0], k[None, :, 0], v[None, :, 0], g)
    assert sum(ops.LAUNCHES.values()) == 0


def test_wrappers_reject_bad_inputs(rng):
    q, k, v, g = (_t(x) for x in _kernel_inputs(rng, 9))
    with pytest.raises(TypeError):
        ahla_chunk_fwd(q.half(), k.half(), v.half(), g)
    with pytest.raises(ValueError):
        ahla_chunk_fwd(q, k, v[:, :4], g)
    with pytest.raises(ValueError):
        ahla_chunk_fwd(q, k, v, g.double())
    _, st = ahla_chunk_fwd(q, k, v, g)
    with pytest.raises(ValueError, match=re.escape("(P, m, E, n)")):
        ahla_chunk_fwd(q, k, v, g, initial_state=st[:3])
    with pytest.raises(ValueError):  # a leaf of the wrong shape
        ahla_chunk_fwd(q, k, v, g, initial_state=(st[0][:, :4],) + st[1:])
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        ahla_chunk_fwd(*(x.to("meta") for x in (q, k, v, g)))
    full = (torch.zeros(BH, KD, KD),) + st
    with pytest.raises(ValueError, match=re.escape("(R, P, m, E, n)")):
        ahla_step(full[:4], q[:, 0], k[:, 0], v[:, 0], g)
    with pytest.raises(TypeError):
        ahla_step(full, q[:, 0].double(), k[:, 0].double(),
                  v[:, 0].double(), g)
    with pytest.raises(ValueError):
        ahla_step(full, q[:, 0], k[:, 0], v[:, 0], g[:2])
    with pytest.raises(ValueError):
        ahla_step(tuple(x.to("meta") for x in full),
                  *(x.to("meta") for x in (q[:, 0], k[:, 0], v[:, 0], g)))
