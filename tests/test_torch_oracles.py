"""The port's serial / naive / scan / chunkwise views of HLA2, AHLA and
first-order linear attention, and its chunk-level oracles
(``repro_torch/kernels/ref.py``), against the reference on the same
numpy-seeded inputs.  Twin of ``tests/test_hla2.py``, ``tests/test_ahla.py``
and the ``linattn`` cases.

Tolerance: fp64 on both sides, 1e-9 relative to max|want|, except where a
test states otherwise (the reference's chunk-level backward oracle runs in
fp32 whatever its inputs).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_qkv
from repro.kernels import ref as ref_kref
from repro_torch.core import ahla as P_ahla
from repro_torch.core import hla2 as P_hla2
from repro_torch.core import linear_attn as P_lin
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ahla_chunk import ahla_chunk_bwd, ahla_chunk_fwd
from repro_torch.kernels.hla2_chunk import hla2_chunk_bwd, hla2_chunk_fwd

# the reference's core/__init__ re-exports functions named like its
# submodules, so bind the submodules by name
R_hla2, R_ahla, R_lin = (importlib.import_module(f"repro.core.{m}")
                         for m in ("hla2", "ahla", "linear_attn"))

REL = 1e-9


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rel=REL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


def _inputs(rng, use_gamma, **kw):
    q, k, v, gam = make_qkv(rng, **kw)
    return (q, k, v, gam if use_gamma else None), \
        (_t(q), _t(k), _t(v), _t(gam) if use_gamma else None)


# --------------------------------------------------------------------------
# HLA2
# --------------------------------------------------------------------------


@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_hla2_all_views_agree(rng, use_gamma, normalize, lam):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(rng, use_gamma)
    kw = dict(normalize=normalize, lam=lam)
    want = R_hla2.hla2_naive(q, k, v, g, **kw)
    _, want_st = R_hla2.hla2_serial(q, k, v, g, **kw)
    outs = [P_hla2.hla2_naive(tq, tk, tv, tg, **kw)]
    for impl, chunk in (("serial", 8), ("scan", 8), ("chunkwise", 8),
                        ("chunkwise", 7)):
        o, st = P_hla2.hla2(tq, tk, tv, tg, impl=impl, chunk=chunk, **kw)
        outs.append(o)
        for a, b in zip(st, want_st):
            _close(a, b)
    for o in outs:
        _close(o, want)


def test_hla2_matches_masked_matrix_form(rng):
    """Theorem 3.1: o_t = row_t[((W W^T) . L) V]."""
    q, k, v, _ = (np.asarray(x) for x in make_qkv(rng, B=1, H=1, n=16))
    L = np.tril(np.ones((16, 16)))
    W = np.einsum("bhtd,bhjd->bhtj", q, k) * L
    want = np.einsum("bhtj,bhje->bhte",
                     np.einsum("bhti,bhji->bhtj", W, W) * L, v)
    o, _ = P_hla2.hla2_serial(_t(q), _t(k), _t(v))
    _close(o, want)


def test_hla2_carry_continuation(rng):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(rng, True)
    want, want_st = R_hla2.hla2_serial(q, k, v, g)
    cut = 10
    o_a, st = P_hla2.hla2_chunkwise(tq[..., :cut, :], tk[..., :cut, :],
                                    tv[..., :cut, :], tg, chunk=5)
    o_b, st_b = P_hla2.hla2_chunkwise(tq[..., cut:, :], tk[..., cut:, :],
                                      tv[..., cut:, :], tg, chunk=7, state=st)
    _close(torch.cat([o_a, o_b], -2), want)
    for a, b in zip(st_b, want_st):
        _close(a, b)
    # the scan and the serial recurrence take the same carry
    for fn in (P_hla2.hla2_scan, P_hla2.hla2_serial):
        o_c, st_c = fn(tq[..., cut:, :], tk[..., cut:, :], tv[..., cut:, :],
                       tg, state=st)
        _close(o_c, want[..., cut:, :])
        for a, b in zip(st_c, want_st):
            _close(a, b)


def test_hla2_linear_attention_reduction(rng):
    """Section 3: with S = 0 (zero keys) and lam = 1 the normalized output
    is first-order linear attention with kernel q_t . q_i."""
    q, k, v, _ = (np.asarray(x) for x in make_qkv(rng, n=12))
    L = np.tril(np.ones((12, 12)))
    Wqq = np.einsum("bhtd,bhjd->bhtj", q, q) * L
    want = np.einsum("bhtj,bhje->bhte", Wqq, v) / (Wqq.sum(-1)[..., None]
                                                   + 1e-6)
    o, _ = P_hla2.hla2_serial(_t(q), torch.zeros_like(_t(k)), _t(v), None,
                              normalize=True, lam=1.0)
    _close(o, want)


def test_hla2_bf16_inputs_fp32_state(rng):
    q, k, v, g = (np.asarray(x, np.float32)
                  for x in make_qkv(rng, dtype=np.float32))
    o_ref, _ = P_hla2.hla2_chunkwise(_t(q), _t(k), _t(v), _t(g), chunk=8)
    qb, kb, vb = (_t(x).bfloat16() for x in (q, k, v))
    for impl in ("chunkwise", "scan", "serial"):
        o, st = P_hla2.hla2(qb, kb, vb, _t(g), impl=impl, chunk=8)
        assert o.dtype == torch.bfloat16 and st.S.dtype == torch.float32
        np.testing.assert_allclose(o.float().numpy(), o_ref.numpy(),
                                   atol=0.2, rtol=0.2)


# --------------------------------------------------------------------------
# AHLA and first-order linear attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_ahla_all_views_agree(rng, use_gamma, normalize):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(rng, use_gamma)
    want = R_ahla.ahla_naive(q, k, v, g, normalize=normalize)
    _, want_st = R_ahla.ahla_serial(q, k, v, g, normalize=normalize)
    outs = [P_ahla.ahla_naive(tq, tk, tv, tg, normalize=normalize)]
    for impl in ("serial", "scan", "chunkwise"):
        o, st = P_ahla.ahla(tq, tk, tv, tg, impl=impl, chunk=8,
                            normalize=normalize)
        outs.append(o)
        for a, b in zip(st, want_st):
            _close(a, b)
    for o in outs:
        _close(o, want)


def test_ahla_matches_masked_matrix_power(rng):
    """Eq. (6.1): o_t = row_t[(A A) V], A = L . (Q K^T)."""
    q, k, v, _ = (np.asarray(x) for x in make_qkv(rng, B=1, H=1, n=16))
    A = np.einsum("bhtd,bhjd->bhtj", q, k) * np.tril(np.ones((16, 16)))
    want = np.einsum("bhtj,bhje->bhte", A @ A, v)
    o, _ = P_ahla.ahla_serial(_t(q), _t(k), _t(v))
    _close(o, want)


def test_ahla_carry_continuation(rng):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(rng, True)
    want, want_st = R_ahla.ahla_serial(q, k, v, g)
    cut = 9
    o_a, st = P_ahla.ahla_chunkwise(tq[..., :cut, :], tk[..., :cut, :],
                                    tv[..., :cut, :], tg, chunk=4)
    for fn in (P_ahla.ahla_chunkwise, P_ahla.ahla_scan, P_ahla.ahla_serial):
        o_b, st_b = fn(tq[..., cut:, :], tk[..., cut:, :], tv[..., cut:, :],
                       tg, state=st)
        _close(torch.cat([o_a, o_b], -2), want)
        for a, b in zip(st_b, want_st):
            _close(a, b)


@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_linattn_views_agree(rng, use_gamma, normalize):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(rng, use_gamma)
    want, want_st = R_lin.linattn(q, k, v, g, chunk=5, normalize=normalize)
    got, st = P_lin.linattn(tq, tk, tv, tg, chunk=5, normalize=normalize)
    _close(got, want)
    for a, b in zip(st, want_st):
        _close(a, b)
    naive, none = P_lin.linattn(tq, tk, tv, tg, impl="naive",
                                normalize=normalize)
    assert none is None
    _close(naive, R_lin.linattn_naive(q, k, v, g, normalize=normalize))
    _close(naive, want)
    # the decode step, token by token, resumes the chunked carry
    cut = 17
    _, st = P_lin.linattn(tq[..., :cut, :], tk[..., :cut, :],
                          tv[..., :cut, :], tg, normalize=normalize)
    for t in range(cut, q.shape[-2]):
        st, o_t = P_lin.linattn_step(st, tq[..., t, :], tk[..., t, :],
                                     tv[..., t, :], tg, normalize=normalize)
        _close(o_t, want[..., t, :])


def test_front_ends_reject_unknown_impl(rng):
    _, (tq, tk, tv, tg) = _inputs(rng, False)
    for fn in (P_hla2.hla2, P_ahla.ahla, P_lin.linattn):
        with pytest.raises(ValueError, match="bogus"):
            fn(tq, tk, tv, tg, impl="bogus")


# --------------------------------------------------------------------------
# gradients of every impl against the reference's naive oracle
# --------------------------------------------------------------------------


_GRAD_CASES = [("hla2", i) for i in ("serial", "scan", "chunkwise")] + \
    [("ahla", i) for i in ("serial", "scan", "chunkwise")] + \
    [("linattn", "chunkwise")]


@pytest.mark.parametrize("op,impl", _GRAD_CASES)
def test_gradients_agree_with_naive(rng, op, impl):
    q, k, v, g = make_qkv(rng, n=16)
    ref_mod = {"hla2": R_hla2, "ahla": R_ahla, "linattn": R_lin}[op]
    ref_naive = getattr(ref_mod, f"{op}_naive")

    def ref_loss(args):
        return jnp.sum(ref_naive(*args, normalize=True) ** 2)

    want = jax.grad(ref_loss)((q, k, v, g))
    port = {"hla2": P_hla2.hla2, "ahla": P_ahla.ahla,
            "linattn": P_lin.linattn}[op]
    args = [_t(x).requires_grad_(True) for x in (q, k, v, g)]
    o, _ = port(*args, impl=impl, chunk=8, normalize=True)
    got = torch.autograd.grad((o**2).sum(), args)
    for a, b in zip(got, want):
        _close(a, b, rel=1e-8)


# --------------------------------------------------------------------------
# kernels/ref.py: the chunk-level oracles
# --------------------------------------------------------------------------


def _rows(rng, BH=3, n=32, d=8, dv=6, decay=True):
    q, k, v, do = (rng.randn(BH, n, x) * 0.5 for x in (d, d, dv, dv))
    g = rng.uniform(0.85, 0.99, BH) if decay else None
    return q, k, v, g, do


def test_chunk_refs_match_reference(rng):
    """With decay, normalize and lam (every branch of the chunk math):
    forward oracles at 1e-9; backward oracles at 1e-4 of max|want|, the
    reference's backward oracle computing in fp32 whatever its inputs."""
    normalize = True
    q, k, v, g, do = _rows(rng)
    jg = None if g is None else jnp.asarray(g)
    tg = None if g is None else _t(g)
    j = [jnp.asarray(x) for x in (q, k, v)]
    t = [_t(x) for x in (q, k, v)]
    o, st = kref.hla2_chunk_ref(*t, tg, chunk=8, normalize=normalize,
                                lam=0.3)
    o_r, st_r = ref_kref.hla2_chunk_ref(*j, jg, chunk=8, normalize=normalize,
                                        lam=0.3)
    for a, b in zip((o,) + st, (o_r,) + st_r):
        _close(a, b)
    o, st = kref.ahla_chunk_ref(*t, tg, chunk=8, normalize=normalize)
    o_r, st_r = ref_kref.ahla_chunk_ref(*j, jg, chunk=8, normalize=normalize)
    for a, b in zip((o,) + st, (o_r,) + st_r):
        _close(a, b)
    got = kref.hla2_chunk_bwd_ref(*t, tg, _t(do), chunk=8,
                                  normalize=normalize, lam=0.3)
    want = ref_kref.hla2_chunk_bwd_ref(*j, jg, jnp.asarray(do), chunk=8,
                                       normalize=normalize, lam=0.3)
    got += kref.ahla_chunk_bwd_ref(*t, tg, _t(do), chunk=8,
                                   normalize=normalize)
    want += ref_kref.ahla_chunk_bwd_ref(*j, jg, jnp.asarray(do), chunk=8,
                                        normalize=normalize)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            _close(a, b, rel=1e-4)


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_chunk_bwd_refs_match_plain_backwards(rng, decay, normalize):
    """The autograd oracles against the hand-derived plain backwards of the
    kernels, at the kernels' chunk width (64) and a ragged n."""
    q, k, v, g, do = (None if x is None else _t(x)
                      for x in _rows(rng, n=150, decay=decay))
    _, _, ckpt = hla2_chunk_fwd(q, k, v, g, normalize=normalize, lam=0.3,
                                save_chunk_states=True)
    got = hla2_chunk_bwd(q, k, v, g, do, ckpt, normalize=normalize, lam=0.3)
    want = kref.hla2_chunk_bwd_ref(q, k, v, g, do, chunk=64,
                                   normalize=normalize, lam=0.3)
    _, _, ckpt = ahla_chunk_fwd(q, k, v, g, normalize=normalize,
                                save_chunk_states=True)
    got += ahla_chunk_bwd(q, k, v, g, do, ckpt, normalize=normalize)
    want += kref.ahla_chunk_bwd_ref(q, k, v, g, do, chunk=64,
                                    normalize=normalize)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            _close(a, b)
