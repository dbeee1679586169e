"""The port's HLA2 backward vs autograd and vs the reference.

* ``hla2_chunk_math_bwd`` (the hand-derived adjoint) against
  ``torch.autograd`` of the port's own ``hla2_chunk_math``, fp64, every
  cotangent (output and all five carry leaves) random: relative error
  <= 1e-12 of max|autograd|.
* The forward's checkpoints and ``hla2_chunk_bwd`` (its plain version, on
  CPU tensors) against ``hla2_chunk_pallas(save_chunk_states=True)`` and
  ``hla2_chunk_bwd_pallas`` in interpret mode, chunk 64 on both sides, n a
  multiple of 64: fp32 on both sides, 1e-5 of max|reference|.
* At ragged n, against ``jax.vjp`` of ``ref.hla2_chunk_ref`` in fp64: the
  reference pads the tail and divides gamma^pad back out, the port runs a
  shorter last chunk, so the two differ by fp64 rounding: 1e-9.
* ``torch.autograd.gradcheck`` of ``ops.hla2_attention`` in fp64.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hla2_chunk import hla2_chunk_bwd_pallas, hla2_chunk_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.chunk_math import hla2_chunk_math, hla2_chunk_math_bwd
from repro_torch.kernels.hla2_chunk import (
    W, hla2_chunk_bwd, hla2_chunk_bwd_plain, hla2_chunk_fwd,
    hla2_chunk_fwd_plain)

ref = importlib.import_module("repro.kernels.ref")

BH, D, DV = 2, 6, 5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these cells run thousands of tiny products,
    and when the suite's parallel workers each hold a full thread pool on
    the same cores, the pools thrash and a gradcheck runs many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(rng, n, positive=False, dtype=np.float32):
    def r(*s):
        x = rng.randn(*s) * 0.5
        return (np.abs(x) if positive else x).astype(dtype)

    g = rng.uniform(0.85, 0.99, BH).astype(dtype)
    return r(BH, n, D), r(BH, n, D), r(BH, n, DV), g, r(BH, n, DV)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-300)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("w", [1, 5, 64])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_chunk_math_bwd_matches_autograd(rng, w, use_gamma, normalize, lam):
    def r(*s, scale=0.5):
        x = torch.from_numpy(rng.randn(2, *s) * scale)
        return x.abs() if normalize else x

    Q, K, V = r(w, D), r(w, D), r(w, DV)
    state = (r(D, D), r(D, DV), r(D), r(D, DV, scale=0.05), r(D, scale=0.05))
    g = torch.from_numpy(rng.uniform(0.85, 0.99, 2) if use_gamma
                         else np.ones(2))
    ins = [x.clone().requires_grad_(True) for x in (Q, K, V, *state, g)]
    o, st1 = hla2_chunk_math(*ins[:3], tuple(ins[3:8]), ins[8],
                             normalize=normalize, eps=1e-6, lam=lam)
    dO = torch.from_numpy(rng.randn(*o.shape))
    dst1 = tuple(torch.from_numpy(rng.randn(*x.shape)) for x in st1)
    want = torch.autograd.grad((o, *st1), ins, (dO, *dst1))
    dQ, dK, dV, dst0, dg = hla2_chunk_math_bwd(
        Q, K, V, state, g, dO, dst1, normalize=normalize, eps=1e-6, lam=lam)
    for got, exp, name in zip((dQ, dK, dV, *dst0, dg), want,
                              ("dQ", "dK", "dV", "dS", "dC", "dm", "dG",
                               "dh", "dg")):
        assert got.shape == exp.shape, name
        assert _rel(got, exp) <= 1e-12, (name, _rel(got, exp))


@pytest.mark.parametrize("n", [W, 2 * W])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize,lam", [(False, 0.0), (True, 0.3)])
def test_chunk_bwd_matches_pallas(rng, n, use_gamma, normalize, lam):
    q, k, v, g, do = _mk(rng, n, positive=normalize)
    gamma = g if use_gamma else None
    kw = dict(normalize=normalize, lam=lam)
    j = [jnp.asarray(x) for x in (q, k, v)]
    jg = None if gamma is None else jnp.asarray(gamma)
    o_ref, _, ck_ref = hla2_chunk_pallas(*j, jg, chunk=W, interpret=True,
                                         save_chunk_states=True, **kw)
    d_ref = hla2_chunk_bwd_pallas(*j, jg, jnp.asarray(do), ck_ref, chunk=W,
                                  interpret=True, **kw)
    o, _, ck = hla2_chunk_fwd(_t(q), _t(k), _t(v), _t(gamma),
                              save_chunk_states=True, **kw)
    got = hla2_chunk_bwd(_t(q), _t(k), _t(v), _t(gamma), _t(do), ck, **kw)
    assert _rel(o, o_ref) <= 1e-5
    # the reference keeps m and h as (1, d) rows
    for a, b, name in zip(ck, ck_ref, "SCmGh"):
        assert _rel(a, np.asarray(b).reshape(a.shape)) <= 1e-5, name
    assert (got[3] is None) == (gamma is None)
    for a, b, name in zip(got, d_ref, ("dq", "dk", "dv", "dgamma")):
        if b is not None:
            assert a.dtype == torch.float32
            assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


@pytest.mark.parametrize("n", [13, 70])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize,lam", [(False, 0.0), (True, 0.3)])
def test_chunk_bwd_matches_reference_vjp_ragged(rng, n, use_gamma, normalize,
                                               lam):
    q, k, v, g, do = _mk(rng, n, positive=normalize, dtype=np.float64)
    gamma = g if use_gamma else None
    kw = dict(normalize=normalize, lam=lam)

    def f(*args):
        return ref.hla2_chunk_ref(*args[:3], args[3] if use_gamma else None,
                                  chunk=W, **kw)[0]

    args = [jnp.asarray(x) for x in (q, k, v, g)]
    _, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(do))
    _, _, ck = hla2_chunk_fwd_plain(_t(q), _t(k), _t(v), _t(gamma),
                                    save_chunk_states=True, **kw)
    assert ck[0].shape == (BH, -(-n // W), D, D)
    got = hla2_chunk_bwd_plain(_t(q), _t(k), _t(v), _t(gamma), _t(do), ck,
                               **kw)
    for a, b, name in zip(got, want, ("dq", "dk", "dv", "dgamma")):
        if name == "dgamma" and not use_gamma:
            assert a is None
            continue
        assert _rel(a, b) <= 1e-9, (name, _rel(a, b))


@pytest.mark.parametrize("normalize,lam", [(False, 0.0), (True, 0.3)])
def test_hla2_attention_gradcheck(rng, normalize, lam):
    def r(*s):
        x = torch.from_numpy(rng.randn(*s) * 0.5)
        return (x.abs() if normalize else x).requires_grad_(True)

    n = W + 3  # two chunks, the second ragged
    q, k, v = r(1, 2, n, 3), r(1, 2, n, 3), r(1, 2, n, 2)
    gamma = torch.from_numpy(rng.uniform(0.85, 0.99, 2)).requires_grad_(True)

    def f(q, k, v, gamma):  # gamma (H,) broadcast to (B, H)
        return ops.hla2_attention(q, k, v, gamma, normalize=normalize,
                                  lam=lam)

    assert torch.autograd.gradcheck(f, (q, k, v, gamma), eps=1e-6,
                                    atol=1e-8, rtol=1e-6)


def test_hla2_attention_without_gamma_and_counts_no_launch(rng):
    q, k, v, _, do = (torch.from_numpy(x) for x in _mk(rng, 9))
    q, k, v = (x[None].requires_grad_(True) for x in (q, k, v))
    ops.LAUNCHES.clear()
    o = ops.hla2_attention(q, k, v)
    o_p, _ = hla2_chunk_fwd_plain(q[0], k[0], v[0])
    assert torch.equal(o[0], o_p)
    dq, = torch.autograd.grad(o, q, do[None])
    assert dq.shape == q.shape and bool(dq.isfinite().all())
    assert sum(ops.LAUNCHES.values()) == 0


def test_chunk_bwd_rejects_bad_inputs(rng):
    q, k, v, g, do = (torch.from_numpy(x) for x in _mk(rng, 9))
    _, _, ck = hla2_chunk_fwd(q, k, v, g, save_chunk_states=True)
    with pytest.raises(ValueError):
        hla2_chunk_bwd(q, k, v, g, do[:, :4], ck)
    with pytest.raises(ValueError):
        hla2_chunk_bwd(q, k, v, g, do, ck[:4])
    with pytest.raises(ValueError):  # checkpoints of another length
        hla2_chunk_bwd(q, k, v, g, do,
                       tuple(torch.cat([x, x], 1) for x in ck))
    with pytest.raises(TypeError):  # fp64 needs an fp64 gamma
        hla2_chunk_bwd(q.double(), k.double(), v.double(), g, do.double(),
                       ck)
