"""The port's AHLA backward vs autograd and vs the reference.

* ``ahla_chunk_math_bwd`` (the hand-derived adjoint) against
  ``torch.autograd`` of the port's own ``ahla_chunk_math``, fp64, every
  cotangent (output and both carry leaves) random: relative error <= 1e-12
  of max|autograd|.
* The forward's checkpoints and ``ahla_chunk_bwd`` (its plain version, on
  CPU tensors) against ``ahla_chunk_pallas(save_chunk_states=True)`` and
  ``ahla_chunk_bwd_pallas`` in interpret mode, and against
  ``ref.ahla_chunk_bwd_ref``, chunk 64 on every side, n a multiple of 64:
  fp32 on every side, 1e-5 of max|reference|.
* At ragged n, in fp64: the checkpoints against the reference's carry after
  each whole chunk, and the gradients against ``jax.vjp`` of
  ``ref.ahla_chunk_ref``.  The reference pads the tail and divides gamma^pad
  back out, the port runs a shorter last chunk, so the two differ by fp64
  rounding: 1e-9.
* ``torch.autograd.gradcheck`` of ``ops.ahla_attention`` in fp64.

Normalized cases use positive inputs so the denominators stay away from 0.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ahla_chunk import ahla_chunk_bwd_pallas, ahla_chunk_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.ahla_chunk import (
    W, ahla_chunk_bwd, ahla_chunk_bwd_plain, ahla_chunk_fwd,
    ahla_chunk_fwd_plain)
from repro_torch.kernels.chunk_math import ahla_chunk_math, ahla_chunk_math_bwd

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
def test_chunk_math_bwd_matches_autograd(rng, w, use_gamma, normalize):
    def r(*s, scale=0.5):
        x = torch.from_numpy(rng.randn(2, *s) * scale)
        return x.abs() if normalize else x

    Q, K, V = r(w, D), r(w, D), r(w, DV)
    state = (r(D, DV + 1), r(D, DV + 1, scale=0.05))
    g = torch.from_numpy(rng.uniform(0.85, 0.99, 2) if use_gamma
                         else np.ones(2))
    ins = [x.clone().requires_grad_(True) for x in (Q, K, V, *state, g)]
    o, st1 = ahla_chunk_math(*ins[:3], tuple(ins[3:5]), ins[5],
                             normalize=normalize, eps=1e-6)
    dO = torch.from_numpy(rng.randn(*o.shape))
    dst1 = tuple(torch.from_numpy(rng.randn(*x.shape)) for x in st1)
    want = torch.autograd.grad((o, *st1), ins, (dO, *dst1))
    dQ, dK, dV, dst0, dg = ahla_chunk_math_bwd(
        Q, K, V, state, g, dO, dst1, normalize=normalize, eps=1e-6)
    for got, exp, name in zip((dQ, dK, dV, *dst0, dg), want,
                              ("dQ", "dK", "dV", "dP", "dE", "dg")):
        assert got.shape == exp.shape, name
        assert _rel(got, exp) <= 1e-12, (name, _rel(got, exp))


def test_den_cotangents_stay_zero_unnormalised(rng):
    """Unnormalised, a zero den-column cotangent of the outgoing carry
    gives a zero one for the incoming carry: the kernel can leave that
    column out of its walk."""
    def r(*s):
        return torch.from_numpy(rng.randn(2, *s) * 0.5)

    Q, K, V = r(W, D), r(W, D), r(W, DV)
    dst1 = tuple(torch.cat([r(D, DV), torch.zeros(2, D, 1, dtype=Q.dtype)],
                           -1) for _ in range(2))
    g = torch.full((2,), 0.9, dtype=Q.dtype)
    *_, dst0, _ = ahla_chunk_math_bwd(
        Q, K, V, (r(D, DV + 1), r(D, DV + 1)), g, r(W, DV), dst1,
        normalize=False, eps=1e-6)
    for x in dst0:
        assert torch.equal(x[..., DV], torch.zeros_like(x[..., DV]))


@pytest.mark.parametrize("n", [W, 2 * W])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_chunk_bwd_matches_pallas(rng, n, use_gamma, normalize):
    q, k, v, g, do = _mk(rng, n, positive=normalize)
    gamma = g if use_gamma else None
    j = [jnp.asarray(x) for x in (q, k, v)]
    jg = None if gamma is None else jnp.asarray(gamma)
    o_ref, _, ck_ref = ahla_chunk_pallas(*j, jg, chunk=W, interpret=True,
                                         save_chunk_states=True,
                                         normalize=normalize)
    d_ref = ahla_chunk_bwd_pallas(*j, jg, jnp.asarray(do), ck_ref, chunk=W,
                                  interpret=True, normalize=normalize)
    d_oracle = ref.ahla_chunk_bwd_ref(*j, jg, jnp.asarray(do), chunk=W,
                                      normalize=normalize)
    o, _, ck = ahla_chunk_fwd(_t(q), _t(k), _t(v), _t(gamma),
                              save_chunk_states=True, normalize=normalize)
    got = ahla_chunk_bwd(_t(q), _t(k), _t(v), _t(gamma), _t(do), ck,
                         normalize=normalize)
    assert _rel(o, o_ref) <= 1e-5
    for a, b, name in zip(ck, ck_ref, ("[P|m]", "[E|n]")):
        assert a.shape == b.shape == (BH, n // W, D, DV + 1), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5 * np.abs(b).max() + 1e-30)
    assert (got[3] is None) == (gamma is None)
    for want in (d_ref, d_oracle):
        for a, b, name in zip(got, want, ("dq", "dk", "dv", "dgamma")):
            if b is not None:
                assert a.dtype == torch.float32
                assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


@pytest.mark.parametrize("n", [13, 70])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_chunk_bwd_matches_reference_vjp_ragged(rng, n, use_gamma,
                                               normalize):
    q, k, v, g, do = _mk(rng, n, positive=normalize, dtype=np.float64)
    gamma = g if use_gamma else None
    kw = dict(normalize=normalize)

    def f(*args):
        return ref.ahla_chunk_ref(*args[:3], args[3] if use_gamma else None,
                                  chunk=W, **kw)[0]

    args = [jnp.asarray(x) for x in (q, k, v, g)]
    _, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(do))
    _, _, ck = ahla_chunk_fwd_plain(_t(q), _t(k), _t(v), _t(gamma),
                                    save_chunk_states=True, **kw)
    assert ck[0].shape == (BH, -(-n // W), D, DV + 1)
    # the reference's carry after each whole chunk: chunk c's checkpoint
    for c in range(1, ck[0].shape[1]):
        _, (P, m, E, nn) = ref.ahla_chunk_ref(
            *(x[:, :c * W] for x in args[:3]), args[3] if use_gamma else None,
            chunk=W, **kw)
        for got, (X, x) in zip(ck, ((P, m), (E, nn))):
            assert _rel(got[:, c], np.concatenate([X, x[..., None]], -1)) \
                <= 1e-9
    assert not ck[0][:, 0].any() and not ck[1][:, 0].any()
    got = ahla_chunk_bwd_plain(_t(q), _t(k), _t(v), _t(gamma), _t(do), ck,
                               **kw)
    for a, b, name in zip(got, want, ("dq", "dk", "dv", "dgamma")):
        if name == "dgamma" and not use_gamma:
            assert a is None
            continue
        assert _rel(a, b) <= 1e-9, (name, _rel(a, b))


@pytest.mark.parametrize("normalize", [False, True])
def test_ahla_attention_gradcheck(rng, normalize):
    def r(*s):
        x = torch.from_numpy(rng.randn(*s) * 0.5)
        return (x.abs() if normalize else x).requires_grad_(True)

    n = W + 3  # two chunks, the second ragged
    q, k, v = r(1, 2, n, 3), r(1, 2, n, 3), r(1, 2, n, 2)
    gamma = torch.from_numpy(rng.uniform(0.85, 0.99, 2)).requires_grad_(True)

    def f(q, k, v, gamma):  # gamma (H,) broadcast to (B, H)
        return ops.ahla_attention(q, k, v, gamma, normalize=normalize)

    assert torch.autograd.gradcheck(f, (q, k, v, gamma), eps=1e-6,
                                    atol=1e-8, rtol=1e-6)


def test_ahla_attention_without_gamma_and_counts_no_launch(rng):
    q, k, v, _, do = (torch.from_numpy(x) for x in _mk(rng, 9))
    q, k, v = (x[None].requires_grad_(True) for x in (q, k, v))
    ops.LAUNCHES.clear()
    o = ops.ahla_attention(q, k, v)
    o_p, _ = ahla_chunk_fwd_plain(q[0], k[0], v[0])
    assert torch.equal(o[0], o_p)
    dq, dv = torch.autograd.grad(o, (q, v), do[None])
    assert dq.shape == q.shape and bool(dq.isfinite().all())
    assert dv.shape == v.shape and bool(dv.isfinite().all())
    assert sum(ops.LAUNCHES.values()) == 0


def test_chunk_bwd_rejects_bad_inputs(rng):
    q, k, v, g, do = (torch.from_numpy(x) for x in _mk(rng, 9))
    _, _, ck = ahla_chunk_fwd(q, k, v, g, save_chunk_states=True)
    with pytest.raises(ValueError):
        ahla_chunk_bwd(q, k, v, g, do[:, :4], ck)
    with pytest.raises(ValueError, match=r"\[P \| m\], \[E \| n\]"):
        ahla_chunk_bwd(q, k, v, g, do, ck[:1])
    with pytest.raises(ValueError):  # checkpoints of another length
        ahla_chunk_bwd(q, k, v, g, do,
                       tuple(torch.cat([x, x], 1) for x in ck))
    with pytest.raises(ValueError):  # the den column missing
        ahla_chunk_bwd(q, k, v, g, do, tuple(x[..., :-1] for x in ck))
    with pytest.raises(TypeError):  # fp64 needs an fp64 gamma
        ahla_chunk_bwd(q.double(), k.double(), v.double(), g, do.double(),
                       ck)
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        ahla_chunk_bwd(*(x.to("meta") for x in (q, k, v, g, do)),
                       tuple(x.to("meta") for x in ck))
