"""Port ``core/hla2.py`` and ``kernels/chunk_math.py`` vs the reference, in
fp64 on the same numpy inputs.

Tolerance: 1e-10 of max|reference| — both sides run the same algebra in
fp64 (the reference pads a ragged tail and divides gamma^pad back out,
the port runs a shorter last chunk; the two differ by fp64 rounding).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import hla2 as port
from repro_torch.kernels import chunk_math as port_cm

ref = importlib.import_module("repro.core.hla2")
ref_cm = importlib.import_module("repro.kernels.chunk_math")

TOL = 1e-10
B, H, D, DV = 2, 2, 6, 5


def _mk(rng, n, positive=False):
    def r(*s):
        x = rng.randn(*s) * 0.5
        return np.abs(x) if positive else x

    return (r(B, H, n, D), r(B, H, n, D), r(B, H, n, DV),
            rng.uniform(0.85, 0.99, (B, H)))


def _close(got, want, name, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f"{name}: {err}"


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x).copy())


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("n", [1, 16, 37])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize,lam", [(False, 0.0), (True, 0.0),
                                           (False, 0.3), (True, 0.3)])
@pytest.mark.parametrize("resume", [False, True])
def test_chunkwise_matches_reference(rng, n, use_gamma, normalize, lam,
                                     resume):
    q, k, v, g = _mk(rng, n, positive=normalize)
    gamma = g if use_gamma else None
    state = None
    if resume:
        qp, kp, vp, _ = _mk(rng, 11, positive=normalize)
        _, state = ref.hla2_chunkwise(_j(qp), _j(kp), _j(vp), _j(gamma),
                                      chunk=4)
    o_ref, st_ref = ref.hla2_chunkwise(
        _j(q), _j(k), _j(v), _j(gamma), chunk=16, normalize=normalize,
        lam=lam, state=state)
    o, st = port.hla2_chunkwise(
        _t(q), _t(k), _t(v), _t(gamma), chunk=16, normalize=normalize,
        lam=lam,
        state=None if state is None else port.HLA2State(*map(_t, state)))
    assert o.dtype == torch.float64
    _close(o, o_ref, "o")
    for got, want, name in zip(st, st_ref, "SCmGh"):
        _close(got, want, name)


@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize,lam", [(False, 0.0), (True, 0.0),
                                           (False, 0.3), (True, 0.3)])
def test_step_matches_reference(rng, use_gamma, normalize, lam):
    q, k, v, g = _mk(rng, 7, positive=normalize)
    gamma = g if use_gamma else None
    st_ref = ref.hla2_init_state((B, H), D, DV, jnp.float64)
    st = port.hla2_init_state((B, H), D, DV, torch.float64)
    for t in range(7):
        st_ref, o_ref = ref.hla2_step(
            st_ref, _j(q[:, :, t]), _j(k[:, :, t]), _j(v[:, :, t]),
            _j(gamma), normalize=normalize, lam=lam)
        st, o = port.hla2_step(
            st, _t(q[:, :, t]), _t(k[:, :, t]), _t(v[:, :, t]), _t(gamma),
            normalize=normalize, lam=lam)
        _close(o, o_ref, f"o[{t}]")
    for got, want, name in zip(st, st_ref, "SCmGh"):
        _close(got, want, name)


@pytest.mark.parametrize("use_gamma", [False, True])
def test_chunkwise_state_equals_serial_steps(rng, use_gamma):
    """Section-4 identity inside the port: the chunkwise final state is the
    serial recurrence's, across a ragged tail."""
    q, k, v, g = (torch.from_numpy(x) for x in _mk(rng, 29))
    gamma = g if use_gamma else None
    _, st_c = port.hla2_chunkwise(q, k, v, gamma, chunk=8)
    st = port.hla2_init_state((B, H), D, DV, torch.float64)
    for t in range(29):
        st, _ = port.hla2_step(st, q[:, :, t], k[:, :, t], v[:, :, t], gamma)
    for got, want, name in zip(st_c, st, "SCmGh"):
        _close(got, want.numpy(), name)


@pytest.mark.parametrize("w", [1, 8, 13])
@pytest.mark.parametrize("normalize,lam", [(False, 0.0), (True, 0.3)])
def test_chunk_math_matches_reference(rng, w, normalize, lam):
    """One chunk on one tile: the reference math is fp32 by construction,
    so this cell holds at 1e-5 of max|reference|."""
    q, k, v, _ = _mk(rng, w, positive=normalize)
    q, k, v = q[0, 0], k[0, 0], v[0, 0]
    st = [rng.randn(D, D), rng.randn(D, DV), rng.randn(D), rng.randn(D, DV),
          rng.randn(D)]
    if normalize:
        st = [np.abs(x) * 0.1 for x in st]
        st[3], st[4] = st[3] * 0.0, st[4] * 0.0
    st = [x.astype(np.float32) for x in st]
    g = np.float32(0.93)
    f32 = [x.astype(np.float32) for x in (q, k, v)]
    o_ref, st_ref = ref_cm.hla2_chunk_math(
        *map(jnp.asarray, f32),
        (jnp.asarray(st[0]), jnp.asarray(st[1]), jnp.asarray(st[2])[None],
         jnp.asarray(st[3]), jnp.asarray(st[4])[None]),
        jnp.float32(g), normalize=normalize, eps=1e-6, lam=lam)
    o, st_new = port_cm.hla2_chunk_math(
        *map(torch.from_numpy, f32), tuple(map(torch.from_numpy, st)),
        torch.tensor(g), normalize=normalize, eps=1e-6, lam=lam)
    _close(o, o_ref, "o", tol=1e-5)
    for got, want, name in zip(st_new, st_ref, "SCmGh"):
        _close(got, np.asarray(want).reshape(got.shape), name, tol=1e-5)


def test_decay_mats_matches_reference():
    g = np.float64(0.9)
    Lg, pt, pr, _ = ref_cm.decay_mats(6, jnp.float64(g), jnp.float64)
    Lg_t, pt_t, pr_t = port_cm.decay_mats(6, torch.tensor(g))
    _close(Lg_t, Lg, "Lg")
    _close(pt_t, pt, "pow_t")
    _close(pr_t, pr, "pow_rev")
