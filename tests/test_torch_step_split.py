"""The column split that the decode-step kernels rely on.

``csrc/hla2_step.cu`` and ``csrc/ahla_step.cu`` spread each row over a
cluster of N CTAs; CTA j owns column slice j of every state matrix (slices
of ceil(cols / N) columns rounded up to 4, the last narrower, some empty)
and computes everything from the old state:

- HLA2: its slice of u = q^T S1 and of S1, kC = k^T C0, q^T C0 and C1;
  then, with u gathered from all the slices (the one exchange), u^T C0,
  q^T G0, G1 and its columns of the output; rank 0 alone writes m1 and h1
  from the old m and h;
- AHLA: its columns of r = q^T P1, P1, E1, R1 and the output, with s and
  den recomputed in every slice; rank 0 alone writes m1 and n1.

Here a function mirrors that work per slice, in fp64 on the CPU, and is
held against the plain versions over 4 consecutive steps from a prefilled
state, at 1e-12 of max|plain| (fp64; only the summation order differs).
d = 20 and dv = 12 make ragged slices (and an empty one at N = 4).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ahla_chunk import ahla_chunk_fwd_plain
from repro_torch.kernels.decode_step import (
    _check_cuda_shape, ahla_step_plain, hla2_step_plain)
from repro_torch.kernels.hla2_chunk import hla2_chunk_fwd_plain

BH, D, DV = 3, 20, 12
STEPS = 4
EPS = 1e-6


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _slices(cols, n):
    """The kernels' split: slice_width and slice_of in step_cluster.cuh."""
    cw = (-(-cols // n) + 3) // 4 * 4
    out = []
    for j in range(n):
        c0 = min(j * cw, cols)
        out.append(slice(c0, c0 + min(cw, cols - c0)))
    return out


def _rnd(rng, positive, *shape, scale=1.0):
    x = rng.standard_normal(shape) * scale
    # normalize divides by a sum of weights: keep it away from zero
    return torch.from_numpy(np.abs(x) if positive else x)


def _tokens(rng, positive):
    """STEPS tokens of q, k (BH, D) and v (BH, DV)."""
    return [(_rnd(rng, positive, BH, D, scale=D**-0.5),
             _rnd(rng, positive, BH, D, scale=D**-0.5),
             _rnd(rng, positive, BH, DV)) for _ in range(STEPS)]


def _dot(x, y):
    return (x * y).sum(-1)


def hla2_split_step(state, q, k, v, gamma, n, normalize, lam):
    """One HLA2 token as the kernel's n CTAs compute it.  Returns the new
    state and o; ``state`` is not modified."""
    S0, C0, m0, G0, h0 = state
    g = torch.ones(BH, dtype=q.dtype) if gamma is None else gamma
    gv, gm = g[:, None], g[:, None, None]
    km, qk, qq = _dot(k, m0), _dot(q, k), _dot(q, q)
    qm, qh = _dot(q, m0), _dot(q, h0)
    S1, C1, G1 = (torch.empty_like(x) for x in (S0, C0, G0))
    u = torch.empty_like(q)
    for B in _slices(D, n):  # before the exchange: S, this slice of u
        u[:, B] = gv * torch.einsum("ra,rab->rb", q, S0[:, :, B]) \
            + qk[:, None] * k[:, B]
        S1[:, :, B] = gm * S0[:, :, B] + k[:, :, None] * k[:, None, B]
    # after the exchange every slice has all of u
    uq, um = _dot(u, q), _dot(u, m0)
    den = (g * um + uq) - (g * g * qh + g * qk * km) \
        + lam * (g * qm + qq) + EPS
    o = torch.empty_like(v)
    for E in _slices(DV, n):
        kC = torch.einsum("ra,rae->re", k, C0[:, :, E])
        qC = torch.einsum("ra,rae->re", q, C0[:, :, E])
        uC = torch.einsum("ra,rae->re", u, C0[:, :, E])
        qG = torch.einsum("ra,rae->re", q, G0[:, :, E])
        C1[:, :, E] = gm * C0[:, :, E] + q[:, :, None] * v[:, None, E]
        G1[:, :, E] = gm**2 * G0[:, :, E] \
            + gm * k[:, :, None] * kC[:, None, :]
        num = (gv * uC + uq[:, None] * v[:, E]) \
            - (gv**2 * qG + (g * qk)[:, None] * kC) \
            + lam * (gv * qC + qq[:, None] * v[:, E])
        o[:, E] = num / den[:, None] if normalize else num
    # rank 0, after the cluster barrier, from the old m and h
    m1 = gv * m0 + q
    h1 = gv**2 * h0 + gv * k * km[:, None]
    return (S1, C1, m1, G1, h1), o


def ahla_split_step(state, q, k, v, gamma, n, normalize):
    """One AHLA token as the kernel's n CTAs compute it.  Returns the new
    state and o; ``state`` is not modified."""
    R0, P0, m0, E0, n0 = state
    g = torch.ones(BH, dtype=q.dtype) if gamma is None else gamma
    gv, gm = g[:, None], g[:, None, None]
    qk, qm, qn = _dot(q, k), _dot(q, m0), _dot(q, n0)
    s = g * qm + qk  # every slice recomputes s and den
    den = g * qn + s * qk + EPS
    R1, P1, E1 = (torch.empty_like(x) for x in (R0, P0, E0))
    o = torch.empty_like(v)
    for E in _slices(DV, n):
        r = gv * torch.einsum("ra,rae->re", q, P0[:, :, E]) \
            + qk[:, None] * v[:, E]
        P1[:, :, E] = gm * P0[:, :, E] + k[:, :, None] * v[:, None, E]
        E1[:, :, E] = gm * E0[:, :, E] + k[:, :, None] * r[:, None, :]
        x = gv * torch.einsum("ra,rae->re", q, E0[:, :, E]) \
            + qk[:, None] * r
        o[:, E] = x / den[:, None] if normalize else x
    for Cc in _slices(D, n):
        R1[:, :, Cc] = R0[:, :, Cc] + k[:, :, None] * q[:, None, Cc]
    # rank 0, after the cluster barrier, from the old m and n
    m1 = gv * m0 + k
    n1 = gv * n0 + s[:, None] * k
    return (R1, P1, m1, E1, n1), o


def _gamma(rng, use_gamma):
    return torch.from_numpy(rng.uniform(0.9, 0.999, BH)) if use_gamma \
        else None


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("use_gamma", [True, False])
@pytest.mark.parametrize("normalize,lam", [(False, 0.0), (True, 0.0),
                                           (True, 0.3)])
def test_hla2_column_slices_compose_the_step(n, use_gamma, normalize, lam):
    rng = np.random.RandomState(10 * n + 2 * use_gamma + normalize)
    gamma = _gamma(rng, use_gamma)
    _, prior = hla2_chunk_fwd_plain(
        _rnd(rng, normalize, BH, 40, D, scale=D**-0.5),
        _rnd(rng, normalize, BH, 40, D, scale=D**-0.5),
        _rnd(rng, normalize, BH, 40, DV), gamma)
    assert prior[0].dtype == torch.float64
    split = tuple(prior)
    plain = tuple(x.clone() for x in prior)
    for q, k, v in _tokens(rng, normalize):
        split, o = hla2_split_step(split, q, k, v, gamma, n, normalize, lam)
        o_p = hla2_step_plain(plain, q, k, v, gamma, normalize=normalize,
                              eps=EPS, lam=lam)
        assert _rel(o, o_p) <= 1e-12
        for a, b in zip(split, plain):
            assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("use_gamma", [True, False])
@pytest.mark.parametrize("normalize", [False, True])
def test_ahla_column_slices_compose_the_step(n, use_gamma, normalize):
    rng = np.random.RandomState(10 * n + 2 * use_gamma + normalize + 100)
    gamma = _gamma(rng, use_gamma)
    qp = _rnd(rng, normalize, BH, 40, D, scale=D**-0.5)
    kp = _rnd(rng, normalize, BH, 40, D, scale=D**-0.5)
    _, (P, m, E, nn) = ahla_chunk_fwd_plain(
        qp, kp, _rnd(rng, normalize, BH, 40, DV), gamma)
    prior = (kp.mT @ qp, P, m, E, nn)  # R = K^T Q, as ops.ahla_prefill
    assert P.dtype == torch.float64
    split = prior
    plain = tuple(x.clone() for x in prior)
    for q, k, v in _tokens(rng, normalize):
        split, o = ahla_split_step(split, q, k, v, gamma, n, normalize)
        o_p = ahla_step_plain(plain, q, k, v, gamma, normalize=normalize,
                              eps=EPS)
        assert _rel(o, o_p) <= 1e-12
        for a, b in zip(split, plain):
            assert _rel(a, b) <= 1e-12


def test_slices_cover_the_columns_once():
    for cols in (4, 12, 16, 20, 40, 72, 128):
        for n in (1, 3, 4, 8):
            sl = _slices(cols, n)
            assert len(sl) == n
            assert [c for s in sl for c in range(cols)[s]] == list(range(cols))
            assert all(s.start % 4 == 0 for s in sl)


def test_cuda_shape_check_refuses_what_the_kernels_cannot_copy():
    state = [torch.zeros(8) for _ in range(5)]
    _check_cuda_shape("k", 128, 128, state)  # hla-1b's heads pass
    _check_cuda_shape("k", 72, 40, state)
    for d, dv in ((6, 8), (8, 6), (260, 8), (8, 1028)):
        with pytest.raises(ValueError, match="multiples of 4"):
            _check_cuda_shape("k", d, dv, state)
    misaligned = state[:4] + [torch.zeros(9)[1:]]  # 4 bytes past the start
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_cuda_shape("k", 16, 16, misaligned)
