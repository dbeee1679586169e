"""The value-column split that the HLA2 chunk kernels rely on.

``csrc/hla2_chunk_fwd.cu`` and ``csrc/hla2_chunk_bwd.cu`` split a row over
CTAs of 32 value columns.  That is exact because chunkwise HLA2 is linear in
the value columns: here the plain versions, in fp64, run once on the whole
row and once per column slice (a tile width that does not divide dv, so the
last slice is narrower), and

- each slice's output and its columns of C, G equal the whole run's;
- S, m and h come out the same from every slice;
- the slices' dq, dk and dgamma sum to the whole run's, and their dv
  columns put side by side are the whole run's dv.

Tolerance: 1e-12 of max|whole| for the forward and 1e-10 for the summed
gradients (fp64; the sums are over up to 150 tokens of decay-weighted
products, and a narrower matrix product rounds in another order).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.hla2_chunk import (
    hla2_chunk_bwd_plain, hla2_chunk_fwd_plain)

TILE = 8  # columns per slice; dv = 20 leaves a last slice of 4
BH, D, DV = 3, 16, 20
F64 = torch.float64


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _slices():
    return [slice(e0, min(e0 + TILE, DV)) for e0 in range(0, DV, TILE)]


def _inputs(seed, n, normalize, use_gamma, with_init):
    rng = np.random.RandomState(seed)

    def rnd(*shape, scale=1.0):
        x = rng.standard_normal(shape) * scale
        # normalize divides by a sum of weights: keep it away from zero
        return torch.from_numpy(np.abs(x) if normalize else x)

    q, k = rnd(BH, n, D, scale=D**-0.5), rnd(BH, n, D, scale=D**-0.5)
    v, do = rnd(BH, n, DV), torch.from_numpy(rng.standard_normal((BH, n, DV)))
    gamma = torch.from_numpy(rng.uniform(0.9, 0.999, BH)) if use_gamma \
        else None
    init = None
    if with_init:  # the carry of an earlier prompt
        _, init = hla2_chunk_fwd_plain(
            rnd(BH, 40, D, scale=D**-0.5), rnd(BH, 40, D, scale=D**-0.5),
            rnd(BH, 40, DV), gamma)
    return q, k, v, gamma, do, init


def _slice_state(state, cols):
    S, C, m, G, h = state
    return S, C[..., cols].contiguous(), m, G[..., cols].contiguous(), h


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("n", [150, 7])
@pytest.mark.parametrize("use_gamma", [True, False])
@pytest.mark.parametrize("normalize,lam", [(False, 0.0), (False, 0.3),
                                           (True, 0.0)])
def test_column_slices_compose_the_whole(normalize, lam, use_gamma, n,
                                         with_init):
    q, k, v, gamma, do, init = _inputs(n + 10 * with_init, n, normalize,
                                       use_gamma, with_init)
    kw = dict(normalize=normalize, lam=lam)
    o, st, ck = hla2_chunk_fwd_plain(q, k, v, gamma, initial_state=init,
                                     save_chunk_states=True, **kw)
    dq, dk, dv, dg = hla2_chunk_bwd_plain(q, k, v, gamma, do, ck, **kw)
    assert o.dtype == F64 and dq.dtype == F64

    sums = [torch.zeros_like(dq), torch.zeros_like(dk)]
    dg_sum = None if gamma is None else torch.zeros_like(dg)
    dv_parts = []
    for cols in _slices():
        v_s, do_s = v[..., cols].contiguous(), do[..., cols].contiguous()
        init_s = None if init is None else _slice_state(init, cols)
        o_s, st_s, ck_s = hla2_chunk_fwd_plain(
            q, k, v_s, gamma, initial_state=init_s, save_chunk_states=True,
            **kw)
        # the slice's output and its columns of the carry and checkpoints
        assert _rel(o_s, o[..., cols]) <= 1e-12
        for a, b in zip(st_s, _slice_state(st, cols)):
            assert _rel(a, b) <= 1e-12
        for a, b in zip(ck_s, _slice_state(ck, cols)):
            assert a.shape == b.shape and _rel(a, b) <= 1e-12
        # S, m, h: the same in every slice
        for i in (0, 2, 4):
            assert _rel(st_s[i], st[i]) <= 1e-12
        g = hla2_chunk_bwd_plain(q, k, v_s, gamma, do_s, ck_s, **kw)
        sums[0] += g[0]
        sums[1] += g[1]
        dv_parts.append(g[2])
        if gamma is not None:
            dg_sum += g[3]
    assert _rel(sums[0], dq) <= 1e-10
    assert _rel(sums[1], dk) <= 1e-10
    assert _rel(torch.cat(dv_parts, -1), dv) <= 1e-12
    if gamma is not None:
        assert _rel(dg_sum, dg) <= 1e-10
