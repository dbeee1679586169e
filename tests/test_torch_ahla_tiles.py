"""The value-column split that the AHLA chunk kernels rely on.

``csrc/ahla_chunk_fwd.cu`` and ``csrc/ahla_chunk_bwd.cu`` split a row over
CTAs of 32 value columns.  Unnormalised, that is exact because chunkwise
AHLA is linear in the value columns: the carry's den column (m, n) and the
first-order den s depend on Q and K only, and every value column of R, O,
P and E on its own column of V.  Here the plain versions, in fp64, run once
on the whole row and once per column slice (a tile width that does not
divide dv, so the last slice is narrower), and

- each slice's output and its columns of P, E (final carry and
  checkpoints) equal the whole run's;
- m and n come out the same from every slice;
- the slices' dq, dk and dgamma sum to the whole run's, and their dv
  columns put side by side are the whole run's dv.

Under normalize the output divides by a den that is the same for every
slice, but the den's cotangent -rowsum(do . O) / z^2 sums over every value
column: the tiles are coupled there, which is why the backward kernel runs
a den pre-pass over the whole row first.  That path is held to its plain
version on the card (``chip_smoke.check_ahla_chunk_bwd`` at d = 128, five
column tiles), not here.

Tolerance: 1e-12 of max|whole| for the forward and the side-by-side dv,
1e-10 for the summed gradients (fp64; the sums are over up to 150 tokens
of decay-weighted products, and a narrower matrix product rounds in
another order, so not even dv is bit for bit the whole run's).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ahla_chunk import (
    ahla_chunk_bwd_plain, ahla_chunk_fwd_plain)

TILE = 8  # columns per slice; dv = 20 leaves a last slice of 4
BH, D, DV = 3, 16, 20
F64 = torch.float64


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _slices():
    return [slice(e0, min(e0 + TILE, DV)) for e0 in range(0, DV, TILE)]


def _inputs(seed, n, use_gamma, with_init):
    rng = np.random.RandomState(seed)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale)

    q, k = rnd(BH, n, D, scale=D**-0.5), rnd(BH, n, D, scale=D**-0.5)
    v, do = rnd(BH, n, DV), rnd(BH, n, DV)
    gamma = torch.from_numpy(rng.uniform(0.9, 0.999, BH)) if use_gamma \
        else None
    init = None
    if with_init:  # the carry of an earlier prompt
        _, init = ahla_chunk_fwd_plain(
            rnd(BH, 40, D, scale=D**-0.5), rnd(BH, 40, D, scale=D**-0.5),
            rnd(BH, 40, DV), gamma)
    return q, k, v, gamma, do, init


def _slice_state(state, cols):
    P, m, E, n = state
    return P[..., cols].contiguous(), m, E[..., cols].contiguous(), n


def _slice_ckpt(ck, cols):
    """A slice's checkpoints ``[P | m], [E | n]``: its value columns and the
    den column."""
    return tuple(torch.cat([x[..., cols], x[..., -1:]], -1) for x in ck)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("n", [150, 7])
@pytest.mark.parametrize("use_gamma", [True, False])
def test_column_slices_compose_the_whole(use_gamma, n, with_init):
    q, k, v, gamma, do, init = _inputs(n + 10 * with_init, n, use_gamma,
                                       with_init)
    o, st, ck = ahla_chunk_fwd_plain(q, k, v, gamma, initial_state=init,
                                     save_chunk_states=True)
    dq, dk, dv, dg = ahla_chunk_bwd_plain(q, k, v, gamma, do, ck)
    assert o.dtype == F64 and dq.dtype == F64

    sums = [torch.zeros_like(dq), torch.zeros_like(dk)]
    dg_sum = None if gamma is None else torch.zeros_like(dg)
    dv_parts = []
    for cols in _slices():
        v_s, do_s = v[..., cols].contiguous(), do[..., cols].contiguous()
        init_s = None if init is None else _slice_state(init, cols)
        o_s, st_s, ck_s = ahla_chunk_fwd_plain(
            q, k, v_s, gamma, initial_state=init_s, save_chunk_states=True)
        # the slice's output and its columns of the carry and checkpoints
        assert _rel(o_s, o[..., cols]) <= 1e-12
        for a, b in zip(st_s, _slice_state(st, cols)):
            assert _rel(a, b) <= 1e-12
        for a, b in zip(ck_s, _slice_ckpt(ck, cols)):
            assert a.shape == b.shape and _rel(a, b) <= 1e-12
        # m and n: the same in every slice
        for i in (1, 3):
            assert _rel(st_s[i], st[i]) <= 1e-12
        g = ahla_chunk_bwd_plain(q, k, v_s, gamma, do_s, ck_s)
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
