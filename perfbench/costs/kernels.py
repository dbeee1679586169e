"""Least time of the HLA2 kernels at one call's shape: the operations the
algorithm needs at the card's published rates, or the bytes it must move at
the memory rate, whichever is longer.

Frozen copy of the FMA counts the port's ``chip_smoke.py`` prices its
kernels with (``chunk_fmas``, ``chunk_bwd_fmas``, ``_bound``), so that a
change to the program cannot move the yardstick.  Counts are per
(batch, head) row; the chunk kernels' schedule is ``W = 64`` tokens.
Bytes count each input read once and each output written once.
"""

from __future__ import annotations

from . import peaks

#: tokens a chunk of the kernels' schedule holds
W = 64


def _tri(x):  # entries of a causal triangle, diagonal included
    return x * (x + 1) // 2


def chunk_fmas(n, d, dv, w=W, has_init=False):
    """FMAs one row of ``hla2_chunk_fwd`` needs for bf16 inputs (gamma, no
    normalize, no lam): ``(bf16 x bf16, bf16 x fp32, fp32 x fp32)``.

    Per chunk of r tokens: only the causal triangles of the masked
    products, the upper triangle of S's update (S is symmetric), and no
    products with the carry on the first chunk when there is no initial
    state.  A product of an input with a decay-weighted term counts as
    bf16 x fp32.  The O(r d) vector terms (m, h) are left out."""
    bb = bf = ff = 0
    for c0 in range(0, n, w):
        r = min(w, n - c0)
        bb += r * r * d                   # K Q^T: both triangles are used
        ff += r * (r + 1) * (r + 2) // 6  # T3 weights, j <= i <= t
        bf += _tri(r) * dv + _tri(r - 1) * dv  # P V, N (g V)
        bf += _tri(d) * r + 2 * d * dv * r     # S, C, G updates
        if has_init or c0 > 0:
            bf += r * d * d + _tri(r) * d  # Q S0, T2 weights (Q S0) Q^T
            ff += r * d * dv               # (Q S0) C0
            bf += 2 * r * d * dv           # Q G0, K C0
    return bb, bf, ff


def chunk_bwd_fmas(n, d, dv, w=W):
    """FMAs one row of ``hla2_chunk_bwd`` needs for bf16 inputs (gamma, no
    normalize, no lam): ``(bf16 x bf16, bf16 x fp32, fp32 x fp32)``.

    Per chunk of r tokens, the products of the chunk adjoint with only the
    causal triangles of the masked ones; left out where the data makes
    them zero or unused: products with the carry on the first chunk and
    the carry cotangent it would hand back, and products with the incoming
    carry cotangent on the last chunk.  O(r d) vector terms are left
    out."""
    bb = bf = ff = 0
    for c0 in range(0, n, w):
        r = min(w, n - c0)
        first, last = c0 == 0, c0 + r == n
        bb += r * r * d + _tri(r) * dv        # K Q^T, E = dO V^T
        ff += 3 * r * (r + 1) * (r + 2) // 6  # A Bm, dA, dBm
        bf += _tri(r) * dv + 4 * _tri(r) * d  # wgt^T dO; dBm, dA into dq, dk
        if not last:  # products with the incoming carry cotangent
            bf += 3 * r * d * dv + 2 * r * d * d
            ff += r * d * dv
            bf += 2 * _tri(r - 1) * dv + 2 * _tri(r - 1) * d
            ff += _tri(r - 1) * dv
            if not first:
                bf += 2 * r * d * dv
                ff += r * d * dv
        if not first:  # products with the carry, and the cotangent of it
            bf += r * d * d + _tri(r) * d
            bf += 2 * r * d * dv
            bf += _tri(r) * d
            ff += _tri(r) * d + 2 * r * d * d
            bf += 2 * d * dv * r + d * d * r
    return bb, bf, ff


def state_bytes(rows, d, dv):
    """fp32 bytes of ``rows`` HLA2 carries ``(S, C, m, G, h)``."""
    return 4 * rows * (d * d + 2 * d * dv + 2 * d)


def least_seconds(nbytes, fmas, rows, rates=peaks.CHUNK_RATES):
    """``(seconds, "bytes" | "operations")``: ``nbytes`` at the memory rate,
    or the FMAs of ``rows`` rows, ``fmas[i]`` of them at ``rates[i]``,
    whichever is longer."""
    t_b = nbytes / peaks.HBM_BYTES_S
    t_f = 2 * rows * sum(f / r for f, r in zip(fmas, rates))
    return max(t_b, t_f), "bytes" if t_b > t_f else "operations"


def chunk_fwd_seconds(rows, n, d, dv, *, has_init=False, checkpoints=False):
    """``hla2_chunk_fwd`` over ``rows`` rows of ``n`` bf16 tokens: q, k, v
    in and o out (bf16), the final carry out, the initial carry in when
    given, every chunk's incoming carry out when ``checkpoints``, and
    gamma."""
    nbytes = 2 * rows * n * (2 * d + 2 * dv) + state_bytes(rows, d, dv) \
        + 4 * rows
    if has_init:
        nbytes += state_bytes(rows, d, dv)
    if checkpoints:
        nbytes += -(-n // W) * state_bytes(rows, d, dv)
    return least_seconds(nbytes, chunk_fmas(n, d, dv, has_init=has_init),
                         rows)


def chunk_bwd_seconds(rows, n, d, dv):
    """``hla2_chunk_bwd`` over ``rows`` rows of ``n`` bf16 tokens: q, k, v,
    do in, dq, dk, dv out (bf16), the forward's checkpoints in, gamma in
    and dgamma out."""
    nbytes = 2 * rows * n * (2 * d + 2 * dv) + 2 * rows * n * (2 * d + dv) \
        + -(-n // W) * state_bytes(rows, d, dv) + 8 * rows
    return least_seconds(nbytes, chunk_bwd_fmas(n, d, dv), rows)


def step_seconds(rows, d, dv):
    """``hla2_step`` over ``rows`` rows: the fp32 carry read and written
    once, q, k, v in and o out (bf16), gamma in; its products (2 FMAs per
    element of S, 4 per element of C, 2 per element of G) at the fp32 SIMT
    rate."""
    nbytes = 2 * state_bytes(rows, d, dv) + 2 * rows * (3 * d + dv) \
        + 4 * rows
    fmas = 2 * d * d + 6 * d * dv
    return least_seconds(nbytes, (fmas,), rows, (peaks.FP32_FLOP_S,))
