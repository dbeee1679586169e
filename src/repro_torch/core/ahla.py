"""Asymmetric Higher-order Linear Attention (AHLA), paper Section 6, in
PyTorch.

    AHLA(Q,K,V) = ((A A) . L) V,   A = L . (Q K^T)

Since A is lower-triangular, (A A) is already causal; the operator factors
as two first-order passes, ``o = A (A V)``, i.e. ``LinAttn(q, k, LinAttn(q,
k, v))``.  Twin of ``repro/core/ahla.py``:

* ``ahla_naive``     -- the materialized oracle;
* ``ahla_serial``    -- Algorithm 2 (``ahla_step``, the decode path) over
                        every token;
* ``ahla_scan``      -- a token-level associative scan with the Eq. (6.2)
                        monoid on ``(R, P, m, E, n)`` (decay-corrected);
* ``ahla_chunkwise`` -- two chunked linear-attention passes (prefill,
                        training).

The state carries, besides the streaming ``(P, m, E, n)`` of Algorithm 2,
the *undecayed* cross moment ``R = sum_i k_i q_i^T`` that the scan
composes with (decay erratum, mirroring HLA2's: the paper's decayed
concatenation uses the decayed ``R_B`` in the cross terms, which breaks
associativity; it is kept as ``ahla_op_decay_paper`` for the property
test).  No output reads ``R``; the port keeps it leaf for leaf with the
reference's ``AHLAState``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.chunk_math import decay_mats
from ._scan import associative_scan
from .hla2 import _compute_dtype, _gamma_arr
from .linear_attn import LinAttnState, linattn_chunkwise


class AHLAState(NamedTuple):
    """Streaming state (Fig. 2(A)) + undecayed cross moment."""

    R: torch.Tensor  # (..., d, d)   sum k q^T (undecayed)
    P: torch.Tensor  # (..., d, dv)
    m: torch.Tensor  # (..., d)
    E: torch.Tensor  # (..., d, dv)
    n: torch.Tensor  # (..., d)


def ahla_init_state(batch_shape, d: int, dv: int, dtype=torch.float32,
                    device="cpu") -> AHLAState:
    batch_shape = tuple(batch_shape)

    def z(*s):
        return torch.zeros(batch_shape + s, dtype=dtype, device=device)

    return AHLAState(R=z(d, d), P=z(d, dv), m=z(d), E=z(d, dv), n=z(d))


def ahla_step(state: AHLAState, q_t, k_t, v_t, gamma=None, *,
              normalize: bool = False, eps: float = 1e-6):
    """Algorithm 2, one token; E uses the *inclusive* P_t (Theorem 6.1).
    Returns ``(new_state, o_t)`` with ``o_t`` in the state dtype; ``state``
    is not modified."""
    dtype = state.P.dtype
    q, k, v = (x.to(dtype) for x in (q_t, k_t, v_t))
    g = _gamma_arr(gamma, q.shape[:-1], dtype, q.device)
    gv, gm = g[..., None], g[..., None, None]

    P = gm * state.P + k[..., :, None] * v[..., None, :]
    m = gv * state.m + k
    r = torch.einsum("...d,...de->...e", q, P)  # q_t^T P_t
    s = (q * m).sum(-1)  # q_t^T m_t
    E = gm * state.E + k[..., :, None] * r[..., None, :]
    n = gv * state.n + s[..., None] * k
    R = state.R + k[..., :, None] * q[..., None, :]
    o = torch.einsum("...d,...de->...e", q, E)
    if normalize:
        o = o / ((q * n).sum(-1)[..., None] + eps)
    return AHLAState(R, P, m, E, n), o


def ahla_serial(q, k, v, gamma=None, *, normalize: bool = False,
                eps: float = 1e-6, state: Optional[AHLAState] = None):
    """Algorithm 2 over the whole sequence.  Returns ``(o, final_state)``,
    ``o`` in ``v.dtype``."""
    if state is None:
        state = ahla_init_state(q.shape[:-2], q.shape[-1], v.shape[-1],
                                _compute_dtype(q), q.device)
    outs = []
    for t in range(q.shape[-2]):
        state, o = ahla_step(state, q[..., t, :], k[..., t, :], v[..., t, :],
                             gamma, normalize=normalize, eps=eps)
        outs.append(o)
    return torch.stack(outs, -2).to(v.dtype), state


def ahla_naive(q, k, v, gamma=None, *, normalize: bool = False,
               eps: float = 1e-6):
    """Oracle: ``o = A_g (A_g V)`` with ``A_g = (Q K^T) . L_gamma``
    (Eq. 6.1)."""
    dtype = _compute_dtype(q)
    q, k, v32 = (x.to(dtype) for x in (q, k, v))
    g = _gamma_arr(gamma, q.shape[:-2], dtype, q.device)
    Lg, _, _ = decay_mats(q.shape[-2], g)
    A = (q @ k.mT) * Lg
    AA = A @ A
    num = AA @ v32
    if normalize:
        num = num / (AA.sum(-1)[..., None] + eps)
    return num.to(v.dtype)


class AHLADecayState(NamedTuple):
    R: torch.Tensor
    P: torch.Tensor
    m: torch.Tensor
    E: torch.Tensor
    n: torch.Tensor
    rho: torch.Tensor  # (...,) segment attenuation gamma^len


def ahla_op(a: AHLAState, b: AHLAState) -> AHLAState:
    """Undecayed concatenation, Eq. (6.2): A then B."""
    return AHLAState(
        R=a.R + b.R, P=a.P + b.P, m=a.m + b.m,
        E=a.E + b.E + b.R @ a.P,
        n=a.n + b.n + (b.R @ a.m[..., None])[..., 0],
    )


def ahla_op_decay(a: AHLADecayState, b: AHLADecayState) -> AHLADecayState:
    """Corrected decay-aware concatenation: ``R`` composes undecayed."""
    rB, rBv = b.rho[..., None, None], b.rho[..., None]
    return AHLADecayState(
        R=a.R + b.R, P=rB * a.P + b.P, m=rBv * a.m + b.m,
        E=rB * a.E + b.E + rB * (b.R @ a.P),
        n=rBv * a.n + b.n + rBv * (b.R @ a.m[..., None])[..., 0],
        rho=a.rho * b.rho,
    )


def ahla_op_decay_paper(a: AHLADecayState,
                        b: AHLADecayState) -> AHLADecayState:
    """The paper's printed decayed concatenation (Section 6.2), with the
    decayed ``R``.  Not associative: kept for the erratum property test
    only."""
    rB, rBv = b.rho[..., None, None], b.rho[..., None]
    return AHLADecayState(
        R=rB * a.R + b.R, P=rB * a.P + b.P, m=rBv * a.m + b.m,
        E=rB * a.E + b.E + b.R @ (rB * a.P),
        n=rBv * a.n + b.n + (b.R @ (rBv * a.m)[..., None])[..., 0],
        rho=a.rho * b.rho,
    )


def ahla_scan(q, k, v, gamma=None, *, normalize: bool = False,
              eps: float = 1e-6, state: Optional[AHLAState] = None):
    """Token-level associative scan under the corrected Eq. (6.2) monoid.
    Returns ``(o, final_state)``, ``o`` in ``v.dtype``; a carry ``state``
    is folded into every prefix with one more monoid application."""
    dtype = _compute_dtype(q)
    batch = q.shape[:-2]
    n = q.shape[-2]
    q32, k32, v32 = (x.to(dtype).movedim(-2, 0) for x in (q, k, v))
    dP = k32[..., :, None] * v32[..., None, :]
    # a one-token segment: E = k (q^T P_incl) = (q.k) k v^T, n likewise
    qk = (q32 * k32).sum(-1)
    g = _gamma_arr(gamma, batch, dtype, q.device).expand((n,) + batch)
    elems = AHLADecayState(k32[..., :, None] * q32[..., None, :], dP, k32,
                           qk[..., None, None] * dP, qk[..., None] * k32, g)
    R, P, m, E, nn, _ = associative_scan(ahla_op_decay, elems)
    if state is not None:
        a = AHLADecayState(*(x.to(dtype) for x in state),
                           rho=torch.ones(batch, dtype=dtype,
                                          device=q.device))
        R, P, m, E, nn, _ = ahla_op_decay(
            a, AHLADecayState(R, P, m, E, nn, torch.cumprod(g, 0)))
    o = (q32[..., None, :] @ E)[..., 0, :]
    if normalize:
        o = o / ((q32 * nn).sum(-1)[..., None] + eps)
    return (o.movedim(0, -2).to(v.dtype),
            AHLAState(R[-1], P[-1], m[-1], E[-1], nn[-1]))


def ahla_chunkwise(q, k, v, gamma=None, *, chunk: int = 64,
                   normalize: bool = False, eps: float = 1e-6,
                   state: Optional[AHLAState] = None):
    """AHLA = LinAttn(q, k, LinAttn(q, k, v)) with chunked passes.  Returns
    ``(o, final_state)``, ``o`` in ``v.dtype``.

    The ``[P | m]`` carry feeds the inner pass over ones-augmented values
    ``[v | 1]`` (its outputs are ``[r | s]``); ``[E | n]`` the outer pass
    over ``[r | s]``.  Exactly the serial recurrence (Theorem 6.1); a
    ragged tail is one shorter last chunk.
    """
    dtype = _compute_dtype(q)
    batch = q.shape[:-2]
    d, dv = q.shape[-1], v.shape[-1]
    if state is None:
        state = ahla_init_state(batch, d, dv, dtype, q.device)
    R0, P0, m0, E0, n0 = (x.to(dtype) for x in state)

    ones = torch.ones(v.shape[:-1] + (1,), dtype=dtype, device=v.device)
    v_aug = torch.cat([v.to(dtype), ones], -1)
    # the inner carry's m is unused: the ones column carries it in [P | m]
    y, inner = linattn_chunkwise(
        q, k, v_aug, gamma, chunk=chunk,
        state=LinAttnState(torch.cat([P0, m0[..., None]], -1), m0))
    y2, outer = linattn_chunkwise(
        q, k, y, gamma, chunk=chunk,
        state=LinAttnState(torch.cat([E0, n0[..., None]], -1), m0))
    num, den = y2[..., :dv], y2[..., dv]
    o = num / (den[..., None] + eps) if normalize else num
    R = R0 + k.to(dtype).mT @ q.to(dtype)
    return o.to(v.dtype), AHLAState(
        R, inner.P[..., :dv], inner.P[..., dv], outer.P[..., :dv],
        outer.P[..., dv])


def ahla(q, k, v, gamma=None, *, impl: str = "chunkwise", chunk: int = 64,
         normalize: bool = False, eps: float = 1e-6,
         state: Optional[AHLAState] = None):
    """Dispatch front end.  Returns ``(o, final_state)`` (None for
    ``naive``)."""
    kw = dict(normalize=normalize, eps=eps)
    if impl == "chunkwise":
        return ahla_chunkwise(q, k, v, gamma, chunk=chunk, state=state, **kw)
    if impl == "scan":
        return ahla_scan(q, k, v, gamma, state=state, **kw)
    if impl == "serial":
        return ahla_serial(q, k, v, gamma, state=state, **kw)
    if impl == "naive":
        return ahla_naive(q, k, v, gamma, **kw), None
    raise ValueError(f"unknown impl {impl!r}")
