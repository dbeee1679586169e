"""Second-order Higher-order Linear Attention (HLA2), in PyTorch.

Twin of ``repro/core/hla2.py`` for the two forms the serving path needs:
the streaming recurrence (``hla2_step``, decode) and the chunkwise form
(``hla2_chunkwise``, prefill).  The decay algebra is the reference's
corrected one, not the paper's printed Section 4.2 monoid: with
``g = gamma``,

    S_t = g S_{t-1} + k_t k_t^T          C_t = g C_{t-1} + q_t v_t^T
    m_t = g m_{t-1} + q_t
    G_t = g^2 G_{t-1} + g * k_t (k_t^T C_{t-1})
    h_t = g^2 h_{t-1} + g * k_t (k_t^T m_{t-1})

and a segment of length L composes with rho = g^L (rho^2 on G, h).

Functions take ``q, k: (..., n, d)`` / ``v: (..., n, dv)`` with any leading
batch dims and a ``gamma`` broadcastable to them.  State math runs in fp32
for bf16/fp32 inputs and in fp64 for fp64 inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.chunk_math import hla2_chunk_math


class HLA2State(NamedTuple):
    """Constant-size per-head state tuple."""

    S: torch.Tensor  # (..., d, d)   prefix key second moment
    C: torch.Tensor  # (..., d, dv)  query-value accumulator
    m: torch.Tensor  # (..., d)      query mass
    G: torch.Tensor  # (..., d, dv)  masked cross summary
    h: torch.Tensor  # (..., d)      masked cross summary


def hla2_init_state(batch_shape, d: int, dv: int, dtype=torch.float32,
                    device="cpu") -> HLA2State:
    batch_shape = tuple(batch_shape)

    def z(*s):
        return torch.zeros(batch_shape + s, dtype=dtype, device=device)

    return HLA2State(S=z(d, d), C=z(d, dv), m=z(d), G=z(d, dv), h=z(d))


def _gamma_arr(gamma, batch_shape, dtype, device):
    if gamma is None:
        return torch.ones(batch_shape, dtype=dtype, device=device)
    g = torch.as_tensor(gamma, dtype=dtype, device=device)
    return g.broadcast_to(batch_shape)


def _compute_dtype(x: torch.Tensor):
    return torch.promote_types(x.dtype, torch.float32)


def hla2_step(state: HLA2State, q_t, k_t, v_t, gamma=None, *,
              normalize: bool = False, eps: float = 1e-6, lam: float = 0.0):
    """One token of the masked streaming recurrence.  Returns
    ``(new_state, o_t)`` with ``o_t`` in the state dtype; ``state`` is not
    modified."""
    dtype = state.S.dtype
    q, k, v = (x.to(dtype) for x in (q_t, k_t, v_t))
    g = _gamma_arr(gamma, q.shape[:-1], dtype, q.device)
    gv, gm = g[..., None], g[..., None, None]

    # cross summaries first: they consume the *previous* C, m
    kC = torch.einsum("...d,...de->...e", k, state.C)
    km = (k * state.m).sum(-1)
    G = gm**2 * state.G + gm * k[..., :, None] * kC[..., None, :]
    h = gv**2 * state.h + gv * k * km[..., None]

    S = gm * state.S + k[..., :, None] * k[..., None, :]
    C = gm * state.C + q[..., :, None] * v[..., None, :]
    m = gv * state.m + q

    u = torch.einsum("...d,...de->...e", q, S)
    num = torch.einsum("...d,...de->...e", u, C) - torch.einsum(
        "...d,...de->...e", q, G
    )
    if lam:
        num = num + lam * torch.einsum("...d,...de->...e", q, C)
    o = num
    if normalize:
        den = (u * m).sum(-1) - (q * h).sum(-1)
        if lam:
            den = den + lam * (q * m).sum(-1)
        o = num / (den[..., None] + eps)
    return HLA2State(S, C, m, G, h), o


def hla2_chunkwise(q, k, v, gamma=None, *, chunk: int = 64,
                   normalize: bool = False, eps: float = 1e-6,
                   lam: float = 0.0, state: Optional[HLA2State] = None):
    """Chunkwise masked HLA2: intra-chunk matmuls, carried state.  Returns
    ``(o, final_state)``, ``o`` in ``v.dtype``.

    ``state`` resumes from a carry.  A ragged tail is one shorter last
    chunk (its own decay powers, rho = gamma^len): no zero padding, so no
    division by gamma^pad afterwards.
    """
    dtype = _compute_dtype(q)
    batch = q.shape[:-2]
    n, d = q.shape[-2], q.shape[-1]
    dv = v.shape[-1]
    if n == 0:
        raise ValueError("hla2_chunkwise needs at least one token")
    g = _gamma_arr(gamma, batch, dtype, q.device)
    if state is None:
        state = hla2_init_state(batch, d, dv, dtype, q.device)
    st = tuple(x.to(dtype) for x in state)
    outs = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        o, st = hla2_chunk_math(
            q[..., sl, :].to(dtype), k[..., sl, :].to(dtype),
            v[..., sl, :].to(dtype), st, g,
            normalize=normalize, eps=eps, lam=lam,
        )
        outs.append(o)
    return torch.cat(outs, -2).to(v.dtype), HLA2State(*st)
