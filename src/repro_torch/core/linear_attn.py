"""First-order (identity feature map) linear attention, in PyTorch.

Twin of ``repro/core/linear_attn.py``: the Section 2.2 baseline (the
``linattn`` record), and the inner pass of AHLA (= LinAttn o LinAttn,
``core/ahla.py``) and of the exact third order (= HLA2 o LinAttn,
``core/hla3.py``):

    o_t = sum_{j<=t} gamma^(t-j) (q_t . k_j) v_j      (masked, decayed)

State: P = sum g^(t-j) k_j v_j^T  (d, dv),  m = sum g^(t-j) k_j  (d,).
State math runs in fp32 for bf16/fp32 inputs and in fp64 for fp64 inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.chunk_math import decay_mats
from .hla2 import _compute_dtype, _gamma_arr


class LinAttnState(NamedTuple):
    P: torch.Tensor  # (..., d, dv)
    m: torch.Tensor  # (..., d)


def linattn_init_state(batch_shape, d: int, dv: int, dtype=torch.float32,
                       device="cpu") -> LinAttnState:
    batch_shape = tuple(batch_shape)
    return LinAttnState(
        P=torch.zeros(batch_shape + (d, dv), dtype=dtype, device=device),
        m=torch.zeros(batch_shape + (d,), dtype=dtype, device=device))


def linattn_step(state: LinAttnState, q_t, k_t, v_t, gamma=None, *,
                 normalize: bool = False, eps: float = 1e-6):
    """One token.  Returns ``(new_state, o_t)``; ``state`` is not
    modified."""
    dtype = state.P.dtype
    q, k, v = (x.to(dtype) for x in (q_t, k_t, v_t))
    g = _gamma_arr(gamma, q.shape[:-1], dtype, q.device)
    P = g[..., None, None] * state.P + k[..., :, None] * v[..., None, :]
    m = g[..., None] * state.m + k
    o = torch.einsum("...d,...de->...e", q, P)
    if normalize:
        o = o / ((q * m).sum(-1)[..., None] + eps)
    return LinAttnState(P, m), o


def linattn_naive(q, k, v, gamma=None, *, normalize: bool = False,
                  eps: float = 1e-6):
    """Materialized oracle: ``o = ((Q K^T) . L_gamma) V``."""
    dtype = _compute_dtype(q)
    q, k, v32 = (x.to(dtype) for x in (q, k, v))
    g = _gamma_arr(gamma, q.shape[:-2], dtype, q.device)
    Lg, _, _ = decay_mats(q.shape[-2], g)
    A = (q @ k.mT) * Lg
    num = A @ v32
    if normalize:
        num = num / (A.sum(-1)[..., None] + eps)
    return num.to(v.dtype)


def linattn_chunkwise(q, k, v, gamma=None, *, chunk: int = 64,
                      normalize: bool = False, eps: float = 1e-6,
                      state: Optional[LinAttnState] = None):
    """Chunkwise masked linear attention.  Returns ``(o, final_state)``,
    ``o`` in ``v.dtype``.

    Per chunk: ``o_t = g^t q_t P0 + row_t[(Q K^T . Lg) V]``, carry
    ``P1 = g^w P0 + sum_j g^(w-1-j) k_j v_j^T``.  A ragged tail is one
    shorter last chunk (its own decay powers): no zero padding, so no
    division by gamma^pad afterwards.
    """
    dtype = _compute_dtype(q)
    batch = q.shape[:-2]
    n, d = q.shape[-2], q.shape[-1]
    dv = v.shape[-1]
    if n == 0:
        raise ValueError("linattn_chunkwise needs at least one token")
    g = _gamma_arr(gamma, batch, dtype, q.device)
    if state is None:
        state = linattn_init_state(batch, d, dv, dtype, q.device)
    P, m = (x.to(dtype) for x in state)
    outs = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        Q, K, V = (x[..., sl, :].to(dtype) for x in (q, k, v))
        w = Q.shape[-2]
        Lg, pow_t, pow_rev = decay_mats(w, g)
        A = (Q @ K.mT) * Lg
        num = pow_t[..., None] * (Q @ P) + A @ V
        if normalize:
            den = pow_t * (Q @ m[..., None])[..., 0] + A.sum(-1)
            outs.append(num / (den[..., None] + eps))
        else:
            outs.append(num)
        rho = torch.exp(torch.log(g) * w)
        Kg = pow_rev[..., None] * K
        P = rho[..., None, None] * P + Kg.mT @ V
        m = rho[..., None] * m + Kg.sum(-2)
    return torch.cat(outs, -2).to(v.dtype), LinAttnState(P, m)


def linattn(q, k, v, gamma=None, *, impl: str = "chunkwise", chunk: int = 64,
            normalize: bool = False, eps: float = 1e-6,
            state: Optional[LinAttnState] = None):
    """Dispatch front end.  Returns ``(o, final_state)`` (None for
    ``naive``)."""
    if impl == "chunkwise":
        return linattn_chunkwise(q, k, v, gamma, chunk=chunk,
                                 normalize=normalize, eps=eps, state=state)
    if impl == "naive":
        return linattn_naive(q, k, v, gamma, normalize=normalize,
                             eps=eps), None
    raise ValueError(f"unknown impl {impl!r}")
