"""Asymmetric Higher-order Linear Attention (AHLA), paper Section 6, in
PyTorch.

    AHLA(Q,K,V) = ((A A) . L) V,   A = L . (Q K^T)

Since A is lower-triangular, (A A) is already causal; the operator factors
as two first-order passes, ``o = A (A V)``, i.e. ``LinAttn(q, k, LinAttn(q,
k, v))``.  Twin of ``repro/core/ahla.py`` for the two forms the serving
path needs: the streaming recurrence (``ahla_step``, Algorithm 2, decode)
and the chunkwise form (``ahla_chunkwise``, prefill).

The state carries, besides the streaming ``(P, m, E, n)`` of Algorithm 2,
the *undecayed* cross moment ``R = sum_i k_i q_i^T`` that the reference's
associative scan composes with (its decay erratum: the paper's decayed
``R_B`` breaks associativity).  No output reads ``R``; the port keeps it
leaf for leaf with the reference's ``AHLAState``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
