"""Second-order Higher-order Linear Attention (HLA2), in PyTorch.

Twin of ``repro/core/hla2.py``, in four exactly-equivalent forms:

* ``hla2_naive``     -- view (B): the materialized n x n masked weights,
                        O(n^2); test oracle only;
* ``hla2_serial``    -- view (A): the streaming recurrence (``hla2_step``,
                        the decode path) over every token;
* ``hla2_scan``      -- view (C), paper-faithful: a token-level associative
                        scan (``core/_scan.py``) with the masked monoid of
                        Eq. (4.1) (``masked_op``; ``masked_op_decay`` with
                        decay); materializes (n, ..., d, d) prefixes;
* ``hla2_chunkwise`` -- view (C), chunked: intra-chunk masked matmuls and a
                        sequential inter-chunk carry (prefill, training).

The decay algebra is the reference's corrected one, not the paper's
printed Section 4.2 monoid (kept as ``masked_op_decay_paper`` for the
property test that shows it is not associative): with ``g = gamma``,

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

from ..kernels.chunk_math import decay_mats, hla2_chunk_math
from ._scan import associative_scan


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


def hla2_serial(q, k, v, gamma=None, *, normalize: bool = False,
                eps: float = 1e-6, lam: float = 0.0,
                state: Optional[HLA2State] = None):
    """The streaming recurrence over the whole sequence (view A).  Returns
    ``(o, final_state)``, ``o`` in ``v.dtype``."""
    if state is None:
        state = hla2_init_state(q.shape[:-2], q.shape[-1], v.shape[-1],
                                _compute_dtype(q), q.device)
    outs = []
    for t in range(q.shape[-2]):
        state, o = hla2_step(state, q[..., t, :], k[..., t, :], v[..., t, :],
                             gamma, normalize=normalize, eps=eps, lam=lam)
        outs.append(o)
    return torch.stack(outs, -2).to(v.dtype), state


def hla2_naive(q, k, v, gamma=None, *, normalize: bool = False,
               eps: float = 1e-6, lam: float = 0.0):
    """Materialized masked second-order attention (Section 3.1), the test
    oracle:

        num_t = sum_{i<=j<=t} g^{(t-i)+(t-j)} (q_t.k_i)(k_i.q_j) v_j

    (gamma None: ``row_t[((W W^T) . L) V]``, ``W = L . (Q K^T)``).
    """
    dtype = _compute_dtype(q)
    q, k, v32 = (x.to(dtype) for x in (q, k, v))
    n = q.shape[-2]
    g = _gamma_arr(gamma, q.shape[:-2], dtype, q.device)
    Lg, _, _ = decay_mats(n, g)  # g^(t-i), i <= t
    t = torch.arange(n, device=q.device)
    U = (t[:, None] <= t[None, :]).to(dtype)  # i <= j
    inner = ((q @ k.mT) * Lg) @ ((k @ q.mT) * U)
    T2 = inner * Lg
    num = T2 @ v32
    den = T2.sum(-1)
    if lam:  # ridge: + lam * first-order (q, q, v) masked linear attention
        Wqq = (q @ q.mT) * Lg
        num = num + lam * (Wqq @ v32)
        den = den + lam * Wqq.sum(-1)
    if normalize:
        num = num / (den[..., None] + eps)
    return num.to(v.dtype)


def masked_op(a: HLA2State, b: HLA2State) -> HLA2State:
    """Undecayed masked semidirect product, Eq. (4.1): A then B."""
    return HLA2State(
        S=a.S + b.S, C=a.C + b.C, m=a.m + b.m,
        G=a.G + b.G + b.S @ a.C,
        h=a.h + b.h + (b.S @ a.m[..., None])[..., 0],
    )


class HLA2DecayState(NamedTuple):
    S: torch.Tensor
    C: torch.Tensor
    m: torch.Tensor
    G: torch.Tensor
    h: torch.Tensor
    rho: torch.Tensor  # (...,) segment attenuation gamma^len


def masked_op_decay(a: HLA2DecayState, b: HLA2DecayState) -> HLA2DecayState:
    """The corrected decay-aware masked monoid (associative)."""
    rB, rBv = b.rho[..., None, None], b.rho[..., None]
    return HLA2DecayState(
        S=rB * a.S + b.S, C=rB * a.C + b.C, m=rBv * a.m + b.m,
        G=rB**2 * a.G + b.G + rB * (b.S @ a.C),
        h=rBv**2 * a.h + b.h + rBv * (b.S @ a.m[..., None])[..., 0],
        rho=a.rho * b.rho,
    )


def masked_op_decay_paper(a: HLA2DecayState,
                          b: HLA2DecayState) -> HLA2DecayState:
    """The paper's printed decay-aware masked concatenation (Section 4.2),
    kept verbatim for the property test showing it is NOT associative.
    Do not compute with it."""
    rB, rBv = b.rho[..., None, None], b.rho[..., None]
    return HLA2DecayState(
        S=rB * a.S + b.S, C=rB * a.C + b.C, m=rBv * a.m + b.m,
        G=rB * a.G + b.G + b.S @ (rB * a.C),
        h=rBv * a.h + b.h + (b.S @ (rBv * a.m)[..., None])[..., 0],
        rho=a.rho * b.rho,
    )


def hla2_scan(q, k, v, gamma=None, *, normalize: bool = False,
              eps: float = 1e-6, lam: float = 0.0,
              state: Optional[HLA2State] = None):
    """Token-level associative scan (view C, Theorem 4.1).  Returns ``(o,
    final_state)``, ``o`` in ``v.dtype``.

    Single-token segments are scanned with the masked monoid; the inclusive
    per-token states give the outputs by Theorem 3.1.  A carry ``state`` is
    folded into every prefix with one more monoid application.  It
    materializes (n, ..., d, d) prefix tensors: memory for span O(log n).
    """
    dtype = _compute_dtype(q)
    batch = q.shape[:-2]
    n, d = q.shape[-2], q.shape[-1]
    dv = v.shape[-1]
    q32, k32, v32 = (x.to(dtype).movedim(-2, 0) for x in (q, k, v))
    dS = k32[..., :, None] * k32[..., None, :]  # (n, ..., d, d)
    dC = q32[..., :, None] * v32[..., None, :]
    zG = torch.zeros((n,) + batch + (d, dv), dtype=dtype, device=q.device)
    zh = torch.zeros((n,) + batch + (d,), dtype=dtype, device=q.device)
    g = _gamma_arr(gamma, batch, dtype, q.device).expand((n,) + batch)
    if gamma is None:
        S, C, m, G, h = associative_scan(
            masked_op, HLA2State(dS, dC, q32, zG, zh))
    else:
        S, C, m, G, h, _ = associative_scan(
            masked_op_decay, HLA2DecayState(dS, dC, q32, zG, zh, g))
    if state is not None:
        a = HLA2DecayState(*(x.to(dtype) for x in state),
                           rho=torch.ones(batch, dtype=dtype,
                                          device=q.device))
        S, C, m, G, h, _ = masked_op_decay(
            a, HLA2DecayState(S, C, m, G, h, torch.cumprod(g, 0)))

    u = (q32[..., None, :] @ S)[..., 0, :]  # q^T S
    num = (u[..., None, :] @ C)[..., 0, :] - (q32[..., None, :] @ G)[..., 0, :]
    if lam:
        num = num + lam * (q32[..., None, :] @ C)[..., 0, :]
    o = num
    if normalize:
        den = (u * m).sum(-1) - (q32 * h).sum(-1)
        if lam:
            den = den + lam * (q32 * m).sum(-1)
        o = num / (den[..., None] + eps)
    return (o.movedim(0, -2).to(v.dtype),
            HLA2State(S[-1], C[-1], m[-1], G[-1], h[-1]))


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


def hla2(q, k, v, gamma=None, *, impl: str = "chunkwise", chunk: int = 64,
         normalize: bool = False, eps: float = 1e-6, lam: float = 0.0,
         state: Optional[HLA2State] = None):
    """Dispatch front end.  Returns ``(o, final_state)`` (None for
    ``naive``)."""
    kw = dict(normalize=normalize, eps=eps, lam=lam)
    if impl == "chunkwise":
        return hla2_chunkwise(q, k, v, gamma, chunk=chunk, state=state, **kw)
    if impl == "scan":
        return hla2_scan(q, k, v, gamma, state=state, **kw)
    if impl == "serial":
        return hla2_serial(q, k, v, gamma, state=state, **kw)
    if impl == "naive":
        return hla2_naive(q, k, v, gamma, **kw), None
    raise ValueError(f"unknown impl {impl!r}")
