"""Third-order linear attention (paper Section 7) and its corrected exact
form, in PyTorch.  Twin of ``repro/core/hla3.py``.

Paper-faithful operators
------------------------
* ``hla3_paper_serial``    -- Algorithm 3 verbatim (state S^K, S^Q, P, m,
  G^(1..3), h^(1..3); decay placed as printed).
* ``hla3_paper_scan``      -- Algorithm 4 / Theorem 7.2: an associative scan
  (``core/_scan.py``) under the composition (7.6)-(7.7) with the segment
  maps M^KQP / M^KQm *materialized* as dense 4-/3-tensors (O(d^3 dv) per
  element, the cost the paper quotes; test-scale d only).
* ``hla3_paper_chunkwise`` -- the serving path: a sequential inter-chunk
  carry of (S^K, S^Q, P, m, F, eta); intra-chunk outputs and the (x)3 cross
  terms as masked matmuls through the scalar identities
  ``D^K Z D^P = (k^T Z k) k v^T`` and ``D^K D^Q = (k.q) k q^T``: the maps
  are applied to the carry, never materialized.  gamma = 1, as Alg. 4.

Erratum (Theorem 7.1, ``docs/DESIGN.md`` section 7.3)
-----------------------------------------------------
The paper claims Algorithm 3 computes ``row_t[((W W^T) . L)(W V)]`` with
``W = L . (Q K^T)``.  It does not: with triples (i = inner key, u = middle
query, j = value index) the target region is ``{i <= u, j <= u, u <= t}``,
while ``S S^Q P - G1 - G2 - G3`` removes the three regions where one index
is the strict unique max.  Both operators are causal and O(d^2 + d dv)
streaming; they differ.  The paper's is kept verbatim (Alg 3 == Eq 7.5 ==
Alg 4, all tested), and

* ``hla3_exact`` computes the stated target: ``(W V)_u = r_u`` is
  first-order linear attention and ``((W W^T) . L)_{t,u}`` the masked HLA2
  weight, so ``HLA3_exact(Q, K, V) = HLA2_masked(Q, K, LinAttn(Q, K, V))``,
  two chunked passes with the nested decode state
  ``HLA3ExactState(inner: LinAttnState, outer: HLA2State)``, decay per
  pass.

State math runs in fp32 for bf16/fp32 inputs and in fp64 for fp64 inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ._scan import associative_scan
from .hla2 import (
    HLA2State,
    _compute_dtype,
    _gamma_arr,
    hla2_chunkwise,
    hla2_init_state,
    hla2_naive,
    hla2_step,
)
from .linear_attn import (
    LinAttnState,
    linattn_chunkwise,
    linattn_init_state,
    linattn_naive,
    linattn_step,
)


def _zeros(batch_shape, dtype, device):
    batch_shape = tuple(batch_shape)
    return lambda *s: torch.zeros(batch_shape + s, dtype=dtype, device=device)


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _ones_col(v, dtype):
    return torch.ones(v.shape[:-1] + (1,), dtype=dtype, device=v.device)


# ===========================================================================
# Paper-faithful third order (Algorithm 3 / 4)
# ===========================================================================


class HLA3PaperState(NamedTuple):
    SK: torch.Tensor  # (..., d, d)
    SQ: torch.Tensor  # (..., d, d)
    P: torch.Tensor  # (..., d, dv)
    m: torch.Tensor  # (..., d)
    G1: torch.Tensor  # (..., d, dv)
    G2: torch.Tensor  # (..., d, dv)
    G3: torch.Tensor  # (..., d, dv)
    h1: torch.Tensor  # (..., d)
    h2: torch.Tensor  # (..., d)
    h3: torch.Tensor  # (..., d)


def hla3_paper_init_state(batch_shape, d: int, dv: int, dtype=torch.float32,
                          device="cpu") -> HLA3PaperState:
    z = _zeros(batch_shape, dtype, device)
    return HLA3PaperState(z(d, d), z(d, d), z(d, dv), z(d), z(d, dv),
                          z(d, dv), z(d, dv), z(d), z(d), z(d))


def hla3_paper_step(state: HLA3PaperState, q_t, k_t, v_t, gamma=None, *,
                    normalize: bool = False, eps: float = 1e-6):
    """Algorithm 3, one token, decay placed exactly as printed.  Returns
    ``(new_state, o_t)``; ``state`` is not modified."""
    dtype = state.SK.dtype
    q, k, v = (x.to(dtype) for x in (q_t, k_t, v_t))
    g = _gamma_arr(gamma, q.shape[:-1], dtype, q.device)
    gv, gm = g[..., None], g[..., None, None]
    SKp, SQp, Pp, mp = state.SK, state.SQ, state.P, state.m

    SK = gm * SKp + k[..., :, None] * k[..., None, :]
    SQ = gm * SQp + q[..., :, None] * q[..., None, :]
    P = gm * Pp + k[..., :, None] * v[..., None, :]
    m = gv * mp + k

    u1 = _mv(SQp, k)  # S^Q_prev k_t
    G1 = gm * state.G1 + k[..., :, None] * _mv(Pp.mT, u1)[..., None, :]
    h1 = gv * state.h1 + k * (u1 * mp).sum(-1)[..., None]
    a2 = _mv(SKp, q)  # S^K_prev q_t
    G2 = gm * state.G2 + a2[..., :, None] * _mv(Pp.mT, q)[..., None, :]
    h2 = gv * state.h2 + a2 * (q * mp).sum(-1)[..., None]
    a3 = _mv(SKp, u1)  # S^K_prev S^Q_prev k_t
    G3 = gm * state.G3 + a3[..., :, None] * v[..., None, :]
    h3 = gv * state.h3 + a3

    z = _mv(SQ, _mv(SK, q))
    o = (_mv(P.mT, z) - _mv(G1.mT, q) - _mv(G2.mT, q) - _mv(G3.mT, q))
    if normalize:
        den = (q * (_mv(SK, _mv(SQ, m)) - h1 - h2 - h3)).sum(-1)
        o = o / (den[..., None] + eps)
    return HLA3PaperState(SK, SQ, P, m, G1, G2, G3, h1, h2, h3), o


def hla3_paper_serial(q, k, v, gamma=None, *, normalize: bool = False,
                      eps: float = 1e-6,
                      state: Optional[HLA3PaperState] = None):
    """Algorithm 3 over the whole sequence.  Returns ``(o, final_state)``."""
    if state is None:
        state = hla3_paper_init_state(q.shape[:-2], q.shape[-1], v.shape[-1],
                                      _compute_dtype(q), q.device)
    outs = []
    for t in range(q.shape[-2]):
        state, o = hla3_paper_step(state, q[..., t, :], k[..., t, :],
                                   v[..., t, :], gamma, normalize=normalize,
                                   eps=eps)
        outs.append(o)
    return torch.stack(outs, -2).to(v.dtype), state


def hla3_paper_naive(q, k, v, *, normalize: bool = False, eps: float = 1e-6):
    """Region oracle for the paper's operator (gamma = 1):

        num_t = sum over triples (i, u, j) <= t with *no strict unique max*
                of (q_t.k_i)(q_u.k_i)(q_u.k_j) v_j

    O(n^3) memory: test sizes only.
    """
    dtype = _compute_dtype(q)
    q, k, v32 = (x.to(dtype) for x in (q, k, v))
    n = q.shape[-2]
    idx = torch.arange(n, device=q.device)
    i_, u_, j_ = idx[None, :, None], idx[:, None, None], idx[None, None, :]
    strict_max = (((i_ > u_) & (i_ > j_)) | ((u_ > i_) & (u_ > j_))
                  | ((j_ > i_) & (j_ > u_)))
    keep = (~strict_max).to(dtype)  # (u, i, j)
    qk = q @ k.mT  # qk[a, b] = q_a . k_b
    core = qk[..., :, :, None] * qk[..., :, None, :] * keep  # (u, i, j)
    le_t = (idx[None, :] <= idx[:, None]).to(dtype)  # [t, a] = a <= t
    tmp = torch.einsum("...ti,...uij->...tuj", qk * le_t, core)
    T = (tmp * le_t[..., None]).sum(-2) * le_t  # u <= t, then j <= t
    num = T @ v32
    if normalize:
        num = num / (T.sum(-1)[..., None] + eps)
    return num.to(v.dtype)


# ----------------------- Algorithm 4: associative scan ---------------------


class HLA3ScanState(NamedTuple):
    """Eq. (7.6)-(7.7) state with materialized segment maps:
    ``W4[a,b,c,e] = sum_t k_a k_b k_c v_e`` represents M^KQP,
    ``W3[a,b,c] = sum_t k_a k_b k_c`` represents M^KQm."""

    SK: torch.Tensor
    SQ: torch.Tensor
    P: torch.Tensor
    m: torch.Tensor
    F: torch.Tensor  # (..., d, dv) corrected state
    eta: torch.Tensor  # (..., d)
    RQP: torch.Tensor  # (..., d, dv)
    rQm: torch.Tensor  # (..., d)
    UKQ: torch.Tensor  # (..., d, d)
    W4: torch.Tensor  # (..., d, d, d, dv)
    W3: torch.Tensor  # (..., d, d, d)


def hla3_op(a: HLA3ScanState, b: HLA3ScanState) -> HLA3ScanState:
    """(x)3, Eqs. (7.6)-(7.7): A then B."""
    F = (a.F + b.F + a.SK @ b.RQP
         + torch.einsum("...abce,...bc->...ae", b.W4, a.SQ) + b.UKQ @ a.P)
    eta = (a.eta + b.eta + _mv(a.SK, b.rQm)
           + torch.einsum("...abc,...bc->...a", b.W3, a.SQ) + _mv(b.UKQ, a.m))
    return HLA3ScanState(
        SK=a.SK + b.SK, SQ=a.SQ + b.SQ, P=a.P + b.P, m=a.m + b.m, F=F,
        eta=eta, RQP=a.RQP + b.RQP, rQm=a.rQm + b.rQm, UKQ=a.UKQ + b.UKQ,
        W4=a.W4 + b.W4, W3=a.W3 + b.W3)


def hla3_paper_scan(q, k, v, *, normalize: bool = False, eps: float = 1e-6):
    """Algorithm 4 as a token-level associative scan (Theorem 7.2), with
    the segment maps materialized: O(n d^3 dv) memory, small d only.
    Returns ``o`` in ``v.dtype``."""
    dtype = _compute_dtype(q)
    q32, k32, v32 = (x.to(dtype).movedim(-2, 0) for x in (q, k, v))

    def outer(a, b):
        return a[..., :, None] * b[..., None, :]

    alpha = (q32 * k32).sum(-1)  # q_t . k_t
    DP = outer(k32, v32)
    # one token: F = D^K D^Q D^P = alpha^2 k v^T, eta = alpha^2 k
    elems = HLA3ScanState(
        SK=outer(k32, k32), SQ=outer(q32, q32), P=DP, m=k32,
        F=(alpha**2)[..., None, None] * DP, eta=(alpha**2)[..., None] * k32,
        RQP=alpha[..., None, None] * outer(q32, v32),
        rQm=alpha[..., None] * q32,
        UKQ=alpha[..., None, None] * outer(k32, q32),
        W4=torch.einsum("n...a,n...b,n...c,n...e->n...abce", k32, k32, k32,
                        v32),
        W3=torch.einsum("n...a,n...b,n...c->n...abc", k32, k32, k32))
    inc = associative_scan(hla3_op, elems)
    o = (q32[..., None, :] @ inc.F)[..., 0, :]
    if normalize:
        o = o / ((q32 * inc.eta).sum(-1)[..., None] + eps)
    return o.movedim(0, -2).to(v.dtype)


# ----------------------- chunkwise (gamma = 1) -----------------------------


class HLA3ChunkState(NamedTuple):
    SK: torch.Tensor
    SQ: torch.Tensor
    P: torch.Tensor
    m: torch.Tensor
    F: torch.Tensor
    eta: torch.Tensor


def hla3_chunk_init_state(batch_shape, d: int, dv: int, dtype=torch.float32,
                          device="cpu") -> HLA3ChunkState:
    """Zero carry for ``hla3_paper_chunkwise``: the decode state of the
    paper's operator.  Decode runs the chunkwise path at n = 1
    (``hla3_paper_chunk_step``), so prefill and decode share one layout;
    the 10-field ``HLA3PaperState`` is Algorithm 3's own form (serial
    path only)."""
    z = _zeros(batch_shape, dtype, device)
    return HLA3ChunkState(z(d, d), z(d, d), z(d, dv), z(d), z(d, dv), z(d))


def hla3_paper_chunk_step(state: HLA3ChunkState, q_t, k_t, v_t, *,
                          normalize: bool = False, eps: float = 1e-6):
    """One decode token in chunk-state space (an n = 1 chunkwise call),
    gamma = 1 as the prefill.  Returns ``(new_state, o_t)``; ``state`` is
    not modified."""
    o, new = hla3_paper_chunkwise(
        q_t[..., None, :], k_t[..., None, :], v_t[..., None, :], chunk=1,
        normalize=normalize, eps=eps, state=state)
    return new, o[..., 0, :]


def _hla3_paper_chunk(Q, K, V, state, *, normalize, eps):
    """One chunk of ``hla3_paper_chunkwise``: outputs and the (x)3 carry
    update with B = the whole chunk.  The den column rides along as a ones
    column of V (``Vb``) and as the last column of ``[P | m]``, ``[F |
    eta]``.  Per token ``alpha_u = q_u . k_u``, ``beta_u = k_u^T S^Q_A k_u``
    (carry) and ``beta_loc_u = k_u^T S^Q_{u-1, local} k_u``."""
    SA, SQA, PA, mA, FA, etaA = state
    w, dv = Q.shape[-2], V.shape[-1]
    idx = torch.arange(w, device=Q.device)
    L = (idx[:, None] >= idx[None, :]).to(Q.dtype)  # inclusive
    Lst = (idx[:, None] > idx[None, :]).to(Q.dtype)  # strictly lower
    Ust = Lst.mT  # strictly upper
    Vb = torch.cat([V, _ones_col(V, V.dtype)], -1)
    PAa = torch.cat([PA, mA[..., None]], -1)
    FAa = torch.cat([FA, etaA[..., None]], -1)

    alpha = (Q * K).sum(-1)
    beta = ((K @ SQA) * K).sum(-1)
    QK = Q @ K.mT  # [t, j] = q_t . k_j
    A = QK * L
    KQs = QK.mT * Ust  # (k_i . q_u), i < u
    Y = (QK * Lst) @ Vb  # q_u^T P_{u-1}^local
    KQl = QK.mT * Lst  # (k_u . q_j), j < u
    beta_loc = (KQl * KQl).sum(-1)
    aV, a2V = alpha[..., None] * Vb, (alpha**2)[..., None] * Vb
    bV, blV = beta[..., None] * Vb, beta_loc[..., None] * Vb
    aY = alpha[..., None] * Y
    QPA = Q @ PAa

    # local F terms (Eq. 7.5 expanded) and the carry cross terms
    W2s = (A @ KQs) * L  # q_t^T S^K_{u-1} q_u
    QSQ = (Q @ SA @ Q.mT) * L
    allt = (Q @ FAa + QSQ @ aV + W2s @ aV
            + A @ (bV + blV + aY + a2V + alpha[..., None] * QPA))
    num, den = allt[..., :dv], allt[..., dv]
    o = num / (den[..., None] + eps) if normalize else num

    # chunk summary -> new carry
    PB = K.mT @ Vb  # last column: m_B
    FB = (K.mT @ KQs) @ aV + K.mT @ (blV + aY + a2V)
    Fnew = (FAa + FB + SA @ (Q.mT @ aV) + K.mT @ bV
            + (K.mT @ (alpha[..., None] * Q)) @ PAa)
    new = HLA3ChunkState(
        SK=SA + K.mT @ K, SQ=SQA + Q.mT @ Q, P=PA + PB[..., :dv],
        m=mA + PB[..., dv], F=Fnew[..., :dv], eta=Fnew[..., dv])
    return o, new


def hla3_paper_chunkwise(q, k, v, *, chunk: int = 64, normalize: bool = False,
                         eps: float = 1e-6,
                         state: Optional[HLA3ChunkState] = None):
    """The paper's third-order operator, chunk-parallel, the maps applied
    to the carry (gamma = 1).  Returns ``(o, final_state)``, ``o`` in
    ``v.dtype``.  A ragged tail is one shorter last chunk."""
    dtype = _compute_dtype(q)
    n, d, dv = q.shape[-2], q.shape[-1], v.shape[-1]
    if n == 0:
        raise ValueError("hla3_paper_chunkwise needs at least one token")
    if state is None:
        state = hla3_chunk_init_state(q.shape[:-2], d, dv, dtype, q.device)
    st = HLA3ChunkState(*(x.to(dtype) for x in state))
    outs = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        o, st = _hla3_paper_chunk(
            *(x[..., sl, :].to(dtype) for x in (q, k, v)), st,
            normalize=normalize, eps=eps)
        outs.append(o)
    return torch.cat(outs, -2).to(v.dtype), st


# ===========================================================================
# Exact masked third order:  HLA3_exact = HLA2_masked o LinAttn
# ===========================================================================


class HLA3ExactState(NamedTuple):
    inner: LinAttnState  # (P, m) of the first-order pass over [v | 1]
    outer: HLA2State  # the second-order pass over values [r | s]


def hla3_exact_init_state(batch_shape, d: int, dv: int, dtype=torch.float32,
                          device="cpu") -> HLA3ExactState:
    return HLA3ExactState(
        inner=linattn_init_state(batch_shape, d, dv + 1, dtype, device),
        outer=hla2_init_state(batch_shape, d, dv + 1, dtype, device))


def hla3_exact_step(state: HLA3ExactState, q_t, k_t, v_t, gamma=None, *,
                    normalize: bool = False, eps: float = 1e-6):
    """One token: the first-order step over ``[v | 1]``, then the HLA2 step
    over its output.  Returns ``(new_state, o_t)``; ``state`` is not
    modified."""
    dtype = state.inner.P.dtype
    v_aug = torch.cat([v_t.to(dtype), _ones_col(v_t, dtype)], -1)
    inner, rs = linattn_step(state.inner, q_t, k_t, v_aug, gamma)
    outer, o_aug = hla2_step(state.outer, q_t, k_t, rs, gamma)
    num, den = o_aug[..., :-1], o_aug[..., -1]
    o = num / (den[..., None] + eps) if normalize else num
    return HLA3ExactState(inner, outer), o


def hla3_exact_serial(q, k, v, gamma=None, *, normalize: bool = False,
                      eps: float = 1e-6,
                      state: Optional[HLA3ExactState] = None):
    """``hla3_exact_step`` over the whole sequence.  Returns ``(o,
    final_state)``."""
    if state is None:
        state = hla3_exact_init_state(q.shape[:-2], q.shape[-1], v.shape[-1],
                                      _compute_dtype(q), q.device)
    outs = []
    for t in range(q.shape[-2]):
        state, o = hla3_exact_step(state, q[..., t, :], k[..., t, :],
                                   v[..., t, :], gamma, normalize=normalize,
                                   eps=eps)
        outs.append(o)
    return torch.stack(outs, -2).to(v.dtype), state


def hla3_exact_chunkwise(q, k, v, gamma=None, *, chunk: int = 64,
                         normalize: bool = False, eps: float = 1e-6,
                         state: Optional[HLA3ExactState] = None):
    """The exact third order as a chunked linear-attention pass then a
    chunked HLA2 pass.  Returns ``(o, final_state)``, ``o`` in
    ``v.dtype``."""
    dtype = _compute_dtype(q)
    if state is None:
        state = hla3_exact_init_state(q.shape[:-2], q.shape[-1], v.shape[-1],
                                      dtype, q.device)
    v_aug = torch.cat([v.to(dtype), _ones_col(v, dtype)], -1)
    rs, inner = linattn_chunkwise(q, k, v_aug, gamma, chunk=chunk,
                                  state=state.inner)
    o_aug, outer = hla2_chunkwise(q, k, rs, gamma, chunk=chunk,
                                  state=state.outer)
    num, den = o_aug[..., :-1], o_aug[..., -1]
    o = num / (den[..., None] + eps) if normalize else num
    return o.to(v.dtype), HLA3ExactState(inner, outer)


def hla3_exact_naive(q, k, v, gamma=None, *, normalize: bool = False,
                     eps: float = 1e-6):
    """Independent oracle: ``o = ((W W^T) . L)(W V)``, decayed per pass."""
    dtype = _compute_dtype(q)
    v_aug = torch.cat([v.to(dtype), _ones_col(v, dtype)], -1)
    o_aug = hla2_naive(q, k, linattn_naive(q, k, v_aug, gamma), gamma)
    num, den = o_aug[..., :-1], o_aug[..., -1]
    return (num / (den[..., None] + eps) if normalize else num).to(v.dtype)


def hla3(q, k, v, gamma=None, *, impl: str = "chunkwise", form: str = "exact",
         chunk: int = 64, normalize: bool = False, eps: float = 1e-6,
         state=None):
    """Front end.  ``form``: ``"exact"`` (the corrected operator; chunkwise,
    serial, naive) or ``"paper"`` (Alg. 3/4; chunkwise at gamma = 1, scan,
    serial, naive).  Returns ``(o, final_state)`` (None where the impl
    keeps no state)."""
    kw = dict(normalize=normalize, eps=eps)
    if form == "exact":
        if impl == "chunkwise":
            return hla3_exact_chunkwise(q, k, v, gamma, chunk=chunk,
                                        state=state, **kw)
        if impl == "serial":
            return hla3_exact_serial(q, k, v, gamma, state=state, **kw)
        if impl == "naive":
            return hla3_exact_naive(q, k, v, gamma, **kw), None
    elif form == "paper":
        if impl == "chunkwise":
            if gamma is not None:
                raise NotImplementedError(
                    "paper Alg. 4 chunk path is stated for gamma = 1")
            return hla3_paper_chunkwise(q, k, v, chunk=chunk, state=state,
                                        **kw)
        if impl == "scan":
            return hla3_paper_scan(q, k, v, **kw), None
        if impl == "serial":
            return hla3_paper_serial(q, k, v, gamma, state=state, **kw)
        if impl == "naive":
            return hla3_paper_naive(q, k, v, **kw), None
    raise ValueError(f"unknown impl/form {(impl, form)!r}")
