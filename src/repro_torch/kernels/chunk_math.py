"""Per-chunk HLA2 and AHLA math: one chunk of the chunkwise scheme as a
pure function ``(Q, K, V, state_in, g) -> (o, state_out)``.

Twin of ``repro/kernels/chunk_math.py``, batched over any leading dims
instead of one 2D tile, in the dtype of its inputs (fp32 for the kernels'
plain versions, fp64 in the parity tests).  The CUDA kernels
``csrc/hla2_chunk_fwd.cu`` and ``csrc/ahla_chunk_fwd.cu`` compute the same
functions, chunk by chunk.
"""

from __future__ import annotations

import torch


def decay_mats(w: int, g: torch.Tensor):
    """``L_gamma[t, j] = g^(t-j)`` (j <= t, else 0), ``g^(t+1)`` and
    ``g^(w-1-t)`` for a batch of scalar decays ``g`` (shape ``(...,)``).

    The masked exponent is clamped to 0 before ``exp`` so no masked branch
    ever holds an overflowed value.  ``g == 1`` gives the plain masks.
    """
    t = torch.arange(w, device=g.device)
    mask = t[:, None] >= t[None, :]
    diff = torch.where(mask, t[:, None] - t[None, :], 0).to(g.dtype)
    logg = torch.log(g)
    Lg = torch.where(mask, torch.exp(diff * logg[..., None, None]), 0.0)
    tv = t.to(g.dtype)
    pow_t = torch.exp((tv + 1.0) * logg[..., None])  # g^t for t = 1..w
    pow_rev = torch.exp((w - 1.0 - tv) * logg[..., None])  # g^(w-t)
    return Lg, pow_t, pow_rev


def hla2_chunk_math(Q, K, V, state, g, *, normalize: bool, eps: float,
                    lam: float):
    """One HLA2 chunk: outputs + monoid carry update.

    ``Q, K: (..., w, d)``, ``V: (..., w, dv)``, ``state = (S0 (..., d, d),
    C0 (..., d, dv), m0 (..., d), G0 (..., d, dv), h0 (..., d))``, ``g:
    (...,)``.  For local tokens 1..w with D0 = S0 C0 - G0:

        num_t = g^{2t} q_t D0                              (T1)
              + g^t   row_t[(Q S0 Q^T . Lg) V]             (T2)
              + row_t[((A B) . Lg) V]                      (T3, intra)
        A = (Q K^T) . Lg,  B = (K Q^T) . U  (U = upper incl diag)

    The carry decays by rho = g^w, and by rho^2 on the cross summaries
    G, h.  The new G and h read the *old* C and m.
    """
    w = Q.shape[-2]
    S0, C0, m0, G0, h0 = state
    Lg, pow_t, pow_rev = decay_mats(w, g)
    t = torch.arange(w, device=Q.device)
    U = (t[:, None] <= t[None, :]).to(Q.dtype)  # i <= j
    Ls = (t[:, None] > t[None, :]).to(Q.dtype)  # strictly lower
    pt = pow_t[..., None]

    KQ = K @ Q.mT  # (..., w, w): KQ[i, j] = k_i . q_j
    A = KQ.mT * Lg
    M3 = (A @ (KQ * U)) * Lg
    QS0Q = (Q @ S0 @ Q.mT) * Lg
    D0 = S0 @ C0 - G0
    num = pt**2 * (Q @ D0) + pt * (QS0Q @ V) + M3 @ V
    if lam:
        Wqq = (Q @ Q.mT) * Lg
        num = num + lam * (pt * (Q @ C0) + Wqq @ V)
    if normalize:
        d0v = (S0 @ m0[..., None])[..., 0] - h0
        den = (
            pow_t**2 * (Q @ d0v[..., None])[..., 0]
            + pow_t * QS0Q.sum(-1)
            + M3.sum(-1)
        )
        if lam:
            den = den + lam * (
                pow_t * (Q @ m0[..., None])[..., 0] + Wqq.sum(-1)
            )
        o = num / (den[..., None] + eps)
    else:
        o = num

    rho = torch.exp(torch.log(g) * w)
    r, rv = rho[..., None, None], rho[..., None]
    pr = pow_rev[..., None]
    Kg = pr * K
    Sw = Kg.mT @ K
    Cw = (pr * Q).mT @ V
    mw = (pr * Q).sum(-2)
    N = KQ * Ls  # N[t, j] = k_t . q_j, j < t
    Gw = Kg.mT @ (N @ (pr * V))
    hw = Kg.mT @ (N @ pow_rev[..., None])
    S1 = r * S0 + Sw
    C1 = r * C0 + Cw
    m1 = rv * m0 + mw
    G1 = r**2 * G0 + Gw + r * (Sw @ C0)
    h1 = rv**2 * h0 + hw[..., 0] + rv * (Sw @ m0[..., None])[..., 0]
    return o, (S1, C1, m1, G1, h1)


def _decay_grad(dLg, dp, dr, drho, w: int, logg):
    """The cotangent of the decay ``g`` from those of the chunk's decay
    powers: ``dLg`` of ``g^(t-j)``, ``dp`` of ``p[t] = g^(t+1)``, ``dr`` of
    ``r[t] = g^(w-1-t)`` and ``drho`` of ``rho = g^w``.  Each derivative is
    formed only where its exponent is >= 1 (t > j, t < w-1): no g^-1."""
    t = torch.arange(w, device=dLg.device)
    dt = dLg.dtype
    diff = t[:, None] - t[None, :]
    strict = diff > 0
    e = torch.where(strict, diff - 1, 0).to(dt)
    cL = torch.where(strict, diff.to(dt)
                     * torch.exp(e * logg[..., None, None]), 0.0)
    tv = t.to(dt)
    cp = (tv + 1) * torch.exp(tv * logg[..., None])
    cr = torch.where(t < w - 1, (w - 1 - tv)
                     * torch.exp((w - 2 - tv).clamp_min(0) * logg[..., None]),
                     0.0)
    return ((dLg * cL).sum((-2, -1)) + (dp * cp).sum(-1)
            + (dr * cr).sum(-1) + drho * w * torch.exp((w - 1) * logg))


def hla2_chunk_math_bwd(Q, K, V, state, g, dO, dstate1, *, normalize: bool,
                        eps: float, lam: float):
    """Adjoint of ``hla2_chunk_math``, derived by hand: the twin of
    ``jax.vjp(hla2_chunk_math)`` in ``repro/kernels/hla2_chunk.py``'s
    backward kernel.

    Given the cotangents ``dO`` of the output and ``dstate1 = (dS1, dC1,
    dm1, dG1, dh1)`` of the outgoing carry, returns ``(dQ, dK, dV,
    dstate0, dg)``: the cotangents of the inputs, of the incoming carry and
    of the decay ``g`` (shape ``(...,)``).  Same shapes and batching as
    ``hla2_chunk_math``.  With ``p[t] = g^(t+1)``, ``r[t] = g^(w-1-t)`` and
    ``rho = g^w``, the forward's intermediates are recomputed from the
    inputs and the incoming carry, then every product is transposed.
    """
    w = Q.shape[-2]
    S0, C0, m0, G0, h0 = state
    dS1, dC1, dm1, dG1, dh1 = dstate1
    Lg, p, r = decay_mats(w, g)
    t = torch.arange(w, device=Q.device)
    U = (t[:, None] <= t[None, :]).to(Q.dtype)
    Ls = (t[:, None] > t[None, :]).to(Q.dtype)
    logg = torch.log(g)
    rho = torch.exp(logg * w)
    rm, rv = rho[..., None, None], rho[..., None]
    pc, rc = p[..., None], r[..., None]

    def mv(M, x):
        return (M @ x[..., None])[..., 0]

    def outer(a, b):
        return a[..., :, None] * b[..., None, :]

    def dot(a, b):  # Frobenius product of matrices, batched
        return (a * b).sum((-2, -1))

    # the forward's intermediates
    QK = Q @ K.mT
    A = QK * Lg
    Bm = QK.mT * U
    AB = A @ Bm
    M3 = AB * Lg
    QS0 = Q @ S0
    X2 = QS0 @ Q.mT
    P2 = X2 * Lg
    D0 = S0 @ C0 - G0
    Kg, Qg, Vg = rc * K, rc * Q, rc * V
    Sw = Kg.mT @ K
    N = QK.mT * Ls
    NVg = N @ Vg
    Nmg = mv(N, r)

    # carry part: S1 = rho S0 + Sw, C1 = rho C0 + Qg^T V, m1 = rho m0 +
    # Qg^T 1, G1 = rho^2 G0 + Kg^T N Vg + rho Sw C0, h1 likewise with m0
    dS0 = rm * dS1
    dC0 = rm * dC1 + rm * (Sw.mT @ dG1)
    dm0 = rv * dm1 + rv * mv(Sw, dh1)
    dG0 = rm**2 * dG1
    dh0 = rv**2 * dh1
    dSw = dS1 + rm * (dG1 @ C0.mT) + rm * outer(dh1, m0)
    drho = (dot(dS1, S0) + dot(dC1, C0) + (dm1 * m0).sum(-1)
            + 2 * rho * dot(dG1, G0) + dot(dG1, Sw @ C0)
            + 2 * rho * (dh1 * h0).sum(-1) + (dh1 * mv(Sw, m0)).sum(-1))
    dKg = K @ dSw.mT + NVg @ dG1.mT + outer(Nmg, dh1)
    dK = Kg @ dSw
    dQg = V @ dC1.mT + dm1[..., None, :]
    dV = Qg @ dC1
    KgdG = Kg @ dG1
    Kgdh = mv(Kg, dh1)
    dN = (KgdG @ Vg.mT + outer(Kgdh, r)) * Ls
    dVg = N.mT @ KgdG
    dK = dK + dN @ Q
    dQ = dN.mT @ K
    dV = dV + rc * dVg
    dK = dK + rc * dKg
    dQ = dQ + rc * dQg
    dr = ((dVg * V).sum(-1) + (dKg * K).sum(-1) + (dQg * Q).sum(-1)
          + mv(N.mT, Kgdh))

    # output part: o = num, or num / (den + eps)
    p2 = p**2
    QD0 = Q @ D0
    P2V = P2 @ V
    if normalize:
        num = p2[..., None] * QD0 + pc * P2V + M3 @ V
        d0v = mv(S0, m0) - h0
        den = p2 * mv(Q, d0v) + p * P2.sum(-1) + M3.sum(-1)
        if lam:
            Wqq = (Q @ Q.mT) * Lg
            num = num + lam * (pc * (Q @ C0) + Wqq @ V)
            den = den + lam * (p * mv(Q, m0) + Wqq.sum(-1))
        z = den + eps
        dnum = dO / z[..., None]
        dden = -(dO * num).sum(-1) / z**2
    else:
        dnum = dO
        dden = torch.zeros_like(p)
    dD0 = Q.mT @ (p2[..., None] * dnum)
    dS0 = dS0 + dD0 @ C0.mT
    dC0 = dC0 + S0.mT @ dD0
    dG0 = dG0 - dD0
    dQ = dQ + p2[..., None] * (dnum @ D0.mT)
    dp = 2 * p * (dnum * QD0).sum(-1) + (dnum * P2V).sum(-1) \
        + dden * P2.sum(-1)
    dV = dV + P2.mT @ (pc * dnum) + M3.mT @ dnum
    dnV = dnum @ V.mT + dden[..., None]
    dP2 = pc * dnV
    dM3 = dnV
    if normalize:
        dd0v = mv(Q.mT, p2 * dden)
        dQ = dQ + outer(p2 * dden, d0v)
        dS0 = dS0 + outer(dd0v, m0)
        dm0 = dm0 + mv(S0.mT, dd0v)
        dh0 = dh0 - dd0v
        dp = dp + 2 * p * dden * mv(Q, d0v)
    if lam:
        QQ = Q @ Q.mT
        Wqq = QQ * Lg
        dQ = dQ + lam * pc * (dnum @ C0.mT) + lam * outer(p * dden, m0)
        dC0 = dC0 + lam * (Q.mT @ (pc * dnum))
        dm0 = dm0 + lam * mv(Q.mT, p * dden)
        dp = dp + lam * (dnum * (Q @ C0)).sum(-1) + lam * dden * mv(Q, m0)
        dWqq = lam * dnV
        dV = dV + lam * (Wqq.mT @ dnum)
        dWL = dWqq * Lg
        dQ = dQ + (dWL + dWL.mT) @ Q
    dX2 = dP2 * Lg
    dQS0 = dX2 @ Q
    dQ = dQ + dX2.mT @ QS0 + dQS0 @ S0.mT
    dS0 = dS0 + Q.mT @ dQS0
    dY = dM3 * Lg
    dA = dY @ Bm.mT
    dBm = (A.mT @ dY) * U
    dK = dK + dBm @ Q
    dQ = dQ + dBm.mT @ K
    dAL = dA * Lg
    dQ = dQ + dAL @ K
    dK = dK + dAL.mT @ Q
    dLg = dP2 * X2 + dM3 * AB + dA * QK
    if lam:
        dLg = dLg + dWqq * QQ

    dg = _decay_grad(dLg, dp, dr, drho, w, logg)
    return dQ, dK, dV, (dS0, dC0, dm0, dG0, dh0), dg


def ahla_chunk_math(Q, K, V, state, g, *, normalize: bool, eps: float):
    """One AHLA chunk: the inner and outer linear-attention passes fused.

    ``Q, K: (..., w, d)``, ``V: (..., w, dv)``, ``state = (P0, E0)``, the
    carries ``[P | m]`` and ``[E | n]`` with the den column appended
    (``(..., d, dv + 1)``), ``g: (...,)``.  With ``Vb = [V | 1]``, ``A =
    (Q K^T) . Lg``, ``p[t] = g^(t+1)``, ``r[t] = g^(w-1-t)``, ``rho = g^w``:

        R  = p . (Q P0) + A Vb       (first-order outputs [r | s])
        O  = p . (Q E0) + A R        (o = O[:, :dv], or / (O[:, dv] + eps))
        P1 = rho P0 + (r . K)^T Vb
        E1 = rho E0 + (r . K)^T R

    The reference writes E1 as ``rho E0 + Kg^T (A Vb) + rho (K^T Q) P0``;
    since ``r[t] p[t] = rho``, ``rho K^T (Q P0) = Kg^T (p . Q P0)`` and the
    two are equal.  This form needs no d x d product, as the kernel does.
    """
    w = Q.shape[-2]
    P0, E0 = state
    Vb = torch.cat([V, torch.ones(V.shape[:-1] + (1,), dtype=V.dtype,
                                  device=V.device)], -1)
    Lg, pow_t, pow_rev = decay_mats(w, g)
    pt = pow_t[..., None]
    A = (Q @ K.mT) * Lg
    R = pt * (Q @ P0) + A @ Vb
    O = pt * (Q @ E0) + A @ R
    o = O[..., :-1] / (O[..., -1:] + eps) if normalize else O[..., :-1]
    rho = torch.exp(torch.log(g) * w)[..., None, None]
    Kg = pow_rev[..., None] * K
    return o, (rho * P0 + Kg.mT @ Vb, rho * E0 + Kg.mT @ R)


def ahla_chunk_math_bwd(Q, K, V, state, g, dO, dstate1, *, normalize: bool,
                        eps: float):
    """Adjoint of ``ahla_chunk_math``, derived by hand: the twin of
    ``jax.vjp(ahla_chunk_math)`` in ``repro/kernels/ahla_chunk.py``'s
    backward kernel.

    Given the cotangents ``dO`` of the output and ``dstate1 = (dP1, dE1)``
    of the outgoing carry, returns ``(dQ, dK, dV, (dP0, dE0), dg)``.  Same
    shapes and batching as ``ahla_chunk_math``.  With ``Ob = [O | den]``
    the forward's widened output and ``dOb`` its cotangent (``[dO | 0]``
    unnormalised; under ``normalize`` ``dO / z`` and ``-rowsum(dO . O) /
    z^2`` with ``z = den + eps``):

        dR  = A^T dOb + Kg dE1
        dA  = dOb R^T + dR Vb^T          (then . Lg for d(Q K^T))
        dQ  = (dA . Lg) K + p . (dOb E0^T + dR P0^T)
        dK  = (dA . Lg)^T Q + r . (Vb dP1^T + R dE1^T)
        dVb = A^T dR + Kg dP1
        dP0 = rho dP1 + Q^T (p . dR),   dE0 = rho dE1 + Q^T (p . dOb)

    Unnormalised, the den column's cotangents (of R, P, E) stay zero.
    """
    w = Q.shape[-2]
    P0, E0 = state
    dP1, dE1 = dstate1
    ones = torch.ones(V.shape[:-1] + (1,), dtype=V.dtype, device=V.device)
    Vb = torch.cat([V, ones], -1)
    Lg, p, r = decay_mats(w, g)
    logg = torch.log(g)
    rho = torch.exp(logg * w)[..., None, None]
    pc, rc = p[..., None], r[..., None]

    # the forward's intermediates
    QK = Q @ K.mT
    A = QK * Lg
    QP0, QE0 = Q @ P0, Q @ E0
    R = pc * QP0 + A @ Vb
    if normalize:
        O = pc * QE0 + A @ R
        z = O[..., -1:] + eps
        dden = -(dO * O[..., :-1]).sum(-1, keepdim=True) / z**2
        dOb = torch.cat([dO / z, dden], -1)
    else:
        dOb = torch.cat([dO, torch.zeros_like(ones)], -1)
    Kg = rc * K

    dR = A.mT @ dOb + Kg @ dE1
    dA = dOb @ R.mT + dR @ Vb.mT
    dQK = dA * Lg
    dKg = Vb @ dP1.mT + R @ dE1.mT
    dQ = dQK @ K + pc * (dOb @ E0.mT + dR @ P0.mT)
    dK = dQK.mT @ Q + rc * dKg
    dVb = A.mT @ dR + Kg @ dP1
    dP0 = rho * dP1 + Q.mT @ (pc * dR)
    dE0 = rho * dE1 + Q.mT @ (pc * dOb)
    dg = _decay_grad(
        dA * QK, (dOb * QE0).sum(-1) + (dR * QP0).sum(-1),
        (dKg * K).sum(-1),
        (dP1 * P0).sum((-2, -1)) + (dE1 * E0).sum((-2, -1)), w, logg)
    return dQ, dK, dVb[..., :-1], (dP0, dE0), dg
