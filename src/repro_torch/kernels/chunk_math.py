"""Per-chunk HLA2 math: one chunk of the chunkwise scheme as a pure function
``(Q, K, V, state_in, g) -> (o, state_out)``.

Twin of the HLA2 half of ``repro/kernels/chunk_math.py``, batched over any
leading dims instead of one 2D tile, in the dtype of its inputs (fp32 for
the kernel's plain version, fp64 in the parity tests).  The CUDA kernel
``csrc/hla2_chunk_fwd.cu`` computes the same function, chunk by chunk.
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
