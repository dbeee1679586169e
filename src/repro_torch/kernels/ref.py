"""Plain-torch oracles for the chunk kernels, twin of
``repro/kernels/ref.py``.

Forward: ``hla2_chunk_ref`` and ``ahla_chunk_ref`` pin the kernels'
semantics to the chunkwise core (``core/hla2.py``, ``core/ahla.py``) over
``(BH, n, d)`` rows.

Backward: ``hla2_chunk_bwd_ref`` and ``ahla_chunk_bwd_ref`` mirror the
backward kernels' structure: a forward walk collects each chunk's incoming
carry (the checkpoints the kernels save), then a reverse walk takes
``torch.autograd.grad`` of the **forward** per-chunk math
(``chunk_math.hla2_chunk_math``, ``ahla_chunk_math``) at each checkpoint.
The reference takes ``jax.vjp`` of its chunk math the same way.  The
hand-derived adjoints the plain backwards run
(``chunk_math.hla2_chunk_math_bwd``, ``ahla_chunk_math_bwd``) appear
nowhere here, so these are an independent oracle for them.

The math runs in fp32 for fp32/bf16 inputs and in fp64 for fp64 inputs.
Chunks are ``chunk`` wide; a ragged tail is one shorter last chunk, as in
the port's kernels.
"""

from __future__ import annotations

import functools

import torch

from ..core.ahla import ahla_chunkwise
from ..core.hla2 import hla2_chunkwise
from .chunk_math import ahla_chunk_math, hla2_chunk_math


def hla2_chunk_ref(q, k, v, gamma=None, *, chunk=128, normalize=False,
                   eps=1e-6, lam=0.0):
    """Reference for ``kernels.hla2_chunk``: returns ``(o, (S, C, m, G,
    h))``."""
    o, st = hla2_chunkwise(q, k, v, gamma, chunk=chunk, normalize=normalize,
                           eps=eps, lam=lam)
    return o, tuple(st)


def ahla_chunk_ref(q, k, v, gamma=None, *, chunk=128, normalize=False,
                   eps=1e-6):
    """Reference for ``kernels.ahla_chunk``: returns ``(o, (P, m, E,
    n))``."""
    o, st = ahla_chunkwise(q, k, v, gamma, chunk=chunk, normalize=normalize,
                           eps=eps)
    return o, (st.P, st.m, st.E, st.n)


def _chunk_bwd(chunk_fn, state0, q, k, v, gamma, do, chunk):
    """The chunk-level backward: forward walk collecting each chunk's
    incoming carry, then the reverse walk through ``autograd.grad`` of
    ``chunk_fn(Q, K, V, state, g) -> (o, state')``.  The final carry's
    cotangent is zero.  Returns ``(dq, dk, dv, dgamma)`` in the inputs'
    dtypes (``dgamma`` None iff ``gamma`` is None)."""
    ct = torch.promote_types(q.dtype, torch.float32)
    BH, n, _ = q.shape
    g = torch.ones(BH, dtype=ct, device=q.device) if gamma is None \
        else gamma.to(ct)
    bounds = [(c0, min(c0 + chunk, n)) for c0 in range(0, n, chunk)]
    rows = [tuple(x[:, a:b].to(ct) for x in (q, k, v, do))
            for a, b in bounds]
    st, st_in = state0, []
    with torch.no_grad():
        for Q, K, V, _ in rows:
            st_in.append(st)
            _, st = chunk_fn(Q, K, V, st, g)
    dst = tuple(torch.zeros_like(x) for x in state0)
    dq, dk, dv = [], [], []
    dg = torch.zeros_like(g)
    for (Q, K, V, dO), s0 in zip(reversed(rows), reversed(st_in)):
        ins = [x.detach().requires_grad_() for x in (Q, K, V, g, *s0)]
        with torch.enable_grad():
            o, s1 = chunk_fn(*ins[:3], tuple(ins[4:]), ins[3])
            grads = torch.autograd.grad((o, *s1), ins, (dO, *dst),
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(ins, grads)]
        dq.append(grads[0])
        dk.append(grads[1])
        dv.append(grads[2])
        dg = dg + grads[3]
        dst = tuple(grads[4:])
    return (torch.cat(dq[::-1], 1).to(q.dtype),
            torch.cat(dk[::-1], 1).to(k.dtype),
            torch.cat(dv[::-1], 1).to(v.dtype),
            None if gamma is None else dg.to(gamma.dtype))


def hla2_chunk_bwd_ref(q, k, v, gamma, do, *, chunk=128, normalize=False,
                       eps=1e-6, lam=0.0):
    """Chunk-level backward oracle for ``hla2_chunk_bwd``: ``(BH, n, d)``
    rows, ``gamma (BH,)`` or None, ``do`` like ``v``.  Returns ``(dq, dk,
    dv, dgamma)``."""
    BH, _, d = q.shape
    dv = v.shape[-1]
    ct = torch.promote_types(q.dtype, torch.float32)

    def z(*s):
        return torch.zeros((BH,) + s, dtype=ct, device=q.device)

    fn = functools.partial(hla2_chunk_math, normalize=normalize, eps=eps,
                           lam=lam)
    return _chunk_bwd(fn, (z(d, d), z(d, dv), z(d), z(d, dv), z(d)), q, k, v,
                      gamma, do, chunk)


def ahla_chunk_bwd_ref(q, k, v, gamma, do, *, chunk=128, normalize=False,
                       eps=1e-6):
    """Chunk-level backward oracle for ``ahla_chunk_bwd``; the carries are
    ``[P | m]`` and ``[E | n]``, as the kernel checkpoints them."""
    BH, _, d = q.shape
    ct = torch.promote_types(q.dtype, torch.float32)
    zero = torch.zeros(BH, d, v.shape[-1] + 1, dtype=ct, device=q.device)
    fn = functools.partial(ahla_chunk_math, normalize=normalize, eps=eps)
    return _chunk_bwd(fn, (zero, zero), q, k, v, gamma, do, chunk)
