"""Entry points over model-layout ``(B, H, n, d)`` tensors.

Twin of ``repro/kernels/ops.py``.  HLA2: ``hla2_attention`` is the
differentiable training path (ONE forward launch that checkpoints each
chunk's incoming carry, ONE backward launch that walks them in reverse);
``hla2_prefill`` runs a whole prompt through ONE chunk-parallel kernel
launch (optionally resuming from a carry) and returns the exact streaming
state; ``hla2_decode_step`` applies one token to every (batch, head) row in
ONE launch, updating the state in place.  AHLA: ``ahla_attention``,
``ahla_prefill`` and ``ahla_decode_step`` likewise.
``LAUNCHES`` counts kernel launches by kernel name (the reference's
``TRACE_COUNTS``).
"""

from __future__ import annotations

import torch

from ._build import LAUNCHES
from ..core.ahla import AHLAState
from ..core.hla2 import HLA2State
from .ahla_chunk import ahla_chunk_bwd, ahla_chunk_fwd
from .decode_step import ahla_step, hla2_step
from .hla2_chunk import hla2_chunk_bwd, hla2_chunk_fwd

__all__ = ["LAUNCHES", "hla2_attention", "hla2_prefill", "hla2_decode_step",
           "ahla_attention", "ahla_prefill", "ahla_decode_step"]


def _rows_gamma(gamma, B, H, device, dtype=torch.float32):
    if gamma is None:
        return None
    g = torch.as_tensor(gamma, dtype=dtype, device=device)
    return g.broadcast_to((B, H)).reshape(B * H).contiguous()


def _rows(x):
    return x.reshape((-1,) + x.shape[2:]).contiguous()


class _ChunkAttention(torch.autograd.Function):
    """The fused training path of a chunkwise operator, twin of the
    reference's ``_hla2_vjp_fwd``/``_hla2_vjp_bwd`` and ``_ahla_vjp_fwd``/
    ``_ahla_vjp_bwd``: the forward kernel ``fwd`` saves each chunk's
    incoming carry, the backward kernel ``bwd`` walks them in reverse.
    ``kw`` holds the operator's options, passed to both."""

    @staticmethod
    def forward(ctx, fwd, bwd, kw, q, k, v, gamma):
        B, H, n, _ = q.shape
        g = _rows_gamma(None if gamma is None else gamma.detach(), B, H,
                        q.device, torch.promote_types(q.dtype, torch.float32))
        rows = tuple(_rows(x.detach()) for x in (q, k, v))
        with torch.no_grad():
            o, _, ckpt = fwd(*rows, g, save_chunk_states=True, **kw)
        ctx.save_for_backward(*rows, g, *ckpt)
        ctx.meta = (bwd, kw, B, H, None if gamma is None else gamma.shape)
        return o.reshape(B, H, n, -1)

    @staticmethod
    def backward(ctx, do):
        q, k, v, g, *ckpt = ctx.saved_tensors
        bwd, kw, B, H, gshape = ctx.meta
        dq, dk, dv, dg = bwd(q, k, v, g, _rows(do.to(v.dtype)), tuple(ckpt),
                             **kw)
        if gshape is not None:  # back through the (B*H,) broadcast
            dg = dg.reshape(B, H).sum_to_size(gshape)
        return (None, None, None, dq.reshape(B, H, *dq.shape[1:]),
                dk.reshape(B, H, *dk.shape[1:]),
                dv.reshape(B, H, *dv.shape[1:]), dg)


def hla2_attention(q, k, v, gamma=None, *, normalize: bool = False,
                   eps: float = 1e-6, lam: float = 0.0):
    """Masked second-order HLA over ``(B, H, n, d)`` tensors, differentiable
    in ``q, k, v`` and ``gamma`` (broadcastable to ``(B, H)``): one
    chunkwise forward launch with checkpoints, one backward launch.
    Returns ``o (B, H, n, dv)`` in ``v.dtype``; no state."""
    return _ChunkAttention.apply(
        hla2_chunk_fwd, hla2_chunk_bwd,
        dict(normalize=normalize, eps=eps, lam=lam), q, k, v, gamma)


def hla2_prefill(q, k, v, gamma=None, *, state: HLA2State | None = None,
                 normalize: bool = False, eps: float = 1e-6,
                 lam: float = 0.0):
    """Chunk-parallel HLA2 prefill over ``(B, H, n, d)``.  Returns
    ``(o, HLA2State)`` with fp32 state leaves ``(B, H, ...)`` (fp64 for fp64
    inputs, CPU only); ``state`` (if given) is the carry to resume from and
    is not modified."""
    B, H, n, _ = q.shape
    ct = torch.promote_types(q.dtype, torch.float32)
    init = None if state is None else tuple(_rows(x.to(ct)) for x in state)
    o, st = hla2_chunk_fwd(
        _rows(q), _rows(k), _rows(v), _rows_gamma(gamma, B, H, q.device, ct),
        initial_state=init, normalize=normalize, eps=eps, lam=lam,
    )
    return (o.reshape(B, H, n, -1),
            HLA2State(*(x.reshape((B, H) + x.shape[1:]) for x in st)))


def hla2_decode_step(state: HLA2State, q_t, k_t, v_t, gamma=None, *,
                     normalize: bool = False, eps: float = 1e-6,
                     lam: float = 0.0):
    """One decode token over ``(B, H, d)`` rows.  **Updates ``state`` in
    place** (its fp32 leaves must be contiguous ``(B, H, ...)`` tensors)
    and returns ``(state, o_t)`` with ``o_t (B, H, dv)``."""
    B, H, _ = q_t.shape
    # views, not copies: the kernel's in-place writes land in ``state``
    views = tuple(x.view((B * H,) + x.shape[2:]) for x in state)
    o = hla2_step(views, _rows(q_t), _rows(k_t), _rows(v_t),
                  _rows_gamma(gamma, B, H, q_t.device),
                  normalize=normalize, eps=eps, lam=lam)
    return state, o.reshape(B, H, -1)


def ahla_attention(q, k, v, gamma=None, *, normalize: bool = False,
                   eps: float = 1e-6):
    """AHLA over ``(B, H, n, d)`` tensors, differentiable in ``q, k, v`` and
    ``gamma`` (broadcastable to ``(B, H)``): one chunkwise forward launch
    with checkpoints, one backward launch.  Returns ``o (B, H, n, dv)`` in
    ``v.dtype``; no state."""
    return _ChunkAttention.apply(
        ahla_chunk_fwd, ahla_chunk_bwd, dict(normalize=normalize, eps=eps),
        q, k, v, gamma)


def ahla_prefill(q, k, v, gamma=None, *, state: AHLAState | None = None,
                 normalize: bool = False, eps: float = 1e-6):
    """Chunk-parallel AHLA prefill over ``(B, H, n, d)``.  Returns
    ``(o, AHLAState)`` with fp32 state leaves ``(B, H, ...)`` (fp64 for fp64
    inputs, CPU only); ``state`` (if given) is the carry to resume from and
    is not modified.  One kernel
    launch computes ``o`` and ``(P, m, E, n)``; the undecayed cross moment
    ``R = R0 + K^T Q`` is a plain product outside it, as in the
    reference."""
    B, H, n, _ = q.shape
    ct = torch.promote_types(q.dtype, torch.float32)
    init = None if state is None else tuple(
        _rows(x.to(ct)) for x in (state.P, state.m, state.E, state.n))
    o, (P, m, E, nn) = ahla_chunk_fwd(
        _rows(q), _rows(k), _rows(v), _rows_gamma(gamma, B, H, q.device, ct),
        initial_state=init, normalize=normalize, eps=eps)
    R = k.to(ct).mT @ q.to(ct)
    if state is not None:
        R = R + state.R.to(ct)

    def unm(x):
        return x.reshape((B, H) + x.shape[1:])

    return (o.reshape(B, H, n, -1),
            AHLAState(R, unm(P), unm(m), unm(E), unm(nn)))


def ahla_decode_step(state: AHLAState, q_t, k_t, v_t, gamma=None, *,
                     normalize: bool = False, eps: float = 1e-6):
    """One AHLA decode token over ``(B, H, d)`` rows.  **Updates ``state``
    in place** (its fp32 leaves must be contiguous ``(B, H, ...)`` tensors)
    and returns ``(state, o_t)`` with ``o_t (B, H, dv)``."""
    B, H, _ = q_t.shape
    # views, not copies: the kernel's in-place writes land in ``state``
    views = tuple(x.view((B * H,) + x.shape[2:]) for x in state)
    o = ahla_step(views, _rows(q_t), _rows(k_t), _rows(v_t),
                  _rows_gamma(gamma, B, H, q_t.device),
                  normalize=normalize, eps=eps)
    return state, o.reshape(B, H, -1)
