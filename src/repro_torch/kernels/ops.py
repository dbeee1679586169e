"""Inference entry points over model-layout ``(B, H, n, d)`` tensors.

Twin of the inference half of ``repro/kernels/ops.py``: ``hla2_prefill``
runs a whole prompt through ONE chunk-parallel kernel launch (optionally
resuming from a carry) and returns the exact streaming state;
``hla2_decode_step`` applies one token to every (batch, head) row in ONE
launch, updating the state in place.  ``LAUNCHES`` counts kernel launches
by kernel name (the reference's ``TRACE_COUNTS``).
"""

from __future__ import annotations

import torch

from ._build import LAUNCHES
from ..core.hla2 import HLA2State
from .decode_step import hla2_step
from .hla2_chunk import hla2_chunk_fwd

__all__ = ["LAUNCHES", "hla2_prefill", "hla2_decode_step"]


def _rows_gamma(gamma, B, H, device):
    if gamma is None:
        return None
    g = torch.as_tensor(gamma, dtype=torch.float32, device=device)
    return g.broadcast_to((B, H)).reshape(B * H).contiguous()


def hla2_prefill(q, k, v, gamma=None, *, state: HLA2State | None = None,
                 normalize: bool = False, eps: float = 1e-6,
                 lam: float = 0.0):
    """Chunk-parallel HLA2 prefill over ``(B, H, n, d)``.  Returns
    ``(o, HLA2State)`` with fp32 state leaves ``(B, H, ...)``; ``state``
    (if given) is the carry to resume from and is not modified."""
    B, H, n, _ = q.shape

    def rows(x):
        return x.reshape((B * H,) + x.shape[2:]).contiguous()

    init = None if state is None else tuple(
        rows(x.to(torch.float32)) for x in state)
    o, st = hla2_chunk_fwd(
        rows(q), rows(k), rows(v), _rows_gamma(gamma, B, H, q.device),
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

    def rows(x):
        return x.reshape((B * H,) + x.shape[2:]).contiguous()

    # views, not copies: the kernel's in-place writes land in ``state``
    views = tuple(x.view((B * H,) + x.shape[2:]) for x in state)
    o = hla2_step(views, rows(q_t), rows(k_t), rows(v_t),
                  _rows_gamma(gamma, B, H, q_t.device),
                  normalize=normalize, eps=eps, lam=lam)
    return state, o.reshape(B, H, -1)
