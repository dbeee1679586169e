"""Chunkwise masked HLA2 forward (prompt prefill): the CUDA kernel
``csrc/hla2_chunk_fwd.cu`` and its plain PyTorch version.

Twin of ``repro/kernels/hla2_chunk.py::hla2_chunk_pallas`` without
``save_chunk_states``.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..core.hla2 import HLA2State, hla2_chunkwise

#: the kernel's chunk tile width (``W`` in csrc/hla2_chunk_fwd.cu); the
#: plain version uses the same so both sum in the same chunk order
W = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = ([_P] * 10 + [_I] * 7 + [_F, _F, _I, _P], ctypes.c_int)


def _check(q, k, v, gamma, initial_state):
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or \
            v.shape[:2] != q.shape[:2]:
        raise ValueError(
            f"want q, k (BH, n, d) and v (BH, n, dv); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, n, d = q.shape
    dv = v.shape[-1]
    if n == 0:
        raise ValueError("hla2_chunk_fwd needs at least one token")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share fp32 or bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    want = [((BH,), gamma)] if gamma is not None else []
    if initial_state is not None:
        if len(initial_state) != 5:
            raise ValueError("initial_state is (S, C, m, G, h)")
        shapes = [(BH, d, d), (BH, d, dv), (BH, d), (BH, d, dv), (BH, d)]
        want += list(zip(shapes, initial_state))
    for shape, x in want:
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"want fp32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    for x in (k, v) + tuple(x for _, x in want):
        if x.device != q.device:
            raise ValueError(f"tensors on {q.device} and {x.device}")


def hla2_chunk_fwd_plain(q, k, v, gamma=None, *, initial_state=None,
                         normalize: bool = False, eps: float = 1e-6,
                         lam: float = 0.0):
    """Plain PyTorch version of the kernel: the same per-chunk math in fp32,
    chunk width ``W``, ragged tail as one shorter chunk."""
    f32 = torch.float32
    st = None if initial_state is None else HLA2State(*initial_state)
    o, st = hla2_chunkwise(
        q.to(f32), k.to(f32), v.to(f32), gamma, chunk=W,
        normalize=normalize, eps=eps, lam=lam, state=st,
    )
    return o.to(v.dtype), tuple(st)


def hla2_chunk_fwd(q, k, v, gamma=None, *, initial_state=None,
                   normalize: bool = False, eps: float = 1e-6,
                   lam: float = 0.0):
    """Chunkwise HLA2 over rows: ``q, k (BH, n, d)``, ``v (BH, n, dv)`` in
    fp32 or bf16, ``gamma (BH,)`` fp32 or None, optional fp32 carry
    ``initial_state = (S, C, m, G, h)`` to resume from (left unmodified).

    Returns ``(o, (S, C, m, G, h))``: ``o`` in ``v.dtype``, the final carry
    in fp32.
    """
    _check(q, k, v, gamma, initial_state)
    if q.device.type == "cpu":
        return hla2_chunk_fwd_plain(
            q, k, v, gamma, initial_state=initial_state,
            normalize=normalize, eps=eps, lam=lam,
        )
    if q.device.type != "cuda":
        raise ValueError(f"hla2_chunk_fwd runs on cpu or cuda, not {q.device}")
    tensors = (q, k, v) + (() if gamma is None else (gamma,)) + tuple(
        initial_state or ())
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("hla2_chunk_fwd needs contiguous tensors")
    _build.refuse_grad("hla2_chunk_fwd", tensors)
    BH, n, d = q.shape
    dv = v.shape[-1]
    o = torch.empty_like(v)
    if initial_state is None:
        state = tuple(
            torch.empty(s, dtype=torch.float32, device=q.device)
            for s in [(BH, d, d), (BH, d, dv), (BH, d), (BH, d, dv), (BH, d)]
        )
    else:  # the kernel rewrites its carry in place
        state = tuple(x.clone() for x in initial_state)
    lib = _build.load("hla2_chunk_fwd", _SIG)
    err = lib.hla2_chunk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if gamma is None else gamma.data_ptr(), o.data_ptr(),
        *(x.data_ptr() for x in state),
        BH, n, d, dv, int(q.dtype == torch.bfloat16),
        int(initial_state is not None), int(normalize), eps, lam,
        q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "hla2_chunk_fwd")
    _build.LAUNCHES["hla2_chunk_fwd"] += 1
    return o, state
