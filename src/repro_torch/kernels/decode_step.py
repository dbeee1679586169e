"""Batched HLA2 and AHLA decode steps: the CUDA kernels ``csrc/hla2_step.cu``
and ``csrc/ahla_step.cu`` and their plain PyTorch versions.

Twin of ``repro/kernels/decode_step.py`` (``hla2_step_pallas``,
``ahla_step_pallas``): one token of the streaming recurrence for every
(slot, head) row in one launch, the state updated in place (the TPU kernels
alias their state operands to their outputs).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  Each kernel spreads a
row over a cluster of CTAs, each owning a column slice of the state that
the TMA copy engine brings in: on the card d and dv are multiples of 4, d
at most 256 and dv at most 1024.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..core.ahla import AHLAState
from ..core.ahla import ahla_step as _core_ahla_step
from ..core.hla2 import HLA2State
from ..core.hla2 import hla2_step as _core_step

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = ([_P] * 10 + [_I] * 5 + [_F, _F, _I, _P], ctypes.c_int)
_AHLA_SIG = ([_P] * 10 + [_I] * 5 + [_F, _I, _P], ctypes.c_int)


def _check(state, q, k, v, gamma, leaves="(S, C, m, G, h)"):
    """Shared by the step wrappers: HLA2's ``(S, C, m, G, h)`` and AHLA's
    ``(R, P, m, E, n)`` have the same shapes."""
    if q.dim() != 2 or k.shape != q.shape or v.dim() != 2 or \
            v.shape[0] != q.shape[0]:
        raise ValueError(
            f"want q, k (BH, d) and v (BH, dv); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, d = q.shape
    dv = v.shape[-1]
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share fp32 or bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if len(state) != 5:
        raise ValueError(f"state is {leaves}")
    shapes = [(BH, d, d), (BH, d, dv), (BH, d), (BH, d, dv), (BH, d)]
    want = list(zip(shapes, state))
    if gamma is not None:
        want.append(((BH,), gamma))
    for shape, x in want:
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"want fp32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    for x in (k, v) + tuple(x for _, x in want):
        if x.device != q.device:
            raise ValueError(f"tensors on {q.device} and {x.device}")


def _check_cuda_shape(name, d, dv, state):
    """What the CUDA kernels take: a column slice of each state matrix is
    one TMA copy (at most 256 rows and 256 columns, in 16-byte rows), and m,
    h (or n) are copied whole."""
    if d % 4 or dv % 4 or d > 256 or dv > 1024:
        raise ValueError(
            f"{name}'s CUDA kernel takes d and dv multiples of 4, d <= 256 "
            f"and dv <= 1024; got d = {d}, dv = {dv}")
    if any(x.data_ptr() % 16 for x in state):
        raise ValueError(f"{name}'s CUDA kernel copies its state in 16-byte "
                         "pieces: every state tensor must be 16-byte aligned")


def hla2_step_plain(state, q, k, v, gamma=None, *, normalize: bool = False,
                    eps: float = 1e-6, lam: float = 0.0):
    """Plain PyTorch version of the kernel, with the same in-place update of
    ``state``."""
    new, o = _core_step(HLA2State(*state), q, k, v, gamma,
                        normalize=normalize, eps=eps, lam=lam)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return o.to(v.dtype)


def hla2_step(state, q, k, v, gamma=None, *, normalize: bool = False,
              eps: float = 1e-6, lam: float = 0.0):
    """One HLA2 decode token for every row.  **Mutates ``state``**: the fp32
    tensors ``(S (BH, d, d), C (BH, d, dv), m (BH, d), G (BH, d, dv),
    h (BH, d))`` hold the new state when this returns.

    ``q, k (BH, d)``, ``v (BH, dv)`` in fp32 or bf16, ``gamma (BH,)`` fp32
    or None.  Returns ``o (BH, dv)`` in ``v.dtype``.
    """
    _check(state, q, k, v, gamma)
    if q.device.type == "cpu":
        return hla2_step_plain(state, q, k, v, gamma, normalize=normalize,
                               eps=eps, lam=lam)
    if q.device.type != "cuda":
        raise ValueError(f"hla2_step runs on cpu or cuda, not {q.device}")
    tensors = (q, k, v) + tuple(state) + (() if gamma is None else (gamma,))
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("hla2_step needs contiguous tensors")
    _build.refuse_grad("hla2_step", tensors)
    BH, d = q.shape
    dv = v.shape[-1]
    _check_cuda_shape("hla2_step", d, dv, state)
    o = torch.empty_like(v)
    lib = _build.load("hla2_step", _SIG)
    err = lib.hla2_step(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if gamma is None else gamma.data_ptr(), o.data_ptr(),
        *(x.data_ptr() for x in state),
        BH, d, dv, int(q.dtype == torch.bfloat16), int(normalize), eps, lam,
        q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "hla2_step")
    _build.LAUNCHES["hla2_step"] += 1
    return o


def ahla_step_plain(state, q, k, v, gamma=None, *, normalize: bool = False,
                    eps: float = 1e-6):
    """Plain PyTorch version of the AHLA kernel, with the same in-place
    update of ``state``."""
    new, o = _core_ahla_step(AHLAState(*state), q, k, v, gamma,
                             normalize=normalize, eps=eps)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return o.to(v.dtype)


def ahla_step(state, q, k, v, gamma=None, *, normalize: bool = False,
              eps: float = 1e-6):
    """One AHLA decode token for every row.  **Mutates ``state``**: the fp32
    tensors ``(R (BH, d, d), P (BH, d, dv), m (BH, d), E (BH, d, dv),
    n (BH, d))`` hold the new state when this returns.

    ``q, k (BH, d)``, ``v (BH, dv)`` in fp32 or bf16, ``gamma (BH,)`` fp32
    or None.  Returns ``o (BH, dv)`` in ``v.dtype``.
    """
    _check(state, q, k, v, gamma, leaves="(R, P, m, E, n)")
    if q.device.type == "cpu":
        return ahla_step_plain(state, q, k, v, gamma, normalize=normalize,
                               eps=eps)
    if q.device.type != "cuda":
        raise ValueError(f"ahla_step runs on cpu or cuda, not {q.device}")
    tensors = (q, k, v) + tuple(state) + (() if gamma is None else (gamma,))
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("ahla_step needs contiguous tensors")
    _build.refuse_grad("ahla_step", tensors)
    BH, d = q.shape
    dv = v.shape[-1]
    _check_cuda_shape("ahla_step", d, dv, state)
    o = torch.empty_like(v)
    lib = _build.load("ahla_step", _AHLA_SIG)
    err = lib.ahla_step(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if gamma is None else gamma.data_ptr(), o.data_ptr(),
        *(x.data_ptr() for x in state),
        BH, d, dv, int(q.dtype == torch.bfloat16), int(normalize), eps,
        q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "ahla_step")
    _build.LAUNCHES["ahla_step"] += 1
    return o
