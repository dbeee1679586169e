"""Chunkwise masked HLA2, forward (prefill and training) and backward: the
CUDA kernels ``csrc/hla2_chunk_fwd.cu`` and ``csrc/hla2_chunk_bwd.cu`` and
their plain PyTorch versions.

Twin of ``repro/kernels/hla2_chunk.py``: ``hla2_chunk_fwd`` of
``hla2_chunk_pallas`` (``save_chunk_states`` included) and
``hla2_chunk_bwd`` of ``hla2_chunk_bwd_pallas``.  Both walk the port's
chunk partition: ``ceil(n / W)`` chunks, the last one as long as what is
left (no zero padding).  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .chunk_math import hla2_chunk_math, hla2_chunk_math_bwd

#: the kernel's chunk tile width (``W`` in csrc/hla2_chunk_fwd.cu); the
#: plain version uses the same so both sum in the same chunk order
W = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = ([_P] * 20 + [_I] * 6 + [_F, _F, _I, _P], ctypes.c_int)
_BWD_SIG = ([_P] * 15 + [_I] * 6 + [_F, _F, _I, _P], ctypes.c_int)


def _state_shapes(BH, d, dv, nc=None):
    lead = (BH,) if nc is None else (BH, nc)
    return [lead + s for s in [(d, d), (d, dv), (d,), (d, dv), (d,)]]


def _float(q):
    """The dtype of the carry and of the plain versions' math: fp32 for
    fp32/bf16 inputs, fp64 for fp64 ones."""
    return torch.promote_types(q.dtype, torch.float32)


def _check(q, k, v, gamma, initial_state, name="hla2_chunk_fwd",
           state_shapes=_state_shapes, leaves="(S, C, m, G, h)"):
    """Shared by the chunk kernels' wrappers: shapes, dtypes and devices of
    the inputs and of an ``initial_state`` of ``state_shapes(BH, d, dv)``
    leaves (named ``leaves`` in the error)."""
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or \
            v.shape[:2] != q.shape[:2]:
        raise ValueError(
            f"want q, k (BH, n, d) and v (BH, n, dv); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, n, d = q.shape
    dv = v.shape[-1]
    if n == 0:
        raise ValueError(f"{name} needs at least one token")
    f64 = torch.float64
    if q.dtype not in (torch.float32, torch.bfloat16, f64) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share fp32 or bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    # fp64 takes the plain version only (the tests' gradient checks)
    if q.dtype == f64 and (q.device.type != "cpu" or (
            gamma is not None and gamma.dtype != f64)):
        raise TypeError("fp64 runs on the CPU only, with an fp64 gamma")
    fdt = _float(q)
    want = [((BH,), gamma)] if gamma is not None else []
    if initial_state is not None:
        shapes = state_shapes(BH, d, dv)
        if len(initial_state) != len(shapes):
            raise ValueError(f"initial_state is {leaves}")
        want += list(zip(shapes, initial_state))
    for shape, x in want:
        if tuple(x.shape) != shape or x.dtype != fdt:
            raise ValueError(f"want {fdt} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    for x in (k, v) + tuple(x for _, x in want):
        if x.device != q.device:
            raise ValueError(f"tensors on {q.device} and {x.device}")


def hla2_chunk_fwd_plain(q, k, v, gamma=None, *, initial_state=None,
                         normalize: bool = False, eps: float = 1e-6,
                         lam: float = 0.0, save_chunk_states: bool = False):
    """Plain PyTorch version of the kernel: the same per-chunk math in fp32
    (fp64 for fp64 inputs), chunk width ``W``, ragged tail as one shorter
    chunk."""
    ct = _float(q)
    BH, n, d = q.shape
    dv = v.shape[-1]
    g = torch.ones(BH, dtype=ct, device=q.device) if gamma is None \
        else gamma.to(ct)
    if initial_state is None:
        st = tuple(torch.zeros(s, dtype=ct, device=q.device)
                   for s in _state_shapes(BH, d, dv))
    else:
        st = tuple(x.to(ct) for x in initial_state)
    outs, saved = [], []
    for c0 in range(0, n, W):
        sl = slice(c0, min(c0 + W, n))
        saved.append(st)
        o, st = hla2_chunk_math(
            q[:, sl].to(ct), k[:, sl].to(ct), v[:, sl].to(ct), st, g,
            normalize=normalize, eps=eps, lam=lam,
        )
        outs.append(o)
    o = torch.cat(outs, 1).to(v.dtype)
    if save_chunk_states:
        return o, st, tuple(torch.stack(x, 1) for x in zip(*saved))
    return o, st


def hla2_chunk_fwd(q, k, v, gamma=None, *, initial_state=None,
                   normalize: bool = False, eps: float = 1e-6,
                   lam: float = 0.0, save_chunk_states: bool = False):
    """Chunkwise HLA2 over rows: ``q, k (BH, n, d)``, ``v (BH, n, dv)`` in
    fp32 or bf16, ``gamma (BH,)`` fp32 or None, optional fp32 carry
    ``initial_state = (S, C, m, G, h)`` to resume from (left unmodified).

    Returns ``(o, (S, C, m, G, h))``: ``o`` in ``v.dtype``, the final carry
    in fp32.  With ``save_chunk_states`` it also returns the incoming carry
    of each of the ``ceil(n / W)`` chunks, fp32 ``(BH, nc, ...)`` leaves:
    what ``hla2_chunk_bwd`` walks back over.
    """
    _check(q, k, v, gamma, initial_state)
    if q.device.type == "cpu":
        return hla2_chunk_fwd_plain(
            q, k, v, gamma, initial_state=initial_state,
            normalize=normalize, eps=eps, lam=lam,
            save_chunk_states=save_chunk_states,
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
    # the kernel reads the initial carry and writes the final one apart
    state = tuple(torch.empty(s, dtype=torch.float32, device=q.device)
                  for s in _state_shapes(BH, d, dv))
    init = (None,) * 5 if initial_state is None else tuple(
        x.data_ptr() for x in initial_state)
    saved = None
    if save_chunk_states:
        saved = tuple(torch.empty(s, dtype=torch.float32, device=q.device)
                      for s in _state_shapes(BH, d, dv, -(-n // W)))
    lib = _build.load("hla2_chunk_fwd", _SIG)
    err = lib.hla2_chunk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if gamma is None else gamma.data_ptr(), *init, o.data_ptr(),
        *(x.data_ptr() for x in state),
        *((None,) * 5 if saved is None else (x.data_ptr() for x in saved)),
        BH, n, d, dv, int(q.dtype == torch.bfloat16), int(normalize), eps,
        lam, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "hla2_chunk_fwd")
    _build.LAUNCHES["hla2_chunk_fwd"] += 1
    if saved is not None:
        return o, state, saved
    return o, state


def _check_bwd(q, k, v, gamma, do, chunk_states, ckpt_shapes=_state_shapes,
               leaves="(S, C, m, G, h)"):
    """Shared by the backward kernels' wrappers: the forward's inputs, ``do``
    like ``v``, and the checkpoints, ``ckpt_shapes(BH, d, dv, nc)`` leaves
    (named ``leaves`` in the error) over ``nc = ceil(n / W)`` chunks."""
    _check(q, k, v, gamma, None)
    BH, n, d = q.shape
    dv = v.shape[-1]
    if do.shape != v.shape or do.dtype != v.dtype or do.device != q.device:
        raise ValueError(f"want do like v {v.dtype} {tuple(v.shape)}, got "
                         f"{do.dtype} {tuple(do.shape)} on {do.device}")
    shapes = ckpt_shapes(BH, d, dv, -(-n // W))
    if len(chunk_states) != len(shapes):
        raise ValueError(f"chunk_states is {leaves}")
    for shape, x in zip(shapes, chunk_states):
        if tuple(x.shape) != shape or x.dtype != _float(q) or \
                x.device != q.device:
            raise ValueError(f"want {_float(q)} chunk states {shape}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _walk_back(math_bwd, q, k, v, gamma, do, chunk_states, **kw):
    """The plain backward of a chunkwise forward: the chunks in reverse,
    each through ``math_bwd`` (a per-chunk adjoint of ``chunk_math``) in
    fp32 (fp64 for fp64 inputs) from its checkpointed incoming carry.  The
    final carry's cotangent is zero: the forward discards it."""
    ct = _float(q)
    BH, n, _ = q.shape
    g = torch.ones(BH, dtype=ct, device=q.device) if gamma is None \
        else gamma.to(ct)
    dstate = tuple(torch.zeros_like(x[:, 0]) for x in chunk_states)
    dq = torch.empty(q.shape, dtype=ct, device=q.device)
    dk, dv = torch.empty_like(dq), torch.empty(v.shape, dtype=ct,
                                                device=q.device)
    dg = torch.zeros(BH, dtype=ct, device=q.device)
    for c in reversed(range(chunk_states[0].shape[1])):
        sl = slice(c * W, min(c * W + W, n))
        dq[:, sl], dk[:, sl], dv[:, sl], dstate, dgc = math_bwd(
            q[:, sl].to(ct), k[:, sl].to(ct), v[:, sl].to(ct),
            tuple(x[:, c] for x in chunk_states), g, do[:, sl].to(ct),
            dstate, **kw)
        dg += dgc
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            None if gamma is None else dg)


def hla2_chunk_bwd_plain(q, k, v, gamma, do, chunk_states, *,
                         normalize: bool = False, eps: float = 1e-6,
                         lam: float = 0.0):
    """Plain PyTorch version of the backward kernel: ``_walk_back`` through
    ``hla2_chunk_math_bwd``."""
    return _walk_back(hla2_chunk_math_bwd, q, k, v, gamma, do, chunk_states,
                      normalize=normalize, eps=eps, lam=lam)


def hla2_chunk_bwd(q, k, v, gamma, do, chunk_states, *,
                   normalize: bool = False, eps: float = 1e-6,
                   lam: float = 0.0):
    """Backward of ``hla2_chunk_fwd`` (output cotangent ``do``, no carry
    cotangent): ``q, k, v, gamma`` as the forward took them, ``do`` like
    ``v``, ``chunk_states`` the forward's checkpoints.  Returns ``(dq, dk,
    dv, dgamma)`` in the inputs' dtypes, ``dgamma (BH,)`` fp32 or None when
    ``gamma`` is None."""
    _check_bwd(q, k, v, gamma, do, chunk_states)
    if q.device.type == "cpu":
        return hla2_chunk_bwd_plain(q, k, v, gamma, do, chunk_states,
                                    normalize=normalize, eps=eps, lam=lam)
    if q.device.type != "cuda":
        raise ValueError(f"hla2_chunk_bwd runs on cpu or cuda, not {q.device}")
    tensors = (q, k, v, do) + (() if gamma is None else (gamma,)) + tuple(
        chunk_states)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("hla2_chunk_bwd needs contiguous tensors")
    _build.refuse_grad("hla2_chunk_bwd", tensors)
    BH, n, d = q.shape
    dv_ = v.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dgamma = None if gamma is None else torch.empty_like(gamma)
    lib = _build.load("hla2_chunk_bwd", _BWD_SIG)
    size = lib.hla2_chunk_bwd_scratch_floats
    size.argtypes, size.restype = [_I] * 4, ctypes.c_long
    # per column tile: the walk's transient tiles, the partial dq, dk
    # (summed by the kernel's second pass) and the partial dgamma
    scratch = torch.empty(size(BH, n, d, dv_), dtype=torch.float32,
                          device=q.device)
    err = lib.hla2_chunk_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if gamma is None else gamma.data_ptr(), do.data_ptr(),
        *(x.data_ptr() for x in chunk_states),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if gamma is None else dgamma.data_ptr(), scratch.data_ptr(),
        BH, n, d, dv_, int(q.dtype == torch.bfloat16), int(normalize), eps,
        lam, q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "hla2_chunk_bwd")
    _build.LAUNCHES["hla2_chunk_bwd"] += 1
    return dq, dk, dv, dgamma
