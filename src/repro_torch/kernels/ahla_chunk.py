"""Chunkwise AHLA, forward (prefill and training) and backward: the CUDA
kernels ``csrc/ahla_chunk_fwd.cu`` and ``csrc/ahla_chunk_bwd.cu`` and their
plain PyTorch versions.

Twin of ``repro/kernels/ahla_chunk.py``: ``ahla_chunk_fwd`` of
``ahla_chunk_pallas`` (``initial_state`` and ``save_chunk_states``) and
``ahla_chunk_bwd`` of ``ahla_chunk_bwd_pallas``.  Both walk the port's
chunk partition: ``ceil(n / W)`` chunks, the last one as long as what is
left (no zero padding, so no division by gamma^pad afterwards).  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .chunk_math import ahla_chunk_math, ahla_chunk_math_bwd
from .hla2_chunk import W, _check, _check_bwd, _float, _walk_back

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = ([_P] * 15 + [_I] * 6 + [_F, _I, _P], ctypes.c_int)
_BWD_SIG = ([_P] * 12 + [_I] * 6 + [_F, _I, _P], ctypes.c_int)


def _state_shapes(BH, d, dv):
    return [(BH, d, dv), (BH, d), (BH, d, dv), (BH, d)]


def _ckpt_shapes(BH, d, dv, nc):
    """Each chunk's incoming ``[P | m]`` and ``[E | n]``: the reference's
    checkpoint layout."""
    return [(BH, nc, d, dv + 1)] * 2


def ahla_chunk_fwd_plain(q, k, v, gamma=None, *, initial_state=None,
                         normalize: bool = False, eps: float = 1e-6,
                         save_chunk_states: bool = False):
    """Plain PyTorch version of the kernel: ``ahla_chunk_math`` chunk by
    chunk in fp32 (fp64 for fp64 inputs), chunk width ``W``, ragged tail as
    one shorter chunk."""
    ct = _float(q)
    BH, n, d = q.shape
    dv = v.shape[-1]
    g = torch.ones(BH, dtype=ct, device=q.device) if gamma is None \
        else gamma.to(ct)
    if initial_state is None:
        Pa = torch.zeros(BH, d, dv + 1, dtype=ct, device=q.device)
        Ea = torch.zeros_like(Pa)
    else:
        P0, m0, E0, n0 = (x.to(ct) for x in initial_state)
        Pa = torch.cat([P0, m0[..., None]], -1)
        Ea = torch.cat([E0, n0[..., None]], -1)
    outs, saved = [], []
    for c0 in range(0, n, W):
        sl = slice(c0, min(c0 + W, n))
        saved.append((Pa, Ea))
        o, (Pa, Ea) = ahla_chunk_math(
            q[:, sl].to(ct), k[:, sl].to(ct), v[:, sl].to(ct), (Pa, Ea), g,
            normalize=normalize, eps=eps)
        outs.append(o)
    state = tuple(x.contiguous() for x in
                  (Pa[..., :dv], Pa[..., dv], Ea[..., :dv], Ea[..., dv]))
    o = torch.cat(outs, 1).to(v.dtype)
    if save_chunk_states:
        return o, state, tuple(torch.stack(x, 1) for x in zip(*saved))
    return o, state


def ahla_chunk_fwd(q, k, v, gamma=None, *, initial_state=None,
                   normalize: bool = False, eps: float = 1e-6,
                   save_chunk_states: bool = False):
    """Chunkwise AHLA over rows: ``q, k (BH, n, d)``, ``v (BH, n, dv)`` in
    fp32 or bf16, ``gamma (BH,)`` fp32 or None, optional fp32 carry
    ``initial_state = (P, m, E, n)`` to resume from (left unmodified).

    Returns ``(o, (P, m, E, n))``: ``o`` in ``v.dtype``, the final carry in
    fp32.  With ``save_chunk_states`` it also returns each of the ``ceil(n
    / W)`` chunks' incoming ``([P | m], [E | n])``, two fp32 ``(BH, nc, d,
    dv + 1)`` tensors: what ``ahla_chunk_bwd`` walks back over.  The
    undecayed cross moment ``R`` is not the kernel's: ``ops.ahla_prefill``
    adds it, as the reference does.
    """
    _check(q, k, v, gamma, initial_state, name="ahla_chunk_fwd",
           state_shapes=_state_shapes, leaves="(P, m, E, n)")
    if q.device.type == "cpu":
        return ahla_chunk_fwd_plain(q, k, v, gamma,
                                    initial_state=initial_state,
                                    normalize=normalize, eps=eps,
                                    save_chunk_states=save_chunk_states)
    if q.device.type != "cuda":
        raise ValueError(f"ahla_chunk_fwd runs on cpu or cuda, not {q.device}")
    tensors = (q, k, v) + (() if gamma is None else (gamma,)) + tuple(
        initial_state or ())
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("ahla_chunk_fwd needs contiguous tensors")
    _build.refuse_grad("ahla_chunk_fwd", tensors)
    BH, n, d = q.shape
    dv = v.shape[-1]
    o = torch.empty_like(v)
    # the kernel reads the initial carry and writes the final one apart
    state = tuple(torch.empty(s, dtype=torch.float32, device=q.device)
                  for s in _state_shapes(BH, d, dv))
    init = (None,) * 4 if initial_state is None else tuple(
        x.data_ptr() for x in initial_state)
    saved = None
    if save_chunk_states:
        saved = tuple(torch.empty(s, dtype=torch.float32, device=q.device)
                      for s in _ckpt_shapes(BH, d, dv, -(-n // W)))
    lib = _build.load("ahla_chunk_fwd", _SIG)
    err = lib.ahla_chunk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if gamma is None else gamma.data_ptr(), *init, o.data_ptr(),
        *(x.data_ptr() for x in state),
        *((None,) * 2 if saved is None else (x.data_ptr() for x in saved)),
        BH, n, d, dv, int(q.dtype == torch.bfloat16), int(normalize), eps,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "ahla_chunk_fwd")
    _build.LAUNCHES["ahla_chunk_fwd"] += 1
    if saved is not None:
        return o, state, saved
    return o, state


def ahla_chunk_bwd_plain(q, k, v, gamma, do, chunk_states, *,
                         normalize: bool = False, eps: float = 1e-6):
    """Plain PyTorch version of the backward kernel: the chunks in reverse,
    each through ``ahla_chunk_math_bwd`` from its checkpoint
    (``hla2_chunk._walk_back``)."""
    return _walk_back(ahla_chunk_math_bwd, q, k, v, gamma, do, chunk_states,
                      normalize=normalize, eps=eps)


def ahla_chunk_bwd(q, k, v, gamma, do, chunk_states, *,
                   normalize: bool = False, eps: float = 1e-6):
    """Backward of ``ahla_chunk_fwd`` (output cotangent ``do``, no carry
    cotangent): ``q, k, v, gamma`` as the forward took them, ``do`` like
    ``v``, ``chunk_states`` the forward's checkpoints ``([P | m], [E |
    n])``.  Returns ``(dq, dk, dv, dgamma)`` in the inputs' dtypes,
    ``dgamma (BH,)`` fp32 or None when ``gamma`` is None."""
    _check_bwd(q, k, v, gamma, do, chunk_states, ckpt_shapes=_ckpt_shapes,
               leaves="([P | m], [E | n])")
    if q.device.type == "cpu":
        return ahla_chunk_bwd_plain(q, k, v, gamma, do, chunk_states,
                                    normalize=normalize, eps=eps)
    if q.device.type != "cuda":
        raise ValueError(f"ahla_chunk_bwd runs on cpu or cuda, not {q.device}")
    tensors = (q, k, v, do) + (() if gamma is None else (gamma,)) + tuple(
        chunk_states)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("ahla_chunk_bwd needs contiguous tensors")
    _build.refuse_grad("ahla_chunk_bwd", tensors)
    BH, n, d = q.shape
    dv_ = v.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dgamma = None if gamma is None else torch.empty_like(gamma)
    lib = _build.load("ahla_chunk_bwd", _BWD_SIG)
    size = lib.ahla_chunk_bwd_scratch_floats
    size.argtypes, size.restype = [_I] * 5, ctypes.c_long
    scratch = torch.empty(size(BH, n, d, dv_, int(normalize)),
                          dtype=torch.float32, device=q.device)
    err = lib.ahla_chunk_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if gamma is None else gamma.data_ptr(), do.data_ptr(),
        *(x.data_ptr() for x in chunk_states),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if gamma is None else dgamma.data_ptr(), scratch.data_ptr(),
        BH, n, d, dv_, int(q.dtype == torch.bfloat16), int(normalize), eps,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "ahla_chunk_bwd")
    _build.LAUNCHES["ahla_chunk_bwd"] += 1
    return dq, dk, dv, dgamma
