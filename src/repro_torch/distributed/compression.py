"""Gradient compression: the int8 error-feedback all-reduce (twin of
``repro/distributed/compression.py``).

A wire-level compressed mean in two phases, both moving int8:

  1. reduce-scatter phase: each rank quantizes its vector (after adding the
     error-feedback buffer) in ``n`` chunks, one per rank, each with its own
     fp32 scale; ``all_to_all_single`` ships the int8 chunks and the
     scales, and each rank dequantizes, sums and divides by ``n`` the chunk
     it owns;
  2. all-gather phase: the reduced chunk is re-quantized and
     ``all_gather_into_tensor``-ed (int8) with its scale.

The quantizer is the reference's: ``scale = max|x| / 127 + 1e-12``, round
half to even, clip to +-127.  Error feedback (``new_error = x_ef -
dequant(q)``, Karimireddy et al.) keeps SGD convergent; the buffer lives in
the caller's optimizer state.  Plain torch on any backend that moves int8
(NCCL on the cards, gloo on the CPU); the reference computes it in jnp
inside ``shard_map``, outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _quantize(x):
    """``x (..., c)`` fp32 -> ``(q int8, scale fp32 (...))`` per row of its
    last dim."""
    scale = x.abs().amax(-1) / 127.0 + 1e-12
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def int8_allreduce_mean(x, error=None, *, group=None):
    """The mean of ``x`` over the ranks of ``group`` (default: the world)
    with int8 wire traffic.  ``x``: a 1-d fp32 tensor of the same shape on
    every rank; ``error`` its error-feedback buffer (None: zeros).  Returns
    ``(mean estimate fp32, new error)``, the estimate the same on every
    rank."""
    n = dist.get_world_size(group)
    size = x.shape[0]
    pad = (-size) % n
    xe = x.float() if error is None else x.float() + error.float()
    xp = torch.nn.functional.pad(xe, (0, pad))
    chunks = xp.reshape(n, -1)  # row r -> the rank that reduces it
    qs, scales = _quantize(chunks)
    new_error = (xp - (qs.float() * scales[:, None]).reshape(-1))[:size]

    # phase 1: int8 chunks and their scales to their owners; dequant-sum
    recv_q = torch.empty_like(qs)
    recv_s = torch.empty_like(scales)
    dist.all_to_all_single(recv_q, qs.contiguous(), group=group)
    dist.all_to_all_single(recv_s, scales.contiguous(), group=group)
    part = (recv_q.float() * recv_s[:, None]).sum(0) / n

    # phase 2: re-quantize the reduced chunk, gather it (int8) everywhere
    q2, s2 = _quantize(part)
    gq = torch.empty(n * q2.numel(), dtype=torch.int8, device=q2.device)
    gs = torch.empty((n,), dtype=torch.float32, device=q2.device)
    dist.all_gather_into_tensor(gq, q2.contiguous(), group=group)
    dist.all_gather_into_tensor(gs, s2.reshape(1).contiguous(), group=group)
    full = (gq.reshape(n, -1).float() * gs[:, None]).reshape(-1)
    return full[:size], new_error


def make_compressed_grad_allreduce(mesh, axis_name: str = "data"):
    """``run(grads, errors) -> (mean grads, new errors)``: the int8
    error-feedback mean of every leaf over ``axis_name`` of ``mesh`` (a
    ``DeviceMesh``).  ``grads`` and ``errors`` are dicts of plain tensors
    of the same structure, each rank's own *unreduced* gradients (a manual
    data-parallel step); the results keep each leaf's shape, the means in
    fp32."""
    from ..models.param import tree_map

    group = mesh.get_group(axis_name)

    def run(grads, errors):
        pairs = tree_map(lambda g, e: int8_allreduce_mean(
            g.reshape(-1), e.reshape(-1), group=group), grads, errors)
        return (tree_map(lambda g, p: p[0].reshape(g.shape), grads, pairs),
                tree_map(lambda g, p: p[1].reshape(g.shape), grads, pairs))

    return run


def quantize_dequantize(x):
    """The straight int8 round trip of the whole of ``x`` (one scale): the
    compression loss of one quantization."""
    q, s = _quantize(x.reshape(-1).float())
    return (q.float() * s).reshape(x.shape)
