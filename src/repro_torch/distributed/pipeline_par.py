"""Pipeline parallelism: a GPipe microbatched pipeline over a "pipe" mesh
axis (twin of ``repro/distributed/pipeline_par.py``).

A stack of ``L`` layers is split into ``S`` contiguous stages, one a rank
of the "pipe" axis, and microbatches stream through with the classic
``M + S - 1``-tick schedule: at tick ``t`` stage 0 takes microbatch ``t``,
every other stage takes what its predecessor sent at tick ``t - 1``, and
the last stage emits microbatch ``t - (S - 1)``.  The shift between
stages (the reference's ``ppermute``) is a differentiable point-to-point
exchange, ``_Shift``: its backward is the reverse shift.  So autograd
through ``pipelined_forward`` gives the GPipe backward, as ``jax.grad``
does through the reference's, with no hand-written adjoint schedule.
The outputs are broadcast from the last stage (``_FromLast``): every rank
returns the same ``(M, mb, ...)`` tensor, and only the last stage's copy
carries the gradient back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _exchange(x, group, send_to, recv_from):
    """Send ``x`` to the group rank ``send_to`` and receive a tensor like
    it from ``recv_from`` (either may be None); zeros when nothing
    arrives."""
    out = torch.zeros_like(x)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, recv_from), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    """Stage ``s`` sends to ``s + 1`` and receives from ``s - 1`` (stage 0
    receives zeros); the backward sends the gradient the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        s, S = dist.get_rank(group), dist.get_world_size(group)
        return _exchange(x, group, s + 1 if s + 1 < S else None,
                         s - 1 if s > 0 else None)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        s, S = dist.get_rank(group), dist.get_world_size(group)
        return _exchange(g, group, s - 1 if s > 0 else None,
                         s + 1 if s + 1 < S else None), None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor ``x`` on every rank; the gradient reaches the
    last stage's ``x`` alone (the other ranks' are placeholders).  ``tail``
    (every shift's output, stacked) gets a zero gradient, so that autograd
    runs every shift's backward on every rank, those whose output no
    later tick reads too (stage 0's): each one's partner waits for it."""

    @staticmethod
    def forward(ctx, x, tail, group):
        ctx.last = dist.get_rank(group) == dist.get_world_size(group) - 1
        ctx.tail = (tail.shape, tail.dtype, tail.device)
        out = x.clone()
        dist.broadcast(out, dist.get_global_rank(
            group, dist.get_world_size(group) - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.tail
        return (g if ctx.last else torch.zeros_like(g),
                torch.zeros(shape, dtype=dtype, device=device), None)


def _local_layers(tree, S: int, s: int):
    """Stage ``s`` of ``S``'s contiguous block of every leaf's leading
    (layers) dim."""
    from ..models.param import tree_map

    def local(x):
        if x.shape[0] % S:
            raise ValueError(f"{x.shape[0]} layers do not split into {S} "
                             "stages")
        n = x.shape[0] // S
        return x[s * n:(s + 1) * n]

    return tree_map(local, tree)


def pipelined_forward(layer_fn, stage_params, x_microbatches, mesh, *,
                      axis_name: str = "pipe"):
    """Run the stack over microbatches with pipeline parallelism.

    ``layer_fn(layer_params, x) -> x`` is one layer; ``stage_params`` a
    tensor or a dict of tensors whose leaves are ``(L, ...)``, stacked over
    all layers, the same on every rank, ``L`` a multiple of the axis size:
    each stage takes its ``L / S`` layers, and their gradient lands on that
    block alone.  ``x_microbatches`` is ``(M, mb, ...)``, the same on every
    rank.  Returns the ``(M, mb, ...)`` outputs, the same on every rank."""
    from ..models.param import unstack

    group = mesh.get_group(axis_name)
    S = dist.get_world_size(group)
    stage = dist.get_rank(group)
    local = _local_layers(stage_params, S, stage)
    layers = unstack(local)
    M = x_microbatches.shape[0]

    def stage_apply(x):
        for p in layers:
            x = layer_fn(p, x)
        return x

    buf = torch.zeros_like(x_microbatches[0])
    outputs, shifted = [None] * M, [buf]
    for t in range(M + S - 1):
        x_in = x_microbatches[min(t, M - 1)] if stage == 0 else buf
        y = stage_apply(x_in)
        if t >= S - 1 and stage == S - 1:
            outputs[t - (S - 1)] = y
        if t < M + S - 2:  # the last tick's shift feeds nothing
            buf = _Shift.apply(y, group)
            shifted.append(buf)
    if stage != S - 1:
        outputs = [torch.zeros_like(buf)] * M
    return _FromLast.apply(torch.stack(outputs), torch.stack(shifted),
                           group)
