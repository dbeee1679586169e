"""Row dispatch of the HLA kernels over a (data, model) mesh (twin of
``repro/distributed/shard_ops.py``).

The chunk and step kernels run on a grid of (batch, head) rows that are
independent: a scan carries state along time only, never across rows.  So
sharding the rows commutes with the kernels:

* batch rows over the ("pod", "data") axes,
* head rows over the "model" axis,
* time and feature dims replicated (a row's scan stays on one device).

``call_sharded(fn, *args)`` takes a kernel wrapper whose every tensor input
and output has leading ``(B, H)`` dims (q/k/v, gamma, the state leaves;
a 0-d or 1-d input, such as a KV cache's length, goes in whole),
redistributes each DTensor input to those row placements, runs ``fn`` on
the local blocks (``to_local``: the kernel on a CUDA tensor, its plain
version on a CPU tensor, exactly as off-mesh) and wraps each output back
into a DTensor (``from_local``).  Both are differentiable, so a kernel's
``autograd.Function`` backward runs per shard, as the reference's custom
VJPs do under ``shard_map``: dq, dk, dv and dgamma are row-local, and the
weight gradients are reduced outside, by DTensor.  An output that is an
input's local block (a decode step updates its state in place) comes back
as that input.

Divisibility fallback as ``sharding.spec_for``: an axis that does not
divide the row grid is dropped.  When no argument is a DTensor it is
exactly ``fn(*args)``; with DTensor arguments and no axis that divides
the grid every rank runs the whole grid on replicated inputs, the
reference's direct call under GSPMD.  The mesh is ``mesh=``, else the
current one, else the arguments' own (autograd runs a CUDA backward, a
remat recompute included, in a thread of its own, outside the caller's
``use_mesh``).

The plain records' chunk loops (``hla3``, ``hla3_paper``, ``linattn``),
GLA's and RWKV-6's take the same dispatch: their inputs and states are
(batch, head) rows too, and on a rank's block they run the one-device
code.

Under ``FakeTensorMode`` (the dry run, ``launch/dryrun.py``) a kernel's
``fn`` is not called: ``fake(*local_args)`` gives outputs of the right
shapes (and ``FAKE_FLOPS`` counts the kernels' FLOPs, which no aten op
carries).  Without a ``fake`` (plain torch) ``fn`` runs on the fake
blocks, and its aten ops count as any other.
"""

from __future__ import annotations

import math

import torch

from . import sharding as shd

#: kernel FLOPs the fake path accounted, by name (``launch/dryrun.py``)
FAKE_FLOPS: dict = {}


def count_flops(name: str, flops: float) -> None:
    """Add a fake kernel call's FLOPs to ``FAKE_FLOPS[name]``."""
    FAKE_FLOPS[name] = FAKE_FLOPS.get(name, 0.0) + float(flops)


def row_axes(mesh, B: int, H: int):
    """``(batch_axes, head_axes)`` for a ``(B, H, ...)`` row grid, or None
    when no axis of the mesh divides it."""
    if mesh is None:
        return None
    sizes = shd.mesh_axes(mesh)
    batch = tuple(a for a in ("pod", "data") if a in sizes)
    while batch and B % math.prod(sizes[a] for a in batch) != 0:
        batch = batch[1:]  # drop "pod" first, like sharding._axes_for
    head = ()
    if "model" in sizes and H % sizes["model"] == 0:
        head = ("model",)
    if not batch and not head:
        return None
    return batch, head


def _row_placements(axes, mesh):
    """One placement per mesh dim (a dim of size 1 replicated, as in
    ``sharding.placements``)."""
    from torch.distributed.tensor import Replicate, Shard

    batch, head = axes
    return tuple(Replicate() if size == 1 else Shard(0) if a in batch
                 else Shard(1) if a in head else Replicate()
                 for a, size in shd.mesh_axes(mesh).items())


def _flatten(tree):
    """Tensor leaves of nested tuples/lists (NamedTuples included) and a
    rebuild; None and other non-tensors pass through."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]

        def rebuild(xs):
            subs, i = [], 0
            for leaves, sub in parts:
                subs.append(sub(xs[i:i + len(leaves)]))
                i += len(leaves)
            if hasattr(tree, "_fields"):
                return type(tree)(*subs)
            return type(tree)(subs)

        return [x for leaves, _ in parts for x in leaves], rebuild
    return [], lambda xs: tree


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(x)


def call_sharded(fn, *args, mesh=None, fake=None):
    """Run ``fn(*args)`` with the ``(B, H)`` rows of every tensor argument
    sharded over the mesh (``mesh``, else ``sharding.current_mesh()``,
    else the DTensor arguments');
    returns ``fn``'s output structure with DTensor leaves.  ``fake``
    stands in for ``fn`` on fake tensors (same signature, shapes only)."""
    from torch.distributed.tensor import DTensor, Replicate

    leaves, rebuild = _flatten(args)
    dts = [x for x in leaves if isinstance(x, DTensor)]
    if not dts:
        return fn(*args)
    # the arguments' own mesh where none is current: a backward pass (a
    # remat recompute among it) runs in autograd's device thread
    mesh = mesh if mesh is not None else (
        shd.current_mesh() or dts[0].device_mesh)
    B, H = next(x for x in leaves if x.ndim >= 2).shape[:2]
    axes = row_axes(mesh, B, H) or ((), ())
    pl = _row_placements(axes, mesh)
    scale = (math.prod(shd.mesh_axes(mesh)[a] for a in axes[0]),
             math.prod(shd.mesh_axes(mesh)[a] for a in axes[1]))
    local, owner = [], {}
    for x in leaves:
        if x.ndim < 2:  # a scalar or a vector beside the rows: whole
            local.append(x.redistribute(mesh, (Replicate(),) * mesh.ndim)
                         .to_local() if isinstance(x, DTensor) else x)
            continue
        if isinstance(x, DTensor):
            y = x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
            loc = y.to_local()
            if y is x:
                owner[id(loc)] = x
        else:  # a full tensor, the same on every rank
            loc = shd.local_block(x, mesh, pl)
        local.append(loc)
    run = fake if fake is not None and any(_is_fake(x) for x in local) \
        else fn
    out = run(*rebuild(local))
    outs, rebuild_out = _flatten(out)
    wrapped = []
    for y in outs:
        if id(y) in owner:  # updated in place: the caller's own tensor
            wrapped.append(owner[id(y)])
            continue
        shape = (y.shape[0] * scale[0], y.shape[1] * scale[1]) + \
            tuple(y.shape[2:])
        wrapped.append(DTensor.from_local(
            y, mesh, pl, run_check=False, shape=torch.Size(shape),
            stride=shd.contiguous_stride(shape)))
    return rebuild_out(wrapped)
