"""Logical-axis sharding rules with the divisibility fallback (twin of
``repro/distributed/sharding.py``), resolved into DTensor placements.

``RULES`` maps logical axis names to mesh axes.  ``spec_for`` resolves a
tuple of logical names against a mesh into the reference's
``PartitionSpec`` entries (a tuple: None, one mesh axis, or a tuple of
them), dropping (a) mesh axes the mesh does not have (a single-pod mesh
has no "pod") and (b) assignments whose dimension the axis size does not
divide (24 heads on a 16-wide model axis: replicated).  ``placements``
turns such a tuple into one DTensor placement per mesh dim: ``Shard(i)``
on every mesh dim that tensor dim ``i`` is split over, ``Replicate()``
elsewhere.

The reference's ambient ``with mesh:`` is an explicit, thread-local
``use_mesh(mesh)`` here; ``current_mesh()`` reads it.  Parameters,
moments and decode states are ``DTensor``s; DTensor's sharding
propagation plays GSPMD's part and ``constrain`` (``redistribute``) plays
``with_sharding_constraint``'s.  On a plain tensor ``constrain`` is the
identity.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch

from ..models.param import Spec, tree_map

# logical axis -> mesh axes (a tuple: try in order, use all present)
RULES = {
    "batch": ("pod", "data"),
    "seq": "model",  # sequence parallelism on the residual stream
    "vocab": "model",
    # FSDP: weight-matrix input dims shard over the data axis; each layer's
    # parameters are gathered where the layer runs (ZeRO-3 style)
    "embed": "data",
    "embed_out": "model",
    "q_heads": "model",
    "q_heads_flat": "model",
    "kv_heads": "model",
    "kv_heads_flat": "model",
    "head_dim": None,
    "ff": "model",
    "expert_ff": None,
    "experts": "model",
    "inner": "model",  # mamba d_inner
    "state": None,
    "conv": None,
    "layers": None,
    None: None,
}

_LOCAL = threading.local()


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh of this thread for the block (None
    leaves the block off-mesh); nests.  Inside a mesh a plain tensor that
    meets a DTensor in an op (an ``arange`` of positions, a mask) counts as
    replicated (DTensor's ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = getattr(_LOCAL, "mesh", None)
    _LOCAL.mesh = mesh
    try:
        if mesh is None:
            yield mesh
        else:
            with implicit_replication():
                yield mesh
    finally:
        _LOCAL.mesh = prev


def current_mesh():
    """The mesh of the innermost ``use_mesh`` of this thread, or None."""
    return getattr(_LOCAL, "mesh", None)


def _axes_for(name, sizes: dict, dim: int) -> Optional[Tuple[str, ...]]:
    cand = RULES.get(name, None)
    if cand is None:
        return None
    if isinstance(cand, str):
        cand = (cand,)
    present = tuple(a for a in cand if a in sizes)
    if not present:
        return None
    if dim % math.prod(sizes[a] for a in present) != 0:
        # shrink from the left (drop "pod" first)
        for i in range(1, len(present)):
            sub = present[i:]
            if dim % math.prod(sizes[a] for a in sub) == 0:
                return sub
        return None
    return present


def spec_for(axes, shape, mesh) -> tuple:
    """The reference's ``PartitionSpec`` entries for a tensor of ``shape``
    with logical ``axes``, as a tuple: per dim None, a mesh axis name, or
    a tuple of names.  A mesh axis shards at most one dim (the first that
    asks for it)."""
    sizes = mesh_axes(mesh)
    parts, used = [], set()
    for name, dim in zip(axes, shape):
        ax = _axes_for(name, sizes, dim)
        if ax is None or any(a in used for a in ax):
            parts.append(None)
        else:
            used.update(ax)
            parts.append(ax if len(ax) > 1 else ax[0])
    return tuple(parts)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a ``spec_for`` tuple.  A
    mesh dim of size 1 is ``Replicate()`` whatever the spec says: the same
    layout, and DTensor's view rules refuse to merge a dim "sharded" over
    one rank with its neighbours."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name, size in mesh_axes(mesh).items():
        dims = [i for i, part in enumerate(spec) if part == name or (
            isinstance(part, tuple) and name in part)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def param_shardings(specs, mesh):
    """Spec tree -> tree of placements."""
    return tree_map(lambda s: placements(
        spec_for(s.axes, s.shape, mesh), mesh), specs)


def zero1_spec(s: Spec, mesh, *, zero1: bool = True) -> tuple:
    """A moment's ``spec_for`` tuple: the parameter's, plus ZeRO-1 (the
    first dim the parameter leaves replicated and the data axis divides
    goes over ``"data"``, when no dim uses it yet)."""
    parts = list(spec_for(s.axes, s.shape, mesh))
    sizes = mesh_axes(mesh)
    if zero1 and "data" in sizes:
        dsize = sizes["data"]
        used = {a for part in parts if part for a in (
            part if isinstance(part, tuple) else (part,))}
        if "data" not in used:
            for i, (part, dim) in enumerate(zip(parts, s.shape)):
                if part is None and dim % dsize == 0 and dim >= dsize:
                    parts[i] = "data"
                    break
    return tuple(parts)


def opt_state_shardings(specs, mesh, *, zero1: bool = True):
    """Moment placements: the parameters', plus ZeRO-1 over the data axis
    (``zero1_spec``), so the moments spread over the data-parallel ranks."""
    return tree_map(lambda s: placements(
        zero1_spec(s, mesh, zero1=zero1), mesh), specs)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, logical_axes, mesh=None):
    """Redistribute ``x`` to the placements of its logical axes (the
    reference's ``with_sharding_constraint`` by logical names); the
    identity on a plain tensor (a DTensor is on a mesh by itself)."""
    if not _is_dtensor(x):
        return x
    # a DTensor's own mesh where none is current (autograd's thread)
    mesh = mesh if mesh is not None else (current_mesh() or x.device_mesh)
    want = placements(spec_for(logical_axes, x.shape, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def batch_sharding(mesh, shape) -> tuple:
    """Placements of a ``(batch, ...)`` input: batch over pod and data,
    with the divisibility fallback."""
    axes = ("batch",) + (None,) * (len(shape) - 1)
    return placements(spec_for(axes, shape, mesh), mesh)


def batch_rows(x: torch.Tensor, mesh):
    """A ``(batch, ...)`` tensor, the same on every rank (token ids, a
    position), as the model reads it on ``mesh``: a batch-sharded DTensor,
    each rank keeping its own rows.  Off-mesh (``mesh`` None) ``x`` as it
    is."""
    if mesh is None:
        return x
    return distribute_leaf(x, mesh, batch_sharding(mesh, x.shape))


def local_block(x: torch.Tensor, mesh, pl) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under placements ``pl``
    (no communication).  Shards are even (``spec_for`` keeps only axes
    that divide): a tensor dim split over several mesh dims is split by
    the first of them first, as DTensor does."""
    coord = mesh.get_coordinate()
    sizes = list(mesh.shape)
    index = [slice(None)] * x.ndim
    for d in range(x.ndim):
        over = [i for i, p in enumerate(pl) if p.is_shard(d)]
        if not over:
            continue
        parts = math.prod(sizes[i] for i in over)
        if x.shape[d] % parts:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"evenly over {parts} ranks")
        k = 0
        for i in over:
            k = k * sizes[i] + coord[i]
        n = x.shape[d] // parts
        index[d] = slice(k * n, (k + 1) * n)
    return x[tuple(index)]


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (no allocation)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def distribute_leaf(x: torch.Tensor, mesh, pl):
    """A full tensor, equal on every rank, as a DTensor with placements
    ``pl``: each rank keeps its own block (no communication)."""
    from torch.distributed.tensor import DTensor

    x = x.contiguous()
    return DTensor.from_local(local_block(x, mesh, pl).contiguous(), mesh,
                              pl, run_check=False, shape=x.shape,
                              stride=x.stride())


def distribute(tree, shardings, mesh):
    """A tree of full tensors (the same values on every rank: seeded
    alike, or restored) as DTensors with the placements of
    ``shardings`` (a tree of the same structure)."""
    return tree_map(lambda x, pl: distribute_leaf(x, mesh, pl), tree,
                    shardings)


def full(x):
    """The full tensor of a DTensor (an all-gather); a plain tensor as it
    is."""
    return x.full_tensor() if _is_dtensor(x) else x
