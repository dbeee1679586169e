"""Per-slot decode-state pool (twin of ``repro/serving/state_pool.py``).

The pooled states are the model's state tree (``models.state_tree``: a flat
NamedTuple for hla2/ahla, nested for hla3) with every leaf ``(layers,
slots, ...)``; the slot axis is axis 1 of every leaf.  The decode
kernel updates these tensors in place, so ``read_slot`` and
``snapshot_slot`` return copies: a reference to the pool would change under
the next decode step.  ``write_slot`` (and ``restore_slot``) accept a
single-slot state on any device: a host snapshot is copied in.

On a mesh (``mesh=`` and a placements list, one per leaf, from
``distributed.steps.state_shardings_for``: slots over "data", heads over
"model") the pooled leaves are DTensors, born sharded from a full
template that every rank builds alike.  A slot then lives on the ranks
whose block of the slot axis holds it: ``write_slot`` and ``reset_slot``
touch only those local blocks, ``read_slot`` gathers the slot axis, and
``finite_mask`` reduces each rank's flags with one all-reduce.  A host
snapshot (``snapshot_slot(host=True)``) is the slot's whole state, the
same on every rank, and restores onto any mesh's layout (the reference's
``restore_slot`` onto the pool's current shardings).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..models.state_tree import leaves, tree_map


def to_device(x, device) -> torch.Tensor:
    """``x`` (a host array, a sequence or a tensor) as a tensor on
    ``device``.  A host value bound for the card goes through pinned memory
    and a non-blocking copy: a copy from pageable memory would make the host
    wait for the device, a sync the serving path does not budget for."""
    t = torch.as_tensor(x)
    device = torch.device(device)
    if t.device.type != "cpu" or device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _slot_block(x, slot_axis: int = 1):
    """``(local tensor, first global slot it holds, slots it holds)`` of
    a pooled DTensor leaf."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return x.to_local(), offset[slot_axis], shape[slot_axis]


def _slot_replicated(x):
    """``x``'s placements with the slot axis (1) replicated."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_shard(1) else p for p in x.placements)


def all_finite(states) -> torch.Tensor:
    """A bool scalar: every element of ``states`` finite.  No host sync; on
    a mesh each rank checks its own blocks and one all-reduce (min) joins
    them, so every rank holds the same flag."""
    src = leaves(states)
    if not any(_is_dtensor(x) for x in src):
        ok = torch.ones((), dtype=torch.bool, device=src[0].device)
        for x in src:
            ok &= x.isfinite().all()
        return ok
    loc = [x.to_local() if _is_dtensor(x) else x for x in src]
    ok = torch.ones((), dtype=torch.int32, device=loc[0].device)
    for x in loc:
        ok &= x.isfinite().all()
    return _all_min(ok, src).bool()


def _all_min(flags, src):
    import torch.distributed as dist

    group = next(x for x in src if _is_dtensor(x)).device_mesh
    for dim in range(group.ndim):
        dist.all_reduce(flags, op=dist.ReduceOp.MIN,
                        group=group.get_group(dim))
    return flags


class StatePool:
    """Owns the pooled decode states for ``slots`` concurrent requests.
    ``template_fn(n)`` builds the zero state tree for ``n`` slots; on a
    ``mesh`` the pool is that tree distributed with ``placements`` (a
    list, one per leaf in ``state_tree`` order)."""

    def __init__(self, template_fn: Callable[[int], Any], slots: int, *,
                 mesh=None, placements=None):
        if slots < 1:
            raise ValueError("need at least one slot")
        self.slots = slots
        self._template_fn = template_fn
        self.mesh = mesh
        self.states = template_fn(slots)
        if mesh is not None:
            from ..distributed.sharding import distribute_leaf

            pls = iter(placements)
            self.states = tree_map(
                lambda x: distribute_leaf(x, mesh, next(pls)), self.states)

    def empty_slot_state(self):
        """A fresh single-slot state (what an admitted request starts from)."""
        return self._template_fn(1)

    def write_slot(self, slot: int, state) -> None:
        """Copy a single-slot state (slot axis of extent 1, on the pool's
        device or the host) into ``slot``; other slots are untouched."""
        for pooled, new in zip(leaves(self.states), leaves(state)):
            if not _is_dtensor(pooled):
                pooled[:, slot].copy_(new[:, 0])
                continue
            loc, first, held = _slot_block(pooled)
            if not first <= slot < first + held:
                continue
            want = _slot_replicated(pooled)
            if _is_dtensor(new):
                new = new.redistribute(pooled.device_mesh, want).to_local()
            else:
                from ..distributed.sharding import local_block

                new = local_block(new.to(loc.device), pooled.device_mesh,
                                  want)
            loc[:, slot - first].copy_(new[:, 0])

    def read_slot(self, slot: int):
        """A copy of ``slot``'s state as a single-slot state tree (on a mesh:
        DTensors with the slot axis replicated)."""
        def one(x):
            if not _is_dtensor(x):
                return x[:, slot:slot + 1].clone()
            from torch.distributed.tensor import DTensor

            from ..distributed.sharding import contiguous_stride

            want = _slot_replicated(x)
            loc = x.redistribute(x.device_mesh, want).to_local()
            shape = (x.shape[0], 1) + tuple(x.shape[2:])
            return DTensor.from_local(
                loc[:, slot:slot + 1].clone(), x.device_mesh, want,
                run_check=False, shape=torch.Size(shape),
                stride=contiguous_stride(shape))

        return tree_map(one, self.states)

    def reset_slot(self, slot: int) -> None:
        """Zero a slot (eviction / quarantine)."""
        for x in leaves(self.states):
            if not _is_dtensor(x):
                x[:, slot].zero_()
                continue
            loc, first, held = _slot_block(x)
            if first <= slot < first + held:
                loc[:, slot - first].zero_()

    def finite_mask(self, states=None) -> torch.Tensor:
        """``(slots,)`` bool on the pool's device: True where every state
        element of that slot is finite, in the pool or in ``states``, a
        state tree of the pool's layout.  No host sync (on a mesh one
        all-reduce, and every rank holds the whole mask)."""
        src = leaves(self.states if states is None else states)
        if not any(_is_dtensor(x) for x in src):
            ok = torch.ones(self.slots, dtype=torch.bool,
                            device=src[0].device)
            for x in src:
                ok &= x.isfinite().flatten(2).all(-1).all(0)
            return ok
        dev = src[0].to_local().device
        ok = torch.ones(self.slots, dtype=torch.int32, device=dev)
        for x in src:
            loc, first, held = _slot_block(x)
            ok[first:first + held] &= loc.isfinite().flatten(2).all(
                -1).all(0)
        return _all_min(ok, src).bool()

    # -- snapshot / rollback (speculative decoding) -------------------------

    def snapshot_slot(self, slot: int, *, host: bool = False):
        """An O(state) copy of ``slot``'s decode state, a single-slot tree.
        It stays as it was through later in-place decode steps on the pool.

        ``host=True`` returns CPU tensors instead: long-lived snapshots (the
        prefix cache holds many) then live in host RAM and take no device
        memory.  The transfer is a deliberate host sync; callers on the hot
        path keep ``host=False``."""
        snap = self.read_slot(slot)
        if not host:
            return snap
        from ..distributed.sharding import full

        # sync-point: host-RAM state snapshot (on a mesh the whole state,
        # gathered from every rank's block, the same on every rank)
        return tree_map(lambda x: full(x).cpu(), snap)

    def restore_slot(self, slot: int, snapshot) -> None:
        """Roll ``slot`` back to ``snapshot`` (from ``snapshot_slot``, on the
        device or the host): one copy per leaf, other slots untouched.  A
        host snapshot is a whole state, so it restores onto the pool's own
        layout, whatever mesh it was taken on: each rank copies in its
        block."""
        self.write_slot(slot, snapshot)
