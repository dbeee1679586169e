"""Per-slot decode-state pool (twin of ``repro/serving/state_pool.py``).

The pooled states are the model's state tuple with every leaf
``(layers, slots, ...)``; the slot axis is axis 1 of every leaf.  The decode
kernel updates these tensors in place, so ``read_slot`` and
``snapshot_slot`` return copies: a reference to the pool would change under
the next decode step.  ``write_slot`` (and ``restore_slot``) accept a
single-slot state on any device: a host snapshot is copied in.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


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


class StatePool:
    """Owns the pooled decode states for ``slots`` concurrent requests.
    ``template_fn(n)`` builds the zero state tuple for ``n`` slots."""

    def __init__(self, template_fn: Callable[[int], Any], slots: int):
        if slots < 1:
            raise ValueError("need at least one slot")
        self.slots = slots
        self._template_fn = template_fn
        self.states = template_fn(slots)

    def empty_slot_state(self):
        """A fresh single-slot state (what an admitted request starts from)."""
        return self._template_fn(1)

    def write_slot(self, slot: int, state) -> None:
        """Copy a single-slot state (slot axis of extent 1, on the pool's
        device or the host) into ``slot``; other slots are untouched."""
        for pooled, new in zip(self.states, state):
            pooled[:, slot].copy_(new[:, 0])

    def read_slot(self, slot: int):
        """A copy of ``slot``'s state as a single-slot state tuple."""
        return type(self.states)(
            *(x[:, slot:slot + 1].clone() for x in self.states))

    def reset_slot(self, slot: int) -> None:
        """Zero a slot (eviction / quarantine)."""
        for x in self.states:
            x[:, slot].zero_()

    def finite_mask(self, states=None) -> torch.Tensor:
        """``(slots,)`` bool on the pool's device: True where every state
        element of that slot is finite, in the pool or in ``states``, a
        state tuple of the pool's layout.  No host sync."""
        src = self.states if states is None else states
        ok = torch.ones(self.slots, dtype=torch.bool, device=src[0].device)
        for x in src:
            ok &= x.isfinite().flatten(2).all(-1).all(0)
        return ok

    # -- snapshot / rollback (speculative decoding) -------------------------

    def snapshot_slot(self, slot: int, *, host: bool = False):
        """An O(state) copy of ``slot``'s decode state, a single-slot tuple.
        It stays as it was through later in-place decode steps on the pool.

        ``host=True`` returns CPU tensors instead: long-lived snapshots (the
        prefix cache holds many) then live in host RAM and take no device
        memory.  The transfer is a deliberate host sync; callers on the hot
        path keep ``host=False``."""
        snap = self.read_slot(slot)
        if not host:
            return snap
        # sync-point: host-RAM state snapshot
        return type(snap)(*(x.cpu() for x in snap))

    def restore_slot(self, slot: int, snapshot) -> None:
        """Roll ``slot`` back to ``snapshot`` (from ``snapshot_slot``, on the
        device or the host): one copy per leaf, other slots untouched."""
        self.write_slot(slot, snapshot)
