"""Per-slot decode-state pool (twin of ``repro/serving/state_pool.py``).

The pooled states are the model's state tuple with every leaf
``(layers, slots, ...)``; the slot axis is axis 1 of every leaf.  The decode
kernel updates these tensors in place, so ``read_slot`` returns a copy.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


class StatePool:
    """Owns the pooled decode states for ``slots`` concurrent requests.
    ``template_fn(n)`` builds the zero state tuple for ``n`` slots."""

    def __init__(self, template_fn: Callable[[int], Any], slots: int):
        if slots < 1:
            raise ValueError("need at least one slot")
        self.slots = slots
        self.states = template_fn(slots)

    def write_slot(self, slot: int, state) -> None:
        """Copy a single-slot state (slot axis of extent 1) into ``slot``;
        other slots are untouched."""
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

    def finite_mask(self) -> torch.Tensor:
        """``(slots,)`` bool on the pool's device: True where every state
        element of that slot is finite.  No host sync."""
        ok = torch.ones(self.slots, dtype=torch.bool,
                        device=self.states[0].device)
        for x in self.states:
            ok &= x.isfinite().flatten(2).all(-1).all(0)
        return ok
