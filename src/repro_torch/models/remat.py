"""Activation recomputation in training (twin of the reference's
``_maybe_remat``): ``cfg.remat`` is ``"none"``, ``"full"`` (keep a unit's
inputs, recompute everything in its backward: ``jax.checkpoint``) or
``"dots"`` (keep the outputs of the plain 2-d products as well: the
reference's ``checkpoint_dots_with_no_batch_dims`` policy).

``"dots"`` is ``torch.utils.checkpoint`` with a selective-checkpoint
policy: the outputs of ``aten.mm`` and ``aten.addmm`` (a projection of
``(B, n, d)`` rows flattens to one; a batched product is ``bmm``) are
saved, every other op is recomputed.  A custom ``autograd.Function`` (the
HLA kernels') runs again in the recomputation, as under ``"full"``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def active(cfg, mode: str = "train") -> bool:
    """True when a unit of a ``mode`` pass is recomputed in backward."""
    return mode == "train" and cfg.remat != "none" and \
        torch.is_grad_enabled()


def run(fn, *args, cfg):
    """``fn(*args)`` under ``cfg.remat``'s checkpoint (``active`` says
    whether to call it)."""
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, *args, use_reentrant=False, **kw)
