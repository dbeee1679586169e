"""AdamW + cosine schedule + global-norm clipping over a parameter dict.

Twin of ``repro/optim/adamw.py``, as plain functions over the nested
parameter dict (``torch.optim.AdamW`` decays and schedules otherwise).
Master weights and moments in fp32.  Weight decay applies to every leaf
with ``ndim >= 2``: with the stacked ``layers`` axis that includes the
norm scales, ``out_scale`` and ``decay_a`` of the layers, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..models.param import leaf_paths, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: int
    mu: Any  # dict like params (fp32)
    nu: Any  # dict like params (fp32)


def init_opt_state(params) -> OptState:
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step=0, mu=tree_map(z, params), nu=tree_map(z, params))


def cosine_lr(step, cfg: OptConfig) -> float:
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = min(max(prog, 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for _, x in leaf_paths(tree)))


def clip_by_global_norm(grads, max_norm):
    """Scales every leaf of ``grads`` **in place** so the global norm is at
    most ``max_norm``; returns ``(grads, norm before clipping)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for _, g in leaf_paths(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def adamw_update(params, grads, state: OptState, cfg: OptConfig):
    """Returns ``(params, new_state, metrics)``; ``metrics`` holds the
    step's learning rate and the gradient norm before clipping.

    **Updates in place**, as the reference's train step donates its
    parameters and moments: the leaves of ``params``, ``state.mu`` and
    ``state.nu`` hold the new values when this returns (the same tensors,
    in returned trees of the same dicts), and ``grads`` holds the clipped
    gradients.  A caller that needs the pre-step values copies them first.
    The elementwise operations and their order are the out-of-place
    formula's (``b1 * m + (1 - b1) * g``, ...), so fp32 results are
    bit-identical to it."""
    grads = tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, torch.float32)), grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_lr(step, cfg)
    b1, b2 = cfg.betas
    bc1, bc2 = 1 - b1**step, 1 - b2**step
    for (_, p), (_, m), (_, v), (_, g) in zip(
            leaf_paths(params), leaf_paths(state.mu), leaf_paths(state.nu),
            leaf_paths(grads)):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(((1 - b2) * g).mul_(g))
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay and p.dim() >= 2:  # no decay on 1-D leaves
            delta.add_(cfg.weight_decay * p)
        p.sub_(delta.mul_(lr))
    return params, OptState(step, state.mu, state.nu), {
        "lr": lr, "grad_norm": gnorm}
