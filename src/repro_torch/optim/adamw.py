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
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(params, grads, state: OptState, cfg: OptConfig):
    """Returns ``(new_params, new_state, metrics)``; ``metrics`` holds the
    step's learning rate and the gradient norm before clipping."""
    grads = tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, torch.float32)), grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_lr(step, cfg)
    b1, b2 = cfg.betas
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    bc1, bc2 = 1 - b1**step, 1 - b2**step

    def upd(p, m, v):
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:  # no decay on 1-D leaves
            delta = delta + cfg.weight_decay * p
        return p - lr * delta

    new_params = tree_map(upd, params, mu, nu)
    return new_params, OptState(step, mu, nu), {"lr": lr, "grad_norm": gnorm}
