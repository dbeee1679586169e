"""AdamW + cosine schedule + global-norm clipping over a parameter dict.

Twin of ``repro/optim/adamw.py``, as plain functions over the nested
parameter dict (``torch.optim.AdamW`` decays and schedules otherwise).
Master weights and moments in fp32 by default; a bf16 parameter or
moment (jamba's ``param_dtype`` / ``moment_dtype``) is updated in fp32
and stored back rounded, as the reference does.  Weight decay applies to
every leaf with ``ndim >= 2``: with the stacked ``layers`` axis that
includes the norm scales, ``out_scale`` and ``decay_a`` of the layers, as
in the reference.

Under a mesh the leaves are DTensors: the moments may be split further
than their parameters (ZeRO-1, ``distributed.sharding.zero1_spec``), each
gradient is brought to its moments' placements (a local slice) and the
update to the parameter's (an all-gather over "data"), and the clip's
global norm is one sum of squares over every leaf's local block (each
block counted once: on the first rank of every mesh dim it is replicated
over; a ``Partial`` gradient is summed first), reduced once over the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

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
    mu: Any  # dict like params (moment_dtype)
    nu: Any  # dict like params (moment_dtype)


def init_opt_state(params, moment_dtype=torch.float32) -> OptState:
    """Zero moments in ``moment_dtype`` (a torch dtype or its name)."""
    if isinstance(moment_dtype, str):
        moment_dtype = getattr(torch, moment_dtype)

    def z(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return OptState(step=0, mu=tree_map(z, params), nu=tree_map(z, params))


def cosine_lr(step, cfg: OptConfig) -> float:
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = min(max(prog, 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    xs = [x for _, x in leaf_paths(tree)]
    if not any(isinstance(x, DTensor) for x in xs):
        return torch.sqrt(sum(x.float().square().sum() for x in xs))
    mesh = xs[0].device_mesh
    coord = mesh.get_coordinate()
    # a Partial block is a share of a sum: reduce it before squaring
    xs = [x.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                for pl in x.placements])
          if any(pl.is_partial() for pl in x.placements) else x for x in xs]
    loc = [x.to_local() for x in xs]
    total = torch.zeros((), dtype=torch.float32, device=loc[0].device)
    for x, lx in zip(xs, loc):
        # a block replicated over a mesh dim counts on that dim's rank 0
        if all(c == 0 for c, pl in zip(coord, x.placements)
               if not pl.is_shard()):
            total = total + lx.float().square().sum()
    part = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                              run_check=False)
    return torch.sqrt(part.full_tensor())


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
    bit-identical to it.  A leaf stored in a narrower dtype than fp32 (a
    bf16 parameter or moment) is computed in fp32 from its stored value
    and copied back rounded, as the reference's ``(p32 - lr *
    delta).astype(p.dtype)``: never an in-place op in bf16."""
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
        if isinstance(m, DTensor) and g.placements != m.placements:
            g = g.redistribute(m.device_mesh, m.placements)
        ct = torch.promote_types(p.dtype, torch.float32)
        if m.element_size() >= 4:
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_(((1 - b2) * g).mul_(g))
            m_c, v_c = m, v
        else:  # narrow moments: the new value in fp32, stored rounded
            m_c = (b1 * m.to(g.dtype)).add_((1 - b1) * g)
            v_c = (b2 * v.to(g.dtype)).add_(((1 - b2) * g).mul_(g))
            m.copy_(m_c)
            v.copy_(v_c)
            m_c, v_c = m.to(ct), v.to(ct)  # the reference reads them back
        delta = (m_c / bc1).div_((v_c / bc2).sqrt_().add_(cfg.eps))
        if p.element_size() >= 4:
            if cfg.weight_decay and p.dim() >= 2:  # no decay on 1-D leaves
                delta.add_(cfg.weight_decay * p)
            p.sub_(delta.mul_(lr))
        else:
            p32 = p.to(ct)
            if cfg.weight_decay and p.dim() >= 2:
                delta.add_(cfg.weight_decay * p32)
            p.copy_(p32.sub_(delta.mul_(lr)))
    return params, OptState(step, state.mu, state.nu), {
        "lr": lr, "grad_norm": gnorm}
