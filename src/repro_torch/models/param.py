"""Parameter specs, seeded init and loading of the reference's parameters.

Same key paths and layouts as ``repro/models/param.py``: dense kernels are
``(d_in, d_out)``, layer parameters carry a leading stacked ``layers`` axis.
The init scheme is the reference's: fan-in truncated normal in [-2, 2]
(the fan-in is the product of all but the last dim, the stacked axis
included), ``embed`` normal at 0.02, ``decay_a`` constant 3.0.  Torch's
generator is not JAX's threefry, so equal seeds give other numbers; tests
carry the reference's own parameters across with ``from_jax_params``.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | ones | embed | constant
    scale: Optional[float] = None  # override; default fan-in scaling
    const: float = 0.0  # for init == "constant"


def leaf_paths(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict, keys in sorted order."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from leaf_paths(tree[key], prefix + (key,))


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in leaf_paths(specs))


def param_bytes(specs) -> int:
    """Bytes of the parameters ``specs`` describe: every leaf is fp32."""
    return 4 * param_count(specs)


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _init_leaf(spec: Spec, gen: torch.Generator, device) -> torch.Tensor:
    f32 = torch.float32
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=f32, device=device)
    if spec.init == "constant":
        return torch.full(spec.shape, spec.const, dtype=f32, device=device)
    x = torch.empty(spec.shape, dtype=f32, device=device)
    if spec.init == "embed":
        scale = spec.scale if spec.scale is not None else 1.0
        return x.normal_(generator=gen).mul_(scale)
    if spec.init == "normal":
        fan_in = math.prod(spec.shape[:-1]) if len(spec.shape) > 1 else 1
        scale = spec.scale if spec.scale is not None else 1.0 / max(
            1.0, math.sqrt(fan_in))
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return x.mul_(scale)
    raise ValueError(spec.init)


def init_params(specs, seed: int, device="cuda"):
    """Materialize a param tree from ``specs`` on ``device``.  Each leaf
    draws from its own generator seeded by ``seed`` and the crc32 of its
    path, so a leaf's values do not depend on the other leaves."""
    device = torch.device(device)
    out = {}
    for path, spec in leaf_paths(specs):
        gen = torch.Generator(device=device)
        gen.manual_seed(
            (seed * 1_000_003 + zlib.crc32("/".join(path).encode()))
            % (2**63))
        _set(out, path, _init_leaf(spec, gen, device))
    return out


def from_jax_params(tree, specs, device="cuda"):
    """Carry the reference's parameters across: ``tree`` is the output of
    ``jax.device_get(init_params(lm_specs(cfg), key))`` (numpy leaves, the
    stacked ``layers`` axis leading); ``specs`` is this package's
    ``lm_specs(cfg)``.  Returns fp32 torch tensors on ``device``."""
    got = dict(leaf_paths(tree))
    want = dict(leaf_paths(specs))
    if set(got) != set(want):
        raise ValueError(
            f"parameter paths differ: missing {sorted(set(want) - set(got))},"
            f" unexpected {sorted(set(got) - set(want))}")
    out = {}
    for path, spec in want.items():
        arr = np.asarray(got[path], dtype=np.float32)
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, want "
                             f"{spec.shape}")
        _set(out, path, torch.from_numpy(arr.copy()).to(device))
    return out

