"""Weights made from the seed, on the device, one large call a stacked leaf.

The layout is the repo's LM parameter tree (``embed``, ``layers`` with a
leading layer axis on every leaf, ``final_norm``, ``unembed`` unless the
embeddings are tied), written out from the configuration's widths; the
harness checks it against the program's own tree before a run.  Every
leaf draws from its own generator, seeded by the run's seed and the leaf's
path, so one leaf can be made again alone (the checks regenerate the
initial weights leaf by leaf rather than keep a copy).

Init: the repo's scheme.  The embedding normal at ``init.embedding_std``;
every matrix normal clipped at two standard deviations, scaled by one over
the square root of its fan-in, the product of all its dims but the last
with the stacked layer axis included (a layer's matrix is that much
smaller than its own input width alone would make it); norm and output
scales ones; decay logits the configuration's constant.
"""

from __future__ import annotations

import math
import zlib

import torch

from . import seeds


def _head_dim(c):
    return c.get("d_head") or c["d_model"] // c["n_heads"]


def leaf_specs(c):
    """``[(path, shape, init)]``, ``init`` one of ``("normal", fan_in)``,
    ``("embed", std)``, ``("const", value)``."""
    d, V, L = c["d_model"], c["vocab"], c["n_layers"]
    H, Hk, dh = c["n_heads"], c["n_kv_heads"], _head_dim(c)
    ones, std = ("const", 1.0), c["init"]["embedding_std"]
    out = [("embed/embedding", (V, d), ("embed", std))]

    def lay(path, shape, init):
        out.append((f"layers/{path}", (L,) + shape, init))

    def dense(path, d_in, d_out):
        lay(f"{path}/kernel", (d_in, d_out), ("normal", L * d_in))

    lay("ln1/scale", (d,), ones)
    lay("ln2/scale", (d,), ones)
    dense("mixer/wq", d, H * dh)
    dense("mixer/wk", d, Hk * dh)
    dense("mixer/wv", d, Hk * dh)
    dense("mixer/wo", H * dh, d)
    if c.get("qkv_bias"):
        for name, w in (("wq", H), ("wk", Hk), ("wv", Hk)):
            lay(f"mixer/{name}/bias", (w * dh,), ("const", 0.0))
    lay("mixer/out_scale", (H, dh), ones)
    lay("mixer/decay_a", (H,), ("const", c["init"]["decay_logit"]))
    if c.get("moe"):
        E, f = c["moe"]["n_experts"], c["moe"]["d_ff"]
        dense("moe/router", d, E)
        lay("moe/wi_gate", (E, d, f), ("normal", L * E * d))
        lay("moe/wi_up", (E, d, f), ("normal", L * E * d))
        lay("moe/wo", (E, f, d), ("normal", L * E * f))
    else:
        dense("mlp/wi_gate", d, c["d_ff"])
        dense("mlp/wi_up", d, c["d_ff"])
        dense("mlp/wo", c["d_ff"], d)
    out.append(("final_norm/scale", (d,), ones))
    if not c.get("tie_embeddings"):
        out.append(("unembed/kernel", (d, V), ("normal", d)))
    return out


def make_leaf(shape, init, seed, path, device):
    """One leaf, fp32, from its own generator."""
    kind, arg = init
    if kind == "const":
        return torch.full(shape, float(arg), dtype=torch.float32,
                          device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, "weights", zlib.crc32(path.encode())))
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.normal_(generator=gen)
    if kind == "embed":
        return x.mul_(arg)
    return x.clamp_(-2.0, 2.0).mul_(1.0 / math.sqrt(arg))


def _set(tree, path, value):
    node = tree
    keys = path.split("/")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def make_params(c, seed, device):
    """The whole parameter tree of config dict ``c`` for ``seed``."""
    tree = {}
    for path, shape, init in leaf_specs(c):
        _set(tree, path, make_leaf(shape, init, seed, path, device))
    return tree


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def regenerate(c, seed, device):
    """``(path, initial value)`` of every leaf, one at a time."""
    for path, shape, init in leaf_specs(c):
        yield path, make_leaf(shape, init, seed, path, device)
