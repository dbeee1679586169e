"""Elementary blocks: RMSNorm, dense, embedding, SwiGLU — plain functions on
parameter dicts (twin of ``repro/models/blocks.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .param import Spec


def rmsnorm_specs(d: int):
    return {"scale": Spec((d,), init="ones")}


def rmsnorm_apply(p, x, eps: float = 1e-5):
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def dense_specs(d_in: int, d_out: int):
    return {"kernel": Spec((d_in, d_out))}


def dense_apply(p, x):
    return x @ p["kernel"].to(x.dtype)


def embed_specs(vocab: int, d: int):
    return {"embedding": Spec((vocab, d), init="embed", scale=0.02)}


def embed_apply(p, ids):
    return p["embedding"][ids]


def mlp_specs(d: int, d_ff: int):
    return {
        "wi_gate": dense_specs(d, d_ff),
        "wi_up": dense_specs(d, d_ff),
        "wo": dense_specs(d_ff, d),
    }


def mlp_apply(p, x):
    """SwiGLU."""
    return dense_apply(
        p["wo"], F.silu(dense_apply(p["wi_gate"], x)) * dense_apply(
            p["wi_up"], x))
