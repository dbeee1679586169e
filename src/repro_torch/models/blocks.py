"""Elementary blocks: RMSNorm, LayerNorm, dense (with an optional bias),
embedding and its tied unembedding, RoPE, whisper's sinusoidal positions,
the MLPs — plain functions on parameter dicts (twin of
``repro/models/blocks.py``).  The mesh-aware embedding gather (multi-GPU)
is not ported."""

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


def layernorm_specs(d: int):
    return {"scale": Spec((d,), init="ones"),
            "bias": Spec((d,), init="zeros")}


def layernorm_apply(p, x, eps: float = 1e-5):
    """LayerNorm in fp32 (population variance), scale and bias applied in
    fp32; the result in ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def dense_specs(d_in: int, d_out: int, bias: bool = False):
    s = {"kernel": Spec((d_in, d_out))}
    if bias:
        s["bias"] = Spec((d_out,), init="zeros")
    return s


def dense_apply(p, x):
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def embed_specs(vocab: int, d: int):
    return {"embedding": Spec((vocab, d), init="embed", scale=0.02)}


def embed_apply(p, ids):
    return p["embedding"][ids]


def unembed_apply(p, x):
    """Logits through the embedding table (tied embeddings)."""
    return x @ p["embedding"].to(x.dtype).T


def rope(x, positions, theta: float = 1e4):
    """Rotary embedding, NeoX style (each head split into halves).  ``x``:
    ``(..., n, h, dh)`` or ``(..., n, dh)``; ``positions``: ``(..., n)``.
    The angles are fp32; the result has ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freqs  # (..., n, half)
    if x.ndim == ang.ndim + 1:  # a heads dim
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def sinusoidal_pos(n: int, d: int, dtype=torch.float32, device=None):
    """``(n, d)`` fixed positions: angle ``pos / 10000 ** (2 * dim / d)``
    for ``dim < d // 2``, sines then cosines, computed in fp32 and cast to
    ``dtype``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def mlp_specs(d: int, d_ff: int, act: str):
    if act == "swiglu":
        return {
            "wi_gate": dense_specs(d, d_ff),
            "wi_up": dense_specs(d, d_ff),
            "wo": dense_specs(d_ff, d),
        }
    if act in ("squared_relu", "gelu", "relu"):
        return {"wi": dense_specs(d, d_ff), "wo": dense_specs(d_ff, d)}
    raise ValueError(act)


def mlp_apply(p, x, act: str):
    if act == "swiglu":
        return dense_apply(p["wo"], F.silu(dense_apply(p["wi_gate"], x))
                           * dense_apply(p["wi_up"], x))
    h = dense_apply(p["wi"], x)
    if act == "squared_relu":
        h = F.relu(h).square()
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    else:
        h = F.relu(h)
    return dense_apply(p["wo"], h)
