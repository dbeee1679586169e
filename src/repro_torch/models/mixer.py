"""The HLA2 mixer sublayer (twin of the ``hla2`` record of
``repro/models/mixer.py``).

Multi-head projections around the HLA2 kernels: q scaled by
``head_dim**-0.5``, K/V heads repeated to the query heads (GQA), per-head
decay ``gamma = sigmoid(decay_a)`` (or fixed, or none), and a per-head RMS
output norm with a learned ``out_scale``.  The full-sequence path is one
chunk-parallel kernel launch per call: differentiable and stateless for
training (``kernels.ops.hla2_attention``), or returning the carry for
prefill (``kernels.ops.hla2_prefill``); the one-token path one batched
decode-step launch that updates the state in place
(``kernels.ops.hla2_decode_step``).
"""

from __future__ import annotations

import torch

from ..core.hla2 import hla2_init_state
from ..kernels import ops as kops
from . import seq_op
from .blocks import dense_apply, dense_specs
from .param import Spec

OUT_NORM_EPS = 1e-6
HLA_EPS = 1e-6


def mixer_specs(cfg):
    d, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": dense_specs(d, H * dh),
        "wk": dense_specs(d, Hk * dh),
        "wv": dense_specs(d, Hk * dh),
        "wo": dense_specs(H * dh, d),
        "out_scale": Spec((H, dh), init="ones"),
    }
    if cfg.hla.decay == "learned":
        s["decay_a"] = Spec((H,), init="constant", const=3.0)
    return s


def _gamma(p, cfg, B, device):
    if cfg.hla.decay == "none":
        return None
    if cfg.hla.decay == "fixed":
        g = torch.full((cfg.n_heads,), cfg.hla.fixed_gamma,
                       dtype=torch.float32, device=device)
    else:
        g = torch.sigmoid(p["decay_a"].float())
    return g[None].expand(B, cfg.n_heads)


def _project(p, x, cfg):
    B, n, _ = x.shape
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense_apply(p["wq"], x).reshape(B, n, H, dh).transpose(1, 2)
    k = dense_apply(p["wk"], x).reshape(B, n, Hk, dh).transpose(1, 2)
    v = dense_apply(p["wv"], x).reshape(B, n, Hk, dh).transpose(1, 2)
    q = q * dh**-0.5
    if Hk != H:  # GQA: broadcast KV heads to query heads
        k = k.repeat_interleave(H // Hk, dim=1)
        v = v.repeat_interleave(H // Hk, dim=1)
    return q, k, v


def _out_norm(p, o):
    """Per-head RMS norm + learned scale (stabilizes unnormalized HLA)."""
    o32 = o.float()
    o32 = o32 * torch.rsqrt(o32.square().mean(-1, keepdim=True) + OUT_NORM_EPS)
    return (o32 * p["out_scale"][None, :, None, :]).to(o.dtype)


def hla2_forward(p, x, cfg, *, state=None, want_state=True):
    """Full-sequence path (train / prefill) over ``x (B, n, d_model)``;
    ``state`` is an optional carry to resume from.  Returns ``(y,
    final_state)``; with no carry in and none wanted (training) the final
    state is None and the path is differentiable."""
    B, n, _ = x.shape
    q, k, v = _project(p, x, cfg)
    gamma = _gamma(p, cfg, B, x.device)
    kw = dict(normalize=cfg.hla.normalize, eps=HLA_EPS, lam=cfg.hla.lam)
    if want_state or state is not None:
        o, st = kops.hla2_prefill(q, k, v, gamma, state=state, **kw)
    else:
        o, st = kops.hla2_attention(q, k, v, gamma, **kw), None
    o = _out_norm(p, o.to(x.dtype))
    o = o.transpose(1, 2).reshape(B, n, cfg.n_heads * cfg.head_dim)
    return dense_apply(p["wo"], o), st


def hla2_step(p, x_t, state, cfg):
    """One-token decode over ``x_t (B, 1, d_model)``; ``state`` is updated
    in place.  Returns ``(y, state)``."""
    B = x_t.shape[0]
    q, k, v = _project(p, x_t, cfg)
    state, o = kops.hla2_decode_step(
        state, q[:, :, 0], k[:, :, 0], v[:, :, 0],
        _gamma(p, cfg, B, x_t.device),
        normalize=cfg.hla.normalize, eps=HLA_EPS, lam=cfg.hla.lam,
    )
    o = _out_norm(p, o[:, :, None, :].to(x_t.dtype))
    o = o.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return dense_apply(p["wo"], o), state


def hla2_init(cfg, B, device):
    dh = cfg.head_dim
    return hla2_init_state((B, cfg.n_heads), dh, dh, torch.float32, device)


seq_op.register_op(seq_op.SequenceOp(
    name="hla2", specs=mixer_specs, forward=hla2_forward, step=hla2_step,
    init_state=hla2_init,
))
