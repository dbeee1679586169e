"""RWKV-6 (Finch) time mix and channel mix: the attention-free rwkv6-7b
(twin of ``repro/models/rwkv6.py``).

A matrix-valued state per head with a **data-dependent per-channel decay**
``w_t`` (a low-rank MLP, the Finch hallmark), a bonus ``u`` for the
current token, token-shift lerps, a per-head GroupNorm and a silu gate.
As in the reference, the token-shift mix ratios are static except the
decay channel's, which carries the data-dependent low-rank path.

Chunk-parallel in log-decay space: cumulative log-decays inside a chunk,
a sequential carry across chunks (a Python loop in place of
``lax.scan``).  The intra-chunk scores factor as ``exp(lc_ex) x
exp(-lc)``; each factor stays in fp32's range because the per-token
log-decay is clamped at ``LOGW_MIN`` and the chunk is ``RWKV_CHUNK``
wide (``|lc| <= 32 * 2.5 = 80 < log(fp32 max) ~ 88``).

The ``rwkv6`` record is ``self_contained``: the layer owns its two
LayerNorms and the channel mix (the token-shift state crosses both
sublayers), so it replaces the whole pre-norm block.  Plain torch, as the
reference is plain jnp: RWKV-6 has no TPU kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..distributed.shard_ops import call_sharded
from ..distributed.sharding import constrain
from . import seq_op
from .blocks import (
    dense_apply,
    dense_specs,
    layernorm_apply,
    layernorm_specs,
    split_heads,
)
from .param import Axes, Spec

LOGW_MIN = -2.5  # per-token log-decay floor (see the module docstring)
RWKV_CHUNK = 32  # |lc| <= w * |LOGW_MIN| = 80 < log(fp32 max) ~ 88
GN_EPS = 1e-5


class RWKVState(NamedTuple):
    x_prev_t: torch.Tensor  # (B, 1, d) last ln1 output (time-mix shift)
    x_prev_c: torch.Tensor  # (B, 1, d) last ln2 output (channel-mix shift)
    S: torch.Tensor  # (B, H, dk, dv) wkv state, fp32


def rwkv6_specs(cfg):
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    H = d // dh
    lora = max(32, d // 64)

    def mu():
        return Spec((d,), ("embed",), init="constant", const=0.5)

    return {
        "ln1": layernorm_specs(d),
        "ln2": layernorm_specs(d),
        "tm": {  # time mix
            "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_g": mu(),
            "mu_w": mu(),
            "wr": dense_specs(d, d, axes=("embed", "q_heads_flat")),
            "wk": dense_specs(d, d, axes=("embed", "q_heads_flat")),
            "wv": dense_specs(d, d, axes=("embed", "q_heads_flat")),
            "wg": dense_specs(d, d, axes=("embed", "q_heads_flat")),
            "w_lora_a": dense_specs(d, lora, axes=("embed", None)),
            "w_lora_b": dense_specs(lora, d, axes=(None, "q_heads_flat")),
            "w0": Spec((d,), ("q_heads_flat",), init="constant", const=-5.0),
            "u": Spec((H, dh), ("q_heads", "head_dim"), init="normal",
                      scale=0.5),
            "gn_scale": Spec((H, dh), ("q_heads", "head_dim"), init="ones"),
            "gn_bias": Spec((H, dh), ("q_heads", "head_dim"), init="zeros"),
            "wo": dense_specs(d, d, axes=("q_heads_flat", "embed")),
        },
        "cm": {  # channel mix
            "mu_k": mu(), "mu_r": mu(),
            "wk": dense_specs(d, cfg.d_ff, axes=("embed", "ff")),
            "wv": dense_specs(cfg.d_ff, d, axes=("ff", "embed")),
            "wr": dense_specs(d, d, axes=("embed", "embed_out")),
        },
    }


def _shift(x, x_prev):
    """Token shift: the previous token of every position (``x_prev``, or
    zeros, before the first)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], 1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _wkv_chunks(r, k, v, logw, u, S, chunk: int):
    """The chunked wkv recurrence over ``(B, H, n, dh)`` fp32 inputs from
    the carry ``S (B, H, dh, dh)``, with the bonus ``u (B, H, dh)`` (every
    input a (batch, head) row tensor: ``call_sharded`` runs it on a rank's
    rows).  Returns ``(y (B, H, n, dh), S)``.
    Zero-padding the tail is exact: a padded log-decay of 0 keeps the
    carry, a padded key of 0 adds nothing."""
    n = r.shape[2]
    w = min(chunk, n)
    pad = (w - n % w) % w
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, logw))
    tidx = torch.arange(w, device=r.device)
    mask = (tidx[:, None] > tidx[None, :]).float()  # j < t
    ub = u[:, :, None]  # (B, H, 1, dh)
    ys = []
    for c0 in range(0, n + pad, w):
        r_, k_, v_, lw_ = (t[:, :, c0:c0 + w] for t in (r, k, v, logw))
        lc = lw_.cumsum(2)  # inclusive
        lc_ex = lc - lw_  # exclusive
        rq = r_ * lc_ex.exp()
        scores = rq @ (k_ * (-lc).exp()).transpose(-1, -2)
        y = (scores * mask) @ v_
        y = y + (r_ * ub * k_).sum(-1, keepdim=True) * v_  # the bonus
        y = y + rq @ S  # the carry
        lc_end = lc[..., -1:, :]  # (B, H, 1, dk)
        S = lc_end[..., 0, :].exp()[..., :, None] * S + \
            (k_ * (lc_end - lc).exp()).transpose(-1, -2) @ v_
        ys.append(y)
    return torch.cat(ys, 2)[:, :, :n], S


def rwkv6_time_mix(p, x, cfg, state: Optional[RWKVState],
                   chunk: int = RWKV_CHUNK):
    """``x (B, n, d)`` (ln1's output), resumed from ``state`` when given
    (only read).  Returns ``(y, RWKVState)``: ``x_prev_t`` is ``x``'s last
    token, ``x_prev_c`` passes through, ``S`` is fp32."""
    B, n, d = x.shape
    dh = cfg.rwkv_head_dim
    H = d // dh
    xs = _shift(x, state.x_prev_t if state is not None else None)

    def heads(t):  # on a mesh heads over "model" (the reference's)
        return constrain(split_heads(t, H, dh).transpose(1, 2),
                         ("batch", "q_heads", None, None)).float()

    r = heads(dense_apply(p["wr"], _lerp(x, xs, p["mu_r"])))
    k = heads(dense_apply(p["wk"], _lerp(x, xs, p["mu_k"])))
    v = heads(dense_apply(p["wv"], _lerp(x, xs, p["mu_v"])))
    g = dense_apply(p["wg"], _lerp(x, xs, p["mu_g"]))
    xw = _lerp(x, xs, p["mu_w"])
    # the data-dependent decay (Finch): log w in (-inf, 0), clamped so the
    # chunk factorization stays in fp32's range (a per-token decay of
    # exp(-2.5) ~ 0.08 already means "forget")
    dd = dense_apply(p["w_lora_b"], torch.tanh(dense_apply(p["w_lora_a"], xw)))
    logw = -torch.exp(p["w0"].float() + dd.float())
    logw = heads(logw.clamp(LOGW_MIN, -1e-6))
    S0 = state.S.float() if state is not None else \
        x.new_zeros((B, H, dh, dh), dtype=torch.float32)
    u = p["u"].float()[None].expand(B, H, dh)
    y, S = call_sharded(
        lambda *a: _wkv_chunks(*a, chunk), r, k, v, logw, u, S0)

    # per-head GroupNorm (population variance) and the gate
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + GN_EPS)
    yn = yn * p["gn_scale"][None, :, None] + p["gn_bias"][None, :, None]
    yn = constrain(yn.transpose(1, 2).reshape(B, n, d).to(x.dtype),
                   ("batch", None, "q_heads_flat"))
    out = dense_apply(p["wo"], yn * F.silu(g))
    x_prev_c = state.x_prev_c if state is not None else \
        torch.zeros_like(x[:, :1])
    return out, RWKVState(x_prev_t=x[:, -1:], x_prev_c=x_prev_c, S=S)


def rwkv6_channel_mix(p, x, cfg, state: Optional[RWKVState]):
    """``x (B, n, d)`` (ln2's output).  Returns ``(y, x's last token)``."""
    xs = _shift(x, state.x_prev_c if state is not None else None)
    kk = F.relu(dense_apply(p["wk"], _lerp(x, xs, p["mu_k"]))).square()
    rr = torch.sigmoid(dense_apply(p["wr"], _lerp(x, xs, p["mu_r"])))
    return rr * dense_apply(p["wv"], kk), x[:, -1:]


def rwkv6_layer_apply(p, x, cfg, state: Optional[RWKVState] = None,
                      chunk: int = RWKV_CHUNK):
    """One self-contained RWKV-6 layer on the residual stream: ln1, time
    mix, residual, ln2, channel mix, residual.  ``state`` is only read.
    Returns ``(x_out, RWKVState)``."""
    xn = layernorm_apply(p["ln1"], x, cfg.norm_eps)
    y, st = rwkv6_time_mix(p["tm"], xn, cfg, state, chunk=chunk)
    x = x + y
    xn2 = layernorm_apply(p["ln2"], x, cfg.norm_eps)
    y2, x_prev_c = rwkv6_channel_mix(p["cm"], xn2, cfg, state)
    return x + y2, RWKVState(x_prev_t=st.x_prev_t, x_prev_c=x_prev_c,
                             S=st.S)


def rwkv6_init_state(cfg, B, device, dtype=torch.float32) -> RWKVState:
    """Zero state.  The token-shift leaves hold activations, so they take
    the activation dtype ``cfg.dtype``; ``S`` takes ``dtype``."""
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    act = getattr(torch, cfg.dtype)
    return RWKVState(
        x_prev_t=torch.zeros((B, 1, d), dtype=act, device=device),
        x_prev_c=torch.zeros((B, 1, d), dtype=act, device=device),
        S=torch.zeros((B, d // dh, dh, dh), dtype=dtype, device=device),
    )


# --------------------------------------------------------------------------
# SequenceOp registration: self-contained (owns its norms and channel mix)
# --------------------------------------------------------------------------


def _rwkv6_forward(p, x, cfg, *, state=None, want_state=True):
    """Train / prefill on the residual stream ``x (B, n, d_model)``;
    ``state`` is only read.  Returns ``(x_out, new RWKVState)``."""
    del want_state  # the state costs nothing beyond the last chunk
    return rwkv6_layer_apply(p, x, cfg, state)


def _rwkv6_step(p, x_t, state, cfg):
    """One-token decode; ``state`` is updated in place.  Returns ``(x_out,
    state)``."""
    x, new = rwkv6_layer_apply(p, x_t, cfg, state)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return x, state


def rwkv6_state_axes() -> RWKVState:
    """Logical axes of the state's leaves: the wkv heads shard like query
    heads (replicated where ``d / rwkv_head_dim`` does not divide the model
    axis)."""
    return RWKVState(x_prev_t=Axes(("batch", None, None)),
                     x_prev_c=Axes(("batch", None, None)),
                     S=Axes(("batch", "q_heads", None, None)))


def _rwkv6_init_state(cfg, B, device, max_len=0):
    del max_len  # a streaming state does not grow with the context
    return rwkv6_init_state(cfg, B, device)


seq_op.register_op(seq_op.SequenceOp(
    name="rwkv6",
    specs=rwkv6_specs,
    forward=_rwkv6_forward,
    step=_rwkv6_step,
    init_state=_rwkv6_init_state,
    state_axes=lambda cfg: rwkv6_state_axes(),
    streaming=True,
    spec_decodable=True,
    self_contained=True,
))
