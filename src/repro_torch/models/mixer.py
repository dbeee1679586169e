"""The HLA mixer sublayers: the ``hla2`` and ``ahla`` records of
``repro/models/mixer.py``.

Multi-head projections around the operator's kernels: q scaled by
``head_dim**-0.5``, K/V heads repeated to the query heads (GQA), per-head
decay ``gamma = sigmoid(decay_a)`` (or fixed, or none), and a per-head RMS
output norm with a learned ``out_scale``.  Both records share that wrapper
(``_sublayer_forward``, ``_sublayer_step``) and the parameter layout, and
differ only in their core calls.  The full-sequence path is one
chunk-parallel kernel launch per call: stateless for training
(``kernels.ops.hla2_attention``, ``ahla_attention``: one forward launch
with chunk checkpoints, then one backward launch), or returning the carry
for prefill (``hla2_prefill``, ``ahla_prefill``); the one-token path one
batched decode-step launch that updates the state in place
(``hla2_decode_step``, ``ahla_decode_step``).
"""

from __future__ import annotations

import torch

from ..core.ahla import ahla_init_state
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


def _sublayer_forward(core_fwd):
    def forward(p, x, cfg, *, state=None, want_state=True):
        """Full-sequence path (train / prefill) over ``x (B, n, d_model)``;
        ``state`` is an optional carry to resume from.  Returns ``(y,
        final_state)``; with no carry in and none wanted (training) the
        final state is None."""
        B, n, _ = x.shape
        q, k, v = _project(p, x, cfg)
        o, st = core_fwd(q, k, v, _gamma(p, cfg, B, x.device), cfg.hla,
                         state=state,
                         want_state=want_state or state is not None)
        o = _out_norm(p, o.to(x.dtype))
        o = o.transpose(1, 2).reshape(B, n, cfg.n_heads * cfg.head_dim)
        return dense_apply(p["wo"], o), st

    return forward


def _sublayer_step(core_step):
    def step(p, x_t, state, cfg):
        """One-token decode over ``x_t (B, 1, d_model)``; ``state`` is
        updated in place.  Returns ``(y, state)``."""
        B = x_t.shape[0]
        q, k, v = _project(p, x_t, cfg)
        state, o = core_step(state, q[:, :, 0], k[:, :, 0], v[:, :, 0],
                             _gamma(p, cfg, B, x_t.device), cfg.hla)
        o = _out_norm(p, o[:, :, None, :].to(x_t.dtype))
        o = o.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.head_dim)
        return dense_apply(p["wo"], o), state

    return step


def _hla2_fwd(q, k, v, gamma, hc, *, state, want_state):
    kw = dict(normalize=hc.normalize, eps=HLA_EPS, lam=hc.lam)
    if want_state:
        return kops.hla2_prefill(q, k, v, gamma, state=state, **kw)
    return kops.hla2_attention(q, k, v, gamma, **kw), None


def _hla2_step(state, q1, k1, v1, gamma, hc):
    return kops.hla2_decode_step(state, q1, k1, v1, gamma,
                                 normalize=hc.normalize, eps=HLA_EPS,
                                 lam=hc.lam)


def _ahla_fwd(q, k, v, gamma, hc, *, state, want_state):
    kw = dict(normalize=hc.normalize, eps=HLA_EPS)
    if want_state:
        return kops.ahla_prefill(q, k, v, gamma, state=state, **kw)
    return kops.ahla_attention(q, k, v, gamma, **kw), None


def _ahla_step(state, q1, k1, v1, gamma, hc):
    return kops.ahla_decode_step(state, q1, k1, v1, gamma,
                                 normalize=hc.normalize, eps=HLA_EPS)


def _register(name, core_fwd, core_step, core_init):
    def init_state(cfg, B, device):
        dh = cfg.head_dim
        return core_init((B, cfg.n_heads), dh, dh, torch.float32, device)

    seq_op.register_op(seq_op.SequenceOp(
        name=name, specs=mixer_specs, forward=_sublayer_forward(core_fwd),
        step=_sublayer_step(core_step), init_state=init_state,
        streaming=True, spec_decodable=True,
    ))


_register("hla2", _hla2_fwd, _hla2_step, hla2_init_state)
_register("ahla", _ahla_fwd, _ahla_step, ahla_init_state)
