"""Gated Linear Attention (GLA): per-token, per-channel gated decay (twin
of ``repro/models/gla.py``).

The registry's worked example: an operator added only through
``seq_op.register_op``.  It trains, prefills chunk-parallel and decodes in
the continuous-batching engine (and speculatively) with no gla-specific
code in ``models/lm.py``, ``serving/`` or ``distributed/``.

The operator (Yang et al., "Gated Linear Attention Transformers with
Hardware-Efficient Training") generalizes the HLA family's scalar per-head
decay to a data-dependent per-channel gate:

    S_t = diag(a_t) S_{t-1} + k_t v_t^T          a_t in (0, 1)^{d_k}
    o_t = S_t^T q_t

with ``a_t = sigmoid(low_rank(x_t))^(1/tau)``.  The chunk-parallel form
works in cumulative log-gate space inside a chunk and carries S across
chunks:

    o_t = (q_t * e^{c_t}) S_0
        + sum_{j<=t} <q_t * e^{c_t - c_j}, k_j> v_j,   c_t = sum_{i<=t} log a_i
    S_w = e^{c_w} *_rows S_0 + sum_j (k_j * e^{c_w - c_j}) v_j^T

The ``exp(+-c)`` factorization stays in fp32 range because the per-token
log-gate is clamped at ``LOG_A_MIN`` and the chunk width is fixed at
``GLA_CHUNK`` (|c| <= 32 * 2.5 = 80 < log(fp32 max) ~ 88).  Plain torch, as
the reference is plain jnp: a Python loop over chunks replaces
``lax.scan``.  The state is fp32 whatever ``cfg.dtype`` is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..distributed.shard_ops import call_sharded
from ..distributed.sharding import constrain
from . import seq_op
from .blocks import dense_apply, dense_specs, split_heads
from .param import Axes, Spec

LOG_A_MIN = -2.5  # per-token floor: a_t >= e^-2.5 ~ 0.08 already "forget"
GLA_CHUNK = 32  # fixed: bounds |cumsum(log a)| for the exp factorization
GATE_TAU = 16.0  # gate temperature (GLA paper): a = sigmoid(z)^(1/tau)
OUT_NORM_EPS = 1e-6


class GLAState(NamedTuple):
    S: torch.Tensor  # (B, H, dk, dv)


def gla_init_state(batch_shape, d, dv, dtype=torch.float32, device="cpu"):
    return GLAState(S=torch.zeros(tuple(batch_shape) + (d, dv), dtype=dtype,
                                  device=device))


def gla_specs(cfg):
    d, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    lora = max(16, d // 16)
    return {
        "wq": dense_specs(d, H * dh, axes=("embed", "q_heads_flat")),
        "wk": dense_specs(d, H * dh, axes=("embed", "q_heads_flat")),
        "wv": dense_specs(d, H * dh, axes=("embed", "q_heads_flat")),
        # low-rank data-dependent gate; a0 ~ 4 => a ~ sigmoid(4)^(1/16)
        # ~ 0.9989 per token at init (slow forgetting)
        "wa_a": dense_specs(d, lora, axes=("embed", None)),
        "wa_b": dense_specs(lora, H * dh, axes=(None, "q_heads_flat")),
        "a0": Spec((H * dh,), ("q_heads_flat",), init="constant", const=4.0),
        "out_scale": Spec((H, dh), ("q_heads", "head_dim"), init="ones"),
        "wo": dense_specs(H * dh, d, axes=("q_heads_flat", "embed")),
    }


def _project(p, x, cfg):
    """``(q, k, v, z)``, each ``(B, H, n, dh)`` fp32 (on a mesh heads over
    "model", as the reference's constraints), ``z`` the gate's logits
    (``_log_gate`` makes ``log a`` of them)."""
    H, dh = cfg.n_heads, cfg.head_dim
    spec = ("batch", "q_heads", None, None)

    def heads(y):
        return constrain(split_heads(y, H, dh).transpose(1, 2), spec)

    q = heads(dense_apply(p["wq"], x)).float() * dh**-0.5
    k = heads(dense_apply(p["wk"], x)).float()
    v = heads(dense_apply(p["wv"], x)).float()
    z = dense_apply(p["wa_b"], dense_apply(p["wa_a"], x)).float()
    z = z + p["a0"].float()[None, None]
    return q, k, v, heads(z)


def _log_gate(z):
    """log a = log sigmoid(z) / tau, clamped into the chunk-stable range."""
    return (F.logsigmoid(z) / GATE_TAU).clamp(LOG_A_MIN, -1e-6)


def gla_chunkwise(q, k, v, log_a, *, chunk: int = GLA_CHUNK,
                  state: Optional[GLAState] = None):
    """Chunk-parallel gated linear attention over ``(B, H, n, d)`` fp32
    inputs.  Returns ``(o (B, H, n, dv), final GLAState)``; ``state`` is
    only read.

    Zero-padding the tail chunk is exact: padded log-gates are 0 (a = 1,
    no decay) and padded keys are 0 (no state contribution).
    """
    B, H, n, dk = q.shape
    dv = v.shape[-1]
    w = min(chunk, n)
    pad = (w - n % w) % w
    if pad:
        q, k, v, log_a = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v, log_a))
    S = state.S.float() if state is not None else q.new_zeros(B, H, dk, dv)
    tril = torch.tril(torch.ones(w, w, dtype=torch.float32,
                                 device=q.device))  # j <= t (diag incl.)
    ys = []
    for c0 in range(0, n + pad, w):
        q_, k_, v_, la_ = (t[:, :, c0:c0 + w] for t in (q, k, v, log_a))
        c = la_.cumsum(2)  # inclusive cumulative log-gates
        qs = q_ * c.exp()
        scores = qs @ (k_ * (-c).exp()).transpose(-1, -2)
        y = (scores * tril) @ v_ + qs @ S
        c_end = c[..., -1:, :]  # (B, H, 1, dk)
        S = c_end[..., 0, :].exp()[..., None] * S + \
            (k_ * (c_end - c).exp()).transpose(-1, -2) @ v_
        ys.append(y)
    o = torch.cat(ys, 2)[:, :, :n]
    return o, GLAState(S=S)


def gla_step(state: GLAState, q_t, k_t, v_t, log_a_t):
    """One-token recurrence over ``(B, H, dh)`` inputs.  Returns ``(new
    GLAState in state.S's dtype, o (B, H, dv) fp32)``; ``state`` is only
    read."""
    S = state.S.float()
    S = log_a_t.float().exp()[..., None] * S + \
        k_t.float()[..., :, None] * v_t.float()[..., None, :]
    o = (q_t.float()[..., None, :] @ S)[..., 0, :]
    return GLAState(S=S.to(state.S.dtype)), o


def _out_norm(p, o):
    """Per-head RMS norm + learned scale (as the HLA mixer sublayer); fp32
    out."""
    o32 = o.float()
    o32 = o32 * torch.rsqrt(o32.square().mean(-1, keepdim=True)
                            + OUT_NORM_EPS)
    return o32 * p["out_scale"][None, :, None, :]


def _gla_forward(p, x, cfg, *, state=None, want_state=True):
    """Full-sequence path (train / prefill) over ``x (B, n, d_model)``,
    resumed from ``state`` when given.  Returns ``(y, final GLAState)``."""
    del want_state  # the final state costs nothing beyond the last chunk
    B, n, _ = x.shape
    q, k, v, z = _project(p, x, cfg)
    # the gate and the chunk loop on each rank's (batch, head) rows
    o, st = call_sharded(
        lambda q_, k_, v_, z_, s_: gla_chunkwise(q_, k_, v_, _log_gate(z_),
                                                 state=s_),
        q, k, v, z, state)
    o = _out_norm(p, o).to(x.dtype)
    o = o.transpose(1, 2).reshape(B, n, cfg.n_heads * cfg.head_dim)
    o = constrain(o, ("batch", None, "q_heads_flat"))
    return dense_apply(p["wo"], o), st


def _gla_step(p, x_t, state, cfg):
    """One-token decode over ``x_t (B, 1, d_model)``; ``state`` is updated
    in place.  Returns ``(y, state)``."""
    B = x_t.shape[0]
    q, k, v, z = _project(p, x_t, cfg)  # (B, H, 1, dh)
    new, o = call_sharded(
        lambda s_, q_, k_, v_, z_: gla_step(s_, q_, k_, v_, _log_gate(z_)),
        state, q[..., 0, :], k[..., 0, :], v[..., 0, :], z[..., 0, :])
    state.S.copy_(new.S)
    o = _out_norm(p, o[..., None, :]).to(x_t.dtype)
    # through the token's row: a plain view, alike on a mesh (the GEMM too)
    o = o[:, :, 0].reshape(B, 1, cfg.n_heads * cfg.head_dim)
    o = constrain(o, ("batch", None, "q_heads_flat"))
    return dense_apply(p["wo"], o), state


def _gla_cost_model(cfg, *, mode, seq_len, batch):
    """Analytic state-math costs (the registry's ``cost_model`` example).

    The chunk width is fixed at ``GLA_CHUNK`` (the exp-factorization range
    bound), not ``cfg.hla.chunk``, which is why this op carries its own
    hook.  Per token per head: intra-chunk scores + apply ``2c(dk+dv)``,
    the gated carry update/readout ``6·dk·dv``; decode is the O(1)
    recurrence ``5·dk·dv`` (gate-decay, outer product, readout).
    """
    del batch
    H, dk, dv = cfg.n_heads, cfg.head_dim, cfg.head_dim
    if mode == "decode_step":
        return {"state_flops_per_token": H * 5.0 * dk * dv}
    c = min(GLA_CHUNK, seq_len)
    return {"state_flops_per_token": H * (2.0 * c * (dk + dv)
                                          + 6.0 * dk * dv)}


def _gla_init_state(cfg, B, device, max_len=0):
    del max_len  # a streaming state does not grow with the context
    return gla_init_state((B, cfg.n_heads), cfg.head_dim, cfg.head_dim,
                          torch.float32, device)


seq_op.register_op(seq_op.SequenceOp(
    name="gla",
    specs=gla_specs,
    forward=_gla_forward,
    step=_gla_step,
    cost_model=_gla_cost_model,
    init_state=_gla_init_state,
    state_axes=lambda cfg: GLAState(S=Axes(("batch", "q_heads", None, None))),
    streaming=True,
    spec_decodable=True,
))
