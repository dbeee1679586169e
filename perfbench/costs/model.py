"""FLOPs and bytes a token of the whole LM needs, by mode.

Frozen copy of the port's ``obs/costs.py::model_cost`` arithmetic for a
uniform stack of ``hla2`` layers with a SwiGLU MLP or an MoE FFN, with the
parameter counts worked out again from the configuration's widths (no
parameter tree of the program is read):

* every dense weight is one multiply-accumulate a token: ``2 * params``
  FLOPs, an MoE layer's experts at ``top_k / n_experts`` of theirs;
* HLA2's state math a layer and token (``_fwd_hla2``, ``_dec_hla2``);
* ``train_step`` is three forward passes (remat's recompute is left out,
  as MFU's convention says);
* bytes: the weights once a call (an MoE call reads the experts it is
  expected to touch, ``1 - (1 - K/E)^T`` of them), ``ACT_ROUNDTRIPS``
  assumed activation round trips of ``d_model`` fp32 values a layer and
  token, and the carry streamed once a chunk (train, prefill) or once a
  token (decode).

One change from the program's copy: weights are counted at the bytes they
are read in, ``weight_bytes`` a parameter (4 for training's fp32 master
weights, 2 for serving's bf16 copy), where the program counts 4 always.
"""

from __future__ import annotations

import dataclasses

MODES = ("train_step", "prefill", "decode_step")

#: forward-activation HBM round trips a token and layer, in units of
#: d_model * 4 bytes (an assumed traffic: residual in/out, q/k/v/o, norms)
ACT_ROUNDTRIPS = 12.0

_SCALE = {"prefill": 1.0, "decode_step": 1.0, "train_step": 3.0}


@dataclasses.dataclass(frozen=True)
class Cost:
    flops_per_token: float
    bytes_per_token: float


def _chunk(c, n):
    return max(1, min(int(c["hla"]["chunk"]), int(n)))


def head_dim(c):
    return c.get("d_head") or c["d_model"] // c["n_heads"]


def mixer_params(c):
    """wq, wk, wv, wo (and their biases), out_scale and decay_a."""
    d, H, Hk, dh = c["d_model"], c["n_heads"], c["n_kv_heads"], head_dim(c)
    n = d * H * dh + 2 * d * Hk * dh + H * dh * d + H * dh
    if c.get("qkv_bias"):
        n += H * dh + 2 * Hk * dh
    if c["hla"]["decay"] == "learned":
        n += H
    return n


def ffn_params(c):
    """``(dense params a layer, expert params a layer, router params)``."""
    d = c["d_model"]
    moe = c.get("moe")
    if moe:
        return 0, 3 * moe["n_experts"] * d * moe["d_ff"], d * moe["n_experts"]
    return 3 * d * c["d_ff"], 0, 0


def param_count(c):
    """Every parameter of the LM: embedding, the layers (two norms, the
    mixer, the FFN), the final norm and an untied unembedding."""
    d, V = c["d_model"], c["vocab"]
    dense, experts, router = ffn_params(c)
    layer = 2 * d + mixer_params(c) + dense + experts + router
    n = V * d + c["n_layers"] * layer + d
    if not c.get("tie_embeddings"):
        n += d * V
    return n


def state_bytes(c):
    """fp32 decode-state bytes a sequence and layer: H carries (S, C, m,
    G, h)."""
    dh = head_dim(c)
    return 4 * c["n_heads"] * (dh * dh + 2 * dh * dh + 2 * dh)


def _fwd_hla2(c, ch):
    H, d, dv = c["n_heads"], head_dim(c), head_dim(c)
    intra = 8 * ch * d + 2 * ch * ch + 6 * ch * dv
    carry = 4 * d * d + 6 * d * dv
    cross = 4.0 * d * d * dv / ch
    return H * (intra + carry + cross)


def _dec_hla2(c):
    H, d, dv = c["n_heads"], head_dim(c), head_dim(c)
    return H * (4 * d * d + 10 * d * dv)


def moe_shares(c, tokens):
    """``(FLOP share, byte share)`` of an MoE layer's expert weights for a
    call of ``tokens`` tokens."""
    E, K = c["moe"]["n_experts"], c["moe"]["top_k"]
    return K / E, 1.0 - (1.0 - K / E) ** tokens


def model_cost(c, *, mode, seq_len, batch=1, weight_bytes=4):
    """Per-token cost of the whole LM under config dict ``c``:
    ``seq_len`` is the call's sequence length (train, prefill) or the
    context length (decode), ``batch`` its rows."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    decode = mode == "decode_step"
    scale = _SCALE[mode]
    n = int(seq_len)
    tokens = max(1, batch * (1 if decode else n))
    n_params = float(param_count(c))
    p_bytes = weight_bytes * n_params
    if c.get("moe"):
        _, experts, _ = ffn_params(c)
        flop_share, byte_share = moe_shares(c, tokens)
        n_params -= c["n_layers"] * experts * (1.0 - flop_share)
        p_bytes -= weight_bytes * c["n_layers"] * experts * (1.0 - byte_share)
    L = c["n_layers"]
    if decode:
        state_flops = _dec_hla2(c)
        state_traffic = 2.0 * state_bytes(c)
    else:
        ch = _chunk(c, n)
        state_flops = _fwd_hla2(c, ch)
        state_traffic = 2.0 * state_bytes(c) / ch
    flops = scale * (2.0 * n_params + L * state_flops)
    act = L * ACT_ROUNDTRIPS * c["d_model"] * 4.0
    nbytes = scale * (p_bytes / tokens + act + L * state_traffic)
    return Cost(flops, nbytes)


def least_seconds(c, *, mode, seq_len, batch=1, weight_bytes=4,
                  flop_s, bytes_s):
    """The least time of one call: its FLOPs at ``flop_s`` or its bytes at
    ``bytes_s``, whichever is longer."""
    cost = model_cost(c, mode=mode, seq_len=seq_len, batch=batch,
                      weight_bytes=weight_bytes)
    tokens = batch * (1 if mode == "decode_step" else seq_len)
    return max(cost.flops_per_token * tokens / flop_s,
               cost.bytes_per_token * tokens / bytes_s)


def serve_least_seconds(c, admissions, decode_blocks, *, flop_s, bytes_s):
    """``(admissions' least seconds, decode steps' least seconds)`` with
    bf16 weights: each admission at its prompt length, each block's steps
    at its active slots."""
    kw = dict(weight_bytes=2, flop_s=flop_s, bytes_s=bytes_s)
    pre = sum(least_seconds(c, mode="prefill", seq_len=n, **kw)
              for n in admissions)
    dec = sum(steps * least_seconds(c, mode="decode_step", seq_len=1,
                                    batch=rows, **kw)
              for steps, rows in decode_blocks if rows)
    return pre, dec
