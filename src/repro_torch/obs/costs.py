"""Analytic per-op cost model for the port's ``SequenceOp`` records.

Twin of ``repro/obs/costs.py`` for the records the port registers: the
HLA family (``linattn``, ``hla2``, ``ahla``, ``hla3``, ``hla3_paper``),
softmax attention (``attn``), gated linear attention (``gla``, whose
record also carries the ``cost_model`` hook), Mamba (``mamba``) and
RWKV-6 (``rwkv6``).  One question, answered without running
anything: *how many FLOPs and how many HBM bytes does operator X move per
token* on each of its execution paths: ``train_fwd`` / ``train_bwd``
(full-sequence chunkwise), ``train_step`` (both), ``prefill`` (same chunk
math, one call) and ``decode_step`` (the state recurrence).  Dividing a measured tok/s
by these numbers gives achieved FLOP/s, and ``obs.perf`` turns that into
roofline utilization.

Derivation (the reference's):

* **Projections** come from the record's own ``specs(cfg)``: every dense
  weight performs one multiply-accumulate per token, so the projection
  term is ``2 * param_count(specs)`` FLOPs/token.
* **State math** is per family: linear attention carries an O(d·dv) state
  (2 matvecs/token), HLA2 adds the O(d²) second-moment update plus the
  intra-chunk masked ``(c×c)·(c×c)`` product, AHLA is two first-order
  passes, the exact third order a first-order pass then an HLA2 pass, the
  paper's third order HLA2-shaped products plus the (x)3 cross terms on
  the carry.  Chunk width enters as ``c = min(cfg.hla.chunk, seq_len)``.
* **State bytes** are measured without memory: the leaves of
  ``op.init_state(cfg, 1, torch.device("meta"))`` (the reference runs
  ``jax.eval_shape``).  A streaming state does not depend on the sequence
  length, so the paper's O(1)-in-n claim is a testable property.
* A record may override the state-math term through the optional
  ``SequenceOp.cost_model`` hook; projections and state bytes always come
  from the record itself.
* **MoE** (``model_cost`` only), where the port departs from the
  reference: the reference counts ``2 x every parameter`` FLOPs a token,
  every expert on every token.  Here an MoE layer's expert weights count
  at ``top_k / n_experts`` for FLOPs (each token runs ``top_k`` of them),
  and for bytes a call reads the experts it is expected to touch, ``E (1 -
  (1 - K/E)^T)`` of the ``E`` for ``T`` tokens routed uniformly, each
  once.  Everything else is the reference's.
* **Hybrid stacks** (``model_cost`` only), where the port departs from the
  reference again: the reference counts ``op_for(cfg)``'s state math in
  all ``n_layers`` (jamba: softmax attention in 72 layers, 63 of which
  are Mamba).  Here each group position counts its own op's state math,
  bytes and state, times the number of groups, and the MoE share applies
  to the experts of the positions that have them.

Cross-check: ``measured_op_flops`` runs the op's forward on the CPU (the
kernels' plain versions) under ``torch.utils.flop_counter.FlopCounterMode``
in place of the reference's XLA ``cost_analysis``;
``tests/test_torch_costs.py`` holds the analytic FLOPs within a factor of 2
of it on small shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

MODES = ("train_fwd", "train_bwd", "train_step", "prefill", "decode_step")

#: forward-activation HBM round-trips per token, in units of
#: d_model * 4 bytes (residual in/out, q/k/v/o tiles, norm scratch).
_ACT_ROUNDTRIPS = 12.0

#: how many forward passes' worth of work each mode is
_SCALE = {"train_fwd": 1.0, "prefill": 1.0, "decode_step": 1.0,
          "train_bwd": 2.0, "train_step": 3.0}


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Per-token cost of one SequenceOp path (one batch-element token)."""

    op: str
    mode: str
    flops_per_token: float
    bytes_per_token: float
    state_bytes: int  # decode-state bytes per sequence
    breakdown: Dict[str, float]

    def as_dict(self) -> dict:
        return {
            "op": self.op, "mode": self.mode,
            "flops_per_token": self.flops_per_token,
            "bytes_per_token": self.bytes_per_token,
            "state_bytes": self.state_bytes,
            "breakdown": dict(self.breakdown),
        }


def _dims(cfg):
    """(heads, key dim, value dim)."""
    return cfg.n_heads, cfg.head_dim, cfg.head_dim


def _chunk(cfg, seq_len: int) -> int:
    return max(1, min(int(cfg.hla.chunk), int(seq_len)))


# --------------------------------------------------------------------------
# family state-math tables: FLOPs/token beyond the projections
# --------------------------------------------------------------------------


def _fwd_linattn(cfg, c, n):
    """One chunkwise first-order pass: intra-chunk masked matmul
    (scores + apply) + per-chunk carry update and state readout."""
    H, d, dv = _dims(cfg)
    return H * (2 * c * (d + dv) + 4 * d * dv)


def _fwd_hla2(cfg, c, n):
    """Masked-matmul form: QK^T/KQ^T scores, the (c×c)·(c×c) second-order
    product, S/C/G carries and the S·C cross term."""
    H, d, dv = _dims(cfg)
    intra = 8 * c * d + 2 * c * c + 6 * c * dv
    carry = 4 * d * d + 6 * d * dv
    cross = 4.0 * d * d * dv / c  # S@C-type products, once per chunk
    return H * (intra + carry + cross)


def _fwd_ahla(cfg, c, n):
    return 2.0 * _fwd_linattn(cfg, c, n)


def _fwd_hla3(cfg, c, n):
    # exact factorization HLA2_masked(Q, K, LinAttn(Q, K, V))
    return _fwd_linattn(cfg, c, n) + _fwd_hla2(cfg, c, n)


def _fwd_hla3_paper(cfg, c, n):
    # Alg 4 chunkwise: HLA2-shaped masked matmuls + the (x)3 cross terms
    # applied to the (S^K, S^Q, P) carry (never materialized)
    H, d, dv = _dims(cfg)
    return 1.5 * _fwd_hla2(cfg, c, n) + H * (4.0 * d * d * dv / c)


def _fwd_gla(cfg, c, n):
    # the fixed GLA_CHUNK intra window; the gate's low-rank projection is
    # in the record's specs already
    H, d, dv = _dims(cfg)
    c = min(32, n)
    return H * (2 * c * (d + dv) + 6 * d * dv)


def _fwd_attn(cfg, c, n):
    # scores + apply over the causal context (~n/2 on average, counted as
    # the full n: the blocks compute the padded tile)
    H, d, dv = _dims(cfg)
    return H * (2 * n * d + 2 * n * dv)


def _fwd_rwkv6(cfg, c, n):
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    c = min(32, n)  # RWKV_CHUNK
    return (d // dh) * (2 * c * (dh + dh) + 8 * dh * dh)


def _fwd_mamba(cfg, c, n):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    return 6.0 * d_in * mc.d_state + 2.0 * mc.d_conv * d_in


def _dec_linattn(cfg, L):
    H, d, dv = _dims(cfg)
    return H * (4 * d * dv + 2 * d)


def _dec_hla2(cfg, L):
    H, d, dv = _dims(cfg)
    return H * (4 * d * d + 10 * d * dv)


def _dec_ahla(cfg, L):
    H, d, dv = _dims(cfg)
    return H * (10 * d * dv + 4 * d)


def _dec_hla3(cfg, L):
    return _dec_linattn(cfg, L) + _dec_hla2(cfg, L)


def _dec_hla3_paper(cfg, L):
    return 1.5 * _dec_hla2(cfg, L)


def _dec_gla(cfg, L):
    H, d, dv = _dims(cfg)
    return H * 5 * d * dv


def _dec_attn(cfg, L):
    # reads the whole KV cache: O(L) a step, the paper's contrast case
    H, d, dv = _dims(cfg)
    return H * (2 * L * d + 2 * L * dv)


def _dec_rwkv6(cfg, L):
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    return (d // dh) * 8 * dh * dh


def _dec_mamba(cfg, L):
    return _fwd_mamba(cfg, 1, 1)


_FWD_STATE_FLOPS: Dict[str, Callable] = {
    "linattn": _fwd_linattn, "hla2": _fwd_hla2, "ahla": _fwd_ahla,
    "hla3": _fwd_hla3, "hla3_paper": _fwd_hla3_paper, "gla": _fwd_gla,
    "attn": _fwd_attn, "rwkv6": _fwd_rwkv6, "mamba": _fwd_mamba,
}

_DEC_STATE_FLOPS: Dict[str, Callable] = {
    "linattn": _dec_linattn, "hla2": _dec_hla2, "ahla": _dec_ahla,
    "hla3": _dec_hla3, "hla3_paper": _dec_hla3_paper, "gla": _dec_gla,
    "attn": _dec_attn, "rwkv6": _dec_rwkv6, "mamba": _dec_mamba,
}


# --------------------------------------------------------------------------
# registry-record plumbing
# --------------------------------------------------------------------------


def record_param_stats(op, cfg):
    """(param_count, param_bytes) of the record's own specs."""
    from ..models.param import param_bytes, param_count

    specs = op.specs(cfg)
    return param_count(specs), param_bytes(specs)


def record_state_bytes(op, cfg, *, max_len: int = 64) -> int:
    """Decode-state bytes per sequence, summed over the leaves of the
    record's ``init_state`` for ``max_len`` tokens, built on the meta
    device (no memory)."""
    import torch

    from ..models.state_tree import leaves

    state = op.init_state(cfg, 1, torch.device("meta"), max_len=max_len)
    return int(sum(x.numel() * x.element_size() for x in leaves(state)))


def record_cost(op, cfg, *, mode: str = "train_fwd",
                seq_len: Optional[int] = None, batch: int = 1) -> OpCost:
    """Cost of one path of a ``SequenceOp`` record (see module docstring).

    ``seq_len`` is the per-call sequence length for train/prefill (chunk
    width saturates at it) and the *context length* for ``decode_step``.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    n = int(seq_len if seq_len is not None else 512)
    c = _chunk(cfg, n)
    n_params, p_bytes = record_param_stats(op, cfg)
    decode = mode == "decode_step"
    sbytes = record_state_bytes(op, cfg, max_len=max(n, 1))

    proj = 2.0 * n_params
    hook = op.cost_model(cfg, mode=mode, seq_len=n, batch=batch) \
        if op.cost_model is not None else {}
    table = _DEC_STATE_FLOPS if decode else _FWD_STATE_FLOPS
    if "state_flops_per_token" in hook:
        state_flops = float(hook["state_flops_per_token"])
    elif op.name not in table:
        raise ValueError(f"no state-math formula for op {op.name!r}: give "
                         "its record a cost_model hook")
    elif decode:
        state_flops = table[op.name](cfg, n)
    else:
        state_flops = table[op.name](cfg, c, n)
    flops = proj + state_flops

    # bytes/token: weights amortize over the call's tokens; activations
    # round-trip a few d_model rows; the state carry streams once per
    # chunk (train/prefill) or once per token (decode).
    tokens_per_call = max(1, batch * (1 if decode else n))
    weight_traffic = p_bytes / tokens_per_call
    act_traffic = _ACT_ROUNDTRIPS * cfg.d_model * 4.0
    if "state_bytes_per_token" in hook:
        state_traffic = float(hook["state_bytes_per_token"])
    else:
        state_traffic = 2.0 * sbytes * (1.0 if decode else 1.0 / c)
    bytes_pt = weight_traffic + act_traffic + state_traffic

    scale = _SCALE[mode]
    return OpCost(
        op=op.name, mode=mode,
        flops_per_token=scale * flops,
        bytes_per_token=scale * bytes_pt,
        state_bytes=sbytes,
        breakdown={
            "proj_flops": scale * proj,
            "state_flops": scale * state_flops,
            "weight_bytes": scale * weight_traffic,
            "act_bytes": scale * act_traffic,
            "state_traffic_bytes": scale * state_traffic,
            "chunk": c,
        },
    )


def op_cost(name: str, cfg, *, mode: str = "train_fwd",
            seq_len: Optional[int] = None, batch: int = 1) -> OpCost:
    """Cost of registered operator ``name`` under ``cfg`` (main entry)."""
    from ..models import seq_op

    return record_cost(seq_op.get_op(name), cfg, mode=mode,
                       seq_len=seq_len, batch=batch)


def model_cost(cfg, *, mode: str = "train_fwd",
               seq_len: Optional[int] = None, batch: int = 1) -> OpCost:
    """Whole-LM cost per token around ``cfg``'s operator.

    A measured tok/s is the FULL model's (embeddings, every layer's mixer +
    FFN, the unembed head), so utilization divides by the full model's
    FLOPs: ``2 * total-param`` projection FLOPs per token (every dense
    weight is one MAC/token) plus each layer's op's state math (a uniform
    stack: ``n_layers x`` the op's; a hybrid one: each group position's
    own op, times the groups).  An MoE layer's experts count at ``top_k /
    n_experts`` of their weights for FLOPs and at the expected share of
    experts a call of ``T`` tokens touches for bytes
    (``moe_weight_shares``); the reference counts all of them for both.
    """
    from ..models import lm, seq_op
    from ..models.param import param_bytes, param_count

    op = seq_op.op_for(cfg)
    kw = dict(mode=mode, seq_len=seq_len, batch=batch)
    opc = record_cost(op, cfg, **kw)
    specs = lm.lm_specs(cfg)
    n = int(seq_len if seq_len is not None else 512)
    decode = mode == "decode_step"
    scale = _SCALE[mode]
    tokens_per_call = max(1, batch * (1 if decode else n))
    n_params, p_bytes = param_count(specs), param_bytes(specs)
    layout, units = lm.stack_layout(cfg)
    stack = specs["groups" if cfg.group_size else "layers"]
    experts = [{k: v for k, v in (stack if key is None else stack[key])
                ["moe"].items() if k != "router"}
               for key, _, use_moe in layout if use_moe]
    if experts:
        flop_share, byte_share = moe_weight_shares(cfg, tokens_per_call)
        n_params -= sum(map(param_count, experts)) * (1.0 - flop_share)
        p_bytes -= sum(map(param_bytes, experts)) * (1.0 - byte_share)
    # each position's own op; breakdown terms are already mode-scaled
    per_pos = [opc if pos_op is op else record_cost(pos_op, cfg, **kw)
               for _, pos_op, _ in layout]
    state_flops = units * sum(c.breakdown["state_flops"] for c in per_pos)
    state_traffic = units * sum(c.breakdown["state_traffic_bytes"]
                                for c in per_pos)
    flops = scale * 2.0 * n_params + state_flops
    act = scale * cfg.n_layers * _ACT_ROUNDTRIPS * cfg.d_model * 4.0
    bytes_pt = scale * p_bytes / tokens_per_call + act + state_traffic
    return OpCost(
        op=f"lm/{op.name}", mode=mode,
        flops_per_token=flops, bytes_per_token=bytes_pt,
        state_bytes=units * sum(c.state_bytes for c in per_pos),
        breakdown={
            "proj_flops": scale * 2.0 * n_params,
            "state_flops": state_flops,
            "weight_bytes": scale * p_bytes / tokens_per_call,
            "act_bytes": act,
            "state_traffic_bytes": state_traffic,
            "chunk": opc.breakdown["chunk"],
        },
    )


def moe_weight_shares(cfg, tokens: int):
    """``(FLOP share, byte share)`` of an MoE layer's expert weights for a
    call of ``tokens`` tokens: each token runs ``K`` of the ``E`` experts
    (``K / E``), and the call reads the experts it is expected to touch,
    ``1 - (1 - K/E)^tokens`` of them, once each."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    return K / E, 1.0 - (1.0 - K / E) ** tokens


# --------------------------------------------------------------------------
# measured cross-check
# --------------------------------------------------------------------------


def measured_op_flops(name: str, cfg, *, seq_len: int = 64,
                      batch: int = 1) -> dict:
    """Run the registered op's full-sequence forward on the CPU (the
    kernels' plain versions, fp32) under ``FlopCounterMode`` and return its
    FLOPs (the tests' factor-of-2 reference; the reference compiles the
    forward and reads XLA's loop-aware dot FLOPs)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import seq_op
    from ..models.param import init_params

    op = seq_op.get_op(name)
    cfg = cfg.replace(dtype="float32")
    params = init_params(op.specs(cfg), 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((batch, seq_len, cfg.d_model), generator=gen)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        op.forward(params, x, cfg, state=None, want_state=False)
    flops = float(counter.get_total_flops())
    return {"flops": flops, "per_token": flops / max(1, batch * seq_len)}
