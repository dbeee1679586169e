"""Analytic per-op cost model for the port's ``SequenceOp`` records.

Twin of ``repro/obs/costs.py`` for the records the port registers
(``hla2``, ``ahla``; the ``linattn`` formulas are kept because AHLA is two
first-order passes).  One question, answered without running anything: *how
many FLOPs and how many HBM bytes does operator X move per token* on each
of its execution paths: ``train_fwd`` / ``train_bwd`` (full-sequence
chunkwise), ``train_step`` (both), ``prefill`` (same chunk math, one call)
and ``decode_step`` (the O(1) state recurrence).  Dividing a measured tok/s
by these numbers gives achieved FLOP/s, and ``obs.perf`` turns that into
roofline utilization.

Derivation (the reference's):

* **Projections** come from the record's own ``specs(cfg)``: every dense
  weight performs one multiply-accumulate per token, so the projection
  term is ``2 * param_count(specs)`` FLOPs/token.
* **State math** is per family: linear attention carries an O(d·dv) state
  (2 matvecs/token), HLA2 adds the O(d²) second-moment update plus the
  intra-chunk masked ``(c×c)·(c×c)`` product, AHLA is two first-order
  passes.  Chunk width enters as ``c = min(cfg.hla.chunk, seq_len)``.
* **State bytes** are measured without memory: the leaves of
  ``op.init_state(cfg, 1, torch.device("meta"))`` (the reference runs
  ``jax.eval_shape``).  A streaming state does not depend on the sequence
  length, so the paper's O(1)-in-n claim is a testable property.
* A record may override the state-math term through the optional
  ``SequenceOp.cost_model`` hook; projections and state bytes always come
  from the record itself.

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


def _dec_linattn(cfg, L):
    H, d, dv = _dims(cfg)
    return H * (4 * d * dv + 2 * d)


def _dec_hla2(cfg, L):
    H, d, dv = _dims(cfg)
    return H * (4 * d * d + 10 * d * dv)


def _dec_ahla(cfg, L):
    H, d, dv = _dims(cfg)
    return H * (10 * d * dv + 4 * d)


_FWD_STATE_FLOPS: Dict[str, Callable] = {
    "linattn": _fwd_linattn, "hla2": _fwd_hla2, "ahla": _fwd_ahla,
}

_DEC_STATE_FLOPS: Dict[str, Callable] = {
    "linattn": _dec_linattn, "hla2": _dec_hla2, "ahla": _dec_ahla,
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
    record's ``init_state`` built on the meta device (no memory).
    ``max_len`` is the reference's argument: the port's records are
    streaming, so their state does not depend on it."""
    import torch

    del max_len
    state = op.init_state(cfg, 1, torch.device("meta"))
    return int(sum(x.numel() * x.element_size() for x in state))


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
    weight is one MAC/token) plus ``n_layers x`` the op's state math.
    """
    from ..models import lm, seq_op
    from ..models.param import param_bytes, param_count

    op = seq_op.op_for(cfg)
    opc = record_cost(op, cfg, mode=mode, seq_len=seq_len, batch=batch)
    specs = lm.lm_specs(cfg)
    n = int(seq_len if seq_len is not None else 512)
    decode = mode == "decode_step"
    scale = _SCALE[mode]
    n_params, p_bytes = param_count(specs), param_bytes(specs)
    # breakdown terms of `opc` are already mode-scaled
    state_flops = opc.breakdown["state_flops"] * cfg.n_layers
    state_traffic = opc.breakdown["state_traffic_bytes"] * cfg.n_layers
    flops = scale * 2.0 * n_params + state_flops
    tokens_per_call = max(1, batch * (1 if decode else n))
    act = scale * cfg.n_layers * _ACT_ROUNDTRIPS * cfg.d_model * 4.0
    bytes_pt = scale * p_bytes / tokens_per_call + act + state_traffic
    return OpCost(
        op=f"lm/{op.name}", mode=mode,
        flops_per_token=flops, bytes_per_token=bytes_pt,
        state_bytes=opc.state_bytes * cfg.n_layers,
        breakdown={
            "proj_flops": scale * 2.0 * n_params,
            "state_flops": state_flops,
            "weight_bytes": scale * p_bytes / tokens_per_call,
            "act_bytes": act,
            "state_traffic_bytes": state_traffic,
            "chunk": opc.breakdown["chunk"],
        },
    )


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
