"""The ``SequenceOp`` registry: one record per sequence-mixing operator.

Minimal twin of ``repro/models/seq_op.py``: a record carries the sublayer's
``specs``, full-sequence ``forward`` (train / chunk-parallel prefill),
one-token ``step`` (decode) and ``init_state``; ``lm.py`` and the serving
engine program against the record only, and a layer keeps the record's
parameters under ``"mixer"``.  The port registers ``hla2`` and ``ahla``
(``models/mixer.py``).  Of the reference's capability flags it keeps the two
the serving engine reads: ``streaming`` (a constant-size per-slot decode
state, so slots batch continuously) and ``spec_decodable`` (that state can
be snapshot and rolled back, so speculative decoding may verify over it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True, eq=False)
class SequenceOp:
    name: str
    specs: Callable[[Any], Any]
    forward: Callable[..., Any]
    step: Callable[..., Any]
    init_state: Callable[..., Any]
    streaming: bool = False
    spec_decodable: bool = False
    # optional analytic-cost override read by ``obs/costs.py``:
    # ``cost_model(cfg, *, mode, seq_len, batch) -> dict`` may return
    # ``state_flops_per_token`` and/or ``state_bytes_per_token`` to replace
    # the family formula for this op's state math (projection FLOPs and
    # state bytes always come from the record's specs and init_state)
    cost_model: Optional[Callable[..., Dict[str, float]]] = None


_REGISTRY: Dict[str, SequenceOp] = {}


def register_op(op: SequenceOp) -> SequenceOp:
    if op.name in _REGISTRY:
        raise KeyError(f"sequence op {op.name!r} is already registered")
    _REGISTRY[op.name] = op
    return op


def get_op(name: str) -> SequenceOp:
    """The registered operator ``name``."""
    from . import mixer  # noqa: F401  (registers hla2 and ahla)

    if name not in _REGISTRY:
        raise KeyError(f"unknown sequence op {name!r}; registered ops: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def op_for(cfg) -> SequenceOp:
    """The registered operator ``cfg.mixer`` names."""
    return get_op(cfg.mixer)
