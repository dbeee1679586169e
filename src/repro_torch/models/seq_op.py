"""The ``SequenceOp`` registry: one record per sequence-mixing operator.

Minimal twin of ``repro/models/seq_op.py``: a record carries the sublayer's
``specs``, full-sequence ``forward`` (train / chunk-parallel prefill),
one-token ``step`` (decode) and ``init_state``; ``lm.py`` and the serving
engine program against the record only, and a layer keeps the record's
parameters under ``"mixer"``.  The port registers ``hla2`` and ``ahla``
(``models/mixer.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict


@dataclasses.dataclass(frozen=True, eq=False)
class SequenceOp:
    name: str
    specs: Callable[[Any], Any]
    forward: Callable[..., Any]
    step: Callable[..., Any]
    init_state: Callable[..., Any]


_REGISTRY: Dict[str, SequenceOp] = {}


def register_op(op: SequenceOp) -> SequenceOp:
    if op.name in _REGISTRY:
        raise KeyError(f"sequence op {op.name!r} is already registered")
    _REGISTRY[op.name] = op
    return op


def op_for(cfg) -> SequenceOp:
    """The registered operator ``cfg.mixer`` names."""
    from . import mixer  # noqa: F401  (registers hla2 and ahla)

    if cfg.mixer not in _REGISTRY:
        raise KeyError(f"unknown sequence op {cfg.mixer!r}; registered ops: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[cfg.mixer]
