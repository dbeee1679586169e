"""Associative operators of the chunk-parallel scans (paper sections 4, 6
and 7), twin of ``repro/core/monoid.py``.

Gathered here for the property tests (associativity, identity, scan
prefixes) and for documentation.  Each operator composes the summary of
segment A followed by segment B.  The two ``*_decay_paper`` operators are
the paper's printed decayed concatenations, which are not associative
(the errata in ``docs/DESIGN.md`` section 7).
"""

from .ahla import (
    AHLADecayState,
    AHLAState,
    ahla_op,
    ahla_op_decay,
    ahla_op_decay_paper,
)
from .hla2 import (
    HLA2DecayState,
    HLA2State,
    masked_op,
    masked_op_decay,
    masked_op_decay_paper,
)
from .hla3 import HLA3ScanState, hla3_op

__all__ = [
    "HLA2State",
    "HLA2DecayState",
    "masked_op",
    "masked_op_decay",
    "masked_op_decay_paper",
    "AHLAState",
    "AHLADecayState",
    "ahla_op",
    "ahla_op_decay",
    "ahla_op_decay_paper",
    "HLA3ScanState",
    "hla3_op",
]
