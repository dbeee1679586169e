"""The HLA operator family (the paper's contribution) in PyTorch, twin of
``repro/core``.

Four exactly-equivalent computation paths per operator: the serial
recurrence, the materialized oracle, the token-level associative scan and
the chunkwise masked-matmul form.

Unlike the reference, the dispatch front ends ``hla2``, ``ahla`` and
``hla3`` are not re-exported here: their names are the submodules', and a
re-export would shadow them (``from repro_torch.core import hla2`` must
stay the module).  Call them as ``core.hla2.hla2`` and so on.
"""

from .ahla import (
    AHLAState,
    ahla_chunkwise,
    ahla_init_state,
    ahla_naive,
    ahla_scan,
    ahla_serial,
    ahla_step,
)
from .hla2 import (
    HLA2State,
    hla2_chunkwise,
    hla2_init_state,
    hla2_naive,
    hla2_scan,
    hla2_serial,
    hla2_step,
)
from .hla3 import (
    HLA3ChunkState,
    HLA3ExactState,
    HLA3PaperState,
    hla3_exact_chunkwise,
    hla3_exact_init_state,
    hla3_exact_naive,
    hla3_exact_serial,
    hla3_exact_step,
    hla3_paper_chunkwise,
    hla3_paper_init_state,
    hla3_paper_naive,
    hla3_paper_scan,
    hla3_paper_serial,
    hla3_paper_step,
)
from .linear_attn import (
    LinAttnState,
    linattn,
    linattn_chunkwise,
    linattn_init_state,
    linattn_naive,
    linattn_step,
)
