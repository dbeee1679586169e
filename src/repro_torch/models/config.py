"""Model configuration dataclasses: own copy of the reference's
``HLAConfig``/``ModelConfig`` fields that the port reads.  The kernels pick
their own chunk width (``kernels.hla2_chunk.W``) and outputs do not depend
on it; ``HLAConfig.chunk`` is the reference's, read only by the cost model
(``obs/costs.py``) and the admission bucket (``analysis/contracts.py``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HLAConfig:
    """Options for the paper's mixer."""

    chunk: int = 256  # the reference's chunk width (not the kernels')
    normalize: bool = False  # paper default: unnormalized
    decay: str = "learned"  # none | fixed | learned  (per-head sigmoid)
    fixed_gamma: float = 0.99
    lam: float = 0.0  # ridge (Alg 1)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 => d_model // n_heads
    mixer: str = "hla2"  # the registered SequenceOp; the MLP is SwiGLU
    hla: HLAConfig = dataclasses.field(default_factory=HLAConfig)
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # activation/compute dtype; parameters are fp32
    remat: str = "none"  # none | full (per-layer recompute in training)

    def __post_init__(self):
        if self.remat == "dots":
            raise ValueError(
                "remat='dots' (keep only the products' outputs) is not "
                "ported yet; use 'none' or 'full'")
        if self.remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full', got "
                             f"{self.remat!r}")

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(1, self.n_heads))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
