"""Model configuration dataclasses: own copy of the reference's
``MoEConfig``, ``HLAConfig``, ``MambaConfig`` and ``ModelConfig`` fields
that the port reads.  The hla2/ahla kernels pick their own chunk width
(``kernels.hla2_chunk.W``) and outputs do not depend on it;
``HLAConfig.chunk`` is the reference's, the chunk width of the plain
records (``hla3``, ``hla3_paper``, ``linattn``), and read by the cost
model (``obs/costs.py``) and the admission bucket
(``analysis/contracts.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    capacity_factor: float = 1.25
    every: int = 1  # every-th layer of a hybrid group is MoE (jamba: 2);
    #   a uniform stack puts an MoE FFN on every layer, as the reference
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class HLAConfig:
    """Options for the paper's mixer."""

    impl: str = "chunkwise"  # chunkwise | scan (hla2/ahla: the paper's
    #   token-level associative scan in plain torch; decode is unchanged)
    chunk: int = 256  # the plain records' chunk width (not the kernels')
    normalize: bool = False  # paper default: unnormalized
    decay: str = "learned"  # none | fixed | learned  (per-head sigmoid)
    fixed_gamma: float = 0.99
    lam: float = 0.0  # ridge (Alg 1)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => d_model // 16


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
    mixer: str = "hla2"  # the registered SequenceOp ("softmax" = "attn")
    mlp: str = "swiglu"  # swiglu | squared_relu | gelu | relu
    moe: Optional[MoEConfig] = None  # MoE FFNs in place of the MLPs
    hla: HLAConfig = dataclasses.field(default_factory=HLAConfig)
    mamba: Optional[MambaConfig] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    # hybrid pattern (jamba): layers come in groups; within a group, layer
    # `attn_index` is the configured mixer and the rest are mamba; every
    # `moe.every`-th layer of the group carries an MoE FFN.
    group_size: int = 0  # 0 = uniform stack
    attn_index: int = 0
    # vlm: number of precomputed patch-embedding tokens (stub frontend)
    vis_tokens: int = 0
    # rwkv6
    rwkv_head_dim: int = 64
    # encoder-decoder (whisper): enc_layers > 0 activates the encoder
    enc_layers: int = 0
    enc_frames: int = 1500  # precomputed frame embeddings (stub frontend)
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # storage dtype (jamba-scale: bfloat16)
    moment_dtype: str = "float32"  # AdamW mu/nu (jamba-scale: bfloat16)
    grad_accum_dtype: str = "float32"  # microbatch gradient accumulator
    remat: str = "none"  # none | full (recompute a layer, or a hybrid
    #   stack's whole group, in training) | dots (keep the 2-d products'
    #   outputs, recompute the rest: models/remat.py)

    def __post_init__(self):
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                             f"{self.remat!r}")

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(1, self.n_heads))

    @property
    def attn_free(self) -> bool:
        return self.mixer in ("rwkv6",)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An input-shape cell of the dry run (the reference's)."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
