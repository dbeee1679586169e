"""Jamba-1.5-Large 398B: hybrid Mamba + attention 1:7, MoE 16 experts top 2.

[arXiv:2403.19887; hf]  72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536.  Groups of 8 layers: attention at in-group index 4, the rest
Mamba; MoE replaces the dense FFN on every 2nd layer.
"""

from ..models.config import MambaConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    mixer="softmax",
    mlp="swiglu",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=24576, every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    group_size=8,
    attn_index=4,
    remat="full",
    # 398B: fp32 master weights and moments would be 4.8 TB; bf16 storage
    # and bf16 moments are the standard trade at this scale
    param_dtype="bfloat16",
    moment_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
)


def reduced():
    return CONFIG.replace(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=96, every=2),
        mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
        group_size=8, attn_index=4, remat="none", dtype="float32",
    )
