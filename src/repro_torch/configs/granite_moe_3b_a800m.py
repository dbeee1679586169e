"""Granite-MoE 3B-a800m — MoE 40e top-8 (per-expert d_ff=512).

[hf:ibm-granite/granite-3.0-*-base; hf]  32L d_model=1536 24H (kv=8)
vocab=49155, tied embeddings.
"""

from ..models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    mixer="softmax",
    mlp="swiglu",
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512),
    tie_embeddings=True,
    remat="full",
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64), remat="none",
        dtype="float32",
    )
