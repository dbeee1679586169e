"""Qwen3-MoE-30B-A3B — MoE 128e top-8 (per-expert d_ff=768), head_dim=128.

[hf:Qwen/Qwen3-30B-A3B; hf]  48L d_model=2048 32H (kv=4) vocab=151936.
"""

from ..models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,
    vocab=151936,
    mixer="softmax",
    mlp="swiglu",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768),
    rope_theta=1e6,
    remat="full",
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=64,
        vocab=128, moe=MoEConfig(n_experts=8, top_k=2, d_ff=64), remat="none",
        dtype="float32",
    )
