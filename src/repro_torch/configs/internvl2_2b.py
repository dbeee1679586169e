"""InternVL2-2B — InternLM2-1.8B backbone + InternViT STUB frontend.

[arXiv:2404.16821; hf]  24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92553.
``lm_apply(vis_embed=...)`` takes 256 precomputed patch embeddings per
image.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    mixer="softmax",
    mlp="swiglu",
    vis_tokens=256,
    remat="full",
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        vis_tokens=8, remat="none", dtype="float32",
    )
