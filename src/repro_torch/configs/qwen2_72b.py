"""Qwen2-72B — dense, GQA kv=8, QKV bias.

[arXiv:2407.10671; hf]  80L d_model=8192 64H (kv=8) d_ff=29568 vocab=152064.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    mixer="softmax",
    mlp="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
    remat="full",
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        remat="none", dtype="float32",
    )
