"""DeepSeek-67B — dense llama arch, GQA kv=8.

[arXiv:2401.02954; hf]  95L d_model=8192 64H (kv=8) d_ff=22016 vocab=102400.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    mixer="softmax",
    mlp="swiglu",
    remat="full",
)


def reduced():
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        remat="none", dtype="float32",
    )
