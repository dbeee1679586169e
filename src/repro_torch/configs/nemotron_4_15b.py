"""Nemotron-4-15B — dense, GQA kv=8, squared-ReLU MLP.

[arXiv:2402.16819; unverified]  32L d_model=6144 48H (kv=8) d_ff=24576
vocab=256000.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    mixer="softmax",
    mlp="squared_relu",
    remat="full",
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        remat="none", dtype="float32",
    )
