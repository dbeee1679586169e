"""CodeQwen1.5-7B — dense, MHA (kv=32), QKV bias.

[hf:Qwen/CodeQwen1.5-7B; hf]  32L d_model=4096 32H d_ff=13440 vocab=92416.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    mixer="softmax",
    mlp="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
    remat="full",
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        remat="none", dtype="float32",
    )
