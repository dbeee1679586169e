"""RWKV-6 (Finch) 7B: attention-free, data-dependent decay.

[arXiv:2404.05892; hf]  32L d_model=4096 d_ff=14336 vocab=65536,
head size 64.  No attention sublayer, so no HLA mixer drops in
(``get_config`` refuses an override).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    mixer="rwkv6",
    rwkv_head_dim=64,
    remat="full",
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        rwkv_head_dim=16, remat="none", dtype="float32",
    )
