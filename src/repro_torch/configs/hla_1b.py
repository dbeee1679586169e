"""The paper's own architecture: an HLA2 LM (~1.4B) for end-to-end runs.

Unnormalized masked HLA2 with learned per-head decay, SwiGLU, RMSNorm,
untied embeddings; bf16 activations over fp32 parameters.
"""

from ..models.config import HLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="hla-1b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5504,
    vocab=50304,
    mixer="hla2",
    hla=HLAConfig(decay="learned"),
    remat="full",
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        remat="none", dtype="float32",
    )
