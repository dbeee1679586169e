"""Whisper-small — enc-dec audio backbone, conv frontend STUB.

[arXiv:2212.04356; unverified]  12L(+12 enc) d_model=768 12H d_ff=3072
vocab=51865.  ``input_specs()`` supplies precomputed frame embeddings
(B, 1500, d) — the conv subsampler is stubbed per the assignment.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    mixer="softmax",
    mlp="gelu",
    enc_layers=12,
    enc_frames=1500,
    remat="full",
)


def reduced():
    return CONFIG.replace(
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, enc_frames=16, remat="none", dtype="float32",
    )
