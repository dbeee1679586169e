"""Architecture registry: --arch <id> resolution."""

from __future__ import annotations

from . import (
    codeqwen1_5_7b,
    deepseek_67b,
    granite_moe_3b_a800m,
    hla_1b,
    internvl2_2b,
    jamba_1_5_large_398b,
    nemotron_4_15b,
    qwen2_72b,
    qwen3_moe_30b_a3b,
    rwkv6_7b,
    whisper_small,
)

_ARCHS = {
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "qwen2-72b": qwen2_72b,
    "nemotron-4-15b": nemotron_4_15b,
    "deepseek-67b": deepseek_67b,
    "whisper-small": whisper_small,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "rwkv6-7b": rwkv6_7b,
    "internvl2-2b": internvl2_2b,
    "hla-1b": hla_1b,
}


def list_archs():
    return sorted(_ARCHS)


def get_config(name: str, *, reduced: bool = False, mixer: str | None = None):
    """Resolve an arch id to its ModelConfig (``reduced`` = the small test
    variant of the same architecture).  ``mixer`` overrides the arch's
    sequence op with another registered one (the paper's drop-in claim,
    Section 5.2; a hybrid stack's attention position); an unknown name
    fails at ``seq_op.op_for``.  An attention-free arch (rwkv6) has no
    sublayer to swap and refuses an override."""
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = _ARCHS[name]
    cfg = mod.reduced() if reduced else mod.CONFIG
    if mixer is None or mixer == cfg.mixer:
        return cfg
    if cfg.attn_free:
        raise ValueError(
            f"{cfg.mixer} is attention-free; an HLA mixer override is "
            "inapplicable (no attention sublayer to replace)")
    return cfg.replace(mixer=mixer)
