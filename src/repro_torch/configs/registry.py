"""Architecture registry: --arch <id> resolution."""

from __future__ import annotations

from . import hla_1b

_ARCHS = {"hla-1b": hla_1b}


def list_archs():
    return sorted(_ARCHS)


def get_config(name: str, *, reduced: bool = False):
    """Resolve an arch id to its ModelConfig (``reduced`` = the small test
    variant of the same architecture)."""
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = _ARCHS[name]
    return mod.reduced() if reduced else mod.CONFIG
