"""Seeds of the parts of a run, derived from the run's ``--seed``."""

from __future__ import annotations

import hashlib


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for the part named by ``keys`` of run ``seed``: the
    same seed and keys give the same number, any other seed another."""
    text = ":".join(str(k) for k in (int(seed),) + keys)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1
