"""Inclusive associative scan over NamedTuples of tensors (the port's
stand-in for ``jax.lax.associative_scan``; torch has no stable one).

Hillis-Steele doubling: after the round with offset ``s`` element ``i``
holds the combination of elements ``max(0, i - 2s + 1) .. i``, so
``ceil(log2 n)`` rounds give every inclusive prefix.  Each round applies
``op`` once, batched over the elements that have a partner.  The only
requirement on ``op`` is associativity with ``op(a, b)`` = "a then b"; the
prefixes equal a left fold up to the rounding of the regrouping.
"""

from __future__ import annotations

import torch


def associative_scan(op, elems):
    """Inclusive prefixes of ``elems`` (a NamedTuple whose leaves all lead
    with the scanned axis, length n) under ``op``: element ``i`` of the
    result is ``op(...op(op(e_0, e_1), e_2)..., e_i)``."""
    kind = type(elems)
    n = elems[0].shape[0]
    x = elems
    off = 1
    while off < n:
        prev = kind(*(t[:-off] for t in x))
        cur = kind(*(t[off:] for t in x))
        x = kind(*(torch.cat([a[:off], b]) for a, b in zip(x, op(prev, cur))))
        off *= 2
    return x
