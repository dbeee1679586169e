"""Decode-state trees: the one place that knows how a state is laid out.

A decode state is whatever a ``SequenceOp`` record's ``init_state`` returns:
a tensor, a (named) tuple or list, or a dict of them, nested to any depth.
hla2/ahla states are flat NamedTuples; ``HLA3ExactState`` nests a
``LinAttnState`` and an ``HLA2State``.  The leaf order is the reference's
tree order (dict keys sorted), so a leaf list (a crc32 over its bytes, a
``zip`` with the reference's ``jax.tree.leaves``) compares leaf for leaf.
A state-axes tree (``SequenceOp.state_axes``) has the same structure with
a ``param.Axes`` at every leaf, and ``tree_map(fn, states, axes)`` pairs
them; an axes tree or a tree of ranks (``resolve_state_ndims``) flattens
like a state.
"""

from __future__ import annotations

import torch

from .param import Axes


def flatten(tree):
    """``(leaves, rebuild)`` of a state tree: a tensor, a (named) tuple or
    list, or a dict (sorted keys); ``rebuild(leaves)`` is the same tree
    over new leaves."""
    if isinstance(tree, (torch.Tensor, Axes, int)):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [flatten(x) for x in tree]
    else:
        raise TypeError(f"state tree leaf of type {type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        subs, i = [], 0
        for (_, sub), n in zip(parts, sizes):
            subs.append(sub(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, subs))
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*subs)
        return type(tree)(subs)

    return [leaf for p in parts for leaf in p[0]], rebuild


def leaves(tree) -> list:
    """The tensors of a state tree, in tree order."""
    return flatten(tree)[0]


def tree_map(fn, *trees):
    """``fn`` over the leaves of state trees of one structure; the result
    has the first tree's structure."""
    flat, rebuild = flatten(trees[0])
    rest = [leaves(t) for t in trees[1:]]
    if any(len(r) != len(flat) for r in rest):
        raise ValueError("state trees of different structure")
    return rebuild([fn(*xs) for xs in zip(flat, *rest)])
