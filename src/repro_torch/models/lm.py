"""Decoder-only LM over a uniform stack of one ``SequenceOp`` (twin of the
uniform-stack half of ``repro/models/lm.py``).

Layer parameters are stacked (leading ``layers`` axis on every leaf, the
reference's layout) and a Python loop over layers replaces ``lax.scan``.
Decode states are the op's state tuple with every leaf ``(layers, B, ...)``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import seq_op
from .blocks import (
    embed_apply,
    embed_specs,
    mlp_apply,
    mlp_specs,
    rmsnorm_apply,
    rmsnorm_specs,
)
from .param import Spec, leaf_paths

MODES = ("train", "prefill", "decode")


def layer_specs(cfg):
    op = seq_op.op_for(cfg)
    return {
        "ln1": rmsnorm_specs(cfg.d_model),
        "ln2": rmsnorm_specs(cfg.d_model),
        "mixer": op.specs(cfg),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
    }


def _stack(tree, L: int):
    if isinstance(tree, Spec):
        return dataclasses.replace(tree, shape=(L,) + tree.shape)
    return {k: _stack(v, L) for k, v in tree.items()}


def lm_specs(cfg):
    return {
        "embed": embed_specs(cfg.vocab, cfg.d_model),
        "layers": _stack(layer_specs(cfg), cfg.n_layers),
        "final_norm": rmsnorm_specs(cfg.d_model),
        "unembed": {"kernel": Spec((cfg.d_model, cfg.vocab))},
    }


def cast_params(params, cfg):
    """The parameters as the forward pass reads them: dense kernels and the
    embedding table in ``cfg.dtype`` (the forward casts them to the
    activation dtype at every use; casting once gives the same values),
    norm scales and decay logits kept fp32."""
    dt = getattr(torch, cfg.dtype)
    out = {}
    for path, x in leaf_paths(params):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        cast = path[-1] in ("kernel", "embedding")
        node[path[-1]] = x.to(dt) if cast else x
    return out


def lm_init_states(cfg, B: int, device):
    """Zero decode states, every leaf ``(layers, B, ...)``."""
    one = seq_op.op_for(cfg).init_state(cfg, B, device)
    return type(one)(*(
        x.expand((cfg.n_layers,) + x.shape).clone() for x in one))


def _layer(tree, l: int):
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _trunk(params, tokens, cfg, states, mode):
    """Embed, run every layer, final norm.  Returns ``(hidden, states)``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "decode" and states is None:
        raise ValueError("decode needs states")
    op = seq_op.op_for(cfg)
    x = embed_apply(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    new = []
    for l in range(cfg.n_layers):
        p = _layer(params["layers"], l)
        st = None if states is None else type(states)(*(s[l] for s in states))
        h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        if mode == "decode":
            y, st = op.step(p["mixer"], h, st, cfg)
        else:
            y, st = op.forward(p["mixer"], h, cfg, state=st,
                               want_state=mode == "prefill")
            new.append(st)
        x = x + y
        x = x + mlp_apply(p["mlp"], rmsnorm_apply(p["ln2"], x, cfg.norm_eps))
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, states  # updated in place, layer by layer
    return x, type(new[0])(*(torch.stack(leaf) for leaf in zip(*new)))


def _unembed(params, x):
    return x @ params["unembed"]["kernel"].to(x.dtype)


def lm_apply(params, tokens, cfg, *, states=None, mode: str = "train"):
    """``tokens (B, n)`` -> ``(logits (B, n, vocab), states)``.

    ``train``: full sequence, no state (``states`` None on return);
    ``prefill``: full sequence resumed from ``states`` (or zero), returns
    the new stacked decode states; ``decode``: one token per row,
    **updates ``states`` in place** and returns the same object.
    """
    x, states = _trunk(params, tokens, cfg, states, mode)
    return _unembed(params, x), states


def lm_prefill(params, tokens, cfg, *, states=None):
    """Chunk-parallel prompt prefill for serving admission: each layer is ONE
    chunkwise kernel launch.  Returns ``(last_logits (B, vocab), states)``,
    the logits of the final prompt position only."""
    x, states = _trunk(params, tokens, cfg, states, "prefill")
    return _unembed(params, x[:, -1]), states


def lm_score_block(params, tokens, cfg, *, states):
    """Score a short block against streaming states: the target side of
    speculative verification (``serving/spec/verify.py``).

    One ``mode="prefill"`` pass (per layer ONE chunkwise kernel launch with
    ``states`` as its carry) over ``tokens (B, k+1) = [last committed,
    draft_1..draft_k]``.  Returns ``(logits (B, k+1, vocab), new_states)``:
    ``logits[:, j]`` is the next-token distribution after ``tokens[:,
    :j+1]``, and ``new_states`` (new tensors) have consumed the whole block.
    ``states`` is only read: the chunk kernels take their carry read-only.
    Takes no ``positions``, unlike the reference: the port's ops carry no
    positional encoding (hla-1b has none), so ``lm_apply`` has none either.
    """
    return lm_apply(params, tokens, cfg, states=states, mode="prefill")


def lm_loss(params, tokens, labels, cfg, *, denom=None):
    """Mean next-token cross-entropy in fp32 over ``mode="train"`` logits;
    labels < 0 are ignored.  ``denom`` overrides the normaliser (default:
    this batch's valid-token count).  Returns ``(loss, ce)`` (the same
    number: the port's stack has no auxiliary loss)."""
    logits, _ = lm_apply(params, tokens, cfg, mode="train")
    logits = logits.float()
    mask = labels >= 0
    nll = F.cross_entropy(logits.flatten(0, 1), labels.clamp_min(0).flatten()
                          .long(), reduction="none")
    d = mask.sum().clamp_min(1).float() if denom is None else denom
    ce = (nll * mask.flatten()).sum() / d
    return ce, ce
