"""Decoder-only LM over a uniform stack of one ``SequenceOp`` (twin of the
uniform-stack half of ``repro/models/lm.py``).

Layer parameters are stacked (leading ``layers`` axis on every leaf, the
reference's layout) and a Python loop over layers replaces ``lax.scan``.
Decode states are the op's state tree (``state_tree``: flat for hla2/ahla,
nested for hla3, a ``KVCache`` for attn) with every leaf ``(layers, B,
...)``.  A streaming op decodes through its ``step``; a non-streaming one
(attn) through its ``forward`` over the one token against its state.  An
op with ``prealloc_state`` (attn) prefills into preallocated states, in
place.  ``positions`` reach the op only when it ``needs_positions``.
``cfg.remat == "full"`` recomputes each layer's activations in the
backward pass of ``mode="train"`` (``torch.utils.checkpoint``).  With
``cfg.moe`` every layer's MLP is an MoE FFN (``models/moe.py``), whose
load-balance loss ``lm_apply`` sums over the layers and ``lm_loss`` adds
to the cross-entropy, as the reference does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import moe as moe_mod
from . import seq_op
from .blocks import (
    embed_apply,
    embed_specs,
    mlp_apply,
    mlp_specs,
    rmsnorm_apply,
    rmsnorm_specs,
    unembed_apply,
)
from .param import Spec, leaf_paths
from .state_tree import tree_map

MODES = ("train", "prefill", "decode")


def layer_specs(cfg):
    op = seq_op.op_for(cfg)
    s = {
        "ln1": rmsnorm_specs(cfg.d_model),
        "ln2": rmsnorm_specs(cfg.d_model),
        op.param_key: op.specs(cfg),
    }
    if cfg.moe is not None:
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp)
    return s


def _stack(tree, L: int):
    if isinstance(tree, Spec):
        return dataclasses.replace(tree, shape=(L,) + tree.shape)
    return {k: _stack(v, L) for k, v in tree.items()}


def lm_specs(cfg):
    specs = {
        "embed": embed_specs(cfg.vocab, cfg.d_model),
        "layers": _stack(layer_specs(cfg), cfg.n_layers),
        "final_norm": rmsnorm_specs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = {"kernel": Spec((cfg.d_model, cfg.vocab))}
    return specs


def cast_params(params, cfg):
    """The parameters as the forward pass reads them: dense kernels and
    biases, the embedding table and the MoE experts' weights in
    ``cfg.dtype`` (the forward casts them to the activation dtype at every
    use; casting once gives the same values); norm scales, decay logits
    and the MoE router kept fp32 (the router routes in fp32 from the fp32
    weights: bf16-rounded weights would pick other experts)."""
    dt = getattr(torch, cfg.dtype)
    out = {}
    for path, x in leaf_paths(params):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if "moe" in path:
            cast = path[-1] in moe_mod.EXPERT_LEAVES
        else:
            cast = path[-1] in ("kernel", "bias", "embedding")
        node[path[-1]] = x.to(dt) if cast else x
    return out


def needs_prealloc_states(cfg) -> bool:
    """True when prefill writes into preallocated states (a KV cache)
    rather than building its states from scratch: the op's
    ``prealloc_state`` flag."""
    return seq_op.op_for(cfg).prealloc_state


def lm_init_states(cfg, B: int, device, max_len: int = 0):
    """Zero decode states, every leaf ``(layers, B, ...)`` (a KV cache's
    shared ``length`` ``(layers,)``), each layer its own memory.
    ``max_len`` sizes a KV cache; a streaming state ignores it."""
    one = seq_op.op_for(cfg).init_state(cfg, B, device, max_len=max_len)
    return tree_map(lambda x: x.expand((cfg.n_layers,) + x.shape).clone(),
                    one)


def _layer(tree, l: int):
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _block(p, x, cfg, mix):
    """One layer: ln1 -> mixer -> residual -> ln2 -> MLP (or MoE FFN) ->
    residual.  ``mix(layer_params, h)`` runs the mixer on its own params
    (the record's ``param_key``) and returns ``(y, state)``.  Returns ``(x,
    state, aux)``, ``aux`` the MoE layer's load-balance loss (None without
    ``cfg.moe``).  It is the unit ``remat="full"`` recomputes (twin of the
    reference's ``_maybe_remat`` around its layer body), so the MoE block
    is recomputed too and its aux leaves the checkpoint as an output."""
    y, st = mix(p, rmsnorm_apply(p["ln1"], x, cfg.norm_eps))
    x = x + y
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_mod.moe_apply(p["moe"], h, cfg)
    else:
        y, aux = mlp_apply(p["mlp"], h, cfg.mlp), None
    return x + y, st, aux


def _trunk(params, tokens, cfg, states, mode, positions=None,
           vis_embed=None):
    """Embed (after ``vis_embed``'s tokens, when given), run every layer,
    final norm.  Returns ``(hidden, states, aux)``, ``aux`` the layers'
    summed MoE load-balance loss (an fp32 scalar, 0 without ``cfg.moe``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "decode" and states is None:
        raise ValueError("decode needs states")
    op = seq_op.op_for(cfg)
    dt = getattr(torch, cfg.dtype)
    x = embed_apply(params["embed"], tokens).to(dt)
    if vis_embed is not None:
        x = torch.cat([vis_embed.to(dt), x], 1)
    n = x.shape[1]
    kw = {}
    if op.needs_positions:
        if positions is None:
            if mode == "decode":
                raise ValueError(f"decode with {op.name!r} needs the "
                                 "tokens' positions")
            positions = torch.arange(n, device=x.device)[None]
        kw["positions"] = positions
    # a prealloc op's prefill, and every decode, update states in place
    prealloc = needs_prealloc_states(cfg)
    in_place = mode == "decode" or (mode == "prefill" and prealloc)
    if mode == "prefill" and states is None and prealloc:
        # room for the prompt and a margin of decode steps
        states = lm_init_states(cfg, x.shape[0], x.device, max_len=n + 64)
    # under remat a layer's activations are recomputed in backward
    remat = (mode == "train" and cfg.remat == "full"
             and torch.is_grad_enabled())
    new = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.n_layers):
        p = _layer(params["layers"], l)
        st = None if states is None else tree_map(lambda s: s[l], states)
        if mode == "decode" and op.streaming:
            mix = lambda pl, h, st=st: op.step(  # noqa: E731
                pl[op.param_key], h, st, cfg, **kw)
        else:
            mix = lambda pl, h, st=st: op.forward(  # noqa: E731
                pl[op.param_key], h, cfg, state=st,
                want_state=mode != "train", **kw)
        x, st, a = checkpoint(_block, p, x, cfg, mix, use_reentrant=False) \
            if remat else _block(p, x, cfg, mix)
        if a is not None:
            aux = aux + a
        if mode == "prefill" and not in_place:
            new.append(st)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if mode == "train":
        return x, None, aux
    if in_place:
        return x, states, aux  # updated in place, layer by layer
    return x, tree_map(lambda *per_layer: torch.stack(per_layer), *new), aux


def _unembed(params, x, cfg):
    if cfg.tie_embeddings:
        return unembed_apply(params["embed"], x)
    return x @ params["unembed"]["kernel"].to(x.dtype)


def lm_apply(params, tokens, cfg, *, states=None, positions=None,
             mode: str = "train", vis_embed=None):
    """``tokens (B, n)`` -> ``(logits (B, nv + n, vocab), states, aux)``,
    ``nv`` the ``vis_embed (B, nv, d_model)`` tokens prepended (none by
    default) and ``aux`` the MoE layers' summed load-balance loss (an fp32
    scalar tensor, 0 without ``cfg.moe``).

    ``train``: full sequence, no state (``states`` None on return);
    ``prefill``: full sequence resumed from ``states`` (or zero), returns
    the new stacked decode states (a KV cache: filled in place, allocated
    for ``n + 64`` tokens when not given); ``decode``: one token per row,
    **updates ``states`` in place** and returns the same object.
    ``positions`` (default ``arange(n)``; decode must pass them) reach an
    op that needs them.
    """
    x, states, aux = _trunk(params, tokens, cfg, states, mode, positions,
                            vis_embed)
    return _unembed(params, x, cfg), states, aux


def lm_prefill(params, tokens, cfg, *, states=None, positions=None):
    """Chunk-parallel prompt prefill for serving admission: each HLA layer
    is ONE chunkwise kernel launch.  Returns ``(last_logits (B, vocab),
    states)``, the logits of the final prompt position only."""
    x, states, _ = _trunk(params, tokens, cfg, states, "prefill", positions)
    return _unembed(params, x[:, -1], cfg), states


def lm_score_block(params, tokens, cfg, *, states):
    """Score a short block against streaming states: the target side of
    speculative verification (``serving/spec/verify.py``).

    One ``mode="prefill"`` pass (per layer ONE chunkwise kernel launch with
    ``states`` as its carry) over ``tokens (B, k+1) = [last committed,
    draft_1..draft_k]``.  Returns ``(logits (B, k+1, vocab), new_states)``:
    ``logits[:, j]`` is the next-token distribution after ``tokens[:,
    :j+1]``, and ``new_states`` (new tensors) have consumed the whole block.
    ``states`` is only read: the chunk kernels take their carry read-only.
    Takes no ``positions``, unlike the reference: no spec-decodable op of
    the port consumes them (``attn`` is not spec-decodable).
    """
    logits, new_states, _ = lm_apply(params, tokens, cfg, states=states,
                                     mode="prefill")
    return logits, new_states


def lm_loss(params, tokens, labels, cfg, *, vis_embed=None, denom=None,
            aux_weight: float = 1.0):
    """Mean next-token cross-entropy in fp32 over ``mode="train"`` logits
    of the token positions (``vis_embed``'s are sliced off) plus the MoE
    load-balance loss; labels < 0 are ignored.  ``denom`` overrides the
    CE normaliser (default: this batch's valid-token count); ``aux_weight``
    scales the aux term (``1 / microbatches`` under accumulation).  Returns
    ``(ce + aux_weight * aux, (ce, aux))``, as the reference does."""
    logits, _, aux = lm_apply(params, tokens, cfg, mode="train",
                              vis_embed=vis_embed)
    if vis_embed is not None:
        logits = logits[:, vis_embed.shape[1]:]
    logits = logits.float()
    mask = labels >= 0
    nll = F.cross_entropy(logits.flatten(0, 1), labels.clamp_min(0).flatten()
                          .long(), reduction="none")
    d = mask.sum().clamp_min(1).float() if denom is None else denom
    ce = (nll * mask.flatten()).sum() / d
    return ce + aux_weight * aux, (ce, aux)
