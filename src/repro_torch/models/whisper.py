"""Whisper-style encoder-decoder backbone (twin of
``repro/models/whisper.py``), the conv frontend a stub.

The encoder reads precomputed frame embeddings ``(B, enc_frames,
d_model)`` (the reference's stub frontend: the conv subsampler is out of
scope), adds sinusoidal positions and runs ``enc_layers`` bidirectional
softmax layers (LayerNorm, attention with ``causal=False``, GELU MLP).  The
decoder adds a learned position table (4096 rows, indexed by row 0's
positions and clipped) to the token embeddings and runs ``n_layers``
layers: causal self-mixing, cross-attention over the encoder's K/V, GELU
MLP; its logits come through the embedding table (tied, whatever
``cfg.tie_embeddings`` says, as in the reference).

The decoder's self-mixing is the registered op ``cfg.mixer`` names.
Softmax stays a whisper-local ``attention_apply`` with no RoPE, its
parameters under ``"self"`` and its decode state a ``KVCache`` filled in
place.  A streaming op drops in through its record, its parameters under
``"self_mixer"``: ``hla2`` and ``ahla`` run their kernels there (one chunk
forward per layer a prefill, one decode step per layer a token, the
forward and backward kernels in training).  A self-contained op (rwkv6)
owns its norms and FFN and cannot be a sublayer: ``whisper_specs`` raises
``SequenceOpError`` for it.

Decode states are ``{"self": op state, "cross_k", "cross_v"}`` with every
leaf ``(n_layers, B, ...)``.  A prefill ignores the self state of a
streaming op (it starts from zero, as the reference's) and returns the
cross K/V it computed from the encoder, in the activation dtype; a decode
step updates the self state in place and reads the cross K/V.  Layers are
a Python loop over the stacked parameters; ``cfg.remat`` ``"full"``
recomputes each encoder and decoder layer in backward, ``"dots"`` all of
it but the 2-d products' outputs (``models/remat.py``).  Under a mesh
(``sharding.use_mesh``, DTensor parameters, states placed by
``whisper_state_axes``) each layer constrains its residual stream to
``("batch", "seq", "embed")``, as the reference's scan bodies do; the
attention's heads, the cross K/V's among them, go over "model" and every
kernel and ``flash_attention`` call runs on a rank's (batch, head) rows.
On the CPU: ``tests/test_torch_distributed_families.py`` (4 gloo ranks);
on the card ``chip_smoke.py`` phase 17 (one rank).
"""

from __future__ import annotations

import torch

from ..distributed.sharding import constrain
from . import attention as attn_mod
from . import remat as remat_mod
from . import seq_op
from .blocks import (
    embed_apply,
    embed_specs,
    layernorm_apply,
    layernorm_specs,
    mlp_apply,
    mlp_specs,
    sinusoidal_pos,
    unembed_apply,
)
from .lm import MODES, _stack, next_token_ce
from .param import Axes, Spec, unstack
from .state_tree import tree_map

POS_ROWS = 4096  # the learned decoder position table


def _enc_layer_specs(cfg):
    return {
        "ln1": layernorm_specs(cfg.d_model),
        "attn": attn_mod.attention_specs(cfg),
        "ln2": layernorm_specs(cfg.d_model),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, "gelu"),
    }


def _self_op(cfg) -> seq_op.SequenceOp:
    """The decoder's causal self-mixing op.  Softmax stays a whisper-local
    attention call; any streaming registered op drops in through its
    record.  A self-contained op (rwkv6) cannot be a sublayer."""
    op = seq_op.op_for(cfg)
    if op.self_contained:
        raise seq_op.SequenceOpError(
            f"whisper decoder cannot host self-contained op {op.name!r} "
            "(it replaces the whole block; the decoder needs a sublayer)")
    return op


def _self_key(op) -> str:
    # the reference's parameter key, so its checkpoints map across
    return "self" if not op.streaming else "self_mixer"


def _dec_layer_specs(cfg):
    op = _self_op(cfg)
    return {
        "ln1": layernorm_specs(cfg.d_model),
        "ln_x": layernorm_specs(cfg.d_model),
        "cross_q": attn_mod.attention_specs(cfg),  # wq/wo used; wk/wv not
        "cross_kv": attn_mod.cross_kv_specs(cfg),
        "ln2": layernorm_specs(cfg.d_model),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, "gelu"),
        _self_key(op): op.specs(cfg),
    }


def whisper_specs(cfg):
    return {
        "embed": embed_specs(cfg.vocab, cfg.d_model),
        "pos_embed": Spec((POS_ROWS, cfg.d_model), (None, "embed"),
                          init="embed", scale=0.01),
        "enc_layers": _stack(_enc_layer_specs(cfg), cfg.enc_layers),
        "enc_norm": layernorm_specs(cfg.d_model),
        "dec_layers": _stack(_dec_layer_specs(cfg), cfg.n_layers),
        "dec_norm": layernorm_specs(cfg.d_model),
    }


def _enc_layer(p, x, cfg):
    x = constrain(x, ("batch", "seq", "embed"))
    h = layernorm_apply(p["ln1"], x, cfg.norm_eps)
    y, _ = attn_mod.attention_apply(p["attn"], h, cfg, causal=False,
                                    use_rope=False)
    x = x + y
    h = layernorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, "gelu")


def whisper_encode(params, frames, cfg):
    """``frames (B, ne, d_model)``, precomputed embeddings (the stub
    frontend) -> the encoder output ``(B, ne, d_model)`` in ``cfg.dtype``."""
    act = getattr(torch, cfg.dtype)
    ne = frames.shape[1]
    x = frames.to(act) + sinusoidal_pos(ne, cfg.d_model, act,
                                        frames.device)[None]
    remat = remat_mod.active(cfg)
    for p in unstack(params["enc_layers"]):
        x = remat_mod.run(_enc_layer, p, x, cfg, cfg=cfg) \
            if remat else _enc_layer(p, x, cfg)
    return layernorm_apply(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(p, x, enc_out, st, cfg, op, mode, positions):
    """One decoder layer.  Returns ``(x, self state, cross_k, cross_v)``:
    the self state as the op left it (a cache filled in place, a streaming
    op's new state; None in training), the cross K/V computed from
    ``enc_out`` or, in decode, read from ``st``."""
    key = _self_key(op)
    x = constrain(x, ("batch", "seq", "embed"))
    h = layernorm_apply(p["ln1"], x, cfg.norm_eps)
    if not op.streaming:  # softmax: whisper-local, no RoPE
        y, new_self = attn_mod.attention_apply(
            p[key], h, cfg, positions=positions,
            cache=None if st is None else st["self"], use_rope=False)
    elif mode == "decode":
        y, new_self = op.step(p[key], h, st["self"], cfg)
    else:  # a prefill starts from zero whatever state it was given
        y, new_self = op.forward(p[key], h, cfg,
                                 want_state=mode == "prefill")
    x = x + y
    h = layernorm_apply(p["ln_x"], x, cfg.norm_eps)
    if mode == "decode":
        ck, cv = st["cross_k"], st["cross_v"]
    else:
        ck, cv = attn_mod.cross_kv_apply(p["cross_kv"], enc_out, cfg)
    y, _ = attn_mod.attention_apply(p["cross_q"], h, cfg, cross_kv=(ck, cv),
                                    use_rope=False)
    x = x + y
    h = layernorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, "gelu"), new_self, ck, cv


def whisper_decode(params, tokens, enc_out, cfg, *, states=None,
                   positions=None, mode: str = "train"):
    """The decoder over ``tokens (B, n)``, cross-attending to ``enc_out``
    (None in decode: the cross K/V live in ``states``).  Returns
    ``(logits, states, aux)``: the states None in training, the given
    ones updated in place in decode, and in prefill the new ones (a KV
    cache filled in place; a streaming op's states and the cross K/V
    stacked over the layers); ``aux`` an fp32 zero."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "decode" and states is None:
        raise ValueError("decode needs states")
    act = getattr(torch, cfg.dtype)
    n = tokens.shape[1]
    dev = tokens.device
    if positions is None:
        positions = torch.arange(n, device=dev)[None]
    x = embed_apply(params["embed"], tokens).to(act)
    # row 0's positions, clipped into the learned table
    table = params["pos_embed"]
    pos_idx = positions[0].clamp(0, table.shape[0] - 1).long()
    x = x + table[pos_idx].to(act)[None]
    op = _self_op(cfg)
    remat = remat_mod.active(cfg, mode)
    outs = []
    for l, p in enumerate(unstack(params["dec_layers"])):
        st = None if states is None else tree_map(lambda s: s[l], states)
        args = (p, x, enc_out, st, cfg, op, mode, positions)
        x, new_self, ck, cv = remat_mod.run(_dec_layer, *args, cfg=cfg) \
            if remat else _dec_layer(*args)
        if mode == "prefill":
            outs.append((new_self, ck, cv))
    x = layernorm_apply(params["dec_norm"], x, cfg.norm_eps)
    logits = unembed_apply(params["embed"], x)  # tied
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if mode == "train":
        return logits, None, aux
    if mode == "decode":
        return logits, states, aux  # updated in place, layer by layer
    selfs = [o[0] for o in outs]
    if states is not None and not op.streaming:
        new_self = states["self"]  # the caches, filled in place
    else:
        new_self = tree_map(lambda *xs: torch.stack(xs), *selfs)
    return logits, {"self": new_self,
                    "cross_k": torch.stack([o[1] for o in outs]),
                    "cross_v": torch.stack([o[2] for o in outs])}, aux


def whisper_init_states(cfg, B: int, device, max_len: int = 0):
    """Zero decode states, every leaf ``(n_layers, B, ...)``: the self op's
    state (a ``max_len`` KV cache for softmax, a streaming state
    otherwise) and bf16 cross K/V buffers ``(B, Hk, enc_frames, dh)``,
    which a prefill replaces by the ones it computes."""
    shape = (B, cfg.n_kv_heads, cfg.enc_frames, cfg.head_dim)
    one = {
        "self": _self_op(cfg).init_state(cfg, B, device, max_len=max_len),
        "cross_k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "cross_v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }
    L = cfg.n_layers
    return tree_map(lambda x: x.expand((L,) + x.shape).clone(), one)


def whisper_state_axes(cfg):
    """Logical axes matching ``whisper_init_states`` leaf for leaf, the
    ``layers`` stacking dim included (see ``lm.lm_state_axes``)."""
    cross = Axes(("batch", "kv_heads", None, None))
    one = {"self": _self_op(cfg).state_axes(cfg), "cross_k": cross,
           "cross_v": cross}
    return tree_map(lambda ax: Axes(("layers",) + tuple(ax)), one)


def whisper_apply(params, tokens, frames, cfg, *, states=None,
                  positions=None, mode: str = "train",
                  prefill_cache_margin: int = 64):
    """Encoder then decoder: ``tokens (B, n)``, ``frames (B, ne,
    d_model)`` (unused in decode) -> ``(logits (B, n, vocab), states,
    aux)``.  A prefill given no states allocates them with a KV cache of
    ``n + prefill_cache_margin`` slots, so decode steps can follow;
    ``positions`` (decode must pass them) index the learned table."""
    if mode == "decode":
        return whisper_decode(params, tokens, None, cfg, states=states,
                              positions=positions, mode=mode)
    if mode == "prefill" and states is None:
        states = whisper_init_states(cfg, tokens.shape[0], tokens.device,
                                     tokens.shape[1] + prefill_cache_margin)
    enc_out = whisper_encode(params, frames, cfg)
    return whisper_decode(params, tokens, enc_out, cfg, states=states,
                          positions=positions, mode=mode)


def whisper_loss(params, tokens, labels, frames, cfg, *, denom=None,
                 aux_weight: float = 1.0):
    """Mean next-token cross-entropy in fp32 over valid labels (< 0
    ignored), as ``lm.lm_loss``: ``denom`` overrides the normaliser
    (microbatches pass the whole batch's count), ``aux_weight`` scales the
    (zero) aux term.  Returns ``(ce + aux_weight * aux, (ce, aux))``."""
    logits, _, aux = whisper_apply(params, tokens, frames, cfg,
                                   mode="train")
    ce = next_token_ce(logits, labels, denom)
    return ce + aux_weight * aux, (ce, aux)
