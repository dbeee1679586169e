"""Decoder-only LM over a uniform or a hybrid stack of ``SequenceOp``
layers (twin of ``repro/models/lm.py``).

Layer parameters are stacked (leading ``layers`` axis on every leaf, the
reference's layout) and a Python loop over layers replaces ``lax.scan``.
A hybrid (jamba) stack, ``cfg.group_size > 0``, comes in groups: within a
group, position ``attn_index`` is the configured mixer and the others are
``mamba``; position ``i`` carries an MoE FFN when ``i % moe.every ==
moe.every - 1``.  Its parameters are ``groups/pos{i}/...``, stacked over
the ``n_layers // group_size`` groups, and the loop runs over groups, then
positions.  A uniform stack puts an MoE FFN in every layer when
``cfg.moe`` is set.  A ``self_contained`` op (rwkv6) is the whole layer:
its record owns the norms and the channel mix and runs on the residual
stream.

Decode states are each op's state tree (``state_tree``: flat for
hla2/ahla, nested for hla3, a ``KVCache`` for attn) with every leaf
``(layers, B, ...)``; a hybrid stack's are ``{"pos{i}": tree}`` with every
leaf ``(groups, B, ...)``.  A streaming op decodes through its ``step``
and a non-streaming one (attn) through its ``forward`` over the one token;
either way decode updates the states in place.  A prefill resumes from
the states it is given and only reads them, except a KV cache, which its
``forward`` fills in place; when any op of the stack has
``prealloc_state`` (attn, mamba), a prefill given no states allocates
zero ones first.  ``positions`` reach an op only when it
``needs_positions``.  ``cfg.remat`` ``"full"`` recomputes a layer (a
hybrid stack: a whole group, the reference's remat unit) in the backward
pass of ``mode="train"``, ``"dots"`` all of it but the 2-d products'
outputs (``models/remat.py``).  The MoE layers'
load-balance losses are summed over the stack and ``lm_loss`` adds them to
the cross-entropy, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.sharding import constrain
from . import moe as moe_mod
from . import remat as remat_mod
from . import seq_op
from .blocks import (
    embed_apply,
    embed_specs,
    fsdp_gather,
    gather_middle,
    mlp_apply,
    regather_grad,
    mlp_specs,
    rmsnorm_apply,
    rmsnorm_specs,
    unembed_apply,
)
from .param import Axes, Spec, unstack
from .state_tree import tree_map

MODES = ("train", "prefill", "decode")


def layer_specs(cfg, op: seq_op.SequenceOp, use_moe: bool):
    if op.self_contained:  # e.g. rwkv6: owns its norms and channel mix
        return op.specs(cfg)
    s = {
        "ln1": rmsnorm_specs(cfg.d_model),
        "ln2": rmsnorm_specs(cfg.d_model),
        op.param_key: op.specs(cfg),
    }
    if use_moe:
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp)
    return s


def _group_layout(cfg):
    """A hybrid group's ``(op, use_moe)`` per position: the configured
    mixer at ``attn_index``, mamba elsewhere; MoE on every
    ``moe.every``-th position."""
    mix_op = seq_op.op_for(cfg)
    mamba_op = seq_op.get_op("mamba")
    return [(mix_op if i == cfg.attn_index else mamba_op,
             cfg.moe is not None and i % cfg.moe.every == cfg.moe.every - 1)
            for i in range(cfg.group_size)]


def stack_layout(cfg):
    """``([(key, op, use_moe)], units)``: the positions of one unit of the
    stack and how many units there are.  A uniform stack's unit is one
    layer (key None); a hybrid stack's is a group (keys ``pos{i}``)."""
    if cfg.group_size:
        return ([(f"pos{i}", op, moe)
                 for i, (op, moe) in enumerate(_group_layout(cfg))],
                cfg.n_layers // cfg.group_size)
    return [(None, seq_op.op_for(cfg), cfg.moe is not None)], cfg.n_layers


def _stack(tree, L: int):
    if isinstance(tree, Spec):
        return dataclasses.replace(tree, shape=(L,) + tree.shape,
                                   axes=("layers",) + tree.axes)
    return {k: _stack(v, L) for k, v in tree.items()}


def lm_specs(cfg):
    specs = {"embed": embed_specs(cfg.vocab, cfg.d_model)}
    layout, units = stack_layout(cfg)
    if cfg.group_size:
        specs["groups"] = _stack({key: layer_specs(cfg, op, moe)
                                  for key, op, moe in layout}, units)
    else:
        _, op, moe = layout[0]
        specs["layers"] = _stack(layer_specs(cfg, op, moe), units)
    specs["final_norm"] = rmsnorm_specs(cfg.d_model)
    if not cfg.tie_embeddings:
        specs["unembed"] = {
            "kernel": Spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))}
    return specs


def cast_params(params, cfg):
    """The parameters as the forward pass reads them: dense kernels and
    their biases, the embedding table and the MoE experts' weights in
    ``cfg.dtype`` (the forward casts them to the activation dtype at every
    use; casting once gives the same values).  Everything else keeps its
    dtype and is cast where it is used, as the reference does: norm scales
    and LayerNorm biases (added in fp32 inside the norm), decay logits,
    the MoE router (it routes in fp32 from its weights: bf16-rounded ones
    would pick other experts), Mamba's ``A_log``, ``D`` and conv taps,
    RWKV's mix ratios, ``w0``, ``u`` and GroupNorm.  A leaf already in
    ``cfg.dtype`` (``param_dtype="bfloat16"``) is not copied."""
    dt = getattr(torch, cfg.dtype)

    def walk(node, in_moe):
        out = {}
        for key, x in node.items():
            if isinstance(x, dict):
                out[key] = walk(x, in_moe or key == "moe")
                continue
            if in_moe:
                cast = key in moe_mod.EXPERT_LEAVES
            else:  # a bias beside a kernel is a dense layer's
                cast = key in ("kernel", "embedding") or (
                    key == "bias" and "kernel" in node)
            out[key] = x.to(dt) if cast else x
        return out

    return walk(params, False)


def needs_prealloc_states(cfg) -> bool:
    """True when a prefill given no states starts from preallocated ones
    (a KV cache, which it fills; a hybrid stack's zero carry): some op of
    the stack has the ``prealloc_state`` flag."""
    return any(op.prealloc_state for _, op, _ in stack_layout(cfg)[0])


def lm_init_states(cfg, B: int, device, max_len: int = 0):
    """Zero decode states, every leaf ``(layers, B, ...)`` (a KV cache's
    shared ``length`` ``(layers,)``); a hybrid stack's ``{"pos{i}": ...}``
    with every leaf ``(groups, B, ...)``.  Each layer has its own memory.
    ``max_len`` sizes a KV cache; a streaming state ignores it."""
    layout, units = stack_layout(cfg)

    def stacked(op):
        one = op.init_state(cfg, B, device, max_len=max_len)
        return tree_map(lambda x: x.expand((units,) + x.shape).clone(), one)

    if cfg.group_size:
        return {key: stacked(op) for key, op, _ in layout}
    return stacked(layout[0][1])


def layer_state_axes(cfg, op: seq_op.SequenceOp):
    """Logical axes matching one layer's state tree (the op record's;
    ``lm_state_axes`` adds the ``layers`` stacking dim)."""
    return op.state_axes(cfg)


def _stack_axes(tree):
    return tree_map(lambda ax: Axes(("layers",) + tuple(ax)), tree)


def lm_state_axes(cfg):
    """Tree of ``Axes`` matching ``lm_init_states`` leaf for leaf: the one
    source of the decode states' sharding (``distributed.steps``
    resolves it against a mesh).  A hybrid stack's group axis is
    ``layers`` too, as in the reference."""
    layout, _ = stack_layout(cfg)
    if cfg.group_size:
        return {key: _stack_axes(layer_state_axes(cfg, op))
                for key, op, _ in layout}
    return _stack_axes(layer_state_axes(cfg, layout[0][1]))


def _block(p, x, cfg, op, use_moe, mix):
    """One layer.  ``mix(sub_params, h)`` runs the op and returns ``(y,
    state)``.  A self-contained op is the layer: ``mix`` runs on the
    residual stream with the layer's params and returns the new stream.
    Otherwise ln1 -> op (its params under ``param_key``) -> residual ->
    ln2 -> MLP or MoE FFN -> residual.  Returns ``(x, state, aux)``,
    ``aux`` the MoE layer's load-balance loss (None without one)."""
    if op.self_contained:
        x, st = mix(p, x)
        return x, st, None
    y, st = mix(p[op.param_key], rmsnorm_apply(p["ln1"], x, cfg.norm_eps))
    x = x + y
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if use_moe:
        y, aux = moe_mod.moe_apply(p["moe"], h, cfg)
    else:
        y, aux = mlp_apply(p["mlp"], h, cfg.mlp), None
    return x + y, st, aux


def _unit(p, x, cfg, layout, mixes):
    """One unit of the stack (a layer, or a hybrid group's positions in
    order, position ``key`` on ``p[key]``).  It is what ``remat="full"``
    recomputes (twin of the reference's ``_maybe_remat`` around its scan
    body), so MoE blocks are recomputed too and their aux leaves the
    checkpoint as an output.  Returns ``(x, [state per position],
    aux)``, ``aux`` None when no position has an MoE FFN."""
    states, aux = [], None
    x = constrain(x, ("batch", "seq", "embed"))
    for (key, op, use_moe), mix in zip(layout, mixes):
        x, st, a = _block(p if key is None else p[key], x, cfg, op, use_moe,
                          mix)
        states.append(st)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, states, aux


def _mixer(op, cfg, mode, st, kw):
    """The op's call for one layer: its step in decode (streaming ops),
    else its forward over the block against ``st``."""
    kw = kw if op.needs_positions else {}
    if mode == "decode" and op.streaming:
        return lambda sub, h: op.step(sub, h, st, cfg, **kw)
    return lambda sub, h: op.forward(sub, h, cfg, state=st,
                                     want_state=mode != "train", **kw)


def _trunk(params, tokens, cfg, states, mode, positions=None,
           vis_embed=None):
    """Embed (after ``vis_embed``'s tokens, when given), run every layer,
    final norm.  Returns ``(hidden, states, aux)``, ``aux`` the layers'
    summed MoE load-balance loss (an fp32 scalar, 0 without ``cfg.moe``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "decode" and states is None:
        raise ValueError("decode needs states")
    layout, _ = stack_layout(cfg)
    hybrid = bool(cfg.group_size)
    dt = getattr(torch, cfg.dtype)
    x = embed_apply(params["embed"], tokens).to(dt)
    if vis_embed is not None:
        x = torch.cat([vis_embed.to(dt), x], 1)
    n = x.shape[1]
    kw = {}
    need_pos = [op.name for _, op, _ in layout if op.needs_positions]
    if need_pos:
        if positions is None:
            if mode == "decode":
                raise ValueError(f"decode with {need_pos[0]!r} needs the "
                                 "tokens' positions")
            positions = torch.arange(n, device=x.device)[None]
        kw["positions"] = positions
    if mode == "prefill" and states is None and needs_prealloc_states(cfg):
        # room for the prompt and a margin of decode steps
        states = lm_init_states(cfg, x.shape[0], x.device, max_len=n + 64)
    # under remat a unit's activations are recomputed in backward
    remat = remat_mod.active(cfg, mode)
    layers = unstack(params["groups" if hybrid else "layers"])
    ins, outs = [], []  # each unit's per-position states in and out
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, p in enumerate(layers):
        st = None if states is None else tree_map(lambda s: s[l], states)
        st_in = [None if st is None else st[key] if hybrid else st
                 for key, _, _ in layout]
        mixes = [_mixer(op, cfg, mode, s, kw)
                 for (_, op, _), s in zip(layout, st_in)]
        x, st_out, a = remat_mod.run(_unit, p, x, cfg, layout, mixes,
                                     cfg=cfg) \
            if remat else _unit(p, x, cfg, layout, mixes)
        if a is not None:
            aux = aux + a
        if mode == "prefill":
            ins.append(st_in)
            outs.append(st_out)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if mode == "train":
        return x, None, aux
    if mode == "decode":
        return x, states, aux  # updated in place, layer by layer
    new = []
    for i, (key, _, _) in enumerate(layout):
        per_unit = [o[i] for o in outs]
        if states is not None and all(o is s[i] for o, s in
                                      zip(per_unit, ins)):
            # the op filled the given states in place (a KV cache)
            new.append(states[key] if hybrid else states)
        else:
            new.append(tree_map(lambda *xs: torch.stack(xs), *per_unit))
    if hybrid:
        return x, {key: t for (key, _, _), t in zip(layout, new)}, aux
    return x, new[0], aux


def _unembed(params, x, cfg):
    if cfg.tie_embeddings:
        return unembed_apply(params["embed"], x)
    return regather_grad(gather_middle(x) @ fsdp_gather(
        params["unembed"]["kernel"].to(x.dtype)))


def lm_apply(params, tokens, cfg, *, states=None, positions=None,
             mode: str = "train", vis_embed=None):
    """``tokens (B, n)`` -> ``(logits (B, nv + n, vocab), states, aux)``,
    ``nv`` the ``vis_embed (B, nv, d_model)`` tokens prepended (none by
    default) and ``aux`` the MoE layers' summed load-balance loss (an fp32
    scalar tensor, 0 without ``cfg.moe``).

    ``train``: full sequence, no state (``states`` None on return);
    ``prefill``: full sequence resumed from ``states`` (or zero; only
    read), returns the new stacked decode states (a KV cache: filled in
    place, allocated for ``n + 64`` tokens when not given); ``decode``:
    one token per row, **updates ``states`` in place** and returns the
    same object.
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
    ``states`` is only read: every spec-decodable op's forward (the chunk
    kernels, mamba, rwkv6, ...) takes its carry read-only.
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
    ce = next_token_ce(logits, labels, denom)
    return ce + aux_weight * aux, (ce, aux)


def next_token_ce(logits, labels, denom=None):
    """Cross-entropy of ``logits (B, n, vocab)`` in fp32 against ``labels
    (B, n)``, summed over the labels >= 0 and divided by ``denom``
    (default: their count)."""
    mask = labels >= 0
    if _vocab_split(logits):
        nll = _vocab_parallel_nll(logits.float(), labels.clamp_min(0))
    else:
        nll = F.cross_entropy(logits.float().flatten(0, 1),
                              labels.clamp_min(0).flatten().long(),
                              reduction="none")
    d = mask.sum().clamp_min(1).float() if denom is None else denom
    return (nll * mask.flatten()).sum() / d


def _vocab_split(logits) -> bool:
    """True for a DTensor whose vocab dim is split over more than one
    rank."""
    return isinstance(logits, DTensor) and any(
        pl.is_shard(logits.ndim - 1) and size > 1
        for pl, size in zip(logits.placements, logits.device_mesh.shape))


class _VocabParallelNLL(torch.autograd.Function):
    """Megatron's vocab-parallel cross-entropy on one rank's block: local
    logits ``(rows, V_local)`` fp32 whose columns start at ``first``, the
    rows' targets, and the process group the vocab is split over.  The max,
    the sum of exponentials and the target's logit are all-reduced over
    that group (three ``(rows,)`` vectors); the backward is local
    (``softmax - onehot``)."""

    @staticmethod
    def forward(ctx, z, lab, first, group):
        from torch.distributed import _functional_collectives as funcol

        def reduce(t, op):
            return funcol.wait_tensor(funcol.all_reduce(t, op, group))

        m = reduce(z.amax(-1), "max")
        e = (z - m[:, None]).exp()
        s = reduce(e.sum(-1), "sum")
        col = lab - first
        hit = (col >= 0) & (col < z.shape[-1])
        zt = z.gather(-1, col.clamp(0, z.shape[-1] - 1)[:, None])[:, 0]
        zt = reduce(torch.where(hit, zt, torch.zeros_like(zt)), "sum")
        ctx.save_for_backward(e, s, col, hit)
        return s.log() + m - zt

    @staticmethod
    def backward(ctx, g):
        e, s, col, hit = ctx.saved_tensors
        grad = e / s[:, None]
        onehot = torch.zeros_like(grad).scatter_(
            -1, col.clamp(0, grad.shape[-1] - 1)[:, None],
            hit[:, None].to(grad.dtype))
        return (grad - onehot) * g[:, None], None, None, None


def _vocab_parallel_nll(logits, labels):
    """Next-token NLL ``(B * n,)`` of vocab-sharded logits without
    gathering the vocab: each rank works on its own block of rows and
    vocab (``_VocabParallelNLL``); the result keeps the logits' row
    split."""
    from ..distributed.sharding import contiguous_stride, local_block

    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    over = [i for i, pl in enumerate(logits.placements)
            if pl.is_shard(vdim)]
    want = tuple(Shard(vdim) if i == over[0] else
                 Shard(0) if pl.is_shard(0) else Replicate()
                 for i, pl in enumerate(logits.placements))
    if want != tuple(logits.placements):
        logits = logits.redistribute(mesh, want)
    rows = tuple(Shard(0) if pl.is_shard(0) else Replicate() for pl in want)
    lab = labels.redistribute(mesh, rows).to_local() \
        if isinstance(labels, DTensor) else local_block(labels, mesh, rows)
    zl = logits.to_local()
    vloc = zl.shape[-1]
    first = mesh.get_coordinate()[over[0]] * vloc
    nll = _VocabParallelNLL.apply(zl.flatten(0, -2), lab.flatten().long(),
                                  first, mesh.get_group(over[0]))
    shape = (math.prod(logits.shape[:-1]),)
    return DTensor.from_local(nll, mesh, rows, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))
