"""Train, prefill and serve step factories with exact microbatch
accumulation, and their shardings (twin of ``repro/distributed/steps.py``).
Each step dispatches on ``cfg.enc_layers``: whisper's encoder-decoder,
else the decoder-only ``lm``.

On one device the steps take plain tensors.  Under a mesh
(``sharding.use_mesh``) they take DTensors: parameters with
``make_shardings``' placements (``sharding.distribute``), moments with
ZeRO-1's, a batch with ``sharding.batch_sharding``'s; the train step
brings the gradients to ``grad_shardings`` before AdamW.  ``state_axes``
and ``state_shardings_for`` place decode states (the serving pool;
``place_states`` distributes a tree of them, as the prefill step does
under a mesh), and
``input_specs`` / ``abstract_train_args`` build a cell's inputs as
DTensors on the meta device for the dry run."""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from ..models import lm, state_tree, whisper
from ..models.param import Spec, leaf_paths, tree_map
from ..optim import adamw
from . import sharding as shd


def with_param_dtype(specs, cfg):
    """``specs`` with every leaf stored in ``cfg.param_dtype``."""
    if cfg.param_dtype == "float32":
        return specs

    def cast(tree):
        if isinstance(tree, Spec):
            return dataclasses.replace(tree, dtype=cfg.param_dtype)
        return {k: cast(v) for k, v in tree.items()}

    return cast(specs)


def model_specs(cfg):
    """``whisper.whisper_specs(cfg)`` when ``cfg.enc_layers``, else
    ``lm.lm_specs(cfg)``, with every leaf stored in ``cfg.param_dtype``
    (twin of the reference's ``steps.model_specs``).  ``init_params`` and
    ``from_jax_params`` over these specs give the parameters a train run
    of ``cfg`` holds."""
    return with_param_dtype(
        whisper.whisper_specs(cfg) if cfg.enc_layers else lm.lm_specs(cfg),
        cfg)


def _loss_fn(params, batch, cfg, denom=None, aux_weight=1.0):
    if cfg.enc_layers:
        return whisper.whisper_loss(
            params, batch["tokens"], batch["labels"], batch["frames"], cfg,
            denom=denom, aux_weight=aux_weight)
    return lm.lm_loss(params, batch["tokens"], batch["labels"], cfg,
                      vis_embed=batch.get("vis_embed"), denom=denom,
                      aux_weight=aux_weight)


def accumulate_grads(params, batch, cfg, microbatches: int = 1):
    """``(loss, ce, aux, grads)`` of the mean next-token CE plus the MoE
    load-balance loss over ``batch``, accumulated over ``microbatches``
    equal parts of its rows.

    Exact, as in the reference: every part's loss is normalised by the
    *whole* batch's valid-token count (taken from the labels first), so the
    parts' summed gradients are the full batch's, however unevenly the
    labels are masked.  Each part's backward adds into the leaves' ``.grad``
    (autograd's own accumulation), so one gradient set is live beside a
    part's activations; when ``cfg.grad_accum_dtype`` differs from a
    leaf's dtype (bf16 parameters, fp32 accumulator), the parts' gradients
    are summed in ``grad_accum_dtype`` instead, each cast as it arrives,
    as the reference's accumulator does.  ``grads`` (a dict like
    ``params``) has the parameters' dtype with one part, and
    ``grad_accum_dtype`` with several (zeros for a leaf the loss does not
    reach);
    ``loss`` and ``ce`` are sums over the parts.  The aux term stays a mean
    over the parts (router statistics do not decompose over rows): each
    part's loss weighs its aux by ``1 / microbatches``, and ``aux`` is the
    parts' mean (0 without ``cfg.moe``).
    """
    B = batch["tokens"].shape[0]
    if microbatches < 1 or B % microbatches:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"{microbatches} microbatches")
    # under a mesh a DTensor sum: the global count, on every rank
    n_valid = (batch["labels"] >= 0).sum().clamp_min(1).float()
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    # every tensor of the batch splits over its rows (tokens, labels, and
    # vis_embed or whisper's frames)
    parts = [dict(zip(batch, xs)) for xs in zip(
        *(_split_rows(x, microbatches) for x in batch.values()))]
    acc_dt = getattr(torch, cfg.grad_accum_dtype)
    # autograd's accumulation is the reference's wherever it adds in the
    # accumulator's dtype
    own_acc = microbatches > 1 and any(
        x.dtype != acc_dt for _, x in leaf_paths(live))
    acc = tree_map(lambda x: torch.zeros_like(x, dtype=acc_dt), live) \
        if own_acc else None
    loss = ce = aux = 0.0
    for part in parts:
        l, (c, a) = _loss_fn(live, part, cfg, denom=n_valid,
                             aux_weight=1.0 / microbatches)
        l.backward()
        loss, ce = loss + l.detach(), ce + c.detach()
        aux = aux + a.detach()
        if own_acc:
            for (_, s), (_, x) in zip(leaf_paths(acc), leaf_paths(live)):
                if x.grad is not None:
                    s.add_(x.grad.to(acc_dt))
                    x.grad = None
    if own_acc:
        grads = acc
    else:
        # a leaf the loss does not reach (hla3_paper's decay_a) gets zeros,
        # as jax.grad gives it
        grads = tree_map(
            lambda x: torch.zeros_like(x) if x.grad is None else x.grad,
            live)
    for _, x in leaf_paths(live):
        x.grad = None  # the returned dict holds the only reference
    return loss, ce, aux / microbatches, grads


def _split_rows(x, parts: int):
    """``x`` in ``parts`` equal groups of rows.  A batch-sharded DTensor
    splits each rank's own rows (part i: every rank's i-th block), so the
    parts stay data-parallel; the loss sums over rows, so any partition of
    them gives the same gradient."""
    if parts == 1:
        return (x,)
    if not isinstance(x, DTensor):
        return x.chunk(parts)
    loc = x.to_local()
    if loc.shape[0] % parts:
        return x.chunk(parts)
    shape = (x.shape[0] // parts,) + tuple(x.shape[1:])
    stride = shd.contiguous_stride(shape)
    return tuple(DTensor.from_local(
        c.contiguous(), x.device_mesh, x.placements, run_check=False,
        shape=torch.Size(shape), stride=stride) for c in loc.chunk(parts))


def make_train_step(cfg, opt_cfg: adamw.OptConfig, *, microbatches: int = 1,
                    grad_shardings=None):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` is the parameter dict (``model_specs(cfg)``'s dtypes),
    ``batch`` holds ``tokens`` and ``labels`` (``(B, n)`` integer tensors
    on the parameters' device, ``B`` a multiple of ``microbatches``) and
    optionally ``vis_embed`` (``(B, nv, d_model)`` patch embeddings
    prepended to the tokens), or whisper's ``frames`` (``(B, enc_frames,
    d_model)`` frame embeddings for the encoder).  The gradient
    comes from autograd through the model (``accumulate_grads``), whose
    mixer layers run ``kernels.ops.hla2_attention`` or ``ahla_attention``
    (``cfg.mixer``: forward and backward kernels on the card; ``cfg.remat
    == "full"`` launches each forward kernel twice).  ``metrics`` holds the reference's
    keys: the scalar tensors ``loss``, ``ce``, ``aux`` (the MoE
    load-balance loss, the microbatches' mean; 0 without ``cfg.moe``) and
    ``grad_norm``, and the float ``lr``.

    The step **updates ``params`` and the moments in place** and returns
    the same tensors (``adamw.adamw_update``): the reference's train step
    donates both, so its outputs alias its inputs.  A caller that needs the
    pre-step values copies them first.  The gradients are freed when the
    step returns.

    Under a mesh the arguments are DTensors and ``grad_shardings`` (a
    placements tree like ``params``, usually ``make_shardings``' first)
    is where each gradient is brought (reduced) before the update.
    """

    def train_step(params, opt_state, batch):
        loss, ce, aux, grads = accumulate_grads(params, batch, cfg,
                                                microbatches)
        if grad_shardings is not None:
            grads = tree_map(
                lambda g, pl: g if tuple(g.placements) == tuple(pl)
                else g.redistribute(g.device_mesh, pl),
                grads, grad_shardings)
        with torch.no_grad():
            params, opt_state, om = adamw.adamw_update(
                params, grads, opt_state, opt_cfg)
        # on a mesh the scalars are replicated DTensors: plain tensors here
        metrics = {k: shd.full(v) if torch.is_tensor(v) else v
                   for k, v in {"loss": loss, "ce": ce, "aux": aux,
                                **om}.items()}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg):
    """``(params, batch) -> (last_logits (B, vocab), states)``.

    ``batch`` holds ``tokens (B, n)`` (and ``frames`` for whisper,
    ``vis_embed`` for a VLM).  The states are allocated inside the step on
    the parameters' device and filled: a KV cache sized to the prompt
    exactly, as in the reference (a decode step after it writes at the
    clamped start ``n - 1``, over the last key; ``whisper_apply`` and
    ``lm_apply`` given no states add a 64-token margin), streaming states
    built from zero.  Decode continues from them (``make_serve_step``).
    Under a mesh (``sharding.use_mesh``) the allocated states are placed
    by ``state_shardings_for`` (``place_states``)."""

    def prefill_step(params, batch):
        B, n = batch["tokens"].shape
        dev = params["embed"]["embedding"].device
        mesh = shd.current_mesh()
        if cfg.enc_layers:
            states = place_states(
                cfg, whisper.whisper_init_states(cfg, B, dev, n), mesh)
            logits, states, _ = whisper.whisper_apply(
                params, batch["tokens"], batch["frames"], cfg,
                states=states, mode="prefill")
        else:
            total = n + (cfg.vis_tokens or 0)  # a VLM prepends patch tokens
            states = place_states(cfg, lm.lm_init_states(cfg, B, dev, total),
                                  mesh) \
                if lm.needs_prealloc_states(cfg) else None
            logits, states, _ = lm.lm_apply(
                params, batch["tokens"], cfg, states=states, mode="prefill",
                vis_embed=batch.get("vis_embed"))
        return logits[:, -1], states

    return prefill_step


def make_serve_step(cfg):
    """``(params, batch, states) -> (logits (B, vocab), states)``: one new
    token per row (``batch``: ``tokens (B, 1)``, ``positions (B, 1)``)
    against pre-filled states, which it updates in place."""

    def serve_step(params, batch, states):
        if cfg.enc_layers:
            logits, states, _ = whisper.whisper_apply(
                params, batch["tokens"], None, cfg, states=states,
                positions=batch["positions"], mode="decode")
        else:
            logits, states, _ = lm.lm_apply(
                params, batch["tokens"], cfg, states=states,
                positions=batch["positions"], mode="decode")
        return logits[:, -1], states

    return serve_step


# --------------------------------------------------------------------------
# shardings, and abstract inputs for the dry run
# --------------------------------------------------------------------------


def state_axes(cfg):
    """Logical axes of every decode-state leaf: the model modules'
    (``lm.lm_state_axes`` / ``whisper.whisper_state_axes``), which read
    each op record's ``state_axes``."""
    if cfg.enc_layers:
        return whisper.whisper_state_axes(cfg)
    return lm.lm_state_axes(cfg)


def state_shardings_for(cfg, mesh, states):
    """A placements tree for a decode-state tree (slots over "data",
    heads over "model", with the divisibility fallback): the list of its
    leaves' placements, in ``state_tree`` order."""
    return [shd.placements(shd.spec_for(ax, x.shape, mesh), mesh)
            for x, ax in zip(state_tree.leaves(states),
                             state_tree.leaves(state_axes(cfg)))]


def place_states(cfg, states, mesh):
    """A decode-state tree of full tensors (the same on every rank: zeros,
    or a host snapshot) as DTensors with ``state_shardings_for``'
    placements, each rank keeping its block; off-mesh as it is."""
    if mesh is None:
        return states
    pls = iter(state_shardings_for(cfg, mesh, states))
    return state_tree.tree_map(
        lambda x: shd.distribute_leaf(x, mesh, next(pls)), states)


def _meta_dtensor(shape, dtype, mesh, pl):
    from torch.distributed.tensor import empty

    return empty(shape, dtype=dtype, device_mesh=mesh, placements=pl)


def state_specs(cfg, B, max_len, mesh):
    """Decode states for ``B`` rows as DTensors with
    ``state_shardings_for``' placements, allocated by ``torch.distributed
    .tensor.empty`` on the mesh's device (fake under ``FakeTensorMode``)."""
    init = whisper.whisper_init_states if cfg.enc_layers else \
        lm.lm_init_states
    meta = init(cfg, B, torch.device("meta"), max_len)
    pls = iter(state_shardings_for(cfg, mesh, meta))
    return state_tree.tree_map(
        lambda x: _meta_dtensor(x.shape, x.dtype, mesh, next(pls)), meta)


def input_specs(cfg, shape_cfg, mesh):
    """The step inputs of a dry-run cell as batch-sharded DTensors.
    train/prefill: ``{tokens, labels?, frames?, vis_embed?}``; decode:
    ``{"batch": {tokens, positions}, "states": ...}`` (states sized to
    the cell's ``seq_len``)."""
    B, n = shape_cfg.global_batch, shape_cfg.seq_len

    def bs(shape, dt=torch.long):
        return _meta_dtensor(shape, dt, mesh, shd.batch_sharding(mesh, shape))

    if shape_cfg.kind in ("train", "prefill"):
        batch = {"tokens": bs((B, n))}
        if shape_cfg.kind == "train":
            batch["labels"] = bs((B, n))
        if cfg.enc_layers:
            batch["frames"] = bs((B, cfg.enc_frames, cfg.d_model),
                                 torch.bfloat16)
        if cfg.vis_tokens:
            batch["vis_embed"] = bs((B, cfg.vis_tokens, cfg.d_model),
                                    torch.bfloat16)
        return batch
    batch = {"tokens": bs((B, 1)), "positions": bs((B, 1))}
    return {"batch": batch, "states": state_specs(cfg, B, n, mesh)}


def make_shardings(cfg, mesh, *, zero1: bool = True):
    """``(param placements, moment placements)`` trees for this config and
    mesh (the moments ZeRO-1's unless ``zero1=False``)."""
    specs = model_specs(cfg)
    return (shd.param_shardings(specs, mesh),
            shd.opt_state_shardings(specs, mesh, zero1=zero1))


def abstract_train_args(cfg, mesh, *, zero1: bool = True):
    """``(params, opt_state)`` as DTensors allocated by ``torch.distributed
    .tensor.empty`` (no values: use under ``FakeTensorMode`` or on the meta
    device), with ``make_shardings``' placements."""
    specs = model_specs(cfg)
    ps, ms = make_shardings(cfg, mesh, zero1=zero1)
    md = getattr(torch, cfg.moment_dtype)
    params = tree_map(lambda s, pl: _meta_dtensor(
        s.shape, getattr(torch, s.dtype), mesh, pl), specs, ps)
    mu = tree_map(lambda s, pl: _meta_dtensor(s.shape, md, mesh, pl),
                  specs, ms)
    nu = tree_map(lambda s, pl: _meta_dtensor(s.shape, md, mesh, pl),
                  specs, ms)
    return params, adamw.OptState(step=0, mu=mu, nu=nu)
