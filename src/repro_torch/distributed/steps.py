"""Train, prefill and serve step factories on one device, with exact
microbatch accumulation (twin of ``repro/distributed/steps.py`` without
the mesh: no ``grad_shardings``, no ``input_specs``).  Each dispatches on
``cfg.enc_layers``: whisper's encoder-decoder, else the decoder-only
``lm``."""

from __future__ import annotations

import dataclasses

import torch

from ..models import lm, whisper
from ..models.param import Spec, leaf_paths, tree_map
from ..optim import adamw


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
    n_valid = (batch["labels"] >= 0).sum().clamp_min(1).float()
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    # every tensor of the batch splits over its rows (tokens, labels, and
    # vis_embed or whisper's frames)
    parts = [dict(zip(batch, xs)) for xs in zip(
        *(x.chunk(microbatches) for x in batch.values()))]
    acc_dt = getattr(torch, cfg.grad_accum_dtype)
    # autograd's accumulation is the reference's wherever it adds in the
    # accumulator's dtype
    own_acc = microbatches > 1 and any(
        x.dtype != acc_dt for _, x in leaf_paths(live))
    acc = tree_map(lambda x: torch.zeros(x.shape, dtype=acc_dt,
                                         device=x.device), live) \
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


def make_train_step(cfg, opt_cfg: adamw.OptConfig, *, microbatches: int = 1):
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
    """

    def train_step(params, opt_state, batch):
        loss, ce, aux, grads = accumulate_grads(params, batch, cfg,
                                                microbatches)
        with torch.no_grad():
            params, opt_state, om = adamw.adamw_update(
                params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
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
    built from zero.  Decode continues from them (``make_serve_step``)."""

    def prefill_step(params, batch):
        B, n = batch["tokens"].shape
        dev = params["embed"]["embedding"].device
        if cfg.enc_layers:
            states = whisper.whisper_init_states(cfg, B, dev, n)
            logits, states, _ = whisper.whisper_apply(
                params, batch["tokens"], batch["frames"], cfg,
                states=states, mode="prefill")
        else:
            total = n + (cfg.vis_tokens or 0)  # a VLM prepends patch tokens
            states = lm.lm_init_states(cfg, B, dev, total) \
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
