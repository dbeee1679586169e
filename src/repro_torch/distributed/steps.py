"""Train step builder on one device, with exact microbatch accumulation
(twin of ``repro/distributed/steps.py::make_train_step`` without the mesh:
no ``grad_shardings``)."""

from __future__ import annotations

import dataclasses

import torch

from ..models import lm
from ..models.param import Spec, leaf_paths, tree_map
from ..optim import adamw


def model_specs(cfg):
    """``lm.lm_specs(cfg)`` with every leaf stored in ``cfg.param_dtype``
    (twin of the reference's ``steps.model_specs``; whisper is not
    ported).  ``init_params`` and ``from_jax_params`` over these specs
    give the parameters a train or serve run of ``cfg`` holds."""
    specs = lm.lm_specs(cfg)
    if cfg.param_dtype == "float32":
        return specs

    def cast(tree):
        if isinstance(tree, Spec):
            return dataclasses.replace(tree, dtype=cfg.param_dtype)
        return {k: cast(v) for k, v in tree.items()}

    return cast(specs)


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
    vis = batch.get("vis_embed")
    parts = zip(batch["tokens"].chunk(microbatches),
                batch["labels"].chunk(microbatches),
                [None] * microbatches if vis is None
                else vis.chunk(microbatches))
    acc_dt = getattr(torch, cfg.grad_accum_dtype)
    # autograd's accumulation is the reference's wherever it adds in the
    # accumulator's dtype
    own_acc = microbatches > 1 and any(
        x.dtype != acc_dt for _, x in leaf_paths(live))
    acc = tree_map(lambda x: torch.zeros(x.shape, dtype=acc_dt,
                                         device=x.device), live) \
        if own_acc else None
    loss = ce = aux = 0.0
    for tokens, labels, vis_embed in parts:
        l, (c, a) = lm.lm_loss(live, tokens, labels, cfg,
                               vis_embed=vis_embed, denom=n_valid,
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
    prepended to the tokens).  The gradient
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
