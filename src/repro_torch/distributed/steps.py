"""Train step builder on one device, with exact microbatch accumulation
(twin of ``repro/distributed/steps.py::make_train_step`` without the mesh:
no ``grad_shardings``)."""

from __future__ import annotations

import torch

from ..models import lm
from ..models.param import leaf_paths, tree_map
from ..optim import adamw


def accumulate_grads(params, batch, cfg, microbatches: int = 1):
    """``(loss, ce, grads)`` of the mean next-token CE over ``batch``,
    accumulated over ``microbatches`` equal parts of its rows.

    Exact, as in the reference: every part's loss is normalised by the
    *whole* batch's valid-token count (taken from the labels first), so the
    parts' summed gradients are the full batch's, however unevenly the
    labels are masked.  Each part's backward adds into the leaves' ``.grad``
    (autograd's own accumulation), so one gradient set is live beside a
    part's activations.  ``grads`` (a dict like ``params``) has the
    parameters' dtype, fp32; ``loss`` and ``ce`` are sums over the parts.
    """
    B = batch["tokens"].shape[0]
    if microbatches < 1 or B % microbatches:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"{microbatches} microbatches")
    n_valid = (batch["labels"] >= 0).sum().clamp_min(1).float()
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    parts = zip(batch["tokens"].chunk(microbatches),
                batch["labels"].chunk(microbatches))
    loss = ce = 0.0
    for tokens, labels in parts:
        l, c = lm.lm_loss(live, tokens, labels, cfg, denom=n_valid)
        l.backward()
        loss, ce = loss + l.detach(), ce + c.detach()
    grads = tree_map(lambda x: x.grad, live)
    for _, x in leaf_paths(live):
        x.grad = None  # the returned dict holds the only reference
    return loss, ce, grads


def make_train_step(cfg, opt_cfg: adamw.OptConfig, *, microbatches: int = 1):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` is the fp32 parameter dict, ``batch`` holds ``tokens`` and
    ``labels`` (``(B, n)`` integer tensors on the parameters' device, ``B``
    a multiple of ``microbatches``).  The gradient comes from autograd
    through the model (``accumulate_grads``), whose mixer layers run
    ``kernels.ops.hla2_attention`` or ``ahla_attention`` (``cfg.mixer``:
    forward and backward kernels on the card; ``cfg.remat == "full"``
    launches each forward kernel twice).  ``metrics`` holds the reference's
    keys: the scalar tensors ``loss``, ``ce`` and ``grad_norm``, the float
    ``lr`` and ``aux`` = 0.0 (the port's stack has no auxiliary loss).

    The step **updates ``params`` and the moments in place** and returns
    the same tensors (``adamw.adamw_update``): the reference's train step
    donates both, so its outputs alias its inputs.  A caller that needs the
    pre-step values copies them first.  The gradients are freed when the
    step returns.
    """

    def train_step(params, opt_state, batch):
        loss, ce, grads = accumulate_grads(params, batch, cfg, microbatches)
        with torch.no_grad():
            params, opt_state, om = adamw.adamw_update(
                params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss, "ce": ce, "aux": 0.0, **om}
        return params, opt_state, metrics

    return train_step
