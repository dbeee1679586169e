"""Train step builder, one device (twin of the single-device,
``microbatches=1`` part of ``repro/distributed/steps.py``)."""

from __future__ import annotations

import torch

from ..models import lm
from ..models.param import leaf_paths, tree_map
from ..optim import adamw


def _loss_fn(params, batch, cfg, denom=None):
    return lm.lm_loss(params, batch["tokens"], batch["labels"], cfg,
                      denom=denom)


def make_train_step(cfg, opt_cfg: adamw.OptConfig):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` is the fp32 parameter dict, ``batch`` holds ``tokens`` and
    ``labels`` (``(B, n)`` integer tensors on the parameters' device).  The
    gradient comes from autograd through the model, whose mixer layers run
    ``kernels.ops.hla2_attention`` or ``ahla_attention`` (``cfg.mixer``:
    forward and backward kernels on the card).  ``metrics`` holds the
    scalar tensors ``loss``, ``ce`` and ``grad_norm`` and the float ``lr``.
    """

    def train_step(params, opt_state, batch):
        live = tree_map(lambda x: x.detach().requires_grad_(True), params)
        loss, ce = _loss_fn(live, batch, cfg)
        flat = [x for _, x in leaf_paths(live)]
        grad_of = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
        grads = tree_map(lambda x: grad_of[id(x)], live)
        with torch.no_grad():
            params, opt_state, om = adamw.adamw_update(
                params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss.detach(), "ce": ce.detach(), **om}
        return params, opt_state, metrics

    return train_step
