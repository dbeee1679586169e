"""The port's AdamW updates in place (``repro_torch/optim/adamw.py``): the
reference's train step donates its parameters and moments, so the port
keeps their storages.  In fp32 the in-place update is bit-identical to the
out-of-place formula it replaced (kept below as the reference), and the
train step returns the tensors it was given."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.param import init_params, leaf_paths, tree_map
from repro_torch.optim import adamw


def _out_of_place(params, grads, state, cfg):
    """The update as it was before it went in place: new clipped
    gradients, moments and parameters."""
    grads = tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, torch.float32)), grads)
    norm = adamw.global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(norm, min=1e-9), max=1.0)
    grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
    step = state.step + 1
    lr = adamw.cosine_lr(step, cfg)
    b1, b2 = cfg.betas
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    bc1, bc2 = 1 - b1**step, 1 - b2**step

    def upd(p, m, v):
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:
            delta = delta + cfg.weight_decay * p
        return p - lr * delta

    return (tree_map(upd, params, mu, nu), adamw.OptState(step, mu, nu),
            {"lr": lr, "grad_norm": norm})


def _ptrs(*trees):
    return [x.untyped_storage().data_ptr() for t in trees
            for _, x in leaf_paths(t)]


@pytest.mark.parametrize("grad_clip", [0.5, 1e9], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_in_place_update_is_bit_identical(grad_clip, weight_decay):
    rng = np.random.RandomState(0)
    shapes = {"layers": {"w": (3, 4, 5), "scale": (3, 5)}, "bias": (5,),
              "embed": (7, 4)}
    params = tree_map(lambda s: torch.from_numpy(
        rng.randn(*s).astype(np.float32)), shapes)
    cfg = adamw.OptConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                          weight_decay=weight_decay, grad_clip=grad_clip)
    want_p, want_s = tree_map(torch.clone, params), adamw.init_opt_state(params)
    got_p, got_s = params, adamw.init_opt_state(params)
    ptrs = _ptrs(got_p, got_s.mu, got_s.nu)
    for _ in range(3):
        g = tree_map(lambda s: rng.randn(*s).astype(np.float32) * 3, shapes)
        want_p, want_s, want_m = _out_of_place(
            want_p, tree_map(torch.from_numpy, g), want_s, cfg)
        grads = tree_map(lambda x: torch.from_numpy(x.copy()), g)
        out_p, got_s, got_m = adamw.adamw_update(got_p, grads, got_s, cfg)
        assert out_p is got_p  # the same dict, updated in place
        assert got_m["lr"] == want_m["lr"]
        assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])
    assert got_s.step == want_s.step == 3
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        for (path, a), (_, b) in zip(leaf_paths(got), leaf_paths(want)):
            assert torch.equal(a, b), path  # bit for bit
    assert _ptrs(got_p, got_s.mu, got_s.nu) == ptrs


def test_train_step_returns_the_tensors_it_was_given():
    cfg = get_config("hla-1b", reduced=True)
    params = init_params(lm.lm_specs(cfg), 0, device="cpu")
    state = adamw.init_opt_state(params)
    before = dict(leaf_paths(tree_map(torch.clone, params)))
    step = make_train_step(cfg, adamw.OptConfig(lr=1e-3, warmup_steps=0))
    tokens = torch.randint(0, cfg.vocab, (2, 20),
                           generator=torch.Generator().manual_seed(0))
    leaves = dict(leaf_paths({"p": params, "mu": state.mu, "nu": state.nu}))
    out_p, out_s, m = step(params, state, {"tokens": tokens,
                                           "labels": tokens.roll(-1, 1)})
    assert out_p is params and out_s.mu is state.mu and out_s.nu is state.nu
    out = dict(leaf_paths({"p": out_p, "mu": out_s.mu, "nu": out_s.nu}))
    assert out.keys() == leaves.keys() and len(out) == 42
    assert all(x is leaves[p] for p, x in out.items())
    assert out_s.step == 1 and torch.isfinite(m["loss"])
    moved = [p for p, x in leaf_paths(out_p) if not torch.equal(x, before[p])]
    assert len(moved) == len(before)  # every leaf was updated
