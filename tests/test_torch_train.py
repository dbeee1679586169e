"""The port's training path vs the reference: loss and gradients, AdamW,
the synthetic stream, three train steps and the CLI, with the HLA2 mixer
of hla-1b and with the AHLA mixer (``mixer="ahla"``, the same weights
layout).

Tolerances: the loss and every gradient leaf within 1e-4 of max|reference
leaf| (fp32 on both sides; the port runs chunk 64 where the reference runs
the config's 128, and sums in other orders).  AdamW on identical inputs:
1e-6 relative (fp32 elementwise math; the bias corrections are computed in
fp64 by the port, fp32 by the reference).  After three train steps the
parameters agree within 5e-5 absolute, 5% of lr (1e-3): AdamW's normalised
update moves a leaf by up to ~lr per step whatever its gradient's size, so
fp32 rounding of a tiny gradient can move it by a fraction of lr (6.7e-6
measured on a CPU).  The AHLA three-step run compares both sides in fp64 at
the same tolerances: in fp32 the reference's own AHLA run drifts from its
fp64 run by 0.64% in grad norm by the second step.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticStream as RefStream
from repro.distributed import steps as ref_steps
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.distributed.steps import make_train_step
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params, leaf_paths, tree_map
from repro_torch.optim import adamw

TOL = 1e-4


def _model(mixer=None):
    ref_cfg = ref_get_config("hla-1b", reduced=True, mixer=mixer)
    cfg = get_config("hla-1b", reduced=True, mixer=mixer)
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def ahla_model():
    return _model("ahla")


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def _ref_leaves(tree):
    return {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(rng, cfg, n=70):
    toks = rng.randint(0, cfg.vocab, (2, n))
    labels = rng.randint(0, cfg.vocab, (2, n))
    labels[0, :5] = -1
    labels[1, -3:] = -1
    return toks, labels


def _check_loss_and_grads(model, rng, denom):
    ref_cfg, ref_params, cfg, params = model
    toks, labels = _batch(rng, cfg)

    def ref_loss(p):
        return ref_lm.lm_loss(p, jnp.asarray(toks), jnp.asarray(labels),
                              ref_cfg, denom=denom)

    (want, _), ref_grads = jax.value_and_grad(ref_loss, has_aux=True)(
        ref_params)
    tree = tree_map(lambda x: x.clone().requires_grad_(True), params)
    live = dict(leaf_paths(tree))
    loss, (ce, aux) = lm.lm_loss(tree, torch.from_numpy(toks),
                                 torch.from_numpy(labels), cfg, denom=denom)
    # no MoE layer: the aux term is 0 and the loss is the CE
    assert loss.dtype == torch.float32 and float(aux) == 0.0
    assert torch.equal(loss, ce)
    assert _rel(loss.detach(), want) <= TOL
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    want_g = _ref_leaves(ref_grads)
    assert set(grads) == set(want_g)
    for path, g in grads.items():
        assert _rel(g, want_g[path]) <= TOL, path


@pytest.mark.parametrize("denom", [None, 200.0])
def test_lm_loss_and_grads_match_reference(model, rng, denom):
    _check_loss_and_grads(model, rng, denom)


@pytest.mark.parametrize("denom", [None, 200.0])
def test_ahla_lm_loss_and_grads_match_reference(ahla_model, rng, denom):
    assert ahla_model[2].mixer == "ahla"
    _check_loss_and_grads(ahla_model, rng, denom)


def test_adamw_matches_reference_on_stacked_tree(rng):
    shapes = {"layers": {"w": (3, 4, 5), "scale": (3, 5)}, "bias": (5,),
              "embed": (7, 4)}
    params = {"layers": {k: rng.randn(*s).astype(np.float32)
                         for k, s in shapes["layers"].items()},
              "bias": rng.randn(5).astype(np.float32),
              "embed": rng.randn(7, 4).astype(np.float32)}
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=4, weight_decay=0.1,
               grad_clip=0.5)
    r_cfg, p_cfg = ref_adamw.OptConfig(**cfg), adamw.OptConfig(**cfg)
    r_params = jax.tree.map(jnp.asarray, params)
    r_state = ref_adamw.init_opt_state(r_params)
    p_params = jax.tree.map(lambda x: torch.from_numpy(x.copy()), params)
    p_state = adamw.init_opt_state(p_params)
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                         params)
        r_params, r_state, r_m = ref_adamw.adamw_update(
            r_params, jax.tree.map(jnp.asarray, g), r_state, r_cfg)
        # copies: the port's update clips its gradients in place
        p_params, p_state, p_m = adamw.adamw_update(
            p_params, jax.tree.map(lambda x: torch.from_numpy(x.copy()), g),
            p_state, p_cfg)
        assert abs(p_m["lr"] - float(r_m["lr"])) <= 1e-6 * float(r_m["lr"])
        assert _rel(p_m["grad_norm"], r_m["grad_norm"]) <= 1e-6
    assert p_state.step == int(r_state.step) == 3
    for got, want in ((p_params, r_params), (p_state.mu, r_state.mu),
                      (p_state.nu, r_state.nu)):
        want = _ref_leaves(want)
        for path, x in leaf_paths(got):
            assert _rel(x, want[path]) <= 1e-6, path


@pytest.mark.parametrize("kind", ["zipf", "copy", "recall"])
def test_synthetic_stream_matches_reference(kind):
    mine = SyntheticStream(DataConfig(97, 33, 4, seed=3, kind=kind),
                           host_index=1, host_count=2)
    theirs = RefStream(RefDataConfig(97, 33, 4, seed=3, kind=kind),
                       host_index=1, host_count=2)
    for step in (0, 5):
        a, b = mine.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def _check_three_steps(model, dtype=None):
    ref_cfg, ref_params, cfg, params = model
    if dtype is not None:  # activations and parameters in ``dtype``
        ref_cfg, cfg = ref_cfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
        ref_params = jax.tree.map(lambda x: x.astype(dtype), ref_params)
        params = tree_map(lambda x: x.to(getattr(torch, dtype)), params)
    params = tree_map(torch.clone, params)  # the step updates in place
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ref_step = ref_steps.make_train_step(ref_cfg, ref_adamw.OptConfig(**kw))
    step = make_train_step(cfg, adamw.OptConfig(**kw))
    r_state = ref_adamw.init_opt_state(ref_params)
    state = adamw.init_opt_state(params)
    stream = RefStream(RefDataConfig(cfg.vocab, 70, 2, seed=1))
    r_params = ref_params
    for i in range(3):
        host = stream.batch(i)
        r_params, r_state, r_m = ref_step(
            r_params, r_state, {k: jnp.asarray(v) for k, v in host.items()})
        params, state, m = step(
            params, state, {k: torch.from_numpy(v) for k, v in host.items()})
        assert _rel(m["loss"], r_m["loss"]) <= TOL
        assert _rel(m["grad_norm"], r_m["grad_norm"]) <= TOL
    want = _ref_leaves(r_params)
    for path, x in leaf_paths(params):
        err = np.abs(x.numpy() - want[path]).max()
        assert err <= 5e-5, (path, err)


def test_three_train_steps_match_reference(model):
    _check_three_steps(model)


def test_ahla_three_train_steps_match_reference(ahla_model):
    # fp64 on both sides (the out-norm and the loss still cast to fp32): in
    # fp32 the reference's own AHLA run leaves its fp64 trajectory by 0.64%
    # in grad norm at the second step (the port's by 0.05%), so an fp32
    # comparison would measure the reference's rounding, not the algorithm
    _check_three_steps(ahla_model, "float64")


def _low_lr_losses(model, seq, steps=5):
    """Loss of each of ``steps`` AdamW steps at lr 1e-5 with one warmup step
    (``chip_smoke.py``'s train phase) on one repeated batch, reference and
    port from the same weights: ``(reference losses, port losses)``."""
    ref_cfg, ref_params, cfg, params = model
    params = tree_map(torch.clone, params)  # the step updates in place
    kw = dict(lr=1e-5, warmup_steps=1, total_steps=steps)
    ref_step = ref_steps.make_train_step(ref_cfg, ref_adamw.OptConfig(**kw))
    step = make_train_step(cfg, adamw.OptConfig(**kw))
    r_state = ref_adamw.init_opt_state(ref_params)
    state = adamw.init_opt_state(params)
    host = RefStream(RefDataConfig(cfg.vocab, seq, 2, seed=0)).batch(0)
    ref_losses, losses = [], []
    for _ in range(steps):
        ref_params, r_state, r_m = ref_step(
            ref_params, r_state, {k: jnp.asarray(v) for k, v in host.items()})
        params, state, m = step(
            params, state, {k: torch.from_numpy(v) for k, v in host.items()})
        ref_losses.append(float(r_m["loss"]))
        losses.append(float(m["loss"]))
    return ref_losses, losses


# hla-1b cut to 4 layers x 512 wide (heads of 128, d_ff in hla-1b's
# ratio, fp32 activations), its vocabulary kept
WIDE = dict(n_layers=4, d_model=512, n_heads=4, n_kv_heads=4, d_ff=1376,
            dtype="float32")


@pytest.mark.parametrize("size, seq", [("reduced", 70), ("4x512", 256)])
def test_low_lr_loss_sequence_matches_reference(model, size, seq):
    # the train phase's schedule, where hla-1b's HLA2 loss rose after the
    # first update on the card: the port's loss follows the reference's at
    # every step
    if size == "4x512":
        ref_cfg, cfg = (ref_get_config("hla-1b").replace(**WIDE),
                        get_config("hla-1b").replace(**WIDE))
        ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg),
                                     jax.random.key(0))
        model = (ref_cfg, ref_params, cfg, from_jax_params(
            jax.device_get(ref_params), lm.lm_specs(cfg), device="cpu"))
    want, got = _low_lr_losses(model, seq)
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL


def _check_cli(capsys, *extra):
    train_cli.main(["--reduced", "--device", "cpu", "--steps", "3",
                    "--batch", "2", "--seq", "40", *extra])
    out = capsys.readouterr().out
    # the summary names the last step's index (0-based), as the reference's
    assert re.search(
        r"\[train\] finished at step 2 \| step p50 [\d.]+s p99 [\d.]+s \| "
        r"\d+ tok/s \| loss \d+\.\d{4}", out), out
    return out


def test_train_cli_prints_summary(capsys):
    _check_cli(capsys)


def test_train_cli_with_ahla_prints_summary(capsys):
    assert "hla-1b (ahla) on cpu" in _check_cli(capsys, "--mixer", "ahla")
