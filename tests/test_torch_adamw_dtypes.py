"""AdamW and gradient accumulation with narrow storage (jamba's
``param_dtype``, ``moment_dtype`` and ``grad_accum_dtype`` of bfloat16),
the port against the reference on the same inputs:

* ``adamw_update`` with bf16 parameters and bf16 moments (and fp32
  parameters with bf16 moments): each leaf is computed in fp32 and stored
  rounded, in place, as the reference's ``(p32 - lr * delta).astype(
  p.dtype)``;
* ``model_specs`` applies ``param_dtype``; ``init_opt_state`` takes
  ``moment_dtype``;
* one train step with 2 microbatches (``accumulate_grads`` with a bf16
  accumulator over bf16 or fp32 parameters, and an fp32 accumulator over
  bf16 parameters) against the reference's ``make_train_step``: loss,
  parameters and both moments after the step.

Tolerance: bf16 storage on both sides; the fp32 intermediates may differ
in their last bits (the bias corrections and the learning rate are fp32
in the reference, Python floats here), which moves a stored value by at
most one bf16 ulp.  So: at least 99% of the elements equal, and the rest
within 2^-7 of max|want| (two ulps of the largest); fp32 moments of a
bf16-accumulated gradient within 2^-7 of max|want|.  fp32 parameters
and the loss (fp32 on both sides) within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed import steps as ref_steps
from repro.models.param import init_params as ref_init_params
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.distributed.steps import make_train_step, model_specs
from repro_torch.models.param import from_jax_params, leaf_paths, tree_map
from repro_torch.optim import adamw

BF16_TOL = 2.0**-7
SAME_SHARE = 0.99
FP32_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(x, np.float32).astype(np.float64)


def _close_bf16(got, want, label, fp32=False):
    """bf16 values (stored, or fp32 moments of a bf16-accumulated
    gradient) as the module docstring says; with ``fp32`` (fp32
    parameters) within ``FP32_TOL`` of max|want|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, label
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    if fp32:
        assert err <= FP32_TOL, (label, err)
        return
    if isinstance(got, torch.Tensor) and got.dtype == torch.float32:
        # an fp32 moment: its last bits follow the clip scale's
        assert err <= BF16_TOL, (label, err)
        return
    same = float(np.mean(g == w))
    assert same >= SAME_SHARE and err <= BF16_TOL, (label, same, err)


def _tree(rs):
    """A small parameter-like tree: 2-D leaves (decayed) and 1-D ones."""
    return {"a": {"kernel": rs.randn(16, 24) * 0.05},
            "b": {"scale": 1.0 + rs.randn(24) * 0.1},
            "c": rs.randn(3, 8, 8) * 0.02}


def _to_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _to_torch(tree, dtype):
    return tree_map(lambda x: torch.from_numpy(
        np.array(x, np.float32)).to(dtype), tree)


@pytest.mark.parametrize("p_dtype", ["bfloat16", "float32"])
def test_adamw_update_narrow_storage_matches_reference(p_dtype):
    """Three steps from random bf16 moments (so the moments' own rounding
    matters), lr 3e-4 after a short warmup, weight decay on the 2-D
    leaves."""
    rs = np.random.RandomState(0)
    params = _tree(rs)
    mu = jax.tree.map(lambda x: rs.randn(*x.shape) * 1e-3, params)
    nu = jax.tree.map(lambda x: rs.uniform(0, 1e-5, x.shape), params)
    grads = [jax.tree.map(lambda x: rs.randn(*x.shape) * 1e-2, params)
             for _ in range(3)]
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[p_dtype]
    tdt = getattr(torch, p_dtype)
    # identical starting values: the bf16 roundings of the same numbers
    params = jax.tree.map(lambda x: np.asarray(
        jnp.asarray(x, jdt), np.float32), params)
    mu, nu = (jax.tree.map(lambda x: np.asarray(
        jnp.asarray(x, jnp.bfloat16), np.float32), t) for t in (mu, nu))
    cfg = adamw.OptConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    ref_cfg = ref_adamw.OptConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    rp = _to_jax(params, jdt)
    rst = ref_adamw.OptState(step=jnp.zeros((), jnp.int32),
                             mu=_to_jax(mu, jnp.bfloat16),
                             nu=_to_jax(nu, jnp.bfloat16))
    tp = _to_torch(params, tdt)
    tst = adamw.OptState(step=0, mu=_to_torch(mu, torch.bfloat16),
                         nu=_to_torch(nu, torch.bfloat16))
    ptrs = [x.data_ptr() for _, x in leaf_paths(tp)]
    for g in grads:
        rp, rst, _ = ref_adamw.adamw_update(rp, _to_jax(g, jnp.float32),
                                            rst, ref_cfg)
        tp, tst, _ = adamw.adamw_update(tp, _to_torch(g, torch.float32),
                                        tst, cfg)
    assert [x.data_ptr() for _, x in leaf_paths(tp)] == ptrs  # in place
    for name, got, want in (("params", tp, rp), ("mu", tst.mu, rst.mu),
                            ("nu", tst.nu, rst.nu)):
        want = dict(leaf_paths(jax.device_get(want)))
        for path, x in leaf_paths(got):
            assert x.dtype == (tdt if name == "params" else torch.bfloat16)
            _close_bf16(x, want[path], f"{name}/{'/'.join(path)}",
                        fp32=name == "params" and x.dtype == torch.float32)


def test_model_specs_and_moments_take_the_config_dtypes():
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    assert (cfg.param_dtype, cfg.moment_dtype, cfg.grad_accum_dtype) == (
        "bfloat16",) * 3
    specs = model_specs(cfg)
    ref_specs = ref_steps.model_specs(
        ref_get_config("jamba-1.5-large-398b", reduced=True))
    got = {p: s.dtype for p, s in leaf_paths(specs)}
    assert set(got.values()) == {"bfloat16"}
    assert len(got) == len(jax.tree.leaves(
        ref_specs, is_leaf=lambda x: hasattr(x, "axes")))
    st = adamw.init_opt_state({"w": torch.zeros(2, 3, dtype=torch.bfloat16)},
                              cfg.moment_dtype)
    assert st.mu["w"].dtype == st.nu["w"].dtype == torch.bfloat16
    fp32 = model_specs(get_config("rwkv6-7b", reduced=True))
    assert {s.dtype for _, s in leaf_paths(fp32)} == {"float32"}


def _small(p_dtype, acc_dtype):
    base = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                vocab=64, param_dtype=p_dtype, grad_accum_dtype=acc_dtype,
                moment_dtype=p_dtype)
    ref_cfg = ref_get_config("hla-1b", reduced=True).replace(**base)
    cfg = get_config("hla-1b", reduced=True).replace(**base)
    return ref_cfg, cfg


@pytest.mark.parametrize("p_dtype, acc_dtype", [
    ("bfloat16", "bfloat16"), ("float32", "bfloat16"),
    ("bfloat16", "float32")], ids=["bf16-bf16", "fp32-bf16", "bf16-fp32"])
def test_train_step_with_narrow_accumulator_matches_reference(p_dtype,
                                                              acc_dtype):
    ref_cfg, cfg = _small(p_dtype, acc_dtype)
    # the reference's init multiplies a numpy-float64 scale into its
    # "normal" leaves, which promotes them past the spec's bf16: cast them
    # to the stated dtype, so both packages step the same stored values
    ref_params = jax.tree.map(
        lambda x: x.astype(jnp.dtype(p_dtype)),
        ref_init_params(ref_steps.model_specs(ref_cfg), jax.random.key(0)))
    tree = jax.device_get(ref_params)
    params = from_jax_params(tree, model_specs(cfg), device="cpu")
    rs = np.random.RandomState(1)
    toks = rs.randint(1, cfg.vocab, (4, 24))
    labels = rs.randint(1, cfg.vocab, (4, 24))
    labels[0, :7] = -1  # uneven microbatches
    ref_opt = ref_adamw.OptConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    opt = adamw.OptConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg, ref_opt,
                                                 microbatches=2))
    ref_st = ref_adamw.init_opt_state(ref_params,
                                      jnp.dtype(ref_cfg.moment_dtype))
    rp, rst, rm = ref_step(ref_params, ref_st, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    st = adamw.init_opt_state(params, cfg.moment_dtype)
    tp, tst, tm = make_train_step(cfg, opt, microbatches=2)(params, st, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert abs(float(tm["loss"]) - float(rm["loss"])) <= 1e-5 * abs(
        float(rm["loss"]))
    for name, got, want in (("params", tp, rp), ("mu", tst.mu, rst.mu),
                            ("nu", tst.nu, rst.nu)):
        want = dict(leaf_paths(jax.device_get(want)))
        for path, x in leaf_paths(got):
            assert str(x.dtype)[6:] == str(want[path].dtype) or (
                want[path].dtype == ml_dtypes.bfloat16
                and x.dtype == torch.bfloat16)
            _close_bf16(x, want[path], f"{name}/{'/'.join(path)}",
                        fp32=name == "params" and x.dtype == torch.float32)
