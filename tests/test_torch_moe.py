"""The mixture-of-experts FFN (``repro_torch/models/moe.py``) and its aux
loss in training, the port against the reference (``repro/models/moe.py``,
``repro/distributed/steps.py``) with the reference's weights
(``from_jax_params``) on numpy inputs, at reduced granite-moe-3b-a800m
(4 experts, top 2) and qwen3-moe-30b-a3b (8 experts, top 2):

* ``moe_apply``'s output and aux loss at the config's capacity factor,
  where pairs past an expert's capacity drop (the test checks some do),
  and at a raised one where none drops; the routing (``gate_e``) is
  **identical** to the reference's, so a swapped expert shows as a routing
  fault and not as a wider tolerance;
* the port against its own ``moe_dense_oracle`` with nothing dropped (twin
  of ``tests/test_archs.py::test_moe_dispatch_matches_dense_oracle``);
* ``accumulate_grads`` with 2 microbatches against the reference's
  accumulation (``_loss_fn`` with the global label count and aux weight
  1/2, summed; aux the mean): loss, ce, aux and every gradient leaf;
* ``lm.cast_params`` keeps the router fp32 and casts the experts;
* reduced granite-moe-3b-a800m with ``hla2`` holds the four entry points'
  run-time contracts (``analysis/contracts.py``): the MoE dispatch reads
  nothing back to the host (1 / 1 / 1 or 2 / 0 transfers, as hla-1b).

Tolerance: fp32, 1e-4 relative to max|want|.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed.steps import _loss_fn as ref_loss_fn
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models.param import init_params as ref_init_params
from repro_torch.analysis import contracts
from repro_torch.configs import get_config
from repro_torch.distributed.steps import accumulate_grads
from repro_torch.models import lm, moe
from repro_torch.models.param import from_jax_params, leaf_paths

TOL = 1e-4
ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _cfgs(arch, capacity_factor=None):
    ref_cfg, cfg = ref_get_config(arch, reduced=True), get_config(
        arch, reduced=True)
    if capacity_factor is not None:
        ref_cfg = ref_cfg.replace(moe=dataclasses.replace(
            ref_cfg.moe, capacity_factor=capacity_factor))
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return ref_cfg, cfg


def _sublayer(arch, capacity_factor=None, seed=3):
    ref_cfg, cfg = _cfgs(arch, capacity_factor)
    ref_p = ref_init_params(ref_moe.moe_specs(ref_cfg), jax.random.key(seed))
    p = from_jax_params(jax.device_get(ref_p), moe.moe_specs(cfg),
                        device="cpu")
    return ref_cfg, ref_p, cfg, p


def _ref_gate_e(ref_p, x, ref_cfg):
    """The reference's routing (``moe_apply``'s first lines)."""
    logits = jnp.einsum("bnd,de->bne", x.astype(jnp.float32),
                        ref_p["router"]["kernel"].astype(jnp.float32))
    return jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                         ref_cfg.moe.top_k)[1]


@pytest.mark.parametrize("capacity", ["default", "raised"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, capacity):
    cf = None if capacity == "default" else 16.0
    ref_cfg, ref_p, cfg, p = _sublayer(arch, cf)
    x = (np.random.RandomState(0).randn(2, 16, cfg.d_model) * 0.5).astype(
        np.float32)
    want, want_aux = jax.jit(lambda p_, x_: ref_moe.moe_apply(
        p_, x_, ref_cfg))(ref_p, jnp.asarray(x))
    tx = torch.from_numpy(x)
    got, aux = moe.moe_apply(p, tx, cfg)
    _, _, gate_e = moe.route(p, tx, cfg)
    assert torch.equal(gate_e, torch.from_numpy(
        np.asarray(_ref_gate_e(ref_p, jnp.asarray(x), ref_cfg)).astype(
            np.int64)))
    # dropped (token, k) pairs: some at the config's capacity, none raised
    E, C = cfg.moe.n_experts, moe.capacity(cfg, x.shape[1])
    _, dest = moe._dispatch(tx, gate_e, E, C)
    dropped = int((dest == E * C).sum())
    assert (dropped > 0) == (capacity == "default"), dropped
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert _rel(got, want) <= TOL and _rel(aux, want_aux) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dispatch_matches_dense_oracle(arch):
    """Nothing dropped (capacity factor 8): the sort-based dispatch and
    combine equal every expert on every token, then the top-k combine."""
    _, _, cfg, p = _sublayer(arch, 8.0)
    x = torch.from_numpy((np.random.RandomState(1).randn(
        2, 8, cfg.d_model) * 0.3).astype(np.float32))
    y, _ = moe.moe_apply(p, x, cfg)
    assert _rel(y, moe.moe_dense_oracle(p, x, cfg)) <= TOL


@functools.lru_cache(maxsize=None)
def _model(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulate_grads_two_microbatches_match_reference(arch):
    """Labels masked unevenly across the microbatch boundary."""
    ref_cfg, ref_params, cfg, params = _model(arch)
    rs = np.random.RandomState(6)
    toks = rs.randint(0, cfg.vocab, (4, 16))
    labels = rs.randint(0, cfg.vocab, (4, 16))
    labels[0, :7] = -1
    labels[3, 2:4] = -1
    n_valid = jnp.maximum(jnp.sum((labels >= 0).astype(jnp.float32)), 1.0)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_loss_fn(p, b, ref_cfg, n_valid, 0.5), has_aux=True))
    ref_loss = ref_ce = 0.0
    ref_aux, ref_grads = [], None
    for half in (slice(0, 2), slice(2, 4)):
        (l, (c, a)), g = grad_fn(ref_params, {
            "tokens": jnp.asarray(toks[half]),
            "labels": jnp.asarray(labels[half])})
        ref_loss, ref_ce = ref_loss + l, ref_ce + c
        ref_aux.append(a)
        ref_grads = g if ref_grads is None else jax.tree.map(
            jnp.add, ref_grads, g)
    loss, ce, aux, grads = accumulate_grads(
        params, {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labels)}, cfg, 2)
    assert float(aux) > 0.0
    assert _rel(loss, ref_loss) <= TOL and _rel(ce, ref_ce) <= TOL
    assert _rel(aux, jnp.mean(jnp.stack(ref_aux))) <= TOL
    want_g = dict(leaf_paths(jax.device_get(ref_grads)))
    got_g = dict(leaf_paths(grads))
    assert set(got_g) == set(want_g)
    for path, g in got_g.items():
        assert _rel(g, want_g[path]) <= TOL, "/".join(path)


def test_cast_params_keeps_the_router_fp32():
    _, _, cfg, params = _model("granite-moe-3b-a800m")
    cast = lm.cast_params(params, cfg.replace(dtype="bfloat16"))
    got = {"/".join(p): x.dtype for p, x in leaf_paths(cast)}
    assert got["layers/moe/router/kernel"] == torch.float32
    for leaf in ("wi_gate", "wi_up", "wo"):
        assert got[f"layers/moe/{leaf}"] == torch.bfloat16, leaf
    assert got["embed/embedding"] == torch.bfloat16
    assert got["layers/ln2/scale"] == torch.float32


def test_moe_entry_points_hold_every_contract():
    cfg = contracts.default_config("hla2", arch="granite-moe-3b-a800m")
    assert cfg.moe is not None
    reports = contracts.check_entry_points(cfg, device="cpu")
    for r in reports:
        assert r.ok, (r.name, r.violations)
        assert r.f64_ops == 0 and r.launches == {}  # plain versions
    assert [r.syncs for r in reports] == [1, 1, 1, 2, 0]
