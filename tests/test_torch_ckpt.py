"""The port's checkpointing (``repro_torch.checkpoint.manager``) against the
reference's (``repro.checkpoint.manager``).

Twins of ``tests/test_substrate.py``'s checkpoint cases, ``tests/
test_chaos.py``'s checkpoint failure domain and ``tests/test_obs.py``'s
``TestCkptMetrics``: each schedule runs through both managers, which must
give the same counters, histogram counts and span sequence.  The on-disk
format is shared: the same values saved by either package give the same
manifest (leaf names, shapes, dtypes, crc32), and a ``(params,
opt_state)`` checkpoint of reduced hla-1b written after two reference
AdamW steps restores in the port (and the reverse), after which one more
step of each package agrees within ``test_torch_train.py``'s tolerances:
loss and gradient norm within ``TOL`` = 1e-4 relative, every parameter
within 5e-5 absolute.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticStream as RefStream
from repro.distributed import steps as ref_steps
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro.optim import adamw as ref_adamw
from repro.runtime.faults import FaultPlan as RefPlan
from repro.runtime.faults import FaultSpec as RefFaultSpec
from repro_torch.checkpoint import manager as port_ckpt
from repro_torch.checkpoint.manager import (
    CheckpointError,
    CheckpointManager,
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_config
from repro_torch.distributed.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params, leaf_paths, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.faults import FaultPlan, FaultSpec

TOL = 1e-4  # test_torch_train.py's
PARAM_TOL = 5e-5  # absolute, test_torch_train.py's three-step bound


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


# -- twins of test_substrate.py ---------------------------------------------


def test_checkpoint_roundtrip(tmp_path, rng):
    tree = {
        "params": {"w": torch.from_numpy(rng.randn(4, 4)),
                   "b": torch.from_numpy(rng.randn(4))},
        "opt": adamw.init_opt_state({"w": torch.zeros(4, 4)}),
    }
    save_checkpoint(str(tmp_path), 17, tree, {"note": "x"})
    assert latest_step(str(tmp_path)) == 17
    restored, manifest = restore_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 17 and manifest["metadata"] == {"note": "x"}
    assert restored["opt"].step == 0 and type(restored["opt"].step) is int
    for (pa, a), (pb, b) in zip(leaf_paths(tree["params"]),
                                leaf_paths(restored["params"])):
        assert pa == pb and b.dtype == a.dtype
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    torch.testing.assert_close(restored["opt"].mu["w"], torch.zeros(4, 4))


def test_checkpoint_atomicity(tmp_path, rng):
    """A stale .tmp dir (a crashed save) is ignored and overwritten."""
    tree = {"w": torch.from_numpy(rng.randn(3))}
    save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert latest_step(str(tmp_path)) == 1
    save_checkpoint(str(tmp_path), 2, tree)
    assert latest_step(str(tmp_path)) == 2
    assert not os.path.exists(tmp_path / "step_00000002.tmp")


def test_manager_rotation_and_async(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = {"w": torch.from_numpy(rng.randn(3))}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    assert list_steps(str(tmp_path)) == [3, 4]


# -- twins of test_chaos.py's checkpoint failure domain ---------------------


def test_async_save_failure_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2,
                            faults=FaultPlan(FaultSpec("ckpt.save", at=0)))
    tree = {"w": torch.arange(3.0)}
    mgr.save(1, tree)
    with pytest.raises(CheckpointError, match="step 1"):
        mgr.wait()
    mgr.save(2, tree)  # the plan fired once: this save succeeds
    mgr.wait()
    assert mgr.latest_step() == 2


def test_async_save_failure_surfaces_on_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2,
                            faults=FaultPlan(FaultSpec("ckpt.save", at=0)))
    mgr.save(1, {"w": torch.zeros(2)})
    with pytest.raises(CheckpointError, match="async checkpoint save"):
        mgr.save(2, {"w": torch.zeros(2)})


def test_checksum_roundtrip_and_corruption(tmp_path):
    tree = {"a": np.arange(12.0).reshape(3, 4), "b": np.int32(7)}
    path = save_checkpoint(str(tmp_path), 3, tree)
    manifest = _manifest(path)
    assert all("crc32" in info for info in manifest["leaves"].values())
    restored, _ = restore_checkpoint(str(tmp_path), tree)
    np.testing.assert_array_equal(restored["a"], tree["a"])
    assert restored["b"] == 7

    mgr = CheckpointManager(
        str(tmp_path / "c"), keep=2,
        faults=FaultPlan(FaultSpec("ckpt.corrupt", at=0)), async_save=False)
    mgr.save(5, tree)
    with pytest.raises(CheckpointError, match="checksum mismatch for leaf"):
        mgr.restore(tree)


def test_checksum_backcompat_without_crc(tmp_path):
    tree = {"w": torch.arange(4.0)}
    path = save_checkpoint(str(tmp_path), 1, tree)
    manifest = _manifest(path)
    for info in manifest["leaves"].values():
        info.pop("crc32", None)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    restored, _ = restore_checkpoint(str(tmp_path), tree)
    torch.testing.assert_close(restored["w"], tree["w"], rtol=0, atol=0)


# -- the same schedule through both managers: metrics and spans -------------


def _ckpt_view(obs):
    """Counter totals, histogram counts and the span/event sequence."""
    snap = obs.snapshot()["metrics"]
    nums = {}
    for name, m in snap.items():
        for s in m["series"]:
            key = (name, tuple(sorted(s["labels"].items())))
            nums[key] = s["count"] if m["kind"] == "histogram" else s["value"]
    seq = [(e["kind"], e["name"], e.get("step"), e.get("point"))
           for e in obs.events()]
    return nums, seq


def _schedule(mod, plan, spec, tmp, leaf, async_save):
    """Save twice and restore, under ``plan`` of the ``ckpt.*`` points;
    returns the manager's obs view and what each call raised."""
    mgr = mod.CheckpointManager(
        str(tmp), keep=1, async_save=async_save,
        faults=None if spec is None else plan(spec))
    tree = {"w": leaf(np.arange(64.0)), "b": leaf(np.zeros(2))}
    raised = []
    for call in (lambda: mgr.save(0, tree), lambda: mgr.save(1, tree),
                 mgr.wait, lambda: mgr.restore(tree)):
        try:
            call()
            raised.append(None)
        except Exception as e:
            raised.append(type(e).__name__)
    return _ckpt_view(mgr.obs), raised


@pytest.mark.parametrize("point, async_save", [
    (None, False), (None, True), ("ckpt.save", False), ("ckpt.save", True),
    ("ckpt.corrupt", False)])
def test_ckpt_metrics_and_spans_match_reference(tmp_path, point, async_save):
    """``TestCkptMetrics``'s schedules (a clean save + restore, a checksum
    failure, a save failure; synchronous and async) give the reference's
    counters, histogram counts, spans and fired-fault events."""
    # the second save (hit 1) is corrupted, so the restore of the latest
    # checkpoint finds it; a save fault fires at the first save
    at = 1 if point == "ckpt.corrupt" else 0
    got = _schedule(port_ckpt, FaultPlan,
                    None if point is None else FaultSpec(point, at=at),
                    tmp_path / "port", torch.from_numpy, async_save)
    want = _schedule(ref_ckpt, RefPlan,
                     None if point is None else RefFaultSpec(point, at=at),
                     tmp_path / "ref", jnp.asarray, async_save)
    assert got == want
    (nums, seq), _ = got
    if point is None:
        assert nums[("ckpt_saves_total", ())] == 2
        assert nums[("ckpt_restores_total", ())] == 1
        assert [s[1] for s in seq] == ["ckpt.save", "ckpt.save",
                                       "ckpt.restore"]
    if point == "ckpt.corrupt":
        assert nums[("ckpt_checksum_failures_total", ())] == 1
        assert ("ckpt_restores_total", ()) not in nums  # never counted


# -- the port's leaf kinds ---------------------------------------------------


def test_bf16_leaf_raises_naming_it(tmp_path):
    """A bf16 leaf saves (sync and async) and comes back bit for bit; a leaf
    whose dtype has no file form (float8) raises naming it, before any
    write."""
    w = torch.randn(2, 3).to(torch.bfloat16)
    tree = {"layers": {"w": w}}
    save_checkpoint(str(tmp_path / "sync"), 0, tree)
    mgr = CheckpointManager(str(tmp_path / "async"))
    mgr.save(0, tree)
    mgr.wait()
    for d in ("sync", "async"):
        got, man = restore_checkpoint(str(tmp_path / d), tree)
        assert man["leaves"]["layers/w"]["dtype"] == "bfloat16"
        assert got["layers"]["w"].dtype == torch.bfloat16
        assert torch.equal(got["layers"]["w"].view(torch.int16),
                           w.view(torch.int16))
    bad = {"layers": {"w": torch.zeros(2, dtype=torch.float8_e4m3fn)}}
    with pytest.raises(CheckpointError, match="'layers/w'.*float8"):
        save_checkpoint(str(tmp_path / "bad"), 0, bad)
    mgr = CheckpointManager(str(tmp_path / "bad"))
    with pytest.raises(CheckpointError, match="layers/w"):
        mgr.save(0, bad)  # in the caller's thread, before any write
    mgr.wait()
    assert list_steps(str(tmp_path / "bad")) == []


def _bf16_pair(seed):
    """The same bf16 values as a reference array and a port tensor, beside
    an fp32 leaf."""
    x = np.random.RandomState(seed).randn(3, 5).astype(np.float32)
    return ({"w": jnp.asarray(x, jnp.bfloat16), "b": jnp.asarray(x[0])},
            {"w": torch.from_numpy(x).to(torch.bfloat16),
             "b": torch.from_numpy(x[0].copy())})


def test_bf16_leaf_file_equals_reference(tmp_path):
    """The port writes the reference's bf16 leaf byte for byte: the ``.npy``
    (a ``<V2`` header, the raw 2-byte values) and the manifest's shape,
    dtype ``"bfloat16"`` and crc32."""
    ref_tree, port_tree = _bf16_pair(0)
    ref = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, ref_tree)
    port = save_checkpoint(str(tmp_path / "port"), 3, port_tree)
    want, got = _manifest(ref)["leaves"], _manifest(port)["leaves"]
    assert want == got and got["w"]["dtype"] == "bfloat16"
    for info in got.values():
        with open(os.path.join(ref, info["file"]), "rb") as a, \
                open(os.path.join(port, info["file"]), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_leaf_restores_bit_for_bit(tmp_path, writer):
    """The port restores a bf16 leaf written by either package to the
    reference's bits, as a ``torch.bfloat16`` tensor.  (The reference's own
    restore rejects the file: jax takes no ``|V2`` array.)"""
    ref_tree, port_tree = _bf16_pair(1)
    if writer == "port":
        save_checkpoint(str(tmp_path), 5, port_tree)
    else:
        ref_ckpt.save_checkpoint(str(tmp_path), 5, ref_tree)
    template = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                "b": torch.zeros(5)}
    got, _ = restore_checkpoint(str(tmp_path), template)
    assert got["w"].dtype == torch.bfloat16
    want = np.asarray(ref_tree["w"]).view(np.int16)
    assert np.array_equal(got["w"].view(torch.int16).numpy(), want)
    assert np.array_equal(got["b"].numpy(), np.asarray(ref_tree["b"]))


def test_bf16_jamba_fault_and_resume_matches_uninterrupted(tmp_path):
    """Reduced jamba with bf16 parameters and moments through the port's
    ``FaultTolerantLoop``: a checkpoint after step 1, a fault at step 2, a
    fresh loop that resumes from step 1 and gives the uninterrupted run's
    step-2 loss bit for bit, with every leaf back in bf16."""
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.distributed.steps import model_specs
    from repro_torch.models.param import init_params
    from repro_torch.runtime.faults import InjectedFault
    from repro_torch.runtime.ft import FaultTolerantLoop

    cfg = get_config("jamba-1.5-large-398b", reduced=True).replace(
        param_dtype="bfloat16", moment_dtype="bfloat16")
    step = make_train_step(cfg, adamw.OptConfig(lr=3e-4, warmup_steps=1,
                                                total_steps=3))
    stream = SyntheticStream(DataConfig(cfg.vocab, 16, 2, seed=0))

    def place(batch):
        return {k: torch.from_numpy(v) for k, v in batch.items()}

    def run(d, faults=None):
        losses = []

        def step_fn(p, o, b):
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
            return p, o, m

        params = init_params(model_specs(cfg), 0, "cpu")
        loop = FaultTolerantLoop(
            step_fn, stream, str(tmp_path / d), ckpt_every=2, faults=faults,
            place_batch=place, log=lambda *a, **k: None)
        out = loop.run(params, adamw.init_opt_state(params, "bfloat16"), 3)
        return out, losses

    (_, _, last), want = run("whole")
    assert last == 2 and len(want) == 3
    with pytest.raises(InjectedFault, match="train.step"):
        run("ft", FaultPlan(FaultSpec("train.step", at=2)))
    assert list_steps(str(tmp_path / "ft")) == [1]
    (params, opt, last), got = run("ft")
    assert last == 2 and got == want[2:]
    leaves = [x for _, x in leaf_paths(params)] + \
        [x for _, x in leaf_paths(opt.mu)] + [x for _, x in leaf_paths(opt.nu)]
    assert {x.dtype for x in leaves} == {torch.bfloat16}


def test_saved_leaves_do_not_follow_later_in_place_updates(tmp_path):
    w = torch.zeros(3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": w})
    w.add_(1.0)  # the next step, while the save may still be writing
    mgr.wait()
    restored, _ = mgr.restore({"w": w})
    torch.testing.assert_close(restored["w"], torch.zeros(3))


def test_int_step_saves_as_reference_optstate_step(tmp_path):
    """The port's ``OptState.step`` (an int) is stored as the reference's
    0-d int32 array, and the reference's array restores as an int."""
    r_state = ref_adamw.init_opt_state({"w": jnp.zeros(3)})._replace(
        step=jnp.asarray(5, jnp.int32))
    ref_ckpt.save_checkpoint(str(tmp_path / "r"), 0, r_state)
    p_state = adamw.init_opt_state({"w": torch.zeros(3)})._replace(step=5)
    save_checkpoint(str(tmp_path / "p"), 0, p_state)
    a = _manifest(tmp_path / "r" / "step_00000000")["leaves"]
    b = _manifest(tmp_path / "p" / "step_00000000")["leaves"]
    assert a == b and a["step"]["dtype"] == "int32"
    got, _ = restore_checkpoint(str(tmp_path / "r"), p_state)
    assert type(got.step) is int and got.step == 5


# -- cross-package (params, opt_state) of reduced hla-1b ---------------------


@pytest.fixture(scope="module")
def two_steps():
    """Reduced hla-1b after two reference AdamW steps (lr 1e-3): the
    reference's state and step function, the port's twins of both, and
    the batch of the third step."""
    ref_cfg = ref_get_config("hla-1b", reduced=True)
    cfg = get_config("hla-1b", reduced=True)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg,
                                                 ref_adamw.OptConfig(**kw)))
    step = make_train_step(cfg, adamw.OptConfig(**kw))
    params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    state = ref_adamw.init_opt_state(params)
    stream = RefStream(RefDataConfig(cfg.vocab, 40, 2, seed=1))
    for i in range(2):
        params, state, _ = ref_step(
            params, state,
            {k: jnp.asarray(v) for k, v in stream.batch(i).items()})
    # fp32, as training keeps them (under the suite's x64 the reference's
    # update promotes the decayed leaves to fp64)
    params, state = jax.tree.map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x,
        (params, state))
    specs = lm.lm_specs(cfg)
    port = (from_jax_params(jax.device_get(params), specs, device="cpu"),
            adamw.OptState(int(state.step), *(
                from_jax_params(jax.device_get(t), specs, device="cpu")
                for t in (state.mu, state.nu))))
    return ref_step, (params, state), step, port, stream.batch(2)


def _ref_leaves(tree):
    return {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _third_step_agrees(ref_step, ref_state, step, port_state, host):
    r_params, _, r_m = ref_step(*ref_state,
                                {k: jnp.asarray(v) for k, v in host.items()})
    # on a copy: the step updates in place, and the fixture's state is shared
    params, opt = port_state
    port_state = (tree_map(torch.clone, params), adamw.OptState(
        opt.step, tree_map(torch.clone, opt.mu), tree_map(torch.clone, opt.nu)))
    p_params, p_opt, m = step(*port_state,
                              {k: torch.from_numpy(v) for k, v in host.items()})
    assert p_opt.step == 3
    assert _rel(m["loss"], r_m["loss"]) <= TOL
    assert _rel(m["grad_norm"], r_m["grad_norm"]) <= TOL
    want = _ref_leaves(r_params)
    for path, x in leaf_paths(p_params):
        assert np.abs(x.numpy() - want[path]).max() <= PARAM_TOL, path


def test_reference_checkpoint_restores_in_port(tmp_path, two_steps):
    ref_step, ref_state, step, port_state, host = two_steps
    ref_ckpt.save_checkpoint(str(tmp_path), 1, ref_state)
    template = (tree_map(torch.zeros_like, port_state[0]),
                adamw.init_opt_state(port_state[0]))
    restored, manifest = restore_checkpoint(str(tmp_path), template)
    assert manifest["step"] == 1 and restored[1].step == 2
    _third_step_agrees(ref_step, ref_state, step, restored, host)


def test_port_checkpoint_restores_in_reference(tmp_path, two_steps):
    ref_step, ref_state, step, port_state, host = two_steps
    save_checkpoint(str(tmp_path), 1, port_state)
    template = jax.tree.map(jnp.zeros_like, ref_state)
    restored, _ = ref_ckpt.restore_checkpoint(str(tmp_path), template)
    assert int(restored[1].step) == 2
    _third_step_agrees(ref_step, restored, step, port_state, host)


def test_manifests_identical_for_the_same_values(tmp_path, two_steps):
    _, ref_state, _, port_state, _ = two_steps
    a = ref_ckpt.save_checkpoint(str(tmp_path / "r"), 1, ref_state)
    b = save_checkpoint(str(tmp_path / "p"), 1, port_state)
    want, got = _manifest(a)["leaves"], _manifest(b)["leaves"]
    assert got == want  # names, files, shapes, dtypes and crc32
    assert {"0/embed/embedding", "1/step", "1/mu/final_norm/scale",
            "1/nu/unembed/kernel"} <= set(got)
