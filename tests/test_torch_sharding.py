"""The port's sharding data and rules against the reference's, in one
process, no collectives:

* every parameter leaf's logical ``axes`` (``model_specs``) for the 11
  archs at ``reduced()`` and hla-1b with ``ahla``;
* every decode-state tree's axes (``lm_state_axes``, whisper's
  ``whisper_state_axes``) and each registered op's ``resolve_state_ndims``;
* ``spec_for``, the ZeRO-1 moment specs (``opt_state_shardings``) and
  ``row_axes`` for every parameter leaf of those configs on the meshes
  (1, 1), (2, 2), (2, 4), (16, 16), 2 x 2 x 2 and 2 x 16 x 16: the
  reference's functions read a mesh's ``axis_names`` and ``shape`` only
  (its ``NamedSharding`` is swapped for the bare spec, so no JAX mesh of
  512 devices is needed); the port's get a ``DeviceMesh`` of a ``fake``
  process group of the mesh's size;
* ``get_shape`` for every shape;
* the dry-run CLI on a fake 2 x 2 x 2 mesh at reduced size (the twin of
  ``tests/test_distributed.py::test_multipod_mesh_axes_and_dryrun_cli``).

All comparisons are exact (names and integers).
"""

import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import pytest

from repro.configs import get_config as ref_get_config
from repro.distributed import shard_ops as ref_shard_ops
from repro.distributed import sharding as ref_shd
from repro.distributed import steps as ref_steps
from repro.models import lm as ref_lm
from repro.models import seq_op as ref_seq_op
from repro.models import whisper as ref_whisper
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.config import get_shape as ref_get_shape
from repro.models.param import is_axes as ref_is_axes
from repro.models.param import is_spec as ref_is_spec
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import shard_ops
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import steps
from repro_torch.models import lm, seq_op, whisper
from repro_torch.models.config import SHAPES, get_shape
from repro_torch.models.param import leaf_paths
from repro_torch.models.state_tree import leaves

ROOT = Path(__file__).resolve().parents[1]

CASES = [(a, None) for a in list_archs()] + [("hla-1b", "ahla")]
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _cfgs(arch, mixer):
    return (ref_get_config(arch, reduced=True, mixer=mixer),
            get_config(arch, reduced=True, mixer=mixer))


def _ref_leaves(tree, is_leaf):
    return {tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in p):
            v for p, v in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=is_leaf)}


@pytest.mark.parametrize("arch, mixer", CASES)
def test_param_axes_match_reference(arch, mixer):
    ref_cfg, cfg = _cfgs(arch, mixer)
    want = {p: (s.shape, s.axes) for p, s in _ref_leaves(
        ref_steps.model_specs(ref_cfg), ref_is_spec).items()}
    got = {p: (s.shape, s.axes) for p, s in leaf_paths(
        steps.model_specs(cfg))}
    assert got == want


@pytest.mark.parametrize("arch, mixer", CASES)
def test_state_axes_match_reference(arch, mixer):
    ref_cfg, cfg = _cfgs(arch, mixer)
    if cfg.enc_layers:
        want = ref_whisper.whisper_state_axes(ref_cfg)
        got = whisper.whisper_state_axes(cfg)
    else:
        want = ref_lm.lm_state_axes(ref_cfg)
        got = lm.lm_state_axes(cfg)
    assert [tuple(a) for a in leaves(got)] == [
        tuple(a) for a in jax.tree.leaves(want, is_leaf=ref_is_axes)]
    assert steps.state_axes(cfg) == got


@pytest.mark.parametrize("name", ["attn", "gla", "hla2", "ahla", "hla3",
                                  "hla3_paper", "linattn", "mamba", "rwkv6"])
def test_state_ndims_match_reference(name):
    arch = {"rwkv6": "rwkv6-7b", "mamba": "jamba-1.5-large-398b"}.get(
        name, "hla-1b")
    ref_cfg, cfg = _cfgs(arch, None)
    if name not in ("rwkv6", "mamba"):
        ref_cfg, cfg = (ref_cfg.replace(mixer=name), cfg.replace(mixer=name))
    ref_op, op = ref_seq_op.get_op(name), seq_op.get_op(name)
    assert leaves(op.resolve_state_ndims(cfg)) == jax.tree.leaves(
        ref_op.resolve_state_ndims(ref_cfg))
    assert [tuple(a) for a in leaves(op.state_axes(cfg))] == [
        tuple(a) for a in jax.tree.leaves(ref_op.state_axes(ref_cfg),
                                          is_leaf=ref_is_axes)]


@pytest.fixture(scope="module")
def meshes():
    """A fake-process-group ``DeviceMesh`` for each mesh shape (the group
    is re-made at each mesh's size), and the plain object the reference's
    functions read."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    out = []
    for shape, axes in MESHES:
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        ref = types.SimpleNamespace(axis_names=axes, shape=dict(zip(
            axes, shape)), empty=False)
        out.append((shd.mesh_axes(mesh), ref, mesh))
    yield out
    dist.destroy_process_group()


@pytest.mark.parametrize("arch, mixer", CASES)
def test_spec_for_zero1_and_row_axes_match_reference(arch, mixer, meshes,
                                                     monkeypatch):
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda mesh, spec: spec)
    ref_cfg, cfg = _cfgs(arch, mixer)
    ref_specs = ref_steps.model_specs(ref_cfg)
    specs = dict(leaf_paths(steps.model_specs(cfg)))
    for sizes, ref_mesh, mesh in meshes:
        want_p = _ref_leaves(ref_shd.param_shardings(ref_specs, ref_mesh),
                             lambda x: isinstance(x, jax.sharding
                                                  .PartitionSpec))
        want_o = _ref_leaves(ref_shd.opt_state_shardings(ref_specs,
                                                         ref_mesh),
                             lambda x: isinstance(x, jax.sharding
                                                  .PartitionSpec))
        for path, s in specs.items():
            assert shd.spec_for(s.axes, s.shape, mesh) == tuple(
                want_p[path]), (sizes, path)
            assert shd.zero1_spec(s, mesh) == tuple(want_o[path]), (
                sizes, path)
            if len(s.shape) >= 2:
                assert shard_ops.row_axes(mesh, *s.shape[:2]) == \
                    ref_shard_ops.row_axes(ref_mesh, *s.shape[:2]), (
                        sizes, path)
        for B in (1, 2, 3, 4, 8, 32):
            assert shard_ops.row_axes(mesh, B, cfg.n_heads) == \
                ref_shard_ops.row_axes(ref_mesh, B, cfg.n_heads)


def test_placements_on_a_device_mesh(meshes):
    """``placements`` over the fake-process-group meshes: a dim over
    ("pod", "data") is ``Shard`` on both mesh dims; a mesh dim of size 1
    is replicated."""
    from torch.distributed.tensor import Replicate, Shard

    by_shape = {tuple(sizes.values()): mesh for sizes, _, mesh in meshes}
    pod = by_shape[(2, 2, 2)]
    spec = shd.spec_for(("batch", None, "q_heads_flat"), (8, 5, 64), pod)
    assert spec == (("pod", "data"), None, "model")
    assert shd.placements(spec, pod) == (Shard(0), Shard(0), Shard(2))
    assert shd.batch_sharding(pod, (2, 7)) == (Replicate(), Shard(0),
                                               Replicate())
    one = by_shape[(1, 1)]
    assert shd.placements(("data", "model"), one) == (Replicate(),
                                                      Replicate())
    specs = steps.model_specs(get_config("hla-1b", reduced=True))
    ps, ms = steps.make_shardings(get_config("hla-1b", reduced=True),
                                  by_shape[(2, 4)])
    assert ps["layers"]["mixer"]["wq"]["kernel"] == (Shard(1), Shard(2))
    # ZeRO-1: the embedding's free dim is already over "data"; decay_a
    # (layers, heads) gets "data" on its stacked axis in the moments
    assert ms["layers"]["mixer"]["decay_a"] == (Shard(0), Shard(1))
    assert set(dict(leaf_paths(ps))) == set(dict(leaf_paths(specs)))


def test_get_shape_matches_reference():
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES] == \
        [(s.name, s.seq_len, s.global_batch, s.kind) for s in REF_SHAPES]
    for s in REF_SHAPES:
        got, want = get_shape(s.name), ref_get_shape(s.name)
        assert (got.seq_len, got.global_batch, got.kind) == (
            want.seq_len, want.global_batch, want.kind)
    with pytest.raises(KeyError):
        get_shape("train_8k")


def test_multipod_mesh_axes_and_dryrun_cli(tmp_path):
    """A reduced dry run through the CLI on a fake 2 x 2 x 2 mesh."""
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "hla-1b", "--shape", "train_4k", "--mesh", "2x2x2", "--reduced",
         "--json", str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(out.read_text())
    assert res["mesh"] == {"pod": 2, "data": 2, "model": 2}
    assert res["devices"] == 8
    mem = res["memory"]
    assert min(mem["param_bytes"], mem["grad_bytes"], mem["moment_bytes"],
               mem["input_bytes"], mem["peak_bytes"]) > 0
    assert res["cost"]["flops"] > res["cost"]["kernel_flops"] > 0
    assert res["collectives"]["counts"]["all_gather"] > 0
    assert res["roofline"]["bottleneck"] in (
        "compute_s", "memory_s", "collective_s")
    assert "[dryrun] hla-1b x train_4k" in proc.stderr


def test_dryrun_refuses_unported_families():
    """Every family has its sharded forward, so the dry run refuses none:
    an MoE cell and an RWKV-6 cell lower through the CLI on a fake 2 x 2
    mesh, the MoE one all-gathering its experts' outputs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch, mixer in (("qwen3-moe-30b-a3b", "hla2"), ("rwkv6-7b", None)):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", "decode_32k", "--mesh", "2x2", "--reduced"]
            + (["--mixer", mixer] if mixer else []),
            capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-2000:]
        res = json.loads(proc.stdout[:proc.stdout.rindex("}") + 1])
        assert res["memory"]["peak_bytes"] > 0
        if arch.startswith("qwen3"):
            assert res["collectives"]["counts"]["all_gather"] > 0
