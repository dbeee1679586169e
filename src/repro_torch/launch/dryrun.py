"""Dry run without hardware: one train, prefill or decode step of a cell
(arch x shape x mesh) on fake DTensors, with its per-rank memory, FLOPs,
collectives and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
        --shape train_4k [--multi-pod | --mesh 2x4] [--json out.json]

Twin of ``repro/launch/dryrun.py``.  The reference lowers and compiles the
step with XLA on host placeholder devices; here the step runs eagerly on
tensors that have shapes and no data: a ``fake`` process group of the
mesh's size (this process is rank 0; collectives return at once),
``FakeTensorMode`` for every tensor, DTensors with the shardings of
``distributed/steps.py``.  It runs on any host, with no card and no
communication, and sets no environment.  What it reports:

* ``mesh``, ``devices``, ``mixer`` (and the reference's ``note``);
* ``memory``: rank 0's bytes of parameters, gradients (the parameters'
  placements and dtypes), moments and inputs, and the peak of its live
  tensor storage through the step (``_rank_mode``: each storage counted
  once, from the op that makes it until its last tensor dies);
* ``cost``: rank 0's FLOPs (``FlopCounterMode``'s formulas over its local
  aten ops, plus the HLA kernels' FLOPs from ``obs.costs``' formulas,
  which the kernels' shape-only fakes count in ``shard_ops.FAKE_FLOPS``)
  and the bytes its ops read and write (each op's inputs and outputs once:
  eager, no fusion);
* ``collectives``: rank 0's collectives by kind, counted and sized (each
  one's output) as its local ops, and ``CommDebugMode``'s count of the
  collectives DTensor issued;
* ``roofline``: those over ``obs/perf.py``'s published H100 SXM rates
  (``published_peak``; the link rate beside them), and the largest term.

The HLA kernels take their shape-only path (``shard_ops.call_sharded``'s
``fake``); the real launch and the CPU's plain versions are untouched.
Every config lowers: the MoE layers' expert all-gathers over "model" and
the batch-split sums of their aux loss, Mamba's channel-split sums, the
plain records' and RWKV-6's and GLA's row-local chunk loops and
whisper's encoder and cross-attention all count among the collectives
and ops of rank 0.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import weakref

import torch
from torch.utils._pytree import tree_flatten

from ..configs import get_config
from ..distributed import shard_ops
from ..distributed import sharding as shd
from ..distributed import steps as steps_mod
from ..models.config import get_shape
from ..models.param import leaf_paths
from ..models.state_tree import leaves as state_leaves
from ..obs.perf import published_peak
from ..optim import adamw
from .mesh import make_mesh, make_production_mesh, mesh_summary

#: the card the roofline terms are taken against
CARD = "H100 80GB HBM3"

_COLLECTIVES = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")


def _kind(func) -> str:
    name = func.__name__ if hasattr(func, "__name__") else str(func)
    for k in _COLLECTIVES:
        if k in name:
            return k
    return name


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _rank_mode():
    """A ``FakeTensorMode`` that also accounts for rank 0's own work.  It
    sees every op on a local (fake) tensor, those DTensor runs inside its
    ops included (a dispatch mode above DTensor would see global shapes):
    the live storage bytes and their peak (each storage counted once, from
    the op that makes it until its last tensor dies), the FLOPs of the
    matmul-like ops (``FlopCounterMode``'s formulas), the bytes every op
    reads and writes, and each collective's count and output bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import flop_registry

    class RankMode(FakeTensorMode):
        def __init__(self):
            super().__init__(allow_non_fake_inputs=True)
            self.live = self.peak = self.traffic = 0
            self.flops = 0
            self.coll_bytes = {k: 0 for k in _COLLECTIVES}
            self.coll_counts = {k: 0 for k in _COLLECTIVES}
            self._refs = {}
            self.quiet = 0

        @contextlib.contextmanager
        def shape_inference_quiet(self):
            """Leave out the ops DTensor runs on global-shape fake tensors
            (in this mode) to infer an op's output metadata."""
            from torch.distributed.tensor._sharding_prop import (
                ShardingPropagator,
            )

            name = "_propagate_tensor_meta_non_cached"
            orig = getattr(ShardingPropagator, name)
            mode = self

            def quiet(*args, **kwargs):
                mode.quiet += 1
                try:
                    return orig(*args, **kwargs)
                finally:
                    mode.quiet -= 1

            setattr(ShardingPropagator, name, quiet)
            try:
                yield
            finally:
                setattr(ShardingPropagator, name, orig)

        def _track(self, t):
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._refs:
                self._refs[key] = [0, st.nbytes()]
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
            self._refs[key][0] += 1
            weakref.finalize(t, self._release, key)

        def _release(self, key):
            ref = self._refs.get(key)
            if ref is None:
                return
            ref[0] -= 1
            if ref[0] == 0:
                self.live -= ref[1]
                del self._refs[key]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = super().__torch_dispatch__(func, types, args, kwargs)
            ins = [x for x in tree_flatten((args, kwargs))[0]
                   if isinstance(x, torch.Tensor)]
            if out is NotImplemented or any(isinstance(x, DTensor)
                                            for x in ins):
                return out  # a DTensor op: its local ops come back here
            outs = [x for x in tree_flatten(out)[0]
                    if isinstance(x, torch.Tensor)]
            if self.quiet or any(x.device.type == "meta"
                                 for x in ins + outs):
                return out  # DTensor's shape inference, on global shapes
            pkt = func.overloadpacket
            if pkt in flop_registry:
                self.flops += flop_registry[pkt](*args, **kwargs,
                                                 out_val=out)
            kind = _kind(func)
            if kind in self.coll_bytes:
                self.coll_counts[kind] += 1
                self.coll_bytes[kind] += sum(_nbytes(x) for x in outs)
            if not func.is_view:
                self.traffic += sum(_nbytes(x) for x in ins + outs)
                for x in outs:
                    self._track(x)
            return out

    return RankMode()


def _local_bytes(tree) -> int:
    return sum(_nbytes(x.to_local()) for x in tree)


def lower_cell(arch, shape_name, mesh, *, mixer=None, microbatches=1,
               zero1=True, hla_impl=None, hla_chunk=None,
               gather_dtype=None, reduced=False):
    """Run one step of the cell on fake DTensors over ``mesh`` (a mesh of a
    ``fake`` process group); returns the result dict.  ``reduced`` takes
    the arch's small test config at the cell's shape (a quick check of the
    sharded path, not a deployment)."""
    from torch.distributed.tensor.debug import CommDebugMode

    shape_cfg = get_shape(shape_name)
    cfg = get_config(arch, mixer=mixer, reduced=reduced)
    note = "reduced config" if reduced else ""
    if shape_cfg.name == "long_500k" and cfg.mixer == "softmax" and \
            mixer is None:
        # full attention at 524k is infeasible: the HLA2 mixer drops in
        cfg = get_config(arch, mixer="hla2", reduced=reduced)
        note = "HLA2 mixer drop-in (O(1)-state decode); native softmax " \
            "skipped by design"
    if hla_impl or hla_chunk:
        hla = dataclasses.replace(
            cfg.hla, **({"impl": hla_impl} if hla_impl else {}),
            **({"chunk": hla_chunk} if hla_chunk else {}))
        cfg = cfg.replace(hla=hla)
        note = (note + f" hla_impl={hla.impl} chunk={hla.chunk}").strip()
    if gather_dtype and gather_dtype != cfg.dtype:
        raise ValueError(
            f"gather_dtype {gather_dtype!r}: the port gathers a weight in "
            f"the activation dtype ({cfg.dtype}; dense_apply casts before "
            "DTensor's all-gather)")
    shard_ops.FAKE_FLOPS.clear()
    live = _rank_mode()
    comm = CommDebugMode()
    t0 = time.time()
    with live, live.shape_inference_quiet(), shd.use_mesh(mesh):
        if shape_cfg.kind == "train":
            ps, _ = steps_mod.make_shardings(cfg, mesh, zero1=zero1)
            step = steps_mod.make_train_step(
                cfg, adamw.OptConfig(), microbatches=microbatches,
                grad_shardings=ps)
            params, opt = steps_mod.abstract_train_args(cfg, mesh,
                                                        zero1=zero1)
            batch = steps_mod.input_specs(cfg, shape_cfg, mesh)
            inputs = list(batch.values())
            with comm:
                step(params, opt, batch)
            moments = [x for _, x in leaf_paths(opt.mu)] + \
                [x for _, x in leaf_paths(opt.nu)]
        else:
            params, _ = steps_mod.abstract_train_args(cfg, mesh, zero1=False)
            spec = steps_mod.input_specs(cfg, shape_cfg, mesh)
            moments = []
            with torch.no_grad(), comm:
                if shape_cfg.kind == "prefill":
                    inputs = list(spec.values())
                    steps_mod.make_prefill_step(cfg)(params, spec)
                else:
                    inputs = list(spec["batch"].values()) + \
                        state_leaves(spec["states"])
                    steps_mod.make_serve_step(cfg)(params, spec["batch"],
                                                   spec["states"])
        pleaves = [x for _, x in leaf_paths(params)]
        t_run = time.time() - t0
        memory = {
            "param_bytes": _local_bytes(pleaves),
            "grad_bytes": _local_bytes(pleaves) if shape_cfg.kind == "train"
            else 0,
            "moment_bytes": _local_bytes(moments),
            "input_bytes": _local_bytes(inputs),
            "peak_bytes": live.peak,
        }
    kernel_flops = sum(shard_ops.FAKE_FLOPS.values())
    total_flops = float(live.flops) + kernel_flops
    # CommDebugMode's count of the collectives DTensor issued, by kind
    traced = {k: 0 for k in _COLLECTIVES}
    for op, n in comm.get_comm_counts().items():
        kind = _kind(op)
        if kind in traced:
            traced[kind] += n
    coll_total = sum(live.coll_bytes.values())
    peak = published_peak(CARD)
    terms = {"compute_s": total_flops / peak["flops_per_s"],
             "memory_s": live.traffic / peak["bytes_per_s"],
             "collective_s": coll_total / peak["link_bytes_per_s"]}
    sizes = shd.mesh_axes(mesh)
    return {
        "arch": arch, "shape": shape_name, "mesh": sizes,
        "devices": int(mesh.size()), "mixer": cfg.mixer, "note": note,
        "run_s": round(t_run, 2),
        "memory": memory,
        "fits_80gb": memory["peak_bytes"] <= 80e9,
        "cost": {"flops": total_flops, "kernel_flops": kernel_flops,
                 "bytes_accessed": float(live.traffic)},
        "collectives": {"bytes": dict(live.coll_bytes),
                        "counts": dict(live.coll_counts),
                        "comm_debug_counts": traced},
        "roofline": {**terms, "bottleneck": max(terms, key=terms.get),
                     "card": peak["kind"], "source": peak["source"]},
    }


def fake_process_group(world_size: int) -> None:
    """Initialise this process as rank 0 of a ``fake`` process group of
    ``world_size`` ranks (collectives return at once, moving nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def cli_mesh(mesh_arg=None, multi_pod: bool = False):
    """The reference CLI's mesh: ``--mesh AxB`` (or ``PxAxB``, with a
    "pod" axis) or the production mesh, on a fake process group of its
    size."""
    if mesh_arg:
        dims = tuple(int(x) for x in mesh_arg.split("x"))
        axes = ("pod", "data", "model")[-len(dims):] if len(dims) == 3 \
            else ("data", "model")
        fake_process_group(int(torch.Size(dims).numel()))
        return make_mesh(dims, axes, device_type="cpu")
    fake_process_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def summary_line(arch, shape, res) -> str:
    gib = res["memory"]["peak_bytes"] / 2**30
    coll = ", ".join(f"{k} {v / 2**30:.2f} GiB"
                     for k, v in res["collectives"]["bytes"].items() if v)
    return (f"[dryrun] {arch} x {shape} on mesh{res['mesh']}: peak "
            f"{gib:.2f} GiB/rank ({'fits' if res['fits_80gb'] else 'over'} "
            f"80 GB); collectives {coll or 'none'}; bottleneck "
            f"{res['roofline']['bottleneck']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 (reduced CI)")
    ap.add_argument("--mixer", default=None, help="HLA mixer override")
    ap.add_argument("--hla-impl", default=None,
                    help="chunkwise | scan (paper-faithful baseline)")
    ap.add_argument("--hla-chunk", type=int, default=None)
    ap.add_argument("--gather-dtype", default=None,
                    help="accepted when it is the activation dtype (the "
                         "port gathers weights in it)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--json", default=None, help="write result JSON here")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's small test config (a quick check)")
    args = ap.parse_args(argv)

    mesh = cli_mesh(args.mesh, args.multi_pod)
    res = lower_cell(
        args.arch, args.shape, mesh, mixer=args.mixer,
        microbatches=args.microbatches, zero1=not args.no_zero1,
        hla_impl=args.hla_impl, hla_chunk=args.hla_chunk,
        gather_dtype=args.gather_dtype, reduced=args.reduced)
    print(json.dumps(res, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    print(summary_line(args.arch, args.shape, res) + f" ({mesh_summary(mesh)}"
          f", ran in {res['run_s']}s)", file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
