"""Training CLI with fault tolerance (twin of ``repro/launch/train.py``).

AdamW steps on the deterministic synthetic stream from seeded random
weights, through ``runtime.ft.FaultTolerantLoop``: exact microbatch
accumulation (``--microbatches``), per-layer remat as the config says
(hla-1b: ``remat="full"``), async checksummed checkpoints every
``--ckpt-every`` steps into ``--ckpt-dir`` (keep 3), auto-resume from the
latest of them, SIGTERM/SIGINT checkpoint-and-exit, a straggler and hang
watchdog, and the loop's metrics, spans and events through one ``Obs``.
Runs on the card by default:

    PYTHONPATH=src python -m repro_torch.launch.train --arch hla-1b \\
        --steps 5 --batch 2 --seq 2048 --ckpt-dir ckpt

and on the CPU (plain versions of the kernels) with ``--device cpu``.
Started by ``torchrun`` it trains on a ``("data", "model")`` mesh over
all its ranks (``launch/mesh.py::mesh_from_env``; NCCL on the cards, gloo
with ``--device cpu``): parameters and ZeRO-1 moments are DTensors, each
batch is split over "data", and the HLA kernels run on each rank's own
(batch, head) rows:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch hla-1b

A failure at step 9 and a run that resumes from the checkpoint of step 7:

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 12 --batch 4 --seq 32 --ckpt-every 4 \\
        --ckpt-dir ckpt --fail-at-step 9
    (rerun without --fail-at-step: "[ft] resumed from step 7")

Without ``--ckpt-dir`` the run checkpoints into a temporary directory that
is removed when it ends, so it never resumes.  ``--arch`` takes every arch
of ``configs/``; the seven public ones train softmax attention (``attn``,
plain torch), internvl2-2b on tokens only, as the reference's CLI does,
and granite-moe-3b-a800m and qwen3-moe-30b-a3b with their MoE FFNs,
whose load-balance loss joins the loss (the summary line prints the last
step's ``aux``).  rwkv6-7b trains its self-contained RWKV-6 layers and
jamba-1.5-large-398b its hybrid groups (7 Mamba layers and attention at
position 4, MoE on every second layer), both plain torch, jamba with its
bf16 parameters and moments (``param_dtype``, ``moment_dtype``).
whisper-small builds its encoder-decoder parameters but its first step
fails for want of ``frames``, which the token stream does not yield, as
in the reference's CLI; ``distributed/steps.py``'s train step trains it
given a batch with ``frames``.  ``--mixer ahla`` trains the same model with the AHLA
mixer (its own kernels, the same parameter layout); ``--mixer hla3``,
``hla3_paper`` or ``linattn`` with the rest of the HLA family (plain
torch, the same parameter layout); ``--mixer gla`` with gated linear
attention (plain torch).
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from ..configs import get_config
from ..data.pipeline import DataConfig, SyntheticStream
from ..distributed import sharding as shd
from ..distributed.steps import make_shardings, make_train_step, model_specs
from ..models import seq_op
from ..models.param import init_params
from ..obs import JsonlSink, Obs, profile_capture, write_metrics
from ..optim import adamw
from ..runtime.faults import FaultPlan, FaultSpec
from ..runtime.ft import FaultTolerantLoop
from .mesh import mesh_from_env, mesh_summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hla-1b")
    ops = seq_op.registered_op_names()
    ap.add_argument("--mixer", default=None, choices=ops,
                    help="override the arch's sequence op with a registered "
                         f"one ({', '.join(ops)})")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (resumed from when it holds "
                         "one); default: a temporary one, removed at exit")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="zipf")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a train.step fault at this step "
                         "(runtime.faults; exercises restart/resume)")
    ap.add_argument("--metrics", default=None,
                    help="append one JSON line of metrics per step")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the final metrics registry snapshot "
                         "(repro.obs.metrics/v1 JSON) on exit")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="stream span/event records (repro.obs.events/v1 "
                         "JSONL): train.step spans, ckpt.save spans, "
                         "resume events, fired faults")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the whole run "
                         "into DIR; profile.start/stop events on the obs "
                         "stream carry matching wall-clock stamps")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced, mixer=args.mixer)
    mesh, device = mesh_from_env(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    where = name if mesh is None else f"{mesh_summary(mesh)} of {name}"
    print(f"[train] {cfg.name} ({cfg.mixer}) on {where}")
    params = init_params(model_specs(cfg), args.seed, device)
    opt_cfg = adamw.OptConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 5))
    opt_state = adamw.init_opt_state(params, cfg.moment_dtype)
    pshard = shardings = None
    if mesh is not None:  # every rank drew the same values: keep its block
        pshard, mshard = make_shardings(cfg, mesh)
        params = shd.distribute(params, pshard, mesh)
        opt_state = adamw.OptState(
            0, shd.distribute(opt_state.mu, mshard, mesh),
            shd.distribute(opt_state.nu, mshard, mesh))
        shardings = (pshard, adamw.OptState(None, mshard, mshard))
    train_step = make_train_step(cfg, opt_cfg,
                                 microbatches=args.microbatches,
                                 grad_shardings=pshard)
    last_metrics = {}

    def step_fn(params, opt_state, batch):
        params, opt_state, m = train_step(params, opt_state, batch)
        last_metrics.update(m)  # for the summary line's aux
        return params, opt_state, m

    stream = SyntheticStream(DataConfig(cfg.vocab, args.seq, args.batch,
                                        seed=args.seed, kind=args.data))

    def place(batch):
        out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if mesh is None:
            return out
        return {k: shd.distribute_leaf(v, mesh,
                                       shd.batch_sharding(mesh, v.shape))
                for k, v in out.items()}

    faults = None
    if args.fail_at_step is not None:
        faults = FaultPlan(FaultSpec("train.step", at=args.fail_at_step))
    obs = Obs()
    sink = None
    if args.events_out:
        sink = JsonlSink(args.events_out,
                         epoch_offset_ns=obs.tracer.epoch_offset_ns)
        obs.attach(sink)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        loop = FaultTolerantLoop(
            step_fn, stream, ckpt_dir, ckpt_every=args.ckpt_every,
            metrics_path=args.metrics, faults=faults, place_batch=place,
            obs=obs, shardings=shardings, mesh=mesh)
        with profile_capture(args.profile_dir, obs=obs), \
                shd.use_mesh(mesh):
            params, opt_state, last = loop.run(params, opt_state, args.steps)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    step_s = obs.registry.get("train_step_seconds")
    p50 = step_s.quantile(0.5) or 0.0
    p99 = step_s.quantile(0.99) or 0.0
    toks = obs.registry.get("train_tokens_total").total()
    total_s = step_s.sum() or 1e-9
    print(f"[train] finished at step {last} | step p50 {p50:.3f}s "
          f"p99 {p99:.3f}s | {toks / total_s:.0f} tok/s | "
          f"loss {obs.registry.get('train_loss').value():.4f} | "
          f"aux {float(last_metrics.get('aux', 0.0)):.4f}")
    if sink is not None:
        sink.close()
        print(f"[train] events -> {args.events_out}")
    if args.metrics_out:
        write_metrics(obs.snapshot(), args.metrics_out)
        print(f"[train] metrics -> {args.metrics_out}")
    return last


if __name__ == "__main__":
    main()
