"""The readings that the limits of ``correct`` are set from, on the card.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--seconds S]

For a ``train`` cell, in one process: on every seed of ``--seeds`` the
program's readings over the checked steps (no measured window) against
the plain reference's; on every seed of ``--control-seeds`` also the
control (the reference in the program's place in float8) and the fault
that leaves out half of each batch, each against the reference.  For a
``closed_loop`` cell: one run of the cell a seed for ``--seconds``, with
the control's gaps read on the same prompts and served tokens for the
control seeds.  One JSON line a reading on standard output.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench.bench import cell, checks, program, spec, train

    if not torch.cuda.is_available():
        sys.exit("control.py reads on the card only")
    bench = spec.load_benchmark(ROOT)
    _, _, c, t = spec.cell(bench, args.workload)
    device = torch.device("cuda:0")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    for seed in seeds + [s for s in controls if s not in seeds]:
        t0 = time.perf_counter()
        if t["kind"] == "train":
            step, params, state = train.build(c, seed, device)
            _, _, prog = train.first_steps(step, params, state, c, t, seed,
                                           device)
            del step, params, state
            program.free()
            ref = train.reference_readings(c, t, seed, device)
            program.free()
            nums, notes = checks.compare_train(prog, ref)
            emit(seed=seed, side="program", numbers=nums, notes=notes,
                 loss=prog["loss"], ref_loss=ref["loss"],
                 grad_norm=prog["grad_norm"], ref_grad_norm=ref["grad_norm"])
            if seed in controls:
                for name, kw in (("control_fp8", dict(prec="fp8")),
                                 ("fault_half_batch", dict(half=True))):
                    other = train.reference_readings(c, t, seed, device,
                                                     **kw)
                    program.free()
                    nums, notes = checks.compare_train(other, ref)
                    emit(seed=seed, side=name, numbers=nums, notes=notes,
                         loss=other["loss"], grad_norm=other["grad_norm"])
        else:
            precs = ("fp32", "fp8") if seed in controls else ("fp32",)
            result, judged = cell.run_cell(
                bench, args.workload, seed, args.seconds, False, device,
                precs=precs)
            emit(seed=seed, side="program", numbers={
                k: v["value"] for k, v in judged.items()},
                notes=result["notes"], metrics=result["metrics"],
                attempted=result["attempted"], failed=result["failed"],
                memory_peak_bytes=result["device"]["memory_peak_bytes"])
            if seed in controls:
                fp8 = result["notes"]["control"]["fp8"]
                emit(seed=seed, side="control_fp8", numbers={
                    "logit_gap_mean": fp8["mean"],
                    "logit_gap": fp8["widest"]}, gaps=fp8)
            program.free()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
