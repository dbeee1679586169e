"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the program (``src/repro_torch``).  It needs as many NVIDIA H100 cards
as the cell asks for; on anything else it prints no result and exits with
a code other than 0.  The last line of standard output is the result, one
JSON object; the compared numbers and their limits are also the last lines
of standard error.  Build outputs and kernel caches stay inside the
checkout, under ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names the port must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg, code=2):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    started = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench.bench import cell, spec
    from perfbench.costs import peaks

    bench = spec.load_benchmark(ROOT)
    w, _, _, _ = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures on the card only")
    if torch.cuda.device_count() < w["chips"]:
        fail(f"{torch.cuda.device_count()} cards, the cell needs "
             f"{w['chips']}")
    name = torch.cuda.get_device_name(0)
    if name != peaks.CARD:
        fail(f"card {name!r}: the peaks are published for {peaks.CARD!r}")
    print(f"perfbench: card found at {time.time() - started:.2f} s",
          file=sys.stderr, flush=True)
    result, judged = cell.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda:0", started=cell.process_start_epoch() or started)
    result["device"]["power_limit_w"] = power_limit()
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        fail(f"modules loaded that the port must not load: {loaded}")
    from perfbench.bench import checks

    print(f"perfbench: notes {json.dumps(result.pop('notes'))}",
          file=sys.stderr, flush=True)
    result["checks"] = judged
    print(json.dumps(result), flush=True)
    checks.print_checks(judged)


def power_limit():
    """The card's power limit in watts, from ``nvidia-smi``; None where it
    cannot be read."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    main()
