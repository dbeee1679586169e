#!/usr/bin/env python3
"""Phases 4 and 6 of ``chip_smoke.py`` (hla-1b served and trained off any
mesh) for two checkouts, alternated on one NVIDIA GPU.

    python3 scripts/unsharded_ab.py OTHER_ROOT [--rounds 1]

``OTHER_ROOT`` is another checkout of the repository (an unpacked ``git
archive`` of an earlier commit, say).  Each run is a fresh process started
in one checkout that imports that checkout's ``chip_smoke.py`` and
``src/``, builds the six kernels (into that checkout's ``build/``), and
runs, for ``hla2`` and ``ahla`` at full size: phase 4's ``serve`` (8
greedy requests, 256-640-token prompts, 64 tokens, 4 slots, bf16) and
phase 6's ``train`` (5 AdamW steps at 2 x 2048, ``remat="full"``).  Runs
go in the order other, this, this, other (``--rounds`` times), so a drift
of the card or the host does not favour either side.  Each run
prints one JSON line: TTFT p50, decode and prefill tok/s, train step p50
and peak memory per mixer; the last lines are the medians per checkout
and the card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

WORKER = r"""
import json, sys
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, ".")
sys.path.insert(0, "src")
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import _build, ahla_chunk, decode_step, hla2_chunk
from repro_torch.models import lm
from repro_torch.models.param import init_params

device = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
builds = [("hla2_chunk_fwd", hla2_chunk._SIG),
          ("hla2_step", decode_step._SIG),
          ("hla2_chunk_bwd", hla2_chunk._BWD_SIG),
          ("ahla_chunk_fwd", ahla_chunk._SIG),
          ("ahla_step", decode_step._AHLA_SIG),
          ("ahla_chunk_bwd", ahla_chunk._BWD_SIG)]
with ThreadPoolExecutor(len(builds)) as pool:
    list(pool.map(lambda a: _build.load(*a), builds))
out = {}
params = init_params(lm.lm_specs(get_config("hla-1b")), 0, device)
for mixer in ("hla2", "ahla"):
    _, s = cs.serve(params, get_config("hla-1b", mixer=mixer), device)
    out[mixer] = {k: s[k] for k in ("ttft_p50_ms", "decode_tok_s",
                                    "prefill_tok_s")}
del params
torch.cuda.empty_cache()
for mixer in ("hla2", "ahla"):
    _, t = cs.train(device, get_config("hla-1b", mixer=mixer))
    out[mixer].update(step_p50_s=t["step_p50_s"], peak_gib=t["peak_gib"])
print("AB " + json.dumps(out), flush=True)
"""


def run(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", WORKER], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"the run in {root} failed")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("AB "))
    return json.loads(line[3:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1,
                    help="blocks of other, this, this, other")
    args = ap.parse_args()
    other = args.other.resolve()
    if not (other / "chip_smoke.py").exists():
        raise SystemExit(f"{other} holds no chip_smoke.py")
    order = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)] * args.rounds
    runs = {"other": [], "this": []}
    for name, root in order:
        res = run(root)
        runs[name].append(res)
        print(json.dumps({"tree": name, **res}), flush=True)
    for name, rs in runs.items():
        med = {m: {k: statistics.median(r[m][k] for r in rs)
                   for k in rs[0][m]} for m in rs[0]}
        print(json.dumps({"tree": name, "runs": len(rs), "median": med}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
