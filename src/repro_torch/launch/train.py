"""Training CLI: AdamW steps on the synthetic stream, on one device.

Twin of ``repro/launch/train.py`` without the fault-tolerant loop (no
checkpoints, restarts or fault injection yet).  Seeded random weights,
data from the deterministic synthetic stream.  Runs on the card by default:

    PYTHONPATH=src python -m repro_torch.launch.train --arch hla-1b \
        --steps 5 --batch 2 --seq 2048

and on the CPU (plain versions of the kernels) with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

``--mixer ahla`` trains the same model with the AHLA mixer (its own
forward and backward kernels, the same parameter layout).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..data.pipeline import DataConfig, SyntheticStream
from ..distributed.steps import make_train_step
from ..models import lm
from ..models.param import init_params
from ..optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hla-1b")
    ap.add_argument("--mixer", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", default="zipf")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced, mixer=args.mixer)
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[train] {cfg.name} ({cfg.mixer}) on {name}")
    params = init_params(lm.lm_specs(cfg), args.seed, device)
    opt_cfg = adamw.OptConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 5))
    opt_state = adamw.init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg)
    stream = SyntheticStream(DataConfig(cfg.vocab, args.seq, args.batch,
                                        seed=args.seed, kind=args.data))
    step_s, tokens, loss = [], 0, float("nan")
    for step in range(args.steps):
        host = stream.batch(step)
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])  # waits for the step's device work
        step_s.append(time.perf_counter() - t0)
        tokens += host["tokens"].size
    p50, p99 = np.percentile(step_s, 50), np.percentile(step_s, 99)
    print(f"[train] finished at step {args.steps} | step p50 {p50:.3f}s "
          f"p99 {p99:.3f}s | {tokens / max(sum(step_s), 1e-9):.0f} tok/s | "
          f"loss {loss:.4f}")
    return params, opt_state, loss


if __name__ == "__main__":
    main()
