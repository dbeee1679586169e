#!/usr/bin/env python3
"""Does hla-1b's HLA2 train loss rise after the first AdamW update because
of depth, of where the weights were drawn, or of the batch?  On one NVIDIA
GPU, no options:

    python3 scripts/loss_rise_depth.py

hla-1b cut to 24, 12 or 6 layers (full width, fp32 activations), weights
from ``init_params(..., 0, device)`` drawn by the card's generator or by
the CPU's and then moved to the card, on ``SyntheticStream`` batch 0 (its
first 1 or 2 sequences of 2048 tokens).  Each runs three AdamW steps at
``chip_smoke.py``'s train schedule (lr 1e-5, one warmup step) and prints
the loss and gradient norm of each step.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# (layers, where the weights are drawn, sequences)
RUNS = [(24, "cuda", 2), (24, "cpu", 2), (24, "cpu", 1), (24, "cuda", 1),
        (12, "cuda", 2), (12, "cpu", 2), (6, "cuda", 2)]


def run(layers, draw, batch, dev, steps=3):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.param import init_params, tree_map
    from repro_torch.optim import adamw

    cfg = get_config("hla-1b").replace(dtype="float32", n_layers=layers)
    params = tree_map(lambda x: x.to(dev),
                      init_params(lm.lm_specs(cfg), 0,
                                  "cpu" if draw == "cpu" else dev))
    host = SyntheticStream(DataConfig(cfg.vocab, 2048, 2, seed=0)).batch(0)
    data = {k: torch.from_numpy(v[:batch]).to(dev) for k, v in host.items()}
    state = adamw.init_opt_state(params)
    step = make_train_step(cfg, adamw.OptConfig(lr=1e-5, warmup_steps=1,
                                                total_steps=5))
    seen = []
    t0 = time.perf_counter()
    for _ in range(steps):
        params, state, m = step(params, state, data)
        seen.append(f"{float(m['loss']):.4f}/{float(m['grad_norm']):.3f}")
    print(f"fp32 {layers} layers, weights drawn on {draw}, batch {batch} x "
          f"2048: loss/grad norm {' '.join(seen)} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("loss_rise_depth: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"on {torch.cuda.get_device_name(0)}", flush=True)
    for layers, draw, batch in RUNS:
        run(layers, draw, batch, dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
