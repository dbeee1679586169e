"""Quickstart (PyTorch port): train a small HLA2 language model for a few
hundred steps.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 300] [--device cpu]

Twin of ``examples/quickstart.py`` on ``src/repro_torch``, with the same
flags and defaults plus ``--device`` (default ``cuda``): config -> specs ->
init -> train step (AdamW, in place) -> loss curve on the zipf
``SyntheticStream``.  On the card the mixer runs the HLA2 chunk kernels
(forward and backward); on the CPU their plain versions.  Loss should drop
well below the uniform baseline ln(vocab).
"""

import argparse
import math
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.distributed import steps as steps_mod
from repro_torch.models import lm
from repro_torch.models.param import init_params, param_count
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu")
    device = torch.device(args.device)

    cfg = get_config("hla-1b", reduced=True).replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512,
    )
    specs = lm.lm_specs(cfg)
    print(f"model: {cfg.name} ({param_count(specs):,} params, mixer={cfg.mixer})")
    params = init_params(specs, 0, device)
    opt_cfg = adamw.OptConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    opt_state = adamw.init_opt_state(params)
    step = steps_mod.make_train_step(cfg, opt_cfg)

    stream = SyntheticStream(
        DataConfig(cfg.vocab, args.seq, args.batch, seed=0, kind="zipf")
    )
    first = None
    for s in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in stream.batch(s).items()}
        params, opt_state, m = step(params, opt_state, batch)
        if s == 0:
            first = float(m["loss"])
        if s % 25 == 0:
            print(f"step {s:4d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}")
    last = float(m["loss"])
    print(f"\nuniform baseline ln({cfg.vocab}) = {math.log(cfg.vocab):.3f}")
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'OK: learning' if last < first * 0.7 else 'WARN: check setup'})")


if __name__ == "__main__":
    main()
