"""Expressivity comparison on associative recall (PyTorch port): HLA2 /
AHLA / HLA3 vs first-order linear attention vs softmax attention.

    PYTHONPATH=src python examples/torch_hla_vs_baselines.py [--steps 400] [--device cpu]

Twin of ``examples/hla_vs_baselines.py`` on ``src/repro_torch``, with the
same flags, defaults and lines plus ``--device`` (default ``cuda``).  The
paper positions HLA's data-dependent metric S^K as strictly richer than
first-order linearizations (Section 3, 'Connection with linear
attention'); associative recall (k1 v1 k2 v2 ... query-k -> v) is the
standard probe.  Each mixer trains reduced hla-1b (2 layers, d_model 128)
with AdamW and reports its recall accuracy.  On the card ``hla2`` and
``ahla`` train through their chunk kernels (forward and backward);
``softmax``, ``linattn`` and ``hla3`` are plain torch.
"""

import argparse
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.distributed import steps as steps_mod
from repro_torch.models import lm
from repro_torch.models.param import init_params
from repro_torch.optim import adamw

MIXERS = ("softmax", "linattn", "hla2", "ahla", "hla3")


def config(mixer):
    cfg = get_config("hla-1b", reduced=True).replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=64,
    )
    if mixer != "hla2":
        cfg = cfg.replace(mixer=mixer)
    return cfg


def _batch(stream, step, device):
    return {k: torch.from_numpy(v).to(device)
            for k, v in stream.batch(step).items()}


@torch.no_grad()
def accuracy(params, cfg, stream, device, steps=5):
    hits = tot = 0
    for s in range(1000, 1000 + steps):
        b = _batch(stream, s, device)
        logits, _, _ = lm.lm_apply(params, b["tokens"], cfg, mode="train")
        pred = logits.argmax(-1)
        mask = b["labels"] >= 0
        hits += int((pred[mask] == b["labels"][mask]).sum())
        tot += int(mask.sum())
    return hits / max(tot, 1)


def run(mixer, args, device):
    cfg = config(mixer)
    stream = SyntheticStream(
        DataConfig(cfg.vocab, args.seq, args.batch, seed=0, kind="recall")
    )
    params = init_params(steps_mod.model_specs(cfg), 0, device)
    opt_cfg = adamw.OptConfig(lr=3e-3, warmup_steps=30,
                              total_steps=args.steps, weight_decay=0.01)
    opt = adamw.init_opt_state(params)
    step = steps_mod.make_train_step(cfg, opt_cfg)
    for s in range(args.steps):
        params, opt, m = step(params, opt, _batch(stream, s, device))
    acc = accuracy(params, cfg, stream, device)
    print(f"{mixer:10s} recall accuracy: {acc*100:5.1f}%  "
          f"(final loss {float(m['loss']):.3f})")
    return acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=18)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu")
    device = torch.device(args.device)
    for mixer in MIXERS:
        run(mixer, args, device)


if __name__ == "__main__":
    main()
