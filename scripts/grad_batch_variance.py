#!/usr/bin/env python3
"""How far hla-1b's fp32 training gradient moves when only the row count
of its GEMMs changes, on one NVIDIA GPU (why ``chip_smoke.py`` phase 9 (a)
logs 2 microbatches against 1 and holds them to the rows' gradients).

    python3 scripts/grad_batch_variance.py

Full width, fp32 activations, the config's remat, seeded random weights,
phase 9's 2 x 2048 batch (row 0's first third of labels masked).  At 24
layers and at 1, it computes the loss and every parameter's gradient with
1 microbatch twice (bit-equal?), with 2 microbatches, with the batch's
rows swapped, with a third, fully masked row appended (the same gradient
in exact arithmetic), and from every weight moved one fp32 ulp up or down
at random; and row 0's logits in the batch of 2 against alone.  It prints each route's loss and per-leaf gradient error
relative to the 1-microbatch leaf's max|g|, largest first.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.param import init_params, tree_map

    if not torch.cuda.is_available():
        print("grad_batch_variance: no CUDA device", file=sys.stderr)
        return 1
    cs.CARD = cs.card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def show(label, a, b):
        e_l, errs = cs._grad_errs(a, b)
        cs.log(f"{label}: loss rel {e_l:.2e}; gradients " + ", ".join(
            f"{k} {v:.2e}" for k, v in sorted(errs.items(),
                                              key=lambda kv: -kv[1])))

    for layers in (24, 1):
        cfg = get_config("hla-1b").replace(dtype="float32", n_layers=layers)
        params = init_params(lm.lm_specs(cfg), 0, dev)
        batch = cs._uneven_batch(cfg, dev)

        def grads(p=params, b=batch, mb=1):
            loss, g = cs._loss_grads(p, b, cfg) if mb == 1 else \
                cs._grads_phase(dev, cfg, p, b, mb, f"{layers} layers, "
                                f"{mb} microbatches")
            return loss, (dict(zip(cs._flat(params), g)) if mb == 1
                          else cs._flat(g))

        one = grads()
        again = grads()
        cs.log(f"{layers} layers: 1 microbatch twice bit-equal: "
               f"{all(torch.equal(again[1][k], x) for k, x in one[1].items())}")
        show(f"{layers} layers, 2 microbatches vs 1", grads(mb=2), one)
        swapped = {k: v.flip(0).contiguous() for k, v in batch.items()}
        show(f"{layers} layers, rows swapped vs 1 microbatch",
             grads(b=swapped), one)
        padded = {"tokens": torch.cat([batch["tokens"],
                                       batch["tokens"][1:]]),
                  "labels": torch.cat([batch["labels"], torch.full_like(
                      batch["labels"][1:], -1)])}
        show(f"{layers} layers, a masked third row vs 1 microbatch",
             grads(b=padded), one)
        gen = torch.Generator(device=dev).manual_seed(1)

        def ulp(x):
            up = torch.rand(x.shape, generator=gen, device=dev) < 0.5
            return torch.nextafter(x, torch.where(up, torch.inf, -torch.inf))

        show(f"{layers} layers, every weight one ulp vs 1 microbatch",
             grads(p=tree_map(ulp, params)), one)
        with torch.no_grad():
            a = lm.lm_apply(params, batch["tokens"], cfg)[0][0]
            b = lm.lm_apply(params, batch["tokens"][:1], cfg)[0][0]
        cs.log(f"{layers} layers: row-0 logits in a batch of 2 vs alone: "
               f"max abs {float((a - b).abs().max()):.3e}, rel "
               f"{cs.rel_err(a, b):.3e}")
        del params, one, again, a, b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
