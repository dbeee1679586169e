#!/usr/bin/env python3
"""How far hla-1b's training gradient moves between two correct
implementations of a mixer's chunk kernels, on one NVIDIA GPU.

    python3 scripts/grad_spread.py

At full width (24 layers, d_model 2048, seeded random weights,
``chip_smoke.py``'s 2 x 2048 train batch), in the config's bf16
activations and then in fp32, it computes the step-0 loss and every
parameter's gradient twice for each mixer: through the CUDA chunk
kernels (mixer ``hla2`` or ``ahla``) and through their plain PyTorch
versions on the card (mixer ``hla2_plain`` or ``ahla_plain``, registered
here: the mixer's record with the plain versions in the same autograd
Function).  For each it then runs three AdamW steps at ``chip_smoke.py``'s
schedule (lr 1e-5, one warmup step) and prints the loss and gradient norm
of each; last, per parameter leaf, the two gradients' norms and their
largest difference relative to max|plain|.
"""

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _register_plain(name):
    """Register ``<name>_plain``: the ``name`` mixer whose training path
    runs the plain forward and backward (same weights layout)."""
    from repro_torch.kernels import ahla_chunk, hla2_chunk, ops
    from repro_torch.models import mixer, seq_op

    mod = {"hla2": hla2_chunk, "ahla": ahla_chunk}[name]
    fwd = getattr(mod, f"{name}_chunk_fwd_plain")
    bwd = getattr(mod, f"{name}_chunk_bwd_plain")

    def core_fwd(q, k, v, gamma, hc, *, state, want_state):
        assert state is None and not want_state, "training path only"
        kw = dict(normalize=hc.normalize, eps=mixer.HLA_EPS)
        if name == "hla2":
            kw["lam"] = hc.lam
        return ops._ChunkAttention.apply(fwd, bwd, kw, q, k, v, gamma), None

    op = seq_op.op_for(_cfg(name))
    seq_op.register_op(dataclasses.replace(
        op, name=f"{name}_plain", forward=mixer._sublayer_forward(core_fwd)))


def _cfg(mixer_name, dtype=None):
    from repro_torch.configs import get_config

    cfg = get_config("hla-1b").replace(mixer=mixer_name)
    return cfg if dtype is None else cfg.replace(dtype=dtype)


def _run(cfg, data, dev):
    """Step-0 loss and gradient of ``cfg``'s model, then three AdamW steps;
    prints both and returns ``(leaf paths, gradients)``."""
    import torch

    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.param import init_params, leaf_paths, tree_map
    from repro_torch.optim import adamw

    live = tree_map(lambda x: x.requires_grad_(True),
                    init_params(lm.lm_specs(cfg), 0, dev))
    loss, _ = lm.lm_loss(live, data["tokens"], data["labels"], cfg)
    paths = ["/".join(p) for p, _ in leaf_paths(live)]
    grads = torch.autograd.grad(loss, [x for _, x in leaf_paths(live)])
    norm = float(torch.sqrt(sum((x.float() ** 2).sum() for x in grads)))
    print(f"{cfg.mixer} ({cfg.dtype}): step-0 loss "
          f"{float(loss.detach()):.6f} grad norm {norm:.4f}", flush=True)
    del live, loss
    params = init_params(lm.lm_specs(cfg), 0, dev)
    state = adamw.init_opt_state(params)
    step = make_train_step(cfg, adamw.OptConfig(lr=1e-5, warmup_steps=1,
                                                total_steps=5))
    seen = []
    for _ in range(3):
        params, state, m = step(params, state, data)
        seen.append(f"{float(m['loss']):.4f}/{float(m['grad_norm']):.3f}")
    print(f"{cfg.mixer} ({cfg.dtype}): 3 AdamW steps, loss/grad norm "
          f"{' '.join(seen)}", flush=True)
    return paths, grads


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("grad_spread: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.data.pipeline import DataConfig, SyntheticStream

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"on {torch.cuda.get_device_name(0)}", flush=True)
    vocab = _cfg("hla2").vocab
    host = SyntheticStream(DataConfig(vocab, 2048, 2, seed=0)).batch(0)
    data = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    for name in ("hla2", "ahla"):
        _register_plain(name)
        for dtype in (None, "float32"):
            paths, kernel = _run(_cfg(name, dtype), data, dev)
            _, plain = _run(_cfg(f"{name}_plain", dtype), data, dev)
            for path, a, b in zip(paths, kernel, plain):
                a, b = a.float(), b.float()
                print(f"  {path}: |kernel| {float(a.norm()):.4e} |plain| "
                      f"{float(b.norm()):.4e} max|diff|/max|plain| "
                      f"{float((a - b).abs().max() / b.abs().max()):.3e}")
            del kernel, plain
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
