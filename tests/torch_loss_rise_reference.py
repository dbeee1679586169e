"""Not a test (pytest does not collect this file): hla-1b at full width
and depth (24 layers, fp32) on the CPU, batch 1 x 2048 of SyntheticStream
batch 0: the loss, the gradient norm, and the loss after the first AdamW
update at chip_smoke.py's train schedule (lr 1e-5, one warmup step),
reference and port from the same weights, each side in its own process:

    PYTHONPATH=src python tests/torch_loss_rise_reference.py ref   # writes build/w24.npz
    PYTHONPATH=src python tests/torch_loss_rise_reference.py port  # reads it

Each side takes about two minutes and 16 (reference) to 25 (port) GB of
host memory; the weights file takes 5.7 GB.

The update is the packages' own adamw_update applied leaf by leaf (step 1
from zero moments, the gradient clipped by its global norm first), which
equals the whole-tree update and keeps the host's memory near 2 copies of
the weights."""

import dataclasses
import math
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

NPZ = ROOT / "build" / "w24.npz"
SEQ, BATCH = 2048, 1
KW = dict(lr=1e-5, warmup_steps=1, total_steps=5)


def ref():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, SyntheticStream
    from repro.models import lm
    from repro.models.param import init_params
    from repro.optim import adamw
    cfg = get_config("hla-1b").replace(dtype="float32")
    params = init_params(lm.lm_specs(cfg), jax.random.key(0))
    flat, tdef = jax.tree_util.tree_flatten_with_path(params)
    np.savez(NPZ, **{"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
                     for p, x in flat})
    host = SyntheticStream(DataConfig(cfg.vocab, SEQ, 2, seed=0)).batch(0)
    toks, labels = (jnp.asarray(host[k][:BATCH]) for k in ("tokens", "labels"))
    loss_fn = jax.jit(lambda p: lm.lm_loss(p, toks, labels, cfg)[0])
    t0 = time.time()
    loss0, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    gnorm = float(adamw.global_norm(grads))
    print(f"ref: step-0 loss {float(loss0):.6f} grad norm {gnorm:.6f} "
          f"({time.time() - t0:.0f}s)", flush=True)
    scale = min(1.0, 1.0 / max(gnorm, 1e-9))
    ocfg = dataclasses.replace(adamw.OptConfig(**KW), grad_clip=math.inf)
    gl = jax.tree_util.tree_leaves(grads)
    del grads
    new = []
    for i, (p, x) in enumerate(flat):
        g = gl[i] * scale
        gl[i] = None
        t = {"x": x}
        out, _, _ = adamw.adamw_update(t, {"x": g}, adamw.init_opt_state(t), ocfg)
        new.append(out["x"])
    del params, flat
    loss1 = float(loss_fn(jax.tree_util.tree_unflatten(tdef, new)))
    print(f"ref: loss after one AdamW update {loss1:.6f}", flush=True)


def port():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.models import lm
    from repro_torch.models.param import from_jax_params, leaf_paths
    from repro_torch.optim import adamw
    cfg = get_config("hla-1b").replace(dtype="float32")
    with np.load(NPZ) as z:
        tree = {}
        for key in z.files:
            node = tree
            *head, last = key.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = z[key]
    params = from_jax_params(tree, lm.lm_specs(cfg), device="cpu")
    del tree
    host = SyntheticStream(DataConfig(cfg.vocab, SEQ, 2, seed=0)).batch(0)
    toks, labels = (torch.from_numpy(host[k][:BATCH]) for k in ("tokens", "labels"))
    t0 = time.time()
    live = [x.requires_grad_(True) for _, x in leaf_paths(params)]
    loss0, _ = lm.lm_loss(params, toks, labels, cfg)
    grads = list(torch.autograd.grad(loss0, live))
    gnorm = float(torch.sqrt(sum(g.square().sum() for g in grads)))
    print(f"port: step-0 loss {float(loss0.detach()):.6f} grad norm {gnorm:.6f} "
          f"({time.time() - t0:.0f}s)", flush=True)
    del loss0
    scale = min(1.0, 1.0 / max(gnorm, 1e-9))
    ocfg = dataclasses.replace(adamw.OptConfig(**KW), grad_clip=math.inf)
    with torch.no_grad():
        for (path, x), i in zip(leaf_paths(params), range(len(grads))):
            t = {"x": x.detach()}
            out, _, _ = adamw.adamw_update(t, {"x": grads[i] * scale},
                                           adamw.init_opt_state(t), ocfg)
            grads[i] = None
            x.requires_grad_(False)
            x.copy_(out["x"])
        loss1, _ = lm.lm_loss(params, toks, labels, cfg)
    print(f"port: loss after one AdamW update {float(loss1):.6f}", flush=True)


if __name__ == "__main__":
    {"ref": ref, "port": port}[sys.argv[1]]()
