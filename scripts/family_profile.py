#!/usr/bin/env python3
"""Where the time of the plain HLA records goes on one NVIDIA GPU.

    python3 scripts/family_profile.py

For hla-1b at full width (24 layers, d_model 2048, seeded random weights)
with ``--mixer hla3``, ``hla3_paper`` and ``linattn`` (plain PyTorch, none
of the hand-written kernels), and with ``hla2`` (its kernels) beside them,
it profiles with ``torch.profiler`` (after a warmup call each):

* one admission prefill of a 450-token prompt (bf16 activations),
* one decode step over 4 slots (bf16),
* for ``hla3`` and ``hla2`` one AdamW train step at 2 x 2048 with the
  config's ``remat="full"`` (bf16 activations, fp32 parameters),

and prints per call: the host wall time (ending in a synchronize), the
summed device time of its CUDA kernels, the device's idle share of the
wall time (1 - device / wall, kernels counted as if they never overlap),
the number of kernel launches, and the five kernels with the most device
time.  fp32 matmuls run in full fp32 (TF32 off), as ``chip_smoke.py``
sets it.
"""

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _profile(label, fn, card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warmup
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device rows of the table: kernels, copies and fills, each with
    # its own device time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3  # ms
    top = sorted(((e.key, e.self_device_time_total / 1e3) for e in rows),
                 key=lambda kv: -kv[1])[:5]
    print(f"[{card}] {label}: wall {1e3 * wall:.1f} ms | device "
          f"{busy:.1f} ms in {sum(e.count for e in rows)} launches | idle "
          f"{1 - busy / (1e3 * wall):.1%} | top: "
          + "; ".join(f"{name[:60]} {ms:.1f} ms" for name, ms in top),
          flush=True)


def main():
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.param import init_params
    from repro_torch.optim import adamw

    if not torch.cuda.is_available():
        print("family_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    dev = torch.device("cuda", 0)
    base = get_config("hla-1b")
    params = init_params(lm.lm_specs(base), 0, dev)
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(2, base.vocab, (1, 450))).to(dev)
    tok = torch.from_numpy(rng.randint(2, base.vocab, (4, 1))).to(dev)
    for mixer in ("hla2", "hla3", "hla3_paper", "linattn"):
        cfg = base.replace(mixer=mixer)
        cast = lm.cast_params(params, cfg)
        with torch.no_grad():
            _profile(f"{mixer} prefill of 450 tokens",
                     lambda: lm.lm_prefill(cast, prompt, cfg), card)
            states = lm.lm_init_states(cfg, 4, dev)
            _profile(f"{mixer} decode step, 4 slots",
                     lambda: lm.lm_apply(cast, tok, cfg, states=states,
                                         mode="decode"), card)
        del cast, states
    del params
    host = SyntheticStream(DataConfig(base.vocab, 2048, 2, seed=0)).batch(0)
    data = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    for mixer in ("hla2", "hla3"):
        cfg = base.replace(mixer=mixer)
        params = init_params(lm.lm_specs(cfg), 0, dev)
        state = adamw.init_opt_state(params)
        step = make_train_step(cfg, adamw.OptConfig(lr=1e-5, warmup_steps=1,
                                                    total_steps=4))

        def run():
            step(params, state, data)  # updates params and state in place

        _profile(f"{mixer} train step, 2 x 2048, remat {cfg.remat}", run,
                 card)
        del params, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
