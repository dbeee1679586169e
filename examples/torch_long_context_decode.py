"""Long-context decode with O(1) state (PyTorch port) — the paper's
headline property.

    PYTHONPATH=src python examples/torch_long_context_decode.py [--ctx 4096] [--device cpu]

Twin of ``examples/long_context_decode.py`` on ``src/repro_torch``, with
the same flags and defaults plus ``--device`` (default ``cuda``).  Streams
a long context token by token through the HLA2 recurrence (one decode-step
launch per layer and token on the card, the state updated in place); the
state size is CONSTANT however long the context gets, against a KV cache
growing linearly.  Prints state-vs-cache bytes and decode throughput at
several context lengths.  The state bytes are read from meta tensors;
softmax attention is not ported, so the KV cache's bytes are reckoned from
the config in the reference's ``KVCache`` layout (``kv_cache_bytes``).
"""

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.param import init_params
from repro_torch.serving.sampling import SamplingConfig, sample


def state_bytes(states):
    return sum(x.numel() * x.element_size() for x in states)


def kv_cache_bytes(cfg, B: int, ctx: int) -> int:
    """Bytes of the reference's softmax-attention decode state for ``cfg``
    at ``ctx`` tokens: per layer a ``KVCache`` of bf16 ``k`` and ``v``
    ``(B, n_kv_heads, ctx, head_dim)`` and an int32 ``length``."""
    kv = 2 * B * cfg.n_kv_heads * ctx * cfg.head_dim * 2
    return cfg.n_layers * (kv + 4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--sampling", default="greedy",
                    choices=["greedy", "temperature", "top_k"])
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu")
    device = torch.device(args.device)
    scfg = SamplingConfig(
        method=args.sampling, temperature=args.temperature, top_k=args.top_k
    )

    cfg = get_config("hla-1b", reduced=True)
    params = init_params(lm.lm_specs(cfg), 0, device)
    B = args.batch

    sb = state_bytes(lm.lm_init_states(cfg, B, torch.device("meta")))
    print(f"HLA2 state:  {sb/2**20:8.2f} MiB  (constant in context)")
    print(f"KV cache @ {args.ctx}: "
          f"{kv_cache_bytes(cfg, B, args.ctx)/2**20:8.2f} MiB  "
          "(linear in context)")

    states = lm.lm_init_states(cfg, B, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    @torch.no_grad()
    def step(tok):
        logits, _ = lm.lm_apply(params, tok, cfg, states=states,
                                mode="decode")  # states updated in place
        return sample(logits[:, -1], gen, scfg)[:, None]  # serving sampler

    tok = torch.ones((B, 1), dtype=torch.long, device=device)
    rng = np.random.RandomState(args.seed)
    checkpoints = [args.ctx // 4, args.ctx // 2, args.ctx]
    t0 = time.time()
    for t in range(args.ctx):
        if t % 64 == 0:  # inject fresh context tokens periodically
            tok = torch.from_numpy(rng.randint(2, cfg.vocab, (B, 1))).to(
                device)
        tok = step(tok)
        if (t + 1) in checkpoints:
            if device.type == "cuda":
                torch.cuda.synchronize(device)  # the steps so far are done
            dt = time.time() - t0
            print(f"ctx {t+1:7d}: {(t+1)*B/dt:8.1f} tok/s, "
                  f"state still {state_bytes(states)/2**20:.2f} MiB")
    print("decode state never grew — O(1) memory per token (paper §1).")


if __name__ == "__main__":
    main()
