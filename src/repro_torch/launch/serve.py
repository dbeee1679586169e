"""Serving CLI — a thin shell over ``repro_torch.serving.engine.Engine``.

Continuous batching over fixed slots with chunk-parallel prefill admission
and step-locked block decode on seeded random weights; synthetic prompts
stand in for traffic.  Runs on the card by default:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hla-1b \
        --slots 4 --requests 8 --prompt-len 512 --gen-len 64 --block 8

and on the CPU (plain versions of the kernels) with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

``--mixer ahla`` swaps the arch's sequence op for AHLA (same weights
layout, its own kernels).  ``--spec ngram`` (prompt lookup) or ``--spec lm``
(a draft LM: ``--draft-arch``, reduced, random weights, the target's
vocabulary) decodes speculatively, ``--spec-k`` draft tokens a round:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --spec ngram
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import lm
from ..models.param import init_params
from ..serving.engine import Engine, GenRequest
from ..serving.sampling import SamplingConfig
from ..serving.spec import SpecConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hla-1b")
    ap.add_argument("--mixer", default=None,
                    help="override the arch's sequence op with a registered "
                         "one (hla2, ahla)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--sampling", default="greedy",
                    choices=["greedy", "temperature", "top_k", "top_p"])
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--spec", default="off", choices=["off", "ngram", "lm"],
                    help="speculative decoding drafter (off = plain blocks)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per speculative round")
    ap.add_argument("--draft-arch", default="hla-1b",
                    help="configs entry for the --spec lm draft model "
                         "(loaded reduced)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced, mixer=args.mixer)
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[serve] {cfg.name} on {name}")
    params = init_params(lm.lm_specs(cfg), args.seed, device)
    spec = None if args.spec == "off" else SpecConfig(
        k=args.spec_k, drafter=args.spec, draft_arch=args.draft_arch)
    engine = Engine(
        cfg, params, slots=args.slots,
        max_len=args.prompt_len + args.gen_len + 8,
        sampling=SamplingConfig(method=args.sampling,
                                temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p),
        block=args.block, seed=args.seed, device=device, spec=spec,
    )
    del params  # the engine keeps its own compute-dtype copy
    rng = np.random.RandomState(args.seed)
    requests = [
        GenRequest(rid=i, prompt=rng.randint(2, cfg.vocab,
                                             size=args.prompt_len),
                   max_new=args.gen_len)
        for i in range(args.requests)
    ]
    # warm up (kernel build, allocator, library handles) so TTFT and tok/s
    # measure steady state
    engine.run([GenRequest(rid=-1, prompt=requests[0].prompt,
                           max_new=args.block)])
    engine.reset_stats()
    engine.reset_breaker()  # warmup zero-acceptance must not leak
    t0 = time.perf_counter()
    results = engine.run(requests)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    st = engine.stats
    gen = st["generated_tokens"]
    # each request's first token comes from its prefill; count only
    # decode-block tokens against decode wall time
    decode_toks = max(gen - len(results), 0)
    ttft = np.asarray(st["ttft_s"]) if st["ttft_s"] else np.zeros(1)
    p50, p99 = np.percentile(ttft, 50), np.percentile(ttft, 99)
    decode_tps = decode_toks / st["decode_s"] if st["decode_s"] else 0.0
    print(
        f"[serve] {len(results)} requests, {gen} generated tokens in "
        f"{dt:.2f}s | TTFT p50 {1e3 * p50:.1f}ms p99 {1e3 * p99:.1f}ms "
        f"| decode {decode_tps:.1f} tok/s | "
        f"prefill {st['prompt_tokens'] / max(st['prefill_s'], 1e-9):.1f} "
        "tok/s"
    )
    if spec is not None:
        acc = st["spec_accepted"] / max(st["spec_drafted"], 1)
        print(
            f"[serve] spec: {st['spec_rounds']} rounds, acceptance "
            f"{acc:.2f}, {st['spec_replays']} rollbacks, "
            f"{decode_toks / max(st['spec_rounds'], 1):.2f} committed "
            "tok/round")
    statuses = collections.Counter(r.status for r in results)
    status_str = " ".join(
        f"{k}={statuses[k]}" for k in ("ok", "error") if statuses[k])
    print(f"[serve] statuses: {status_str or 'ok=0'} | "
          f"quarantined={st['quarantined']} "
          f"breaker_trips={st['breaker_trips']}")
    return results


if __name__ == "__main__":
    main()
