"""Serving CLI — a thin shell over ``repro_torch.serving.engine.Engine``.

Continuous batching over fixed slots with chunk-parallel prefill admission
and step-locked block decode on seeded random weights; synthetic prompts
stand in for traffic.  Runs on the card by default:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hla-1b \
        --slots 4 --requests 8 --prompt-len 512 --gen-len 64 --block 8

and on the CPU (plain versions of the kernels) with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Started by ``torchrun`` it serves on a ``("data", "model")`` mesh over all
its ranks (``launch/mesh.py::mesh_from_env``): ``Engine(mesh=)`` with the
parameters and slot states as DTensors, every rank producing the same
streams, ``--spec``, ``--cache-mb`` and ``--stream`` included (the draft
LM's pool on the mesh too; cache entries are whole host states, the same
on every rank).  On 2 or 4 CPU ranks:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --reduced --device cpu --spec lm --cache-mb 1 --cache-chunk 16 \
        --shared-prefix 32 --prompt-len 48 --stream

and on cards the same without ``--reduced --device cpu`` (NCCL, a rank a
card).

``--arch`` takes every arch of ``configs/`` (hla-1b, codeqwen1.5-7b,
qwen2-72b, deepseek-67b, nemotron-4-15b, internvl2-2b, and the MoE
granite-moe-3b-a800m and qwen3-moe-30b-a3b).  ``--mixer ahla`` swaps the
arch's sequence op for AHLA (same weights layout, its own kernels);
``--mixer hla3``, ``hla3_paper`` or ``linattn`` for the rest of the HLA
family (same weights layout, plain torch); ``--mixer gla`` for gated
linear attention (its own weights layout, plain torch).  The engine
serves streaming ops only: an arch whose op is softmax attention
(``attn``, the seven public configs) serves with an HLA mixer in its
place, e.g. ``--arch granite-moe-3b-a800m --mixer hla2``, and without
one the engine refuses it, as the reference's does.  rwkv6-7b serves its
self-contained RWKV-6 layers (no override: it is attention-free); the
engine refuses the hybrid jamba-1.5-large-398b with any mixer, as the
reference's does, and the CLI exits with its message before allocating
parameters.  ``--arch whisper-small`` (with a streaming ``--mixer``)
serves a decoder-only stack of whisper's widths, with no encoder, as the
reference's CLI does (it builds ``lm_specs`` whatever the arch); whisper
itself serves through ``models.whisper.whisper_apply`` and the step
factories of ``distributed/steps.py``.  ``--spec ngram`` (prompt lookup)
or ``--spec lm`` (a draft LM: ``--draft-arch``, reduced, random weights,
the target's vocabulary) decodes speculatively, ``--spec-k`` draft tokens
a round.

The serving front-end:

* ``--stream`` serves through the asyncio front-end
  (``serving.server.AsyncServer``): per-token async streams, backpressure,
  graceful drain;
* ``--cache-mb N`` attaches a prefix/state cache of N MiB of host memory
  keyed every ``--cache-chunk`` tokens; ``--shared-prefix T`` gives every
  synthetic prompt the same first T tokens, so admissions after the first
  resume from a cached snapshot;
* ``--deadline-s`` gives every request a wall-clock budget (expiry ->
  ``status=timeout``); ``--inject point[@at[+]][:arg]`` (repeatable)
  schedules deterministic faults from ``runtime.faults`` — e.g.
  ``engine.nan_state@1:0`` poisons slot 0's state before the 2nd decode
  block (quarantine);
* ``--metrics-out`` / ``--events-out`` write the measured run's metrics
  snapshot (``repro.obs.metrics/v1``) and event log
  (``repro.obs.events/v1``), which ``python -m repro_torch.obs.validate``
  checks; ``--profile-dir`` captures a ``torch.profiler`` trace of it.

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --stream --cache-mb 1 --cache-chunk 16 \
        --shared-prefix 32 --prompt-len 48 --inject engine.nan_state@1:0 \
        --metrics-out m.json --events-out e.jsonl
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from ..configs import get_config
from ..distributed import sharding as shd
from ..distributed.steps import with_param_dtype
from ..models import lm, seq_op
from ..models.param import init_params
from ..obs import JsonlSink, Obs, profile_capture, write_metrics
from ..runtime.faults import FaultPlan, parse_fault
from ..serving import Engine, GenRequest, PrefixCache, SamplingConfig
from ..serving.engine import check_servable
from ..serving.spec import SpecConfig
from .mesh import mesh_from_env, mesh_summary

#: default cache key granularity: hla-1b's chunk width in the reference
#: config (a multiple of the port's 64-token kernel chunk)
CACHE_CHUNK = 128


def _run_streaming(engine, requests):
    """Serve through the asyncio front-end: every request submitted
    concurrently, each stream consumed by its own task, graceful drain on
    exit.  Results come back in request order (as ``engine.run``)."""
    import asyncio

    from ..serving.server import AsyncServer, collect

    async def _main():
        async with AsyncServer(engine) as srv:
            outs = await asyncio.gather(*[collect(srv, r)
                                          for r in requests])
        return [res for _, res in outs]

    return asyncio.run(_main())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hla-1b")
    ops = seq_op.registered_op_names()
    ap.add_argument("--mixer", default=None, choices=ops,
                    help="override the arch's sequence op with a registered "
                         f"one ({', '.join(ops)})")
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
    ap.add_argument("--stream", action="store_true",
                    help="serve through the asyncio streaming front-end "
                         "(serving.server.AsyncServer)")
    ap.add_argument("--cache-mb", type=float, default=0.0,
                    help="prefix/state cache budget in MiB of host memory "
                         "(0 = no cache)")
    ap.add_argument("--cache-chunk", type=int, default=0,
                    help="cache key granularity in tokens (0 = "
                         f"{CACHE_CHUNK})")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens shared by every synthetic prompt — nonzero "
                         "exercises prefix-cache hits")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget; expiry -> "
                         "status=timeout with the partial stream")
    ap.add_argument("--inject", action="append", default=[],
                    metavar="POINT[@AT[+]][:ARG]",
                    help="schedule a deterministic fault (runtime.faults "
                         "catalog; repeatable)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the final metrics registry snapshot "
                         "(repro.obs.metrics/v1 JSON) on exit")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="stream span/event records (repro.obs.events/v1 "
                         "JSONL) of the measured run")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the measured "
                         "traffic (not the warmup) into DIR")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced, mixer=args.mixer)
    mesh, device = mesh_from_env(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    where = name if mesh is None else f"{mesh_summary(mesh)} of {name}"
    print(f"[serve] {cfg.name} on {where}")
    spec = None if args.spec == "off" else SpecConfig(
        k=args.spec_k, drafter=args.spec, draft_arch=args.draft_arch)
    try:  # the engine's refusal, before any parameter is allocated
        check_servable(cfg, spec)
    except ValueError as e:
        raise SystemExit(f"[serve] {cfg.name} ({cfg.mixer}): {e}") from None
    # the decoder-only stack whatever the arch (the reference's CLI)
    specs = with_param_dtype(lm.lm_specs(cfg), cfg)
    params = init_params(specs, args.seed, device)
    if mesh is not None:  # every rank drew the same values: keep its block
        params = shd.distribute(params, shd.param_shardings(specs, mesh),
                                mesh)
    engine = Engine(
        cfg, params, slots=args.slots,
        max_len=args.prompt_len + args.gen_len + 8,
        sampling=SamplingConfig(method=args.sampling,
                                temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p),
        block=args.block, seed=args.seed, device=device, spec=spec,
        obs=Obs(), mesh=mesh,
    )
    del params  # the engine keeps its own compute-dtype copy
    rng = np.random.RandomState(args.seed)
    shared = min(args.shared_prefix, args.prompt_len)
    prefix = rng.randint(2, cfg.vocab, size=shared)
    requests = [
        GenRequest(rid=i, prompt=np.concatenate([
            prefix, rng.randint(2, cfg.vocab, size=args.prompt_len - shared),
        ]).astype(np.int64), max_new=args.gen_len,
            deadline_s=args.deadline_s)
        for i in range(args.requests)
    ]
    # warm up (kernel build, allocator, library handles) through the
    # measured execution mode, so TTFT and tok/s measure steady state
    runner = _run_streaming if args.stream else (
        lambda eng, reqs: eng.run(reqs))
    runner(engine, [GenRequest(rid=-1, prompt=requests[0].prompt,
                               max_new=args.block)])
    cache = None
    if args.cache_mb > 0:
        gran = args.cache_chunk or CACHE_CHUNK
        budget = int(args.cache_mb * 2**20)
        if shared and shared < gran + 1:
            print(f"[serve] note: shared prefix {shared} <= cache "
                  f"granularity {gran}: no cache hits possible")
        # warm the carry and resume paths against a throwaway cache, so
        # the measured run's first hit pays a lookup, not a first launch
        engine.cache = PrefixCache(granularity=gran, budget_bytes=budget)
        for rid in (-2, -3):  # miss + insert, then hit + resume
            runner(engine, [GenRequest(rid=rid, prompt=requests[0].prompt,
                                       max_new=2)])
        cache = PrefixCache(granularity=gran, budget_bytes=budget,
                            namespace=cfg.name, obs=engine.obs)
        engine.cache = cache
    # fresh obs epoch: the artifacts below describe only measured traffic
    engine.obs.reset()
    engine.reset_breaker()  # warmup zero-acceptance must not leak
    sink = None
    if args.events_out:
        sink = JsonlSink(args.events_out,
                         epoch_offset_ns=engine.obs.tracer.epoch_offset_ns)
        engine.obs.attach(sink)
    # attach the fault plan after the warmup, so hit counts start at the
    # measured traffic
    if args.inject:
        engine.faults = FaultPlan(*[parse_fault(s) for s in args.inject])
    t0 = time.perf_counter()
    with profile_capture(args.profile_dir, obs=engine.obs):
        results = runner(engine, requests)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    st = engine.stats
    gen = st["generated_tokens"]
    # each request's first token comes from its prefill; count only
    # decode-block tokens against decode wall time (non-ok results may
    # have produced no tokens at all)
    decode_toks = max(gen - len(results), 0)
    reg = engine.obs.registry
    # submission -> first token, and the part of it spent queued
    ttft, wait = (tuple(1e3 * (reg.get(name).quantile(q) or 0.0)
                        for q in (0.5, 0.99))
                  for name in ("serving_ttft_seconds",
                               "sched_queue_wait_seconds"))
    decode_tps = decode_toks / st["decode_s"] if st["decode_s"] else 0.0
    print(
        f"[serve] {len(results)} requests, {gen} generated tokens in "
        f"{dt:.2f}s | TTFT p50 {ttft[0]:.1f}ms p99 {ttft[1]:.1f}ms "
        f"(queued p50 {wait[0]:.1f}ms p99 {wait[1]:.1f}ms) "
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
        f"{k}={statuses[k]}" for k in ("ok", "error", "timeout", "cancelled")
        if statuses[k])
    print(f"[serve] statuses: {status_str or 'ok=0'} | "
          f"quarantined={st['quarantined']} "
          f"breaker_trips={st['breaker_trips']}")
    if cache is not None:
        cs = cache.stats()
        print(
            f"[serve] cache: {int(cs['entries'])} entries "
            f"{cs['bytes'] / 2**20:.2f} MiB | hit rate "
            f"{cs['hit_rate']:.2f} ({int(cs['hits'])} hits, "
            f"{int(cs['misses'])} misses, "
            f"{int(cs['evicted_bytes'])} bytes evicted)")
    if sink is not None:
        sink.close()
        print(f"[serve] events -> {args.events_out}")
    if args.metrics_out:
        write_metrics(engine.obs.snapshot(), args.metrics_out)
        print(f"[serve] metrics -> {args.metrics_out}")
    return results


if __name__ == "__main__":
    main()
