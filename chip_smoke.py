#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code nonzero, no result line):

1. build the hand-written kernels from ``src/repro_torch/csrc`` (six: the
   HLA2 chunkwise forward, decode step and chunkwise backward, the AHLA
   chunkwise forward, decode step and chunkwise backward; one nvcc per
   source, all at once), print nvcc's register report and the four
   chunk kernels' shared memory, and fail on a spill in a step kernel;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (hla-1b rows, head dim 128): the forwards and the
   steps at serving shapes (the steps over 4 tokens in a row, also at
   d = 16 and at a ragged d = 72, dv = 40), the forwards at the verify
   shape too (64 rows x k+1 = 5 tokens and 1 token, with and without a
   carry, which must be left as it was), the forwards' checkpoints and
   the backwards at the train phase's (32 rows x 2048 tokens), the
   backwards' normalize (and HLA2's lam) cases at d = 16 and across the
   column tiles of d = 128; at phase 12's rows (codeqwen1.5-7b's 32
   heads): the forwards at 32 rows, the steps at 128, HLA2's backward and
   forward with checkpoints at 64 rows x 2048 tokens; and at phase 13's
   (granite-moe-3b-a800m's 24 heads of d = dv = 64): the forwards at 24
   rows, the steps at 96, both backwards and forwards with checkpoints at
   48 rows x 2048 and 300 tokens; and at phase 14's (jamba-1.5-large-398b's
   64 heads of 128, 8 KV heads broadcast): HLA2's forward at 128 rows x
   300 tokens, its step at 128 rows, its backward and forward with
   checkpoints at 64 rows x 1024 tokens; and at phase 15's (whisper-small's
   12 heads of d = dv = 64): the forwards at 48 rows x 224 tokens and x 4
   (one partial chunk, no carry), the steps at 48 rows, both backwards
   and forwards with checkpoints at 96 rows x 448 tokens;
3. check the port against its plain path on a small model (card vs CPU):
   prefill + decode logits, and the training loss and every parameter's
   gradient, with either mixer; and at full width that prefill(L) + one
   decode step equals prefill(L + 1) for hla-1b with either mixer (24
   layers, seeded random weights, fp32);
4. serve 8 hla-1b requests through the port's ``Engine`` (bf16, 4 slots),
   once with the HLA2 mixer and once with AHLA (``mixer="ahla"``), count
   the kernel launches of each run and time the chunk kernel's launches in
   it (4b: then one ``torch.profiler`` window over 3 plain HLA2 decode
   blocks of that engine's shape says where a decode step's host time
   goes);
5. serve the same requests speculatively (``Engine(spec=...)``, k = 4),
   with either mixer on the same weights: in fp32, speculative greedy with
   the n-gram drafter and with an always-wrong drafter (every round rolls
   back) must equal plain greedy token for token; in bf16, with the n-gram
   and the draft-LM drafter (reduced hla-1b, random weights), log decode
   tok/s, acceptance, rounds, replays and ms per round, and fail where a
   stream parts from plain bf16 greedy at a top-2 logit gap above the
   bound the phase measures; every run serves all requests ``ok``, trips
   no breaker, and launches exactly the kernels its stats imply (target
   and draft model), no plain version;
8. (runs after phase 5) the serving front-end, full hla-1b, either mixer:
   (a) fp32, the requests of a shared 384-token prefix with a prefix cache
   (granularity 128) equal the same engine's streams without one, hits
   resume at 384 and some advance and insert at 512, one injected
   ``cache.corrupt`` is dropped; (b) bf16 through ``AsyncServer``, 16
   requests (2 tenants, 2 priorities, 4 slots) with a 3-entry cache (LRU
   evicts), one expiring queued, one cancelled, one ``engine.nan_state``:
   exactly those statuses, the quarantined slot's neighbours keep their
   streams, the metrics and events pass ``repro_torch.obs.validate``;
   HLA2 also with the n-gram drafter and one ``drafter.propose``; then the
   time split of a hit admission (crc32, restore, suffix prefill,
   snapshot).  Every run launches exactly 24 chunk kernels per admission,
   carry advance and spec round and 24 step kernels per decode or replay
   step, and no plain version;
6. train hla-1b at full width and depth for 5 AdamW steps on one repeated
   2 x 2048 batch, once with either mixer, with the config's per-layer
   remat (``remat="full"``), count the kernel launches of each run (per
   step 48 forward, 24 of them the backward's recompute, + 24 backward of
   its mixer's kernels, no other, no plain version) and check the loss
   falls; then the same 5 steps without remat (24 + 24), to log what
   recomputing costs in step time and peak memory;
9. (runs after phase 6) full hla-1b, HLA2, on one fp32 2 x 2048 batch
   whose labels are masked unevenly across the microbatch boundary:
   (b) ``remat="full"`` against ``"none"``: the loss and every gradient
   leaf within ``TOL_FP32``, at exactly 48 + 24 and 24 + 24 launches;
   (a) 2 microbatches against the sum of the two rows' gradients taken
   alone with the whole batch's denominator: fp32 leaves, the loss and
   every leaf within ``TOL_FP32``; 2 microbatches against 1 and each
   run's peak memory are logged; (f) ``remat="dots"`` against ``"none"``:
   the loss and every gradient leaf within ``TOL_FP32`` at 48 + 24
   launches (the kernels' forwards recomputed), its memory above what was
   held between ``"full"``'s and ``"none"``'s, and 2 AdamW steps of each
   from the same weights: the losses and final parameters within
   ``TOL_FP32``; (c) bf16: a
   ``FaultTolerantLoop`` that checkpoints after step 1 (17.05 GB: fp32
   parameters and both moments) and dies at an injected ``train.step``
   fault, then a fresh loop that resumes from step 1 and gives the
   uninterrupted run's step-2 loss bit for bit, with no checksum failure;
   logs the save and restore seconds and GB/s (the checkpoint lives in a
   temporary directory, removed when the phase ends);
10. (runs after phase 9) the main path's tooling, full hla-1b, either
   mixer: (a) the four entry points' run-time contracts
   (``repro_torch.analysis.contracts``: an admission's prefill, a decode
   block, an accepting and a rejecting speculative round, a train step):
   no fp64 op, every donated buffer (state pool, tokens; parameters and
   moments) keeps its storage, 0 / 1 / 1 / 1 or 2 host transfers counted
   both as calls and as the sync debug mode's warnings, no collective,
   exactly the call's kernel launches, and one op sequence for three
   prompt lengths of one 128-token bucket; (b) ``model_cost`` of prefill,
   decode and the train step at phases 4 and 6's shapes and the
   ``roofline_utilization`` of their measured tok/s against
   ``device_peak``; (c) phase 6's peak memory with the in-place AdamW;
   (d) ``examples/torch_quickstart.py``,
   ``examples/torch_long_context_decode.py``,
   ``examples/torch_hla_vs_baselines.py`` (five accuracy lines) and
   ``examples/torch_train_hla_100m.py`` (20 steps, one checkpoint) in a
   subprocess each, short;
11. (runs after phase 10) the rest of the HLA operator family, plain torch
   (``hla3``, ``hla3_paper``, ``linattn``, and ``impl="scan"`` for HLA2 and
   AHLA), which launches none of the six kernels: (a) at head_dim 128,
   fp32, one row of 16 heads, chunkwise equals serial for the three at a
   ragged n = 200 and the scan equals chunkwise for hla2 and ahla at n =
   64; (b) full hla-1b, fp32, prefill(L) + one decode step equals
   prefill(L + 1) for each of the three, and an ``impl="scan"`` HLA2
   prefill of 64 tokens equals the kernel prefill (its decode step still
   launches 24 ``hla2_step``); (c) phase 4's 8 requests in bf16 with each
   of the three (TTFT, decode tok/s, peak memory logged), and ``hla3`` in
   fp32: speculative greedy with the always-wrong drafter equals plain
   greedy, and phase 8's requests through a prefix cache (every admission
   a hit) equal their cold streams, an entry holding
   ``state_bytes_for(cfg)`` bytes; (d) 3 AdamW steps of ``hla3`` cut to
   12 layers at 2 x 2048 with the config's remat, bf16 activations: the
   loss falls.  Every
   run's launch counts are zeroed before it and must read 0 after;
12. (runs after phase 11) softmax attention (``attn``, plain torch) and the
   dense public configs, each at full width: (a) codeqwen1.5-7b (32
   layers, 32 heads, qkv biases, vocabulary 92,416) with ``hla2`` and then
   ``ahla`` in place of its attention: fp32 prefill(L) + a decode step
   equals prefill(L + 1), then phase 4's 8 requests in bf16 through
   ``Engine``, all ``ok``, exactly 32 chunk launches per admission and 32
   step launches per decode step, no plain version; ``Engine`` refuses the
   config's own ``attn``; (b) codeqwen1.5-7b with ``attn``, fp32
   parameters: 2 prompts of 300 tokens prefilled into a KV cache, then 16
   greedy decode steps, whose logits equal one cache prefill over all 316
   tokens (``TOL_CACHE``), the same with fp32 caches (``TOL_CACHE_FP32``)
   and the train-mode forward (``TOL_CACHE_VS_TRAIN``: its K/V are not
   rounded to the bf16 cache); the K/V elements whose bf16 rounding
   differs between the two caches are logged, and two planted faults
   (decode positions, every cache's length, off by one) must each part
   from the fp32-cache prefill by more than ``TOL_CACHE_FP32``;
   the same in bf16 logs ms a decode step, and one more step makes no host
   transfer and no sync warning; (c) internvl2-2b (24 layers, its
   ``remat="full"``, bf16): 3 AdamW steps at 2 x 2048 tokens after 256
   seeded ``vis_embed`` tokens, the loss falls; (d) codeqwen1.5-7b with
   ``hla2`` at 4 layers: 3 AdamW steps at 2 x 2048, the loss falls, 24
   forward (with checkpoints) and 12 backward launches at 64 rows; (e)
   nemotron-4-15b (squared ReLU, GQA 48/8, vocabulary 256,000) at 2
   layers: an fp32 prefill of 128 tokens and 8 decode steps equal the
   cache prefill over 136, with (b)'s readings and planted faults.  No
   ``attn`` run launches any of the six kernels;
13. (runs after phase 12) GLA and the mixture-of-experts configs, each at
   full width: (a) granite-moe-3b-a800m (32 layers, 24 heads of 64, 8 KV
   heads, 40 experts top 8, tied embeddings) with ``hla2`` and then
   ``ahla`` in place of its attention: phase 4's 8 requests in bf16
   through ``Engine``, all ``ok``, exactly 32 chunk launches per
   admission and 32 step launches per decode step, no plain version, and
   a profile of decode steps (launches, aten ops, device busy); (b)
   before each, in fp32 with the capacity factor at ``n_experts / top_k``
   (no pair dropped), prefill(L) + a decode step equals prefill(L + 1)
   and both routes choose the same experts for every (token, k) in every
   layer; (c) its own ``attn``, no pair dropped, as phase 12 (b); (d)
   3 AdamW steps at 2 x 2048 at full depth with its ``remat="full"``,
   with ``attn``, ``hla2`` and ``ahla``: loss and aux each step, the loss
   falls, 64 + 32 launches a step with an HLA mixer; (e)
   qwen3-moe-30b-a3b (32 heads of 128, 4 KV heads, 128 experts top 8) cut
   to ``QWEN3_LAYERS`` layers with ``hla2``: (b)'s identity, then (a)'s
   requests, one chunk launch a layer an admission and one step launch a
   layer a decode step; (f) granite's four entry points' contracts
   with ``hla2`` (1 / 1 / 1 or 2 / 0 host transfers); (g) hla-1b with
   ``gla`` (plain torch): phase 4's requests and one AdamW step at 2 x
   2048, none of the six kernels launched;
14. (runs after phase 13) Mamba, RWKV-6 and the hybrid group stack (plain
   torch but for the HLA2 kernels at jamba's attention position): (a)
   rwkv6-7b at full size (32 layers, 7.53 B parameters) serving phase 4's
   8 requests in bf16 through ``Engine``, 4 slots, no kernel launched, and
   a profile of one decode step (launches, aten ops, device busy); (b) its
   fp32 prefill(L) + one step equals prefill(L + 1), and 2 requests
   served speculatively (n-gram, k = 4) in fp32 equal plain greedy; (c)
   its training at ``RWKV_TRAIN_LAYERS`` layers with ``remat="full"``: 3
   AdamW steps at 2 x 2048, the loss falls; (d) jamba-1.5-large-398b at
   full width cut to one group (8 layers: 7 Mamba, attention at position
   4) and ``JAMBA_EXPERTS`` experts, bf16 parameters: 2 prompts of 300
   tokens through ``lm_prefill`` and 16 greedy decode steps through
   ``lm_apply`` (``Engine`` refuses hybrid stacks), with ``hla2`` (exactly
   one ``hla2_chunk_fwd`` a prefill and one ``hla2_step`` a decode step, no
   plain version) and with its own ``attn`` (no launch); (e) before (d),
   the same cut in fp32 with ``hla2`` and no pair dropped: prefill(L) +
   one step equals prefill(L + 1), every MoE layer's routes alike; (f)
   jamba at half width (``_jamba_half``), one group, ``hla2``, bf16
   parameters, moments and accumulator, ``remat="full"`` on the group: 3
   AdamW steps at 2 x 1024 with lr ``JAMBA_LR``, the loss falls, 2 + 1
   launches a step;
15. (runs after phase 14) whisper-small at full size (12 encoder and 12
   decoder layers, d_model 768, 12 heads of 64, vocabulary 51,865, 1500
   frames of the stub frontend, 0.255 B parameters, seeded random
   weights), with its own softmax decoder and with ``hla2`` and ``ahla``
   in the decoder's self-attention: (b) fp32, 2 rows, a
   ``whisper_apply`` prefill of L tokens then one decode step equals a
   prefill of L + 1 at L = 4 and 224 (softmax within ``TOL_WHISPER_CACHE``
   with its bf16 KV cache and within ``TOL_FP32`` with fp32 caches; the HLA
   mixers within ``TOL_FP32``); (c) bf16, 4 rows of 1500 frames, a 4- and
   a 224-token prompt, 64 greedy tokens: time to the first token
   (encoder + prefill), ms a decode step, tok/s, peak memory; exactly 12
   chunk launches a prefill and 12 step launches a decode step with an
   HLA mixer (none with softmax), no plain version; one ``hla2`` stream
   through ``make_prefill_step`` + ``make_serve_step`` equals
   ``whisper_apply``'s token for token; (d) 3 AdamW steps at 8 x 448
   decoder tokens + 8 x 1500 frames with the config's ``remat="full"``,
   bf16 activations: the loss falls, 24 + 12 launches a step with an HLA
   mixer;
16. (runs after phase 15) hla-1b at full size under a one-rank ``(data,
   model)`` device mesh (an NCCL process group of one rank, ``make_mesh((1,
   1))``; parameters, moments and slot states as DTensors, every HLA kernel
   call through ``shard_ops.call_sharded``), with ``hla2`` and ``ahla``:
   (a) 2 AdamW steps at 2 x 2048 with ``remat="full"``: the step-0 loss,
   every gradient leaf, each step's loss and the final parameters equal
   the unsharded step's on the same weights bit for bit, 48 + 24 launches
   a step; (b) ``Engine(mesh=)``, 4 greedy requests, 4 slots, 256-640-token
   prompts, 32 tokens: the unsharded engine's streams, 24 chunk launches
   an admission and 24 step launches a decode step, one host transfer an
   admission and one a decode block (``analysis.contracts``' count and the
   sync debug mode's warnings); TTFT, decode tok/s, peak memory of both;
   (c) the dry run (``launch/dryrun.py``, host work on fake process groups,
   ``DRYRUN_WORKERS`` at a time, started after (a) and (b), which time the
   host, and run beside phases 17 and 7; its lines printed after phase 7)
   of
   hla-1b,
   qwen2-72b and codeqwen1.5-7b with ``hla2`` at full depth, ``train_4k``
   (``decode_32k`` cut for time), on a (1, 4) mesh and the production
   16 x 16: one
   line a cell (GiB a rank, whether it fits in 80 GB, collective bytes by
   kind, the roofline's terms and bottleneck);
17. (runs after phase 16 (a), (b), beside (c)'s dry runs) the rest
   of the multi-device code under a one-rank ``(data, model)`` NCCL mesh:
   (a) ``Engine(mesh=, spec=)`` for hla-1b at full size, ``hla2`` and
   ``ahla``, fp32 greedy, with the n-gram and the LM drafter (its pool on
   the mesh too), on phase 5's first 4 requests cut to 16 tokens: phase
   5's fp32 greedy streams token for token, launches equal the stats'
   counts (verify chunk launches, replay steps, draft steps), one host
   transfer an admission and one a round (two with a rollback); (b)
   ``Engine(mesh=, cache=)`` on phase 8 (a)'s requests and injected
   ``cache.corrupt``: phase 8 (a)'s streams and the same hits at the same
   prompt positions, launches exact; (c) a 2 x 128 train step's loss
   and gradients, then a 16-token prefill and 2 serve steps' logits, of
   qwen3-moe-30b-a3b (2 layers, ``hla2``), jamba's one group at half width
   (the ``hla2`` drop-in), rwkv6-7b (2 layers) and whisper-small
   (``hla2``), every other width as published: equal to the unsharded
   runs bit for bit (deterministic algorithms on), the same launches; (d)
   ``compression.int8_allreduce_mean`` over the one rank against
   ``quantize_dequantize``, ``pipeline_par.pipelined_forward`` with S = 1
   against the serial stack (forward and gradients within 1e-5 and
   1e-4). Full-depth jamba's and qwen3-moe's ``train_4k`` dry runs take
   ~600 s and ~60 s of host time: they are run on their own
   (``launch/dryrun.py``), not here;
7. time each kernel and its plain version at its path's shapes (the step
   kernels also at 16 rows, one slot; the chunk forwards also at the
   verify shape, ``[verify]``; all six also at phase 13's d = 64 shapes,
   ``[d=64]``; the HLA2 three at phase 14's jamba shapes, ``[jamba]``;
   all six at phase 15's whisper shapes, ``[whisper]``; phase 16's
   launches are logged by that phase, not timed here).

The second-to-last line is the ``kernels`` JSON, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, the script exits nonzero before printing any result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import re
import statistics
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

# published H100 SXM peaks (NVIDIA data sheet) for the lower bounds
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
# the chunk kernels' FMAs by operand type, (bf16 x bf16, bf16 x fp32, fp32 x
# fp32), each at the card's fastest rate that keeps fp32 accuracy:
#   - bf16 x bf16 on the bf16 tensor cores, 989 TFLOP/s;
#   - bf16 x fp32 with the fp32 operand split into three bf16 parts (24
#     bits), three bf16 MMAs: 989/3 (TF32 with a split operand, the HLA2
#     kernels' route, needs two MMAs at 495: 495/2, slower);
#   - fp32 x fp32 in TF32 with both operands split into high and low parts,
#     three MMAs: 495/3 (six bf16 MMAs would give 989/6, no faster).
CHUNK_RATES = (989e12, 989e12 / 3, 495e12 / 3)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)

# kernel vs plain tolerances, relative to max|plain|:
# fp32 outputs and every fp32 state differ only by summation order (the
# chunk kernels' split-TF32 tensor-core products, whose dropped low x low
# term is below 2^-22 of a product, and the step kernels' SIMT loops, vs
# cuBLAS, over up to 640 tokens and 128-wide dots): ~1e-6
TOL_FP32 = 1e-4
# bf16 outputs are the fp32 results rounded to bf16 (2^-8 relative), and a
# last-place difference in fp32 may flip a rounding: at most one bf16 ulp
TOL_BF16 = 1e-2
# logits after 24 fp32 layers, kernels vs kernels in two summation orders
TOL_LOGITS = 2e-3
# dgamma of a row sums the derivative of every decay power over every chunk
# (n * 64 terms of both signs): summation order moves it more than one
# output element, so its tolerance is wider
TOL_DGAMMA = 1e-3

CHUNK_SRC = "src/repro_torch/csrc/hla2_chunk_fwd.cu"
STEP_SRC = "src/repro_torch/csrc/hla2_step.cu"
BWD_SRC = "src/repro_torch/csrc/hla2_chunk_bwd.cu"
AHLA_CHUNK_SRC = "src/repro_torch/csrc/ahla_chunk_fwd.cu"
AHLA_STEP_SRC = "src/repro_torch/csrc/ahla_step.cu"
AHLA_BWD_SRC = "src/repro_torch/csrc/ahla_chunk_bwd.cu"


# the card's name and power limit, printed beside every number
CARD = "card not read yet"


def log(msg: str) -> None:
    print(f"[chip_smoke | {CARD}] {msg}", flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() /
                 want.abs().max().clamp_min(1e-30))


def abs_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _inputs(gen, rows, n, d, dv, dtype, device, positive=False):
    import torch

    def rnd(*shape, scale=1.0):
        x = torch.randn(shape, generator=gen, device=device) * scale
        return (x.abs() if positive else x).to(dtype)

    q = rnd(rows, n, d, scale=d**-0.5)
    k = rnd(rows, n, d, scale=d**-0.5)
    v = rnd(rows, n, dv)
    gamma = torch.rand(rows, generator=gen, device=device) * 0.099 + 0.9
    return q, k, v, gamma


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def check_chunk(device, rows=16, d=128, ns=(512, 300), main_init=False):
    """hla2_chunk_fwd vs hla2_chunk_fwd_plain, and the initial carry left as
    it was.  Returns the max absolute output error of the main-path case
    (bf16, first n, with a carry if ``main_init``: the verify shape)."""
    import torch

    from repro_torch.kernels.hla2_chunk import (
        hla2_chunk_fwd, hla2_chunk_fwd_plain)

    gen = torch.Generator(device=device).manual_seed(0)
    qp, kp, vp, gp = _inputs(gen, rows, 200, d, d, torch.float32, device)
    _, prior = hla2_chunk_fwd_plain(qp, kp, vp, gp)  # a carry to resume
    cases = [(dt, n, init, False, 0.0, True)
             for dt in (torch.bfloat16, torch.float32) for n in ns
             for init in (False, True)]
    cases += [(torch.float32, ns[-1], True, True, 0.2, True),
              (torch.bfloat16, ns[0], True, False, 0.0, False)]
    main_abs = None
    for dt, n, init, norm, lam, use_gamma in cases:
        q, k, v, g = _inputs(gen, rows, n, d, d, dt, device, positive=norm)
        g = g if use_gamma else None
        st0 = prior if init else None
        kw = dict(initial_state=st0, normalize=norm, lam=lam)
        before = [x.clone() for x in prior]
        o_k, s_k = hla2_chunk_fwd(q, k, v, g, **kw)
        o_p, s_p = hla2_chunk_fwd_plain(q, k, v, g, **kw)
        e_o = rel_err(o_k, o_p)
        e_s = max(rel_err(a, b) for a, b in zip(s_k, s_p))
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_FP32
        log(f"hla2_chunk_fwd {str(dt)[6:]} rows={rows} n={n} d={d} "
            f"init={init} gamma={use_gamma} normalize={norm} lam={lam}: "
            f"o rel {e_o:.2e} (tol {tol:.0e}), "
            f"state rel {e_s:.2e} (tol {TOL_FP32:.0e})")
        if not (e_o <= tol and e_s <= TOL_FP32):
            raise AssertionError("hla2_chunk_fwd disagrees with its plain "
                                 "version")
        if any(not torch.equal(a, b) for a, b in zip(before, prior)):
            raise AssertionError("hla2_chunk_fwd modified initial_state")
        if main_abs is None and init == main_init:
            main_abs = abs_err(o_k, o_p)
    return main_abs


def check_chunk_bwd(device, rows=32, d=128, ns=(2048, 300), small=False):
    """hla2_chunk_fwd's checkpoints and hla2_chunk_bwd vs their plain
    versions, at the train phase's rows.  ``small`` runs the normalize and
    lam cases instead: at d = 16 (the reduced model's heads) one column
    tile, at d = 128 four, each with its own den column.  Returns the max
    absolute errors of the main-path case (bf16, first n, gamma): of
    dq/dk/dv, and of the forward's output and checkpoints."""
    import torch

    from repro_torch.kernels.hla2_chunk import (
        hla2_chunk_bwd, hla2_chunk_bwd_plain, hla2_chunk_fwd,
        hla2_chunk_fwd_plain)

    gen = torch.Generator(device=device).manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    if small:
        cases = [(f32, n, True, norm, lam) for n in ns
                 for norm, lam in ((True, 0.0), (False, 0.3), (True, 0.3))]
        cases.append((bf, ns[0], False, True, 0.3))
    else:
        cases = [(dt, n, True, False, 0.0) for dt in (bf, f32) for n in ns]
        cases += [(dt, ns[-1], False, False, 0.0) for dt in (bf, f32)]
    main_abs = None
    for dt, n, use_gamma, norm, lam in cases:
        q, k, v, g = _inputs(gen, rows, n, d, d, dt, device, positive=norm)
        g = g if use_gamma else None
        do = torch.randn(v.shape, generator=gen, device=device).to(dt)
        kw = dict(normalize=norm, lam=lam)
        o_k, _, ck_k = hla2_chunk_fwd(q, k, v, g, save_chunk_states=True,
                                      **kw)
        o_p, _, ck_p = hla2_chunk_fwd_plain(q, k, v, g,
                                            save_chunk_states=True, **kw)
        got = hla2_chunk_bwd(q, k, v, g, do, ck_k, **kw)
        want = hla2_chunk_bwd_plain(q, k, v, g, do, ck_p, **kw)
        e_ck = max(rel_err(a, b) for a, b in zip(ck_k, ck_p))
        e_o = rel_err(o_k, o_p)
        e_x = max(rel_err(a, b) for a, b in zip(got[:3], want[:3]))
        e_g = rel_err(got[3], want[3]) if use_gamma else 0.0
        tol = TOL_BF16 if dt == bf else TOL_FP32
        log(f"hla2_chunk_bwd {str(dt)[6:]} rows={rows} n={n} d={d} "
            f"gamma={use_gamma} normalize={norm} lam={lam}: dq/dk/dv rel "
            f"{e_x:.2e} (tol {tol:.0e}), dgamma rel {e_g:.2e} (tol "
            f"{TOL_DGAMMA:.0e}), forward o rel {e_o:.2e} (tol {tol:.0e}), "
            f"checkpoints rel {e_ck:.2e} (tol {TOL_FP32:.0e})")
        if not (e_x <= tol and e_g <= TOL_DGAMMA and e_ck <= TOL_FP32
                and e_o <= tol):
            raise AssertionError("hla2_chunk_bwd or the checkpoints disagree "
                                 "with the plain versions")
        if main_abs is None:
            main_abs = (max(abs_err(a, b) for a, b in zip(got[:3], want[:3])),
                        max(abs_err(a, b) for a, b in
                            zip((o_k,) + ck_k, (o_p,) + ck_p)))
    return main_abs


def check_step(device, rows=64, d=128, dv=None, n_prior=300, steps=4):
    """hla2_step vs hla2_step_plain over ``steps`` tokens after a prefill,
    both in place (a race on the in-place vectors shows in a later step).
    Returns the max absolute output error of the main-path case (bf16,
    first step)."""
    import torch

    from repro_torch.kernels.decode_step import hla2_step, hla2_step_plain
    from repro_torch.kernels.hla2_chunk import hla2_chunk_fwd

    dv = d if dv is None else dv
    gen = torch.Generator(device=device).manual_seed(1)
    main_abs = None
    for dt, norm, lam, use_gamma in ((torch.bfloat16, False, 0.0, True),
                                     (torch.float32, False, 0.0, True),
                                     (torch.float32, True, 0.2, True),
                                     (torch.float32, False, 0.0, False)):
        qp, kp, vp, g = _inputs(gen, rows, n_prior, d, dv, dt, device,
                                positive=norm)
        g = g if use_gamma else None
        _, st0 = hla2_chunk_fwd(qp, kp, vp, g)  # the prefill the steps resume
        s_k = [x.clone() for x in st0]
        s_p = [x.clone() for x in st0]
        ptrs = [x.data_ptr() for x in s_k]
        e_o = 0.0
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_FP32
        for _ in range(steps):
            q, k, v, _ = _inputs(gen, rows, 1, d, dv, dt, device,
                                 positive=norm)
            q, k, v = (x[:, 0].contiguous() for x in (q, k, v))
            o_k = hla2_step(s_k, q, k, v, g, normalize=norm, lam=lam)
            o_p = hla2_step_plain(s_p, q, k, v, g, normalize=norm, lam=lam)
            e_o = max(e_o, rel_err(o_k, o_p))
            if main_abs is None:
                main_abs = abs_err(o_k, o_p)
        if [x.data_ptr() for x in s_k] != ptrs or any(
                torch.equal(a, b) for a, b in zip(s_k, st0)):
            raise AssertionError("hla2_step did not update its state in place")
        e_s = max(rel_err(a, b) for a, b in zip(s_k, s_p))
        log(f"hla2_step {str(dt)[6:]} rows={rows} d={d} dv={dv} after "
            f"prefill {n_prior}, {steps} steps, gamma={use_gamma} "
            f"normalize={norm} lam={lam}: o rel {e_o:.2e} (tol {tol:.0e}), "
            f"state rel {e_s:.2e} (tol {TOL_FP32:.0e})")
        if not (e_o <= tol and e_s <= TOL_FP32):
            raise AssertionError("hla2_step disagrees with its plain version")
    return main_abs


def check_ahla_chunk(device, rows=16, d=128, ns=(512, 300), main_init=False):
    """ahla_chunk_fwd vs ahla_chunk_fwd_plain: o and all four carry leaves,
    and the initial carry left as it was.  Returns the max absolute output
    error of the main-path case (bf16, first n, with a carry if
    ``main_init``: the verify shape)."""
    import torch

    from repro_torch.kernels.ahla_chunk import (
        ahla_chunk_fwd, ahla_chunk_fwd_plain)

    gen = torch.Generator(device=device).manual_seed(10)
    qp, kp, vp, gp = _inputs(gen, rows, 200, d, d, torch.float32, device)
    _, prior = ahla_chunk_fwd_plain(qp, kp, vp, gp)  # a carry to resume
    _, prior_pos = ahla_chunk_fwd_plain(
        *_inputs(gen, rows, 200, d, d, torch.float32, device, positive=True))
    cases = [(dt, n, init, False, True)
             for dt in (torch.bfloat16, torch.float32) for n in ns
             for init in (False, True)]
    cases += [(torch.float32, ns[-1], True, True, True),
              (torch.bfloat16, ns[0], True, False, False),
              (torch.float32, ns[-1], False, False, False)]
    main_abs = None
    for dt, n, init, norm, use_gamma in cases:
        q, k, v, g = _inputs(gen, rows, n, d, d, dt, device, positive=norm)
        g = g if use_gamma else None
        st0 = (prior_pos if norm else prior) if init else None
        kw = dict(initial_state=st0, normalize=norm)
        before = [x.clone() for x in st0] if init else []
        o_k, s_k = ahla_chunk_fwd(q, k, v, g, **kw)
        o_p, s_p = ahla_chunk_fwd_plain(q, k, v, g, **kw)
        e_o = rel_err(o_k, o_p)
        e_s = max(rel_err(a, b) for a, b in zip(s_k, s_p))
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_FP32
        log(f"ahla_chunk_fwd {str(dt)[6:]} rows={rows} n={n} d={d} "
            f"init={init} gamma={use_gamma} normalize={norm}: "
            f"o rel {e_o:.2e} (tol {tol:.0e}), "
            f"state rel {e_s:.2e} (tol {TOL_FP32:.0e})")
        if not (e_o <= tol and e_s <= TOL_FP32):
            raise AssertionError("ahla_chunk_fwd disagrees with its plain "
                                 "version")
        if any(not torch.equal(a, b) for a, b in zip(before, st0 or ())):
            raise AssertionError("ahla_chunk_fwd modified initial_state")
        if main_abs is None and init == main_init:
            main_abs = abs_err(o_k, o_p)
    return main_abs


def check_ahla_step(device, rows=64, d=128, dv=None, n_prior=300, steps=4):
    """ahla_step vs ahla_step_plain over ``steps`` tokens after a prefill,
    both in place; then prefill(n_prior) + one step == prefill(n_prior + 1)
    through ``ops`` (kernels on both sides), in o and every state leaf.
    Returns the max absolute output error of the main-path case (bf16)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_step import ahla_step, ahla_step_plain

    dv = d if dv is None else dv
    gen = torch.Generator(device=device).manual_seed(11)
    main_abs = None
    for dt, norm, use_gamma in ((torch.bfloat16, False, True),
                                (torch.float32, False, True),
                                (torch.float32, True, True),
                                (torch.float32, False, False)):
        qp, kp, vp, g = _inputs(gen, rows, n_prior, d, dv, dt, device,
                                positive=norm)
        g = g if use_gamma else None
        # the prefill the steps resume from, R included: (1, rows) heads
        _, st0 = ops.ahla_prefill(qp[None], kp[None], vp[None], g)
        st0 = [x[0] for x in st0]
        s_k = [x.clone() for x in st0]
        s_p = [x.clone() for x in st0]
        ptrs = [x.data_ptr() for x in s_k]
        e_o = 0.0
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_FP32
        for _ in range(steps):
            q, k, v, _ = _inputs(gen, rows, 1, d, dv, dt, device,
                                 positive=norm)
            q, k, v = (x[:, 0].contiguous() for x in (q, k, v))
            o_k = ahla_step(s_k, q, k, v, g, normalize=norm)
            o_p = ahla_step_plain(s_p, q, k, v, g, normalize=norm)
            e_o = max(e_o, rel_err(o_k, o_p))
            if main_abs is None:
                main_abs = abs_err(o_k, o_p)
        if [x.data_ptr() for x in s_k] != ptrs or any(
                torch.equal(a, b) for a, b in zip(s_k, st0)):
            raise AssertionError("ahla_step did not update its state in place")
        e_s = max(rel_err(a, b) for a, b in zip(s_k, s_p))
        log(f"ahla_step {str(dt)[6:]} rows={rows} d={d} dv={dv} after "
            f"prefill {n_prior}, {steps} steps, gamma={use_gamma} "
            f"normalize={norm}: "
            f"o rel {e_o:.2e} (tol {tol:.0e}), "
            f"state rel {e_s:.2e} (tol {TOL_FP32:.0e})")
        if not (e_o <= tol and e_s <= TOL_FP32):
            raise AssertionError("ahla_step disagrees with its plain version")

    # the carry identity through both kernels, fp32
    q, k, v, g = _inputs(gen, rows, n_prior + 1, d, dv, torch.float32,
                         device)
    q, k, v = q[None], k[None], v[None]  # (1, rows) heads
    o_full, st_full = ops.ahla_prefill(q, k, v, g)
    _, st = ops.ahla_prefill(q[:, :, :n_prior].contiguous(),
                             k[:, :, :n_prior].contiguous(),
                             v[:, :, :n_prior].contiguous(), g)
    _, o_t = ops.ahla_decode_step(
        st, *(x[:, :, n_prior].contiguous() for x in (q, k, v)), g)
    e_o = rel_err(o_t, o_full[:, :, n_prior])
    e_s = max(rel_err(a, b) for a, b in zip(st, st_full))
    log(f"ahla prefill({n_prior}) + step vs prefill({n_prior + 1}), fp32 "
        f"rows={rows} d={d} dv={dv}: o rel {e_o:.2e}, state rel "
        f"{e_s:.2e} (tol {TOL_FP32:.0e})")
    if not (e_o <= TOL_FP32 and e_s <= TOL_FP32):
        raise AssertionError("ahla prefill + step != longer prefill")
    return main_abs


def check_ahla_chunk_bwd(device, rows=32, d=128, ns=(2048, 300),
                         small=False):
    """ahla_chunk_fwd's checkpoints and ahla_chunk_bwd vs their plain
    versions, at the train phase's rows.  ``small`` adds the normalize
    cases: at d = 16 (the reduced model's heads) one column tile holds the
    den column, at d = 128 a fifth tile holds it alone.  Returns the max
    absolute errors of the main-path case (bf16, first n, gamma): of
    dq/dk/dv, and of the forward's output and checkpoints."""
    import torch

    from repro_torch.kernels.ahla_chunk import (
        ahla_chunk_bwd, ahla_chunk_bwd_plain, ahla_chunk_fwd,
        ahla_chunk_fwd_plain)

    gen = torch.Generator(device=device).manual_seed(14)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(dt, n, True, False) for dt in (bf, f32) for n in ns]
    cases += [(dt, ns[-1], False, False) for dt in (bf, f32)]
    if small:
        cases += [(f32, n, True, True) for n in ns]
        cases += [(f32, ns[0], False, True), (bf, ns[0], True, True)]
    main_abs = None
    for dt, n, use_gamma, norm in cases:
        q, k, v, g = _inputs(gen, rows, n, d, d, dt, device, positive=norm)
        g = g if use_gamma else None
        do = torch.randn(v.shape, generator=gen, device=device).to(dt)
        o_k, _, ck_k = ahla_chunk_fwd(q, k, v, g, save_chunk_states=True,
                                      normalize=norm)
        o_p, _, ck_p = ahla_chunk_fwd_plain(q, k, v, g,
                                            save_chunk_states=True,
                                            normalize=norm)
        got = ahla_chunk_bwd(q, k, v, g, do, ck_k, normalize=norm)
        want = ahla_chunk_bwd_plain(q, k, v, g, do, ck_p, normalize=norm)
        e_ck = max(rel_err(a, b) for a, b in zip(ck_k, ck_p))
        e_o = rel_err(o_k, o_p)
        e_x = max(rel_err(a, b) for a, b in zip(got[:3], want[:3]))
        e_g = rel_err(got[3], want[3]) if use_gamma else 0.0
        tol = TOL_BF16 if dt == bf else TOL_FP32
        log(f"ahla_chunk_bwd {str(dt)[6:]} rows={rows} n={n} d={d} "
            f"gamma={use_gamma} normalize={norm}: dq/dk/dv rel {e_x:.2e} "
            f"(tol {tol:.0e}), dgamma rel {e_g:.2e} (tol {TOL_DGAMMA:.0e}), "
            f"forward o rel {e_o:.2e} (tol {tol:.0e}), checkpoints rel "
            f"{e_ck:.2e} (tol {TOL_FP32:.0e})")
        if not (e_x <= tol and e_g <= TOL_DGAMMA and e_ck <= TOL_FP32
                and e_o <= tol):
            raise AssertionError("ahla_chunk_bwd or the checkpoints disagree "
                                 "with the plain versions")
        if main_abs is None:
            main_abs = (max(abs_err(a, b) for a, b in zip(got[:3], want[:3])),
                        max(abs_err(a, b) for a, b in
                            zip((o_k,) + ck_k, (o_p,) + ck_p)))
    return main_abs


# --------------------------------------------------------------------------
# phase 3: the model, against its plain path and against itself
# --------------------------------------------------------------------------


def check_small_model(device, mixer=None):
    """Reduced hla-1b (fp32, its own mixer or ``mixer``): prefill + one
    decode step on ``device`` (the kernels) vs on the CPU (the plain
    versions), same weights."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.param import init_params

    cfg = get_config("hla-1b", reduced=True, mixer=mixer)
    p_cpu = init_params(lm.lm_specs(cfg), 0, "cpu")
    p_dev = _to(p_cpu, device)
    tok = torch.randint(0, cfg.vocab, (2, 150),
                        generator=torch.Generator().manual_seed(2))
    out = []
    for p, dev in ((p_dev, device), (p_cpu, "cpu")):
        t = tok.to(dev)
        last, st = lm.lm_prefill(p, t[:, :-1], cfg)
        step, _, _ = lm.lm_apply(p, t[:, -1:], cfg, states=st, mode="decode")
        out.append((last.cpu(), step[:, -1].cpu()))
    e = max(rel_err(a, b) for a, b in zip(*out))
    log(f"reduced hla-1b ({cfg.mixer}) fp32, prefill 149 + 1 step: {device} "
        f"kernels vs cpu plain logits rel {e:.2e} (tol {TOL_FP32:.0e})")
    if not e <= TOL_FP32:
        raise AssertionError("the model on the card disagrees with the CPU")


def _loss_grads(params, batch, cfg):
    """The model's loss and its gradient for every parameter leaf (in
    ``leaf_paths`` order), through the train step's ``accumulate_grads``."""
    from repro_torch.distributed.steps import accumulate_grads
    from repro_torch.models.param import leaf_paths

    loss, _, _, grads = accumulate_grads(params, batch, cfg)
    return loss, [g for _, g in leaf_paths(grads)]


def check_small_train(device, mixer=None):
    """Reduced hla-1b (fp32, its own mixer or ``mixer``): the loss and every
    parameter's gradient on ``device`` (forward and backward kernels) vs on
    the CPU (plain versions), same weights and batch."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.models import lm
    from repro_torch.models.param import init_params, leaf_paths

    cfg = get_config("hla-1b", reduced=True, mixer=mixer)
    p_cpu = init_params(lm.lm_specs(cfg), 0, "cpu")
    host = SyntheticStream(DataConfig(cfg.vocab, 150, 2, seed=6)).batch(0)
    out = []
    for p, dev in ((_to(p_cpu, device), device), (p_cpu, "cpu")):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        loss, grads = _loss_grads(p, batch, cfg)
        out.append((loss.cpu(), [g.cpu() for g in grads]))
    (l_k, g_k), (l_p, g_p) = out
    e_l = rel_err(l_k, l_p)
    errs = {"/".join(path): rel_err(a, b) for (path, _), a, b in
            zip(leaf_paths(p_cpu), g_k, g_p)}
    worst = max(errs, key=errs.get)
    log(f"reduced hla-1b ({cfg.mixer}) fp32 train loss, 2 x 150 tokens: "
        f"{device} kernels "
        f"vs cpu plain: loss {float(l_k):.6f} rel {e_l:.2e}, gradients of "
        f"{len(errs)} leaves rel <= {errs[worst]:.2e} ({worst}) (tol "
        f"{TOL_FP32:.0e})")
    if not (e_l <= TOL_FP32 and errs[worst] <= TOL_FP32):
        raise AssertionError("the model's gradients on the card disagree "
                             "with the CPU")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@contextlib.contextmanager
def _routes():
    """Every MoE layer's expert ids (``gate_e``) computed inside, in call
    order."""
    from repro_torch.models import moe

    made, seen = moe.route, []

    def route(*args, **kw):
        out = made(*args, **kw)
        seen.append(out[2])
        return out

    moe.route = route
    try:
        yield seen
    finally:
        moe.route = made


def _no_drop(cfg):
    """``cfg`` with an MoE capacity factor of ``n_experts / top_k``, so an
    expert's ``C`` slots hold every token of a row and no pair drops (the
    reference's treatment when it compares decode with a forward: a
    one-token decode never drops).  Without MoE, ``cfg``."""
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def check_identity(params, cfg, L=300):
    """prefill(L) + decode step == prefill(L + 1) on the last logits; with
    MoE also the routing agreement, the share of (token, k) expert ids, in
    every layer, that the two routes choose alike (must be all)."""
    import torch

    from repro_torch.models import lm

    dev = params["embed"]["embedding"].device
    tok = torch.randint(2, cfg.vocab, (1, L + 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    with _routes() as seen:
        _, st = lm.lm_prefill(params, tok[:, :L], cfg)
        step, _, _ = lm.lm_apply(params, tok[:, L:], cfg, states=st,
                                 mode="decode")
        full, _ = lm.lm_prefill(params, tok, cfg)
    step = step[:, -1]
    if step.shape != full.shape or not bool(step.isfinite().all()):
        raise AssertionError(f"bad logits {tuple(step.shape)}")
    e = rel_err(step, full)
    routing = ""
    agree = 1.0
    if cfg.moe is not None:
        n = _moe_layers(cfg)
        split, one = seen[:n], zip(seen[n:2 * n], seen[2 * n:3 * n])
        same = sum(int((torch.cat([a, b], 1) == c).sum())
                   for a, (b, c) in zip(split, one))
        total = sum(c.numel() for c in seen[2 * n:3 * n])
        agree = same / total
        routing = (f", routing agreement {same}/{total} (token, k) expert "
                   f"ids = {agree:.2%} (capacity factor "
                   f"{cfg.moe.capacity_factor:g})")
    log(f"{cfg.name} ({cfg.mixer}) {cfg.n_layers} layers d_model "
        f"{cfg.d_model} {cfg.dtype}: prefill({L}) + step vs prefill({L + 1}) "
        "logits rel "
        f"{e:.2e} (tol {TOL_LOGITS:.0e}), argmax "
        f"{int(step.argmax())} vs {int(full.argmax())}{routing}")
    if not e <= TOL_LOGITS:
        raise AssertionError("prefill + step != longer prefill")
    if agree != 1.0:
        raise AssertionError("the two routes chose other experts")
    return e, agree


# --------------------------------------------------------------------------
# phase 4: serving
# --------------------------------------------------------------------------


# the prefill and decode kernels each mixer's serving path launches
SERVE_KERNELS = {"hla2": ("hla2_chunk_fwd", "hla2_step"),
                 "ahla": ("ahla_chunk_fwd", "ahla_step")}


def serve_requests(cfg, n_req, lens, gen):
    """The serve phases' requests: ``n_req`` prompts of seeded random
    lengths in ``lens`` and random tokens, ``gen`` tokens each."""
    import numpy as np

    from repro_torch.serving.engine import GenRequest

    rng = np.random.RandomState(0)
    return [GenRequest(rid=i, prompt=rng.randint(2, cfg.vocab, size=L),
                       max_new=gen)
            for i, L in enumerate(rng.randint(lens[0], lens[1] + 1, n_req))]


def serve(params, cfg, device, n_req=8, slots=4, lens=(256, 640), gen=64,
          block=8):
    """Serve ``n_req`` greedy requests with ``cfg.mixer``; returns the launch
    counts of that run and its summary numbers (and streams).  On the CPU
    (a rehearsal) nothing is counted or timed on a device."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import LAUNCHES
    from repro_torch.serving.engine import Engine, GenRequest

    engine = Engine(cfg, params, slots=slots, max_len=lens[1] + gen + 8,
                    block=block, seed=0, device=device)
    reqs = serve_requests(cfg, n_req, lens, gen)
    engine.run([GenRequest(rid=-1, prompt=reqs[0].prompt, max_new=block)])
    engine.obs.reset()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    # CUDA events around each chunk-kernel call of the run: the stream is
    # busy with the layer before, so each pair brackets the launch's device
    # time (plus the wrapper's host time where the stream ran dry)
    marks = []
    chunk_name, step_name = SERVE_KERNELS[cfg.mixer]
    kernel = getattr(ops, chunk_name)

    def timed(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = kernel(*args, **kw)
        end.record()
        marks.append((start, end))
        return out

    if cuda:
        setattr(ops, chunk_name, timed)
    LAUNCHES.clear()  # count the main path only
    t0 = time.perf_counter()
    try:
        results = engine.run(reqs)
    finally:
        setattr(ops, chunk_name, kernel)
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    bad = [(r.rid, r.status, len(r.tokens), r.error) for r in results
           if r.status != "ok" or len(r.tokens) != gen]
    if bad:
        raise AssertionError(f"requests not served: {bad}")
    st = engine.stats
    # one chunk launch per layer per admission, one step launch per layer
    # per decode step, and no other kernel
    want = {chunk_name: cfg.n_layers * n_req,
            step_name: cfg.n_layers * st["decode_steps"]}
    if cuda and launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want}")
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else 0.0
    chunk_ms = [s.elapsed_time(e) for s, e in marks]
    per_adm = [sum(chunk_ms[i:i + cfg.n_layers])
               for i in range(0, len(chunk_ms), cfg.n_layers)]
    # admissions run in request order (FIFO), as do the chunk kernels'
    # marks; a result's ttft_s is its admission's own time
    lens_served = [len(r.prompt) for r in reqs]
    ttfts = [r.ttft_s for r in results]
    for L, ttft, ms in zip(lens_served, ttfts, per_adm):
        log(f"admission of {L} tokens: TTFT {1e3 * ttft:.2f} ms, chunk "
            f"kernel {ms:.2f} ms over {cfg.n_layers} launches "
            f"({ms / (1e3 * ttft):.1%})")
    out = dict(
        wall_s=wall,
        ttft_p50_ms=1e3 * float(np.percentile(ttfts, 50)),
        prompt_p50=float(np.percentile(lens_served, 50)),
        chunk_share_of_prefill=sum(per_adm) / (1e3 * st["prefill_s"]),
        decode_tok_s=(st["generated_tokens"] - n_req) / st["decode_s"],
        prefill_tok_s=st["prompt_tokens"] / st["prefill_s"],
        decode_steps=st["decode_steps"], peak_gib=peak, slots=slots,
        streams=[r.tokens for r in results])
    log(f"served {n_req} requests with {cfg.mixer} (prompts "
        f"{lens[0]}-{lens[1]}, gen {gen}, {slots} slots, block {block}, "
        f"{cfg.dtype}) in {wall:.2f}s: TTFT "
        f"p50 {out['ttft_p50_ms']:.1f} ms (prompt p50 "
        f"{out['prompt_p50']:.0f} tokens; chunk kernel "
        f"{out['chunk_share_of_prefill']:.1%} of prefill time) | decode "
        f"{out['decode_tok_s']:.1f} tok/s | prefill "
        f"{out['prefill_tok_s']:.1f} tok/s | peak memory {peak:.2f} GiB | "
        f"prefill {st['prefill_s']:.3f}s over {n_req} admissions, decode "
        f"{st['decode_s']:.3f}s over {st['decode_steps']} steps | "
        f"launches {launches}")
    return launches, out


# --------------------------------------------------------------------------
# phase 5: speculative serving
# --------------------------------------------------------------------------


SPEC_K = 4  # draft tokens per round, the reference's default


def _wrong_drafter():
    """A drafter that always proposes token 1: nearly every round rejects
    and rolls back (the reference tests' ``_WrongDrafter``)."""
    import numpy as np

    from repro_torch.serving.spec import Drafter

    class WrongDrafter(Drafter):
        def admit(self, slot, tokens):
            pass

        def commit(self, slot, tokens):
            pass

        def propose(self, slot_ids, k):
            return np.ones((len(slot_ids), k), np.int64), None

    return WrongDrafter()


#: the serving kernels' plain versions, (module under repro_torch.kernels,
#: function)
SERVE_PLAINS = (("hla2_chunk", "hla2_chunk_fwd_plain"),
                ("ahla_chunk", "ahla_chunk_fwd_plain"),
                ("decode_step", "hla2_step_plain"),
                ("decode_step", "ahla_step_plain"))


def _count_plain_calls(plains):
    """Wrap each of ``plains`` (module under repro_torch.kernels, function)
    to count its calls; returns ``(calls, restore)``."""
    import importlib

    calls = []
    originals = []
    for mod_name, fn_name in plains:
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        fn = getattr(mod, fn_name)
        originals.append((mod, fn_name, fn))

        def counted(*a, _fn=fn, _name=fn_name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        setattr(mod, fn_name, counted)

    def restore():
        for mod, name, fn in originals:
            setattr(mod, name, fn)

    return calls, restore


def serve_spec(params, cfg, device, drafter, n_req=8, slots=4,
               lens=(256, 640), gen=64, block=8, mesh=None, reqs=None):
    """Serve the serve phase's requests speculatively (``drafter``: "ngram",
    "lm" or an instance; k = ``SPEC_K``), on ``mesh`` when given (the
    parameters distributed; the draft LM's too).  On the card, the run's
    kernel launches must equal the counts its stats imply, with no
    plain-version call and no breaker trip.  ``reqs`` (each of ``gen``
    tokens) replaces the serve phase's.  Returns its summary numbers,
    streams and engine."""
    import collections

    import torch

    from repro_torch.kernels.ops import LAUNCHES
    from repro_torch.serving.engine import Engine, GenRequest
    from repro_torch.serving.spec import HLADrafter, SpecConfig

    cuda = device.type == "cuda"
    # zero-acceptance rounds are common with random weights and would trip
    # the breaker into plain blocks: here it trips on a drafter exception
    # only, so any trip fails the phase
    spec = SpecConfig(k=SPEC_K, drafter=drafter, breaker_zero_rounds=2**31)
    if mesh is not None:
        from repro_torch.distributed import sharding as shd
        from repro_torch.models import lm

        params = shd.distribute(params, shd.param_shardings(
            lm.lm_specs(cfg), mesh), mesh)
    engine = Engine(cfg, params, slots=slots, max_len=lens[1] + gen + 8,
                    block=block, seed=0, device=device, spec=spec, mesh=mesh)
    reqs = reqs or serve_requests(cfg, n_req, lens, gen)
    n_req = len(reqs)
    engine.run([GenRequest(rid=-1, prompt=reqs[0].prompt, max_new=block)])
    engine.obs.reset()
    engine.reset_breaker()
    hla_drafter = isinstance(engine.drafter, HLADrafter)
    if hla_drafter:
        engine.drafter.stats.update(admissions=0, steps=0)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    plain_calls, restore = _count_plain_calls(SERVE_PLAINS)
    LAUNCHES.clear()  # count the main path only
    t0 = time.perf_counter()
    try:
        results = engine.run(reqs)
    finally:
        restore()
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    st = engine.stats
    bad = [(r.rid, r.status, len(r.tokens), r.error) for r in results
           if r.status != "ok" or len(r.tokens) != gen]
    if bad:
        raise AssertionError(f"requests not served: {bad}")
    if st["breaker_trips"] or st["decode_steps"]:
        raise AssertionError(f"breaker tripped ({engine.breaker['reason']}): "
                             f"{st['decode_steps']} plain decode steps")
    # one target chunk launch per layer per admission and per round, one
    # step launch per layer per replay step; the draft model's likewise
    want = collections.Counter()
    chunk_name, step_name = SERVE_KERNELS[cfg.mixer]
    want[chunk_name] += cfg.n_layers * (n_req + st["spec_rounds"])
    want[step_name] += cfg.n_layers * st["spec_replay_steps"]
    name = "ngram" if not hla_drafter else "lm"
    if hla_drafter:
        dcfg, dst = engine.drafter.cfg, engine.drafter.stats
        d_chunk, d_step = SERVE_KERNELS[dcfg.mixer]
        want[d_chunk] += dcfg.n_layers * dst["admissions"]
        want[d_step] += dcfg.n_layers * dst["steps"]
        name += (f" (draft {dcfg.name} reduced, {dcfg.n_layers} layers, "
                 f"d_model {dcfg.d_model}, {dst['admissions']} admissions, "
                 f"{dst['steps']} steps)")
    elif not isinstance(drafter, str):
        name = type(drafter).__name__
    want = {k: v for k, v in want.items() if v}
    if cuda and (launches != want or plain_calls):
        raise AssertionError(f"kernel launches {launches}, want {want}; "
                             f"plain calls {collections.Counter(plain_calls)}")
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else 0.0
    rounds = st["spec_rounds"]
    out = dict(
        wall_s=wall, rounds=rounds, replays=st["spec_replays"],
        replay_steps=st["spec_replay_steps"],
        acceptance=st["spec_accepted"] / max(st["spec_drafted"], 1),
        decode_tok_s=(st["generated_tokens"] - n_req) / st["decode_s"],
        ms_per_round=1e3 * st["decode_s"] / max(rounds, 1),
        tok_per_round=(st["generated_tokens"] - n_req) / max(rounds, 1),
        peak_gib=peak, launches=launches,
        streams=[r.tokens for r in results], engine=engine)
    where = "" if mesh is None else \
        f" on mesh{dict(zip(mesh.mesh_dim_names, mesh.shape))}"
    log(f"speculative serve{where}, {cfg.mixer}, {cfg.dtype}, drafter "
        f"{name}, k {SPEC_K}: {n_req} requests in {wall:.2f}s | decode "
        f"{out['decode_tok_s']:.1f} tok/s | {rounds} rounds, "
        f"{out['ms_per_round']:.2f} ms/round, {out['tok_per_round']:.2f} "
        f"committed tok/round | acceptance {out['acceptance']:.3f} "
        f"({st['spec_accepted']}/{st['spec_drafted']}) | replay rounds "
        f"{st['spec_replays']} ({st['spec_replays'] / max(rounds, 1):.1%}), "
        f"{st['spec_replay_steps']} replay steps | breaker trips 0 | peak "
        f"memory {peak:.2f} GiB | launches {launches}")
    return out


def _parted_at(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def route_logits(params, cfg, prompt, toks):
    """The logits after ``prompt + toks`` two ways: a prefill of the prompt
    then one decode step per token (plain decode's route: step kernel), and
    one prefill of it all (the verify route: chunk kernel).  One request."""
    import torch

    from repro_torch.models import lm

    dev = params["embed"]["embedding"].device
    p = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    t = torch.as_tensor(toks, dtype=torch.long, device=dev)[None]
    step, st = lm.lm_prefill(params, p, cfg)
    for j in range(t.shape[1]):
        logits, _, _ = lm.lm_apply(params, t[:, j:j + 1], cfg, states=st,
                                   mode="decode")
        step = logits[:, -1]
    chunk, _ = lm.lm_prefill(params, torch.cat([p, t], 1), cfg)
    return step[0].float(), chunk[0].float()


def spec_phase(params, cfg, device, plain_bf16, n_req=8, lens=(256, 640),
               gen=64):
    """Speculative serving of full-width hla-1b with ``cfg.mixer``.

    (a) fp32 activations: speculative greedy (n-gram, then an always-wrong
    drafter) equals plain greedy token for token; (b) bf16, as phase 4,
    with the n-gram and the draft-LM drafters: the numbers, and which
    streams part from plain bf16 greedy (``plain_bf16``, phase 4's streams)
    and where.  A stream may part only where plain greedy's top-2 logit gap
    is within the bound set by the bf16 logit error between the verify
    route and the decode route, measured here: 4 x that error, 2 x for a
    difference of two logits and 2 x more for a stream whose state mixed
    both routes.  Returns the bf16 runs' numbers by drafter, and under
    ``"fp32"`` plain fp32 greedy's streams (phase 17's oracle)."""
    from repro_torch.models import lm

    cfg32 = cfg.replace(dtype="float32")
    kw = dict(n_req=n_req, lens=lens, gen=gen)
    _, plain32 = serve(params, cfg32, device, **kw)
    for drafter in ("ngram", _wrong_drafter()):
        out = serve_spec(params, cfg32, device, drafter, **kw)
        del out["engine"]
        parted = [(i, _parted_at(a, b)) for i, (a, b) in
                  enumerate(zip(plain32["streams"], out["streams"]))
                  if a != b]
        log(f"fp32 {cfg.mixer} speculative greedy vs plain greedy: "
            f"{n_req - len(parted)} of {n_req} streams equal"
            + (f"; parted (request, position): {parted}" if parted else ""))
        if parted:
            raise AssertionError("fp32 speculative greedy parted from plain "
                                 "greedy")
        if not isinstance(drafter, str) and not out["replays"]:
            raise AssertionError("the wrong drafter never rolled back")

    reqs = serve_requests(cfg, n_req, lens, gen)
    runs = {"fp32": plain32["streams"]}
    for drafter in ("ngram", "lm"):
        out = serve_spec(params, cfg, device, drafter, **kw)
        del out["engine"]
        runs[drafter] = out
        # the engine's bf16 weights, cast anew: a copy kept across the runs
        # would count in their peak memory
        p_bf = lm.cast_params(params, cfg)
        parted = {i: _parted_at(a, b) for i, (a, b) in
                  enumerate(zip(plain_bf16, out["streams"])) if a != b}
        # the route error where streams part, and at mid-stream of the
        # first two requests for a measure when none parts
        probes = dict(parted)
        for i in (0, 1):
            probes.setdefault(i, gen // 2)
        errs, gaps = {}, {}
        for i, pos in probes.items():
            step, chunk = route_logits(p_bf, cfg, reqs[i].prompt,
                                       plain_bf16[i][:pos])
            errs[i] = float((step - chunk).abs().max())
            top2 = step.topk(2).values
            gaps[i] = float(top2[0] - top2[1])
        del p_bf
        bound = 4 * max(errs.values())
        log(f"bf16 {cfg.mixer} speculative ({drafter}) vs plain greedy: "
            f"{n_req - len(parted)} of {n_req} streams equal; bf16 logit "
            f"error, verify route vs decode route: "
            + ", ".join(f"request {i} at {p}: {errs[i]:.4f}"
                        for i, p in probes.items())
            + f"; bound on the top-2 gap where a stream parts {bound:.4f}"
            + "".join(f"; request {i} parts at {p}, plain greedy top-2 gap "
                      f"{gaps[i]:.4f}" for i, p in parted.items()))
        wide = [i for i in parted if gaps[i] > bound]
        if wide:
            raise AssertionError(f"streams {wide} parted where plain greedy's "
                                 "top-2 gap exceeds the bf16 bound")
    return runs


# --------------------------------------------------------------------------
# phase 4b: where a decode step's host time goes (torch.profiler)
# --------------------------------------------------------------------------


def profile_decode(params, cfg, device, slots=4, block=8, blocks=3,
                   tag="profile"):
    """One ``obs.perf.profile_capture`` window (``torch.profiler``, CPU and
    CUDA activity) over ``blocks`` plain decode blocks of phase 4's engine
    (bf16, 4 slots, block 8, all slots live), with the forward, the
    sampling and the step-kernel wrapper each labelled by
    ``record_function``.  Logs the wall time per decode step (also of one
    block outside the profiler) beside the host time of each part, the
    block's sync and copy, the launches and the device's busy time, and
    writes the profiler table and its Chrome trace under
    ``build/chip_smoke/`` (``<tag>_table.txt``, ``<tag>/``)."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.obs import Obs, profile_capture
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import Engine

    out_dir = ROOT / "build" / "chip_smoke"
    engine = Engine(cfg, params, slots=slots, max_len=1024, block=block,
                    seed=0, device=device, obs=Obs(annotate=True))
    reqs = serve_requests(cfg, slots, (256, 640), 10 * block * blocks)
    for s, r in enumerate(reqs):
        engine.admit(s, r)
    engine.step_block()  # warm
    _sync(device)
    step_name = SERVE_KERNELS[cfg.mixer][1]
    kernel_fn = {"hla2_step": "hla2_decode_step",
                 "ahla_step": "ahla_decode_step"}[step_name]
    patched = [(lm, "lm_apply"), (engine_mod, "sample"), (ops, kernel_fn)]
    labels = {"lm_apply": "decode.forward", "sample": "decode.sample",
              kernel_fn: "decode.step_kernel"}
    originals = [(mod, name, getattr(mod, name)) for mod, name in patched]

    def labelled(fn, label):
        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped

    _sync(device)
    t0 = time.perf_counter()
    engine.step_block()  # unprofiled, for the profiler's overhead
    _sync(device)
    bare = (time.perf_counter() - t0) / block
    for mod, name, fn in originals:
        setattr(mod, name, labelled(fn, labels[name]))
    try:
        with profile_capture(str(out_dir / tag), obs=engine.obs) \
                as prof:
            t0 = time.perf_counter()
            for _ in range(blocks):
                engine.step_block()
            _sync(device)
            wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    steps = blocks * block
    table = prof.key_averages()
    (out_dir / f"{tag}_table.txt").write_text(
        table.table(sort_by="self_cpu_time_total", row_limit=40))

    def cpu_ms(*keys):
        return sum(e.cpu_time_total for e in table if e.key in keys) / 1e3

    def calls(*keys):
        return sum(e.count for e in table if e.key in keys)

    # device busy: the kernels' own time, the device rows of the table
    # (the host ops' "self CUDA" column repeats it) less the device-side
    # copies of the record_function ranges, which span kernels and gaps
    ranges = set(labels.values()) | {"engine.decode_block"}
    kernels = [e for e in table if e.device_type == DeviceType.CUDA
               and e.key not in ranges]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launch_keys = ("cudaLaunchKernel", "cuLaunchKernelEx",
                   "cudaLaunchKernelExC")
    aten = sum(e.count for e in table if e.key.startswith("aten::"))
    parts = {k: cpu_ms(k) / steps for k in (
        "decode.forward", "decode.step_kernel", "decode.sample")}
    sync = cpu_ms("cudaStreamSynchronize", "cudaMemcpyAsync",
                  "cudaDeviceSynchronize")
    top = sorted(table, key=lambda e: -e.self_cpu_time_total)[:8]
    log(f"decode profile, {cfg.mixer}, {cfg.dtype}, {slots} slots, "
        f"{blocks} blocks x {block} steps: {1e3 * bare:.2f} ms a step "
        f"unprofiled, {1e3 * wall / steps:.2f} ms profiled; host time a "
        f"step (profiled): forward {parts['decode.forward']:.2f} ms, of it "
        f"the {cfg.n_layers} step-kernel wrappers "
        f"{parts['decode.step_kernel']:.2f} ms; sampling "
        f"{parts['decode.sample']:.2f} ms; the block's sync and copy "
        f"{sync / blocks:.2f} ms a block; {calls(*launch_keys) / steps:.0f} "
        f"kernel launches ({cpu_ms(*launch_keys) / steps:.2f} ms) and "
        f"{aten / steps:.0f} aten ops a step; device busy "
        f"{device_ms / steps:.2f} ms a step ({device_ms / (1e3 * wall):.1%} "
        "of the profiled window); top host ops by self time: "
        + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / steps:.3f} ms "
                    f"({e.count / steps:.0f}/step)" for e in top))
    if device_ms <= 0:
        log("decode profile: torch.profiler recorded no device time")


# --------------------------------------------------------------------------
# phase 8: the serving front-end (runs after phase 5)
# --------------------------------------------------------------------------


FE_PREFIX = 384  # the prompts' shared prefix: three cache chunks
FE_CHUNK = 128  # cache key granularity
#: unique tokens after the prefix, per request of the fp32 run: prompt
#: lengths 400-640, so the chunk-aligned boundary falls on 384 or 512
FE_SUFFIXES = (16, 200, 64, 256, 130, 90, 240, 33)


def frontend_requests(cfg, suffixes, gen, seed=1, **per_rid):
    """Prompts of the shared ``FE_PREFIX``-token prefix and ``suffixes[i]``
    unique tokens; ``per_rid[name](i)`` sets a request field."""
    import numpy as np

    from repro_torch.serving.engine import GenRequest

    rng = np.random.RandomState(seed)
    prefix = rng.randint(2, cfg.vocab, FE_PREFIX)
    return [GenRequest(
        rid=i, prompt=np.concatenate([prefix, rng.randint(2, cfg.vocab, n)]),
        max_new=gen, **{k: f(i) for k, f in per_rid.items()})
        for i, n in enumerate(suffixes)]


def _admitted(engine):
    """rid -> (prompt length, cached prefix) of every admission."""
    return {e["rid"]: (e["prompt_len"], e["cached_prefix"])
            for e in engine.obs.events("request.admitted")}


def _want_launches(cfg, engine, admitted):
    """The chunk and step launches a front-end run must make: 24 chunk
    launches per admission and per carry advance (an admission whose
    chunk-aligned boundary lies past its cached prefix) and per spec round,
    24 step launches per decode step and per replay step."""
    chunk_name, step_name = SERVE_KERNELS[cfg.mixer]
    st = engine.stats
    advances = sum((L - 1) // FE_CHUNK * FE_CHUNK > hit
                   for L, hit in admitted.values())
    want = {chunk_name: cfg.n_layers * (len(admitted) + advances
                                        + st["spec_rounds"]),
            step_name: cfg.n_layers * (st["decode_steps"]
                                       + st["spec_replay_steps"])}
    return {k: v for k, v in want.items() if v}, advances


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_counted(device, fn):
    """``fn()`` with the launch counts zeroed before and read after, and
    every plain-version call counted; on the card a plain call fails.
    Returns ``(fn's result, launches, wall seconds)``.  On the CPU (a
    rehearsal) the plain versions run and nothing launches."""
    from repro_torch.kernels.ops import LAUNCHES

    plain_calls, restore = _count_plain_calls(SERVE_PLAINS)
    _sync(device)
    LAUNCHES.clear()  # count this path only
    t0 = time.perf_counter()
    try:
        out = fn()
        _sync(device)
    finally:
        restore()
    wall = time.perf_counter() - t0
    if device.type == "cuda" and plain_calls:
        raise AssertionError(f"plain versions called: {plain_calls}")
    return out, dict(LAUNCHES), wall


def _serve_async(engine, reqs):
    import asyncio

    from repro_torch.serving.server import AsyncServer, collect

    async def main():
        async with AsyncServer(engine) as srv:
            return await asyncio.gather(*[collect(srv, r) for r in reqs])

    outs = asyncio.run(main())
    for (toks, res), r in zip(outs, reqs):
        if toks != res.tokens:
            raise AssertionError(f"request {r.rid}: streamed {len(toks)} "
                                 f"tokens != result {len(res.tokens)}")
    return [res for _, res in outs]


def frontend_exact(params, cfg, device, gen=16):
    """(a) fp32: the phase's requests with a prefix cache against the
    same engine's streams without one: every cache hit's stream equal
    token for token; a cold admission with the cache attached (two
    prefill calls instead of one) may part only at a near-tie, a cold top-2
    logit gap within 4x the route error measured there.  Hits resume at
    384 (and some advance and insert at 512), one injected
    ``cache.corrupt`` is dropped and its request goes cold; launches
    exact."""
    from repro_torch.obs import Obs
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    from repro_torch.serving import Engine, PrefixCache

    cfg32 = cfg.replace(dtype="float32")
    reqs = frontend_requests(cfg32, FE_SUFFIXES, gen)
    kw = dict(slots=4, max_len=FE_PREFIX + 256 + gen + 8, block=8, seed=0,
              device=device)
    cold_eng = Engine(cfg32, params, **kw)
    cold_eng.run(frontend_requests(cfg32, FE_SUFFIXES[:1], 2))  # warm
    cold = cold_eng.run(reqs)
    del cold_eng
    cache = PrefixCache(granularity=FE_CHUNK, budget_bytes=1 << 40)
    engine = Engine(cfg32, params, cache=cache, obs=Obs(),
                    faults=FaultPlan(FaultSpec("cache.corrupt", at=1)), **kw)
    got, launches, wall = _run_counted(device, lambda: engine.run(reqs))
    parted = [r.rid for r, c in zip(got, cold) if r.tokens != c.tokens]
    bad = [(r.rid, r.status) for r in got if r.status != "ok"]
    admitted = _admitted(engine)
    hits = {rid: hit for rid, (L, hit) in admitted.items() if hit}
    dropped = engine.obs.registry.get("cache_corrupt_dropped_total").total()
    corrupt_rid = next(rid for rid, (L, hit) in sorted(admitted.items())
                       if rid and not hit)
    want, advances = _want_launches(cfg32, engine, admitted)
    ttft = {k: engine.obs.registry.get(f"serving_ttft_{k}_seconds")
            for k in ("cold", "hit")}
    log(f"front-end fp32 {cfg.mixer}: {len(reqs)} requests with a prefix "
        f"cache (granularity {FE_CHUNK}) vs without, in {wall:.2f}s: "
        f"{len(reqs) - len(parted)} of {len(reqs)} streams equal; hits "
        f"(rid: prefix) {hits}; entries at lengths "
        f"{sorted(n for n, c in cache._lengths.items() if c)}; corrupt "
        f"dropped {dropped:.0f} (request {corrupt_rid} went cold); "
        f"{advances} carry advances; TTFT p50 cold "
        + " vs hit ".join(f"{1e3 * (h.quantile(0.5) or 0.0):.1f} ms "
                          f"({h.count()})" for h in ttft.values())
        + f"; launches {launches}")
    if bad:
        raise AssertionError(f"fp32 cached run statuses {bad}")
    if parted:
        # a cold admission with the cache attached prefills in two calls
        # (to the aligned boundary, then the rest), a hit resumes from a
        # snapshot: the same sums as one prefill in another order.  Measure
        # that route error where a stream parts and the cold route's top-2
        # gap there
        errs, gaps = {}, {}
        for rid in parted:
            pos = _parted_at(cold[rid].tokens, got[rid].tokens)
            L, hit = admitted[rid]
            one, split = split_route_logits(
                engine.params, cfg32, reqs[rid].prompt,
                cold[rid].tokens[:pos], hit, (L - 1) // FE_CHUNK * FE_CHUNK)
            errs[rid] = float((one - split).abs().max())
            top2 = one.topk(2).values
            gaps[rid] = (pos, float(top2[0] - top2[1]))
        log(f"front-end fp32 {cfg.mixer}: streams {parted} part from cold: "
            + "; ".join(f"request {rid} (cached prefix {admitted[rid][1]}) "
                        f"at {gaps[rid][0]}, cold top-2 logit gap "
                        f"{gaps[rid][1]:.3e}, route error {errs[rid]:.3e}"
                        for rid in parted))
        wide = [rid for rid in parted
                if hits.get(rid) or gaps[rid][1] > 4 * errs[rid]]
        if wide:
            raise AssertionError(f"fp32 streams {wide} part from cold at a "
                                 "cache hit or beyond a near-tie")
    long_hits = [rid for rid in hits if admitted[rid][0] > 512]
    if FE_PREFIX not in hits.values() or not long_hits or \
            not cache._lengths[512]:
        raise AssertionError("no hit at 384, or none advanced to 512 and "
                             "inserted there")
    if dropped != 1:
        raise AssertionError(f"{dropped} corrupt entries dropped, want 1")
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want}")
    return dict(streams=[r.tokens for r in got], admitted=admitted)


def split_route_logits(params, cfg, prompt, toks, hit, aligned):
    """The last logits after ``prompt + toks`` two ways, one request: the
    cold engine's route (one prefill of the prompt, then a decode step per
    token) and the cached engine's (prefill to ``hit`` (a snapshot), then
    to ``aligned``, then the rest from the carry, then the same steps)."""
    import torch

    from repro_torch.models import lm

    dev = params["embed"]["embedding"].device
    p = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    t = torch.as_tensor(toks, dtype=torch.long, device=dev)[None]

    def steps(last, st):
        for j in range(t.shape[1]):
            logits, _, _ = lm.lm_apply(params, t[:, j:j + 1], cfg, states=st,
                                       mode="decode")
            last = logits[:, -1]
        return last[0].float()

    with torch.no_grad():
        one = steps(*lm.lm_prefill(params, p, cfg))
        carry = None
        for a, b in ((0, hit), (hit, aligned)):
            if b > a:
                _, carry = lm.lm_prefill(params, p[:, a:b], cfg,
                                         states=carry)
        split = steps(*lm.lm_prefill(params, p[:, max(hit, aligned):], cfg,
                                     states=carry))
    return one, split


def hit_split(engine, cfg, device, reqs, reps=3):
    """The parts of a cache-hit admission at full size, each timed alone
    (host clock around work that ends in a synchronize, median of
    ``reps``): the crc32 over the 384 entry, its host->device restore, the
    suffix prefill of a prompt <= 512 tokens from it, the carry advance
    384 -> 512 of a longer prompt and the device->host snapshot of the 512
    state; beside a cold prefill of the same short prompt.  Returns ms."""
    import statistics as stats_mod

    import torch

    from repro_torch.models import lm
    from repro_torch.serving.cache import tree_checksum

    entry = next(e for e in engine.cache._entries.values()
                 if e.key[0] == FE_PREFIX)
    snap = entry.state
    short = next(r for r in reqs if len(r.prompt) <= 512)
    long = next(r for r in reqs if len(r.prompt) > 512)

    def ids(r, a, b=None):
        return torch.as_tensor(r.prompt[None, a:b], device=device)

    def timed(fn):
        out = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            out.append(1e3 * (time.perf_counter() - t0))
        return stats_mod.median(out)

    p = engine.params
    with torch.no_grad():
        carry = type(snap)(*(x.to(device) for x in snap))
        _, c512 = lm.lm_prefill(p, ids(long, FE_PREFIX, 512), cfg,
                                states=carry)
        ms = dict(
            crc32=timed(lambda: tree_checksum(snap)),
            restore=timed(lambda: [x.to(device, non_blocking=True)
                                   for x in snap]),
            suffix=timed(lambda: lm.lm_prefill(
                p, ids(short, FE_PREFIX), cfg, states=carry)),
            advance=timed(lambda: lm.lm_prefill(
                p, ids(long, FE_PREFIX, 512), cfg, states=carry)),
            snapshot=timed(lambda: [x.to("cpu", non_blocking=True, copy=True)
                                    for x in c512]),
            cold=timed(lambda: lm.lm_prefill(p, ids(short, 0), cfg)))
    pinned = all(x.is_pinned() for x in snap)
    log(f"hit admission split, {cfg.mixer} {cfg.dtype}, entry "
        f"{entry.nbytes:,} bytes ({'pinned' if pinned else 'pageable'} "
        f"host memory): crc32 {ms['crc32']:.2f} ms, host->device restore "
        f"{ms['restore']:.2f} ms, suffix prefill of "
        f"{len(short.prompt) - FE_PREFIX} tokens {ms['suffix']:.2f} ms; a "
        f"longer prompt's carry advance 384 -> 512 {ms['advance']:.2f} ms and "
        f"its device->host snapshot {ms['snapshot']:.2f} ms; cold prefill "
        f"of the {len(short.prompt)}-token prompt {ms['cold']:.2f} ms")
    return ms


def frontend_load(params, cfg, device, spec=None, n_req=16, gen=32):
    """(b) bf16 through ``AsyncServer``: ``n_req`` requests (2 tenants, 2
    priorities, 4 slots, block 8) sharing the 384-token prefix, a cache of
    3 entries' budget (LRU evicts at full size), one request expiring while
    queued, one cancelled, ``engine.nan_state`` once (and with ``spec``,
    ``drafter.propose`` once, in both runs, with a breaker that stays open
    after it: the rest decodes in plain blocks).  A baseline run without
    the NaN gives the streams of the requests admitted before it fired.
    Checks statuses, the neighbours' streams, exact launches, no plain
    call, and the run's artifacts through ``obs.validate``; logs TTFT cold
    vs hit, hit rate, bytes per entry, decode tok/s and peak memory.
    Returns the run's numbers."""
    import collections

    import numpy as np
    import torch

    from repro_torch.obs import JsonlSink, Obs, validate, write_metrics
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    from repro_torch.serving import Engine, PrefixCache, state_bytes_for
    from repro_torch.serving.spec import SpecConfig

    rng = np.random.RandomState(2)
    suffixes = rng.randint(16, 257, n_req)
    # the first admission (rid 0) ends at or before 512 tokens, so its
    # boundary state is the shared 384 prefix's: the entry the others hit
    suffixes[0] = 40
    expiring, cancelled = n_req - 1, n_req - 2
    reqs = lambda: frontend_requests(  # noqa: E731
        cfg, suffixes, gen, seed=3, tenant=lambda i: "ab"[i % 2],
        priority=lambda i: (i // 2) % 2,
        deadline_s=lambda i: 0.0 if i == expiring else None)
    per_entry = state_bytes_for(cfg)
    cuda = device.type == "cuda"
    name = cfg.mixer + (f" spec {spec['drafter']}" if spec else "")
    for faulted in (False, True):
        engine = Engine(
            cfg, params, slots=4, max_len=FE_PREFIX + 256 + gen + 8, block=8,
            seed=0, device=device, obs=Obs(),
            spec=None if spec is None else SpecConfig(**spec))
        # warm the cold, carry and resume paths through the server
        engine.cache = PrefixCache(granularity=FE_CHUNK,
                                   budget_bytes=4 * per_entry)
        warm = frontend_requests(cfg, (200,), 2, seed=4)[0]
        for rid in (-1, -2):
            warm.rid = rid
            _serve_async(engine, [warm])
        engine.cache = PrefixCache(granularity=FE_CHUNK,
                                   budget_bytes=3 * per_entry + per_entry // 2,
                                   namespace=cfg.name, obs=engine.obs)
        engine.obs.reset()
        engine.reset_breaker()
        art = ROOT / "build" / "chip_smoke" / f"{name.replace(' ', '_')}"
        art.mkdir(parents=True, exist_ok=True)
        sink = JsonlSink(str(art / "events.jsonl"),
                         epoch_offset_ns=engine.obs.tracer.epoch_offset_ns)
        engine.obs.attach(sink)
        faults = [FaultSpec("engine.nan_state", at=2, arg=1)] \
            if faulted else []
        if spec:
            faults.append(FaultSpec("drafter.propose", at=12))
        engine.faults = FaultPlan(*faults) if faults else None
        if not engine.cancel(cancelled):
            raise AssertionError(f"request {cancelled} not cancellable")
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        batch = reqs()
        results, launches, wall = _run_counted(
            device, lambda: _serve_async(engine, batch))
        sink.close()
        write_metrics(engine.obs.snapshot(), str(art / "metrics.json"))
        if not faulted:  # free the baseline engine before the measured run
            base = {r.rid: r.tokens for r in results}
            del engine
    statuses = collections.Counter(r.status for r in results)
    want_status = {"ok": n_req - 3, "error": 1, "timeout": 1, "cancelled": 1}
    by_rid = {r.rid: r for r in results}
    evs = engine.obs.events()
    fired = next(e["seq"] for e in evs if e["name"] == "fault.fired"
                 and e["point"] == "engine.nan_state")
    before = [e["rid"] for e in evs if e["name"] == "request.admitted"
              and e["seq"] < fired]
    quarantined = [r.rid for r in results if r.status == "error"]
    neighbours = [rid for rid in before if rid not in quarantined]
    parted = [rid for rid in neighbours if by_rid[rid].tokens != base[rid]]
    admitted = _admitted(engine)
    want, advances = _want_launches(cfg, engine, admitted)
    st = engine.stats
    reg = engine.obs.registry
    cache = engine.cache
    cs = cache.stats()
    cold = reg.get("serving_ttft_cold_seconds")
    hit = reg.get("serving_ttft_hit_seconds")
    decode_toks = max(st["generated_tokens"] - len(results), 0)
    out = dict(
        wall_s=wall, statuses=dict(statuses),
        ttft_cold_p50_ms=1e3 * (cold.quantile(0.5) or 0.0),
        ttft_hit_p50_ms=1e3 * (hit.quantile(0.5) or 0.0),
        n_cold=cold.count(), n_hit=hit.count(), hit_rate=cs["hit_rate"],
        bytes_per_entry=cs["bytes"] / max(cs["entries"], 1),
        evicted=cs["evicted_bytes"],
        decode_tok_s=decode_toks / st["decode_s"] if st["decode_s"] else 0.0,
        peak_gib=torch.cuda.max_memory_allocated(device) / 2**30 if cuda
        else 0.0, launches=launches, advances=advances)
    log(f"front-end load, {name}, {cfg.dtype}, through AsyncServer: "
        f"{n_req} requests (2 tenants, 2 priorities, 4 slots, block 8, gen "
        f"{gen}) in {wall:.2f}s | statuses {dict(statuses)} | TTFT p50 cold "
        f"{out['ttft_cold_p50_ms']:.1f} ms ({out['n_cold']}) vs hit "
        f"{out['ttft_hit_p50_ms']:.1f} ms ({out['n_hit']}) | hit rate "
        f"{cs['hit_rate']:.2f} ({cs['hits']:.0f} hits, {cs['misses']:.0f} "
        f"misses), {cs['entries']:.0f} entries of "
        f"{out['bytes_per_entry']:,.0f} bytes (state_bytes_for "
        f"{per_entry:,}), {cs['evicted_bytes']:,.0f} bytes evicted | "
        f"decode {out['decode_tok_s']:.1f} tok/s | peak memory "
        f"{out['peak_gib']:.2f} GiB | quarantined {quarantined}, neighbours "
        f"admitted before the NaN {neighbours}: {len(neighbours) - len(parted)}"
        f" keep their baseline streams | breaker trips {st['breaker_trips']}"
        f", spec rounds {st['spec_rounds']} | launches {launches}")
    if dict(statuses) != want_status or \
            by_rid[expiring].status != "timeout" or \
            by_rid[cancelled].status != "cancelled":
        raise AssertionError(f"statuses {dict(statuses)}, want {want_status}")
    if parted or not neighbours:
        raise AssertionError(f"neighbours {parted} parted from the baseline")
    if cuda and launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want}")
    if out["bytes_per_entry"] != per_entry or not cs["evicted_bytes"] or \
            not cs["hits"]:
        raise AssertionError(f"cache: {cs}, {per_entry} bytes an entry")
    if spec and (st["breaker_trips"] != 1 or not st["spec_rounds"]):
        raise AssertionError(f"{st['breaker_trips']} breaker trips, want 1 "
                             f"(after {st['spec_rounds']} spec rounds)")
    art = ROOT / "build" / "chip_smoke" / f"{name.replace(' ', '_')}"
    rc = validate.main([
        "--metrics", str(art / "metrics.json"),
        "--events", str(art / "events.jsonl"),
        "--expect-requests", str(n_req),
        "--expect-terminal-statuses", "cancelled,error,ok,timeout",
        "--expect-counter", "serving_quarantined_total=1",
        "--expect-counter-min", "cache_hits_total=1"])
    if rc:
        raise AssertionError("the run's artifacts fail obs.validate")
    return out, engine


def frontend_phase(params, cfg, device, spec=False):
    """Phase 8 for ``cfg.mixer``: (a) fp32 exactness, (b) bf16 under load,
    then the hit admission's time split on (b)'s cache; with ``spec`` also
    (b) with the n-gram drafter.  Returns (b)'s numbers, the split and
    (a)'s streams and admissions (phase 17's oracle)."""
    exact = frontend_exact(params, cfg, device)
    load, engine = frontend_load(params, cfg, device)
    reqs = frontend_requests(cfg, FE_SUFFIXES, 2)
    split = hit_split(engine, cfg, device, reqs)
    del engine
    if spec:
        frontend_load(params, cfg, device, spec=dict(
            k=SPEC_K, drafter="ngram", breaker_zero_rounds=2**31,
            breaker_cooldown_blocks=2**31))
    return load, split, exact


# --------------------------------------------------------------------------
# phase 6: training
# --------------------------------------------------------------------------


# each mixer's training kernels: (module under repro_torch.kernels, forward,
# backward); the plain records (phase 11) have none
TRAIN_KERNELS = {"hla2": ("hla2_chunk", "hla2_chunk_fwd", "hla2_chunk_bwd"),
                 "ahla": ("ahla_chunk", "ahla_chunk_fwd", "ahla_chunk_bwd")}


def _mixer_layers(cfg):
    """The layers that run ``cfg.mixer``: all of a uniform stack's, one a
    hybrid group."""
    return cfg.n_layers // cfg.group_size if cfg.group_size else \
        cfg.n_layers


def _moe_layers(cfg):
    """The layers with an MoE FFN."""
    from repro_torch.models import lm

    layout, units = lm.stack_layout(cfg)
    return units * sum(use_moe for _, _, use_moe in layout)


def _want_train(cfg, steps=1, microbatches=1):
    """Each training kernel's launches over ``steps`` steps of ``cfg``: per
    layer and microbatch one forward and one backward, and under
    ``remat="full"`` the forward again when backward recomputes the
    layer (``"full"`` and ``"dots"``).  A plain record launches none."""
    if cfg.mixer not in TRAIN_KERNELS:
        return {}
    _, fwd, bwd = TRAIN_KERNELS[cfg.mixer]
    passes = _mixer_layers(cfg) * steps * microbatches
    # "dots" recomputes all but the 2-d products: the kernels' forwards too
    return {fwd: passes * (2 if cfg.remat != "none" else 1), bwd: passes}


def _count_train(device, cfg, fn):
    """``fn()`` with the launch counts zeroed before and read after, and
    the plain versions of ``cfg.mixer``'s training kernels counted.
    Returns ``(fn's result, launches)``, where on the CPU (a rehearsal)
    the launches are the plain calls under their kernels' names."""
    import collections

    from repro_torch.kernels.ops import LAUNCHES

    plains = []
    if cfg.mixer in TRAIN_KERNELS:
        mod_name, fwd, bwd = TRAIN_KERNELS[cfg.mixer]
        plains = [(mod_name, f"{fwd}_plain"), (mod_name, f"{bwd}_plain")]
    plain_calls, restore = _count_plain_calls(plains)
    _sync(device)
    LAUNCHES.clear()  # count this path only
    try:
        out = fn()
        _sync(device)
    finally:
        restore()
    if device.type == "cuda":
        if plain_calls:
            raise AssertionError(f"plain versions called: {plain_calls}")
        return out, dict(LAUNCHES)
    return out, dict(collections.Counter(
        name.removesuffix("_plain") for name in plain_calls))


def train(device, cfg, steps=5, batch=2, seq=2048, lr=1e-5):
    """AdamW steps of ``cfg`` (its activations' dtype and remat, its
    ``param_dtype`` and ``moment_dtype``: fp32 but for jamba) on one
    repeated synthetic batch (with ``cfg.vis_tokens`` seeded patch
    embeddings x 0.1 before the tokens; for whisper ``cfg.enc_frames``
    seeded frame embeddings x 0.1 for the encoder).  Returns the launch
    counts of the run and its summary numbers."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.distributed.steps import make_train_step, model_specs
    from repro_torch.models.param import init_params
    from repro_torch.optim import adamw

    params = init_params(model_specs(cfg), 0, device)
    # with one warmup step, the default lr 3e-4 moves every weight by ~lr
    # at once: on this random-weight model the loss rose 11.0 -> 18.2 and
    # the gradient norm 109 -> 28757 (H100, 700 W); 1e-5 stays in the
    # regime where a step follows the gradient (bf16 storage needs more:
    # see hybrid_phase)
    opt_cfg = adamw.OptConfig(lr=lr, warmup_steps=1, total_steps=steps)
    state = adamw.init_opt_state(params, cfg.moment_dtype)
    step_fn = make_train_step(cfg, opt_cfg)
    host = SyntheticStream(DataConfig(cfg.vocab, seq, batch, seed=0)).batch(0)
    data = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    extra = {"vis_embed": cfg.vis_tokens, "frames": cfg.enc_frames
             if cfg.enc_layers else 0}
    for key, n in extra.items():
        if n:
            gen = torch.Generator(device=device).manual_seed(4)
            data[key] = torch.randn((batch, n, cfg.d_model), generator=gen,
                                    device=device) * 0.1
    _sync(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses, norms, auxes, step_s = [], [], [], []

    def run():
        nonlocal params, state
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, data)
            losses.append(float(m["loss"]))  # waits for the step
            step_s.append(time.perf_counter() - t0)
            norms.append(float(m["grad_norm"]))
            auxes.append(float(m["aux"]))

    _, launches = _count_train(device, cfg, run)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else 0.0
    p50 = float(np.percentile(step_s, 50))
    vis = "".join(f" (+ {n} {key})" for key, n in extra.items() if n)
    aux = f" | aux {' '.join(f'{x:.5f}' for x in auxes)}" if cfg.moe else ""
    log(f"trained {cfg.name} ({cfg.mixer}; {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype} activations, {cfg.param_dtype} "
        f"parameters, {cfg.moment_dtype} moments, remat {cfg.remat}, lr "
        f"{lr:g}) for {steps} AdamW steps on one "
        f"{batch} x {seq}{vis} batch: loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}{aux} | grad norm "
        f"{' '.join(f'{x:.3f}' for x in norms)} | step "
        f"{' '.join(f'{x:.3f}' for x in step_s)} s | step p50 {p50:.3f}s "
        f"| {batch * seq / p50:.0f} tok/s | peak memory {peak:.2f} GiB | "
        f"launches {launches}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError("non-finite loss or gradient norm")
    if steps > 1 and not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on the repeated batch")
    want = _want_train(cfg, steps)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want}")
    return launches, dict(step_p50_s=p50, tok_s=batch * seq / p50,
                          peak_gib=peak, losses=losses, auxes=auxes,
                          batch=batch, seq=seq)


def train_phase(device, mixer="hla2"):
    """Phase 6 for one mixer: the config's remat run (the main path, whose
    launches the kernels line reports), then the same steps without remat,
    to say what recomputing costs.  Returns the remat run's launches and
    summary numbers."""
    from repro_torch.configs import get_config

    cfg = get_config("hla-1b", mixer=mixer)
    launches, full = train(device, cfg)
    _, none = train(device, cfg.replace(remat="none"))
    log(f"remat cost ({mixer}): step p50 {full['step_p50_s']:.3f}s with "
        f"remat, {none['step_p50_s']:.3f}s without "
        f"({full['step_p50_s'] / none['step_p50_s'] - 1:+.1%}); peak memory "
        f"{full['peak_gib']:.2f} GiB with, {none['peak_gib']:.2f} GiB "
        f"without; losses equal: {full['losses'] == none['losses']}")
    return launches, full


# --------------------------------------------------------------------------
# phase 9: microbatches, remat and a restart (runs after phase 6)
# --------------------------------------------------------------------------


def _uneven_batch(cfg, device, batch=2, seq=2048):
    """One synthetic batch whose label mask is uneven across the
    microbatch boundary (row 0 loses its first third of labels, as
    ``tests/test_distributed.py`` masks its first rows)."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticStream

    host = SyntheticStream(DataConfig(cfg.vocab, seq, batch, seed=0)).batch(0)
    host["labels"][0, : seq // 3] = -1
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def _grads_phase(device, cfg, params, batch, microbatches, label):
    """``accumulate_grads`` counted and measured: returns ``(loss, grads)``
    and fails unless its launches are exactly the path's."""
    import torch

    from repro_torch.distributed.steps import accumulate_grads

    held = peak = float("nan")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device) / 2**30
    t0 = time.perf_counter()
    (loss, _, _, grads), launches = _count_train(
        device, cfg, lambda: accumulate_grads(params, batch, cfg,
                                              microbatches))
    dt = time.perf_counter() - t0
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**30
    want = _want_train(cfg, microbatches=microbatches)
    log(f"{label}: loss {float(loss):.6f} | {dt:.3f}s | peak memory "
        f"{peak:.2f} GiB, {peak - held:.2f} above the {held:.2f} GiB held "
        f"before the call | launches {launches}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    _grads_phase.peak = peak - held
    return loss, grads


def _grad_errs(a, b):
    """Loss and per-leaf gradient errors of ``a`` against ``b``, each
    relative to ``b``'s max|g| for that leaf."""
    (la, ga), (lb, gb) = a, b
    return rel_err(la, lb), {k: rel_err(x, gb[k]) for k, x in ga.items()}


def _same_grads(a, b, label):
    """Loss and every gradient leaf of ``a`` against ``b`` within
    ``TOL_FP32`` relative to the leaf's max|g|."""
    e_l, errs = _grad_errs(a, b)
    worst = max(errs, key=errs.get)
    log(f"{label}: loss rel {e_l:.2e} (tol {TOL_FP32:.0e}), gradients of "
        f"{len(errs)} leaves rel <= {errs[worst]:.2e} ({worst}; tol "
        f"{TOL_FP32:.0e})")
    if not (e_l <= TOL_FP32 and errs[worst] <= TOL_FP32):
        raise AssertionError(f"{label}: gradients disagree")


def _flat(tree):
    from repro_torch.models.param import leaf_paths

    return {"/".join(p): x for p, x in leaf_paths(tree)}


def _row_grads(params, batch, cfg):
    """The loss and gradients of ``batch`` as the sum of its rows', each
    row's taken alone (``lm_loss`` on one row, normalised by the whole
    batch's valid-label count) and the rows' gradients added in fp32:
    what ``accumulate_grads`` with one row per microbatch must give, by
    the same GEMMs."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.param import tree_map

    n_valid = (batch["labels"] >= 0).sum().clamp_min(1).float()
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    names, leaves = zip(*_flat(live).items())
    loss, total = 0.0, None
    for r in range(batch["tokens"].shape[0]):
        l, _ = lm.lm_loss(live, batch["tokens"][r:r + 1],
                          batch["labels"][r:r + 1], cfg, denom=n_valid)
        g = torch.autograd.grad(l, leaves)
        loss = loss + l.detach()
        if total is None:
            total = g
        else:
            for a, b in zip(total, g):
                a.add_(b)
        del g
    return loss, dict(zip(names, total))


def accum_remat_phase(device, cfg=None, seq=2048):
    """On one fp32 batch of 2 rows whose labels are masked unevenly across
    the microbatch boundary:

    (b) the config's remat (``"full"``) against ``"none"``, 1 microbatch:
    the same loss and every gradient leaf within ``TOL_FP32``; (f)
    ``remat="dots"`` against ``"none"`` likewise, its memory above what was
    held between the other two's;
    (a) ``accumulate_grads`` with 2 microbatches against the sum of the
    two rows' gradients, each taken alone with the whole batch's label
    count as denominator (``_row_grads``): the same GEMMs on both sides, so
    the loss and every gradient leaf within ``TOL_FP32``, and every leaf
    fp32.  A wrong denominator would move the gradients by ~25% (the rows
    hold 1366 and 2048 valid labels), a bf16 accumulator by up to 2^-8.
    2 microbatches against 1 is logged, not held: a 1-microbatch pass runs
    its projections as GEMMs of twice the rows, for which cuBLAS picks
    other kernels, and 24 fp32 layers amplify those last-bit differences
    (``scripts/grad_batch_variance.py`` on an H100, 700 W: gradients up to
    1.1e-3 apart; at 1 layer 3.6e-6).

    Each ``accumulate_grads`` run launches exactly its path's kernels
    (48 + 24 per microbatch with remat, 24 + 24 without) and no plain
    version; its peak memory is logged beside what was held before it
    (the parameters, and the earlier runs' gradients still compared)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.param import init_params

    cfg = (cfg or get_config("hla-1b")).replace(dtype="float32")
    params = init_params(lm.lm_specs(cfg), 0, device)
    batch = _uneven_batch(cfg, device, seq=seq)
    n_valid = [int((lab >= 0).sum()) for lab in batch["labels"]]
    what = (f"{cfg.name} ({cfg.mixer}, {cfg.n_layers} layers, fp32, "
            f"2 x {seq}, valid labels per row {n_valid}")

    def grads(c, mb, label):
        loss, g = _grads_phase(device, c, params, batch, mb, label)
        return loss, _flat(g)

    one = grads(cfg, 1, f"{what}, remat {cfg.remat}) 1 microbatch")
    peaks = {cfg.remat: _grads_phase.peak}
    none = grads(cfg.replace(remat="none"), 1,
                 f"{what}, remat none) 1 microbatch")
    peaks["none"] = _grads_phase.peak
    _same_grads(one, none, f"(b) remat {cfg.remat} vs none")
    # (f) remat "dots": the 2-d products' outputs kept, the rest (the
    # kernels' forwards among it) recomputed
    dots = grads(cfg.replace(remat="dots"), 1,
                 f"{what}, remat dots) 1 microbatch")
    peaks["dots"] = _grads_phase.peak
    _same_grads(dots, none, "(f) remat dots vs none")
    log(f"(f) memory above what was held, GiB: " + ", ".join(
        f"remat {k} {v:.2f}" for k, v in peaks.items()))
    if device.type == "cuda" and not \
            peaks[cfg.remat] < peaks["dots"] < peaks["none"]:
        raise AssertionError(f"(f) remat dots' peak is not between "
                             f"{cfg.remat}'s and none's: {peaks}")
    del none, dots
    two = grads(cfg, 2, f"{what}, remat {cfg.remat}) 2 microbatches")
    dtypes = {str(g.dtype) for g in two[1].values()}
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"(a) gradients accumulated in {dtypes}")
    _same_grads(two, _row_grads(params, batch, cfg),
                "(a) 2 microbatches vs the sum of the rows' gradients")
    e_l, errs = _grad_errs(two, one)
    worst = max(errs, key=errs.get)
    log(f"(a) reading, not held: 2 microbatches vs 1: loss rel {e_l:.2e}, "
        f"gradients rel <= {errs[worst]:.2e} ({worst})")
    del one, two, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    remat_steps(device, cfg)


def remat_steps(device, cfg, steps=2, seq=2048, lr=1e-5):
    """(f) ``steps`` AdamW steps of fp32 ``cfg`` with ``remat="dots"`` and
    with ``"none"``, each from the same seeded weights on one batch: every
    step's loss and the final parameters within ``TOL_FP32`` (relative to
    each leaf's largest), the launches of each path's steps exact."""
    import torch

    from repro_torch.distributed import steps as S
    from repro_torch.models import lm
    from repro_torch.models.param import init_params
    from repro_torch.optim import adamw

    batch = _uneven_batch(cfg, device, seq=seq)
    opt_cfg = adamw.OptConfig(lr=lr, warmup_steps=1, total_steps=steps)
    runs = {}
    for remat in ("dots", "none"):
        c = cfg.replace(remat=remat)
        params = init_params(lm.lm_specs(c), 0, device)
        state = adamw.init_opt_state(params)
        step = S.make_train_step(c, opt_cfg)
        losses = []

        def run():
            nonlocal params, state
            for _ in range(steps):
                params, state, m = step(params, state, batch)
                losses.append(float(m["loss"]))

        _, launches = _count_train(device, c, run)
        want = _want_train(c, steps)
        if launches != want:
            raise AssertionError(f"(f) remat {remat}: launches {launches}, "
                                 f"want {want}")
        runs[remat] = (losses, {k: x.detach().cpu() for k, x in
                                _flat(params).items()})
        del params, state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    (l_d, p_d), (l_n, p_n) = runs["dots"], runs["none"]
    e_l = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(l_d, l_n))
    errs = {k: rel_err(x, p_n[k]) for k, x in p_d.items()}
    worst = max(errs, key=errs.get)
    log(f"(f) {steps} AdamW steps (lr {lr}), remat dots vs none: losses "
        f"{' '.join(f'{x:.6f}' for x in l_d)} vs "
        f"{' '.join(f'{x:.6f}' for x in l_n)} (rel {e_l:.2e}), final "
        f"parameters rel <= {errs[worst]:.2e} ({worst}; tol {TOL_FP32:.0e})")
    if not (e_l <= TOL_FP32 and errs[worst] <= TOL_FP32):
        raise AssertionError("(f) remat dots' steps part from none's")


def restart_phase(device, cfg=None, seq=2048, steps=3):
    """(c) bf16, lr 1e-5: the per-step losses of ``steps`` uninterrupted
    AdamW steps; then a ``FaultTolerantLoop`` that checkpoints after step 1
    (``ckpt_every=2``, ``keep=1``) and dies at ``train.step`` hit 2, and a
    fresh loop over the same directory, which must resume from step 1 and
    give the uninterrupted run's step-2 loss bit for bit, with no checksum
    failure.  Logs the save's and the restore's seconds and GB/s."""
    import json
    import math
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.param import init_params
    from repro_torch.obs import Obs
    from repro_torch.optim import adamw
    from repro_torch.runtime.faults import FaultPlan, FaultSpec, InjectedFault
    from repro_torch.runtime.ft import FaultTolerantLoop

    cfg = cfg or get_config("hla-1b")
    opt_cfg = adamw.OptConfig(lr=1e-5, warmup_steps=1, total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg)
    stream = SyntheticStream(DataConfig(cfg.vocab, seq, 2, seed=0))

    def place(host):
        return {k: torch.from_numpy(v).to(device) for k, v in host.items()}

    def fresh():
        params = init_params(lm.lm_specs(cfg), 0, device)
        return params, adamw.init_opt_state(params)

    params, state = fresh()
    want = []
    for step in range(steps):
        params, state, m = step_fn(params, state, place(stream.batch(step)))
        want.append(float(m["loss"]))
    del params, state, m
    lines = []

    def keep(msg):
        lines.append(msg)
        log(msg)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        metrics = f"{d}/metrics.jsonl"
        loop = FaultTolerantLoop(
            step_fn, stream, f"{d}/ckpt", ckpt_every=2, keep=1,
            metrics_path=metrics, faults=FaultPlan(FaultSpec("train.step",
                                                             at=2)),
            log=keep, place_batch=place, obs=Obs())
        try:
            loop.run(*fresh(), steps)
        except InjectedFault as e:
            if e.point != "train.step":
                raise
        else:
            raise AssertionError("the injected train.step fault did not fire")
        saved = loop.obs.registry
        del loop
        if device.type == "cuda":
            torch.cuda.empty_cache()
        loop = FaultTolerantLoop(step_fn, stream, f"{d}/ckpt", ckpt_every=2,
                                 keep=1, metrics_path=metrics, log=keep,
                                 place_batch=place, obs=Obs())
        loop.run(*fresh(), steps)
        with open(metrics) as f:
            got = [(r["step"], r["loss"]) for r in map(json.loads, f)]
        with open(f"{d}/ckpt/step_00000001/manifest.json") as f:
            n_bytes = sum(np.dtype(x["dtype"]).itemsize * math.prod(x["shape"])
                          for x in json.load(f)["leaves"].values())
        reg = loop.obs.registry
    save_s = saved.get("ckpt_save_seconds").sum()
    restore_s = reg.get("ckpt_restore_seconds").sum()
    crc = reg.get("ckpt_checksum_failures_total").total()
    log(f"(c) {cfg.name} ({cfg.mixer}, {cfg.n_layers} layers, {cfg.dtype}, "
        f"2 x {seq}) restart: uninterrupted losses {want}; the loops' "
        f"(step, loss) {got}; one checkpoint of {n_bytes:,} bytes: save "
        f"{save_s:.3f}s ({n_bytes / save_s / 1e9:.2f} GB/s, "
        f"{saved.get('ckpt_saves_total').total():.0f} saved), restore "
        f"{restore_s:.3f}s ({n_bytes / restore_s / 1e9:.2f} GB/s); "
        f"checksum failures {crc:.0f}")
    if "[ft] resumed from step 1" not in lines:
        raise AssertionError("the second loop did not resume from step 1")
    if got != [(0, want[0]), (1, want[1]), (2, want[2])]:
        raise AssertionError(f"the loops' losses {got} are not the "
                             f"uninterrupted run's {want}")
    if crc:
        raise AssertionError("checksum failures on restore")


# --------------------------------------------------------------------------
# phase 10: the main path's tooling (runs after phase 9)
# --------------------------------------------------------------------------


# (script, arguments, environment, a line each run must print, how many
# times); "{tmp}" is a temporary directory the phase removes
EXAMPLES = (
    ("examples/torch_quickstart.py", ["--steps", "30", "--batch", "8",
                                      "--seq", "64"], {}, "loss: ", 1),
    ("examples/torch_long_context_decode.py", ["--ctx", "512"], {},
     "decode state never grew", 1),
    ("examples/torch_hla_vs_baselines.py", ["--steps", "40"], {},
     "recall accuracy: ", 5),
    ("examples/torch_train_hla_100m.py",
     ["--ckpt-dir", "{tmp}/ck", "--ckpt-every", "20", "--metrics",
      "{tmp}/metrics.jsonl"], {"STEPS": "20"},
     "[train] finished at step 19 |", 1),
)


def contracts_phase(device, mixer):
    """(a) the four entry points' run-time contracts at full width."""
    from repro_torch.analysis import contracts
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    reports = contracts.check_entry_points(
        get_config("hla-1b", mixer=mixer), device=device)
    for r in reports:
        log(f"(a) contract {mixer} {contracts.format_report(r)}")
    bad = {r.name: r.violations for r in reports if not r.ok}
    if bad:
        raise AssertionError(f"contracts violated ({mixer}): {bad}")
    log(f"(a) {mixer}: every contract held ({time.perf_counter() - t0:.1f}s)")
    return reports


def utilization_phase(device, served, trained):
    """(b) the analytic cost of each path at the shape it ran, and the
    share of the card's peak its measured tok/s reaches: ``served`` and
    ``trained`` map each mixer to phase 4's and phase 6's summaries."""
    from repro_torch.configs import get_config
    from repro_torch.obs.costs import model_cost
    from repro_torch.obs.perf import device_peak, roofline_utilization

    peak = device_peak(device)
    log(f"(b) device_peak: {peak}")
    rows = []
    for mixer in ("hla2", "ahla"):
        cfg = get_config("hla-1b", mixer=mixer)
        s, t = served[mixer], trained[mixer]
        paths = (
            ("prefill", s["prefill_tok_s"],
             dict(mode="prefill", seq_len=int(s["prompt_p50"]), batch=1)),
            ("decode_step", s["decode_tok_s"],
             dict(mode="decode_step", seq_len=int(s["prompt_p50"]),
                  batch=s["slots"])),
            ("train_step", t["tok_s"],
             dict(mode="train_step", seq_len=t["seq"], batch=t["batch"])),
        )
        for name, tok_s, kw in paths:
            cost = model_cost(cfg, **kw)
            u = roofline_utilization(tok_s, cost, peak)
            rows.append((mixer, name, u))
            log(f"(b) {mixer} {name} {kw}: {cost.flops_per_token:.4e} "
                f"FLOP/token, {cost.bytes_per_token:.4e} B/token; measured "
                f"{tok_s:.1f} tok/s -> {u['achieved_flops_per_s'] / 1e12:.2f}"
                f" TFLOP/s ({u['compute_util']:.2%} of "
                f"{peak['flops_per_s'] / 1e12:.0f}), "
                f"{u['achieved_bytes_per_s'] / 1e9:.1f} GB/s "
                f"({u['memory_util']:.2%} of "
                f"{peak['bytes_per_s'] / 1e12:.2f} TB/s); {u['bound']}-bound"
                f", utilization {u['utilization']:.2%}")
    return rows


def examples_phase():
    """(d) the four examples on the card, each in its own interpreter; the
    100M example must leave one checkpoint in its directory."""
    import os
    import tempfile

    for path, args, extra, want, count in EXAMPLES:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            argv = [a.replace("{tmp}", tmp) for a in args]
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
            out = subprocess.run([sys.executable, str(ROOT / path), *argv],
                                 cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=300)
            ckpts = sorted(os.listdir(f"{tmp}/ck")) \
                if os.path.isdir(f"{tmp}/ck") else None
        lines = out.stdout.strip().splitlines()
        env_text = "".join(f"{k}={v} " for k, v in extra.items())
        log(f"(d) {env_text}{path} {' '.join(args)}: exit {out.returncode} "
            f"in {time.perf_counter() - t0:.1f}s; "
            f"{' | '.join(lines[-max(4, count):])}"
            + ("" if ckpts is None else f"; checkpoints {ckpts}"))
        if out.returncode != 0 or sum(want in x for x in lines) != count \
                or ckpts != (["step_00000019"] if "--ckpt-dir" in args
                             else None):
            raise AssertionError(f"{path} failed:\n{out.stdout}\n"
                                 f"{out.stderr}")


def tooling_phase(device, served, trained):
    """Phase 10: (a) contracts, (b) utilization, (c) phase 6's peak, (d) the
    examples."""
    t0 = time.perf_counter()
    for mixer in ("hla2", "ahla"):
        contracts_phase(device, mixer)
    utilization_phase(device, served, trained)
    log("(c) phase 6 peak memory with the in-place AdamW: " + ", ".join(
        f"{m} {t['peak_gib']:.2f} GiB" for m, t in trained.items()))
    examples_phase()
    log(f"phase 10 took {time.perf_counter() - t0:.1f}s")


# --------------------------------------------------------------------------
# phase 11: the rest of the HLA operator family (runs after phase 10)
# --------------------------------------------------------------------------


#: the plain-torch records of the HLA family (no hand-written kernel)
FAMILY = ("hla3", "hla3_paper", "linattn")


def _no_launches(device, label, fn, allowed=None):
    """``_run_counted(fn)``; on the card fails unless the launches equal
    ``allowed`` (default none).  Returns ``(fn's result, launches)``."""
    out, launches, _ = _run_counted(device, fn)
    launches = {k: v for k, v in launches.items() if v}
    if device.type == "cuda" and launches != (allowed or {}):
        raise AssertionError(f"{label}: kernel launches {launches}, want "
                             f"{allowed or {}}")
    return out, launches


def _linattn_serial(q, k, v, gamma, state):
    """``linattn_step`` over every token (the core has no serial form)."""
    import torch

    from repro_torch.core.linear_attn import linattn_step

    outs = []
    for t in range(q.shape[-2]):
        state, o = linattn_step(state, q[..., t, :], k[..., t, :],
                                v[..., t, :], gamma)
        outs.append(o)
    return torch.stack(outs, -2), state


def family_core_phase(device, d=128, heads=16, n=200, n_scan=64):
    """(a) the core identities at head_dim ``d``, fp32, one row of
    ``heads`` heads, hla-1b's initial decay sigmoid(3): chunkwise (chunk
    128, so a ragged second chunk at ``n``) equals the serial recurrence
    for ``linattn``, ``hla3`` (outputs and nested states) and
    ``hla3_paper`` (Algorithm 3 against the chunk path, gamma = 1); the
    token-level scan equals chunkwise for ``hla2`` and ``ahla`` at
    ``n_scan``.  Within ``TOL_FP32``; no kernel launches."""
    import torch

    from repro_torch.core import ahla, hla2, hla3, linear_attn
    from repro_torch.models.state_tree import leaves

    gen = torch.Generator(device=device).manual_seed(11)

    def qkv(m):
        q, k, v, _ = _inputs(gen, heads, m, d, d, torch.float32, device)
        return q[None], k[None], v[None]

    gamma = torch.sigmoid(torch.full((1, heads), 3.0, device=device))
    q, k, v = qkv(n)
    qs, ks, vs = qkv(n_scan)
    st0 = linear_attn.linattn_init_state((1, heads), d, d, device=device)
    cases = {
        f"linattn chunkwise vs serial, n {n}": (
            linear_attn.linattn_chunkwise(q, k, v, gamma, chunk=128),
            _linattn_serial(q, k, v, gamma, st0)),
        f"hla3 chunkwise vs serial, n {n}": (
            hla3.hla3_exact_chunkwise(q, k, v, gamma, chunk=128),
            hla3.hla3_exact_serial(q, k, v, gamma)),
        f"hla3_paper chunkwise vs Alg. 3 serial, n {n}": (
            (hla3.hla3_paper_chunkwise(q, k, v, chunk=128)[0], None),
            (hla3.hla3_paper_serial(q, k, v)[0], None)),
        f"hla2 scan vs chunkwise, n {n_scan}": (
            hla2.hla2_scan(qs, ks, vs, gamma),
            hla2.hla2_chunkwise(qs, ks, vs, gamma, chunk=128)),
        f"ahla scan vs chunkwise, n {n_scan}": (
            ahla.ahla_scan(qs, ks, vs, gamma),
            ahla.ahla_chunkwise(qs, ks, vs, gamma, chunk=128)),
    }
    for label, ((o, st), (o_w, st_w)) in cases.items():
        pairs = [(o, o_w)] + ([] if st is None else
                              list(zip(leaves(st), leaves(st_w))))
        errs = [rel_err(a, b) for a, b in pairs]
        finite = all(bool(a.isfinite().all()) for a, _ in pairs)
        log(f"(a) {label}: output rel {errs[0]:.2e}, state leaves max rel "
            f"{max(errs[1:], default=0.0):.2e} (tol {TOL_FP32:.0e})")
        if not finite or max(errs) > TOL_FP32:
            raise AssertionError(f"{label}: disagree or non-finite")


def family_model_phase(params, cfg, device):
    """(b) ``cfg`` (full-width hla-1b on the card) in fp32: prefill(L) +
    one decode step equals prefill(L + 1) for each plain record (no kernel
    launch); an ``impl="scan"`` HLA2 prefill of 64 tokens equals the kernel
    prefill (no launch), and a decode step after it launches one
    ``hla2_step`` per layer."""
    import dataclasses

    import torch

    from repro_torch.models import lm
    from repro_torch.models.state_tree import leaves

    cfg = cfg.replace(dtype="float32")
    for mixer in FAMILY:
        _no_launches(device, f"identity {mixer}",
                     lambda: check_identity(params, cfg.replace(mixer=mixer)))
    scan_cfg = cfg.replace(hla=dataclasses.replace(cfg.hla, impl="scan"))
    tok = torch.randint(2, cfg.vocab, (1, 65), device=device,
                        generator=torch.Generator(device=device).manual_seed(5))
    with torch.no_grad():
        (scan, st), _ = _no_launches(
            device, "scan prefill",
            lambda: lm.lm_prefill(params, tok[:, :64], scan_cfg))
        kern, st_k = lm.lm_prefill(params, tok[:, :64], cfg)
        e = rel_err(scan, kern)
        es = max(rel_err(a, b) for a, b in zip(leaves(st), leaves(st_k)))
        # the decode step updates ``st`` in place
        _, launches = _no_launches(
            device, "decode after the scan prefill",
            lambda: lm.lm_apply(params, tok[:, 64:], scan_cfg, states=st,
                                mode="decode"),
            allowed={"hla2_step": cfg.n_layers} if device.type == "cuda"
            else None)
    log(f"(b) {cfg.name} fp32 HLA2 impl=\"scan\" prefill of 64 tokens vs the "
        f"kernel prefill: logits rel {e:.2e}, state leaves max rel {es:.2e} "
        f"(tol {TOL_LOGITS:.0e}); a decode step after it launches "
        f"{launches}")
    if not e <= TOL_LOGITS or not es <= TOL_LOGITS:
        raise AssertionError("scan prefill != kernel prefill")


def family_serve(params, cfg, device, n_req=8, slots=4, lens=(256, 640),
                 gen=64, block=8):
    """(c) phase 4's requests with a plain record: all ``ok``, no kernel
    launch.  Returns the summary numbers and streams."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import Engine, GenRequest

    engine = Engine(cfg, params, slots=slots, max_len=lens[1] + gen + 8,
                    block=block, seed=0, device=device)
    reqs = serve_requests(cfg, n_req, lens, gen)
    engine.run([GenRequest(rid=-1, prompt=reqs[0].prompt, max_new=block)])
    engine.obs.reset()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    results, launches = _no_launches(device, f"serve {cfg.mixer}",
                                     lambda: engine.run(reqs))
    wall = time.perf_counter() - t0
    bad = [(r.rid, r.status, len(r.tokens), r.error) for r in results
           if r.status != "ok" or len(r.tokens) != gen]
    if bad:
        raise AssertionError(f"requests not served: {bad}")
    st = engine.stats
    peak = torch.cuda.max_memory_allocated(device) / 2**30 \
        if device.type == "cuda" else 0.0
    # each result's ttft_s: its admission alone, the queue wait left out
    ttfts = [r.ttft_s for r in results]
    out = dict(ttft_p50_ms=1e3 * float(np.percentile(ttfts, 50)),
               decode_tok_s=(st["generated_tokens"] - n_req) / st["decode_s"],
               prefill_tok_s=st["prompt_tokens"] / st["prefill_s"],
               peak_gib=peak, streams=[r.tokens for r in results])
    log(f"(c) served {n_req} requests with {cfg.mixer} (prompts "
        f"{lens[0]}-{lens[1]}, gen {gen}, {slots} slots, block {block}, "
        f"{cfg.dtype}) in {wall:.2f}s: TTFT p50 {out['ttft_p50_ms']:.1f} ms "
        f"| decode {out['decode_tok_s']:.1f} tok/s | prefill "
        f"{out['prefill_tok_s']:.1f} tok/s | peak memory {peak:.2f} GiB | "
        f"{st['decode_steps']} decode steps | launches {launches}")
    return out


def family_exact_serving(params, cfg, device, n_req=4, gen=32):
    """(c) ``cfg.mixer`` in fp32: speculative greedy with the always-wrong
    drafter (every round rolls the nested state back) equals plain greedy
    token for token; a second pass of the front-end requests through a
    prefix cache (every admission a hit) equals the cold streams, and an
    entry holds ``state_bytes_for(cfg)`` bytes.  No kernel launch."""
    from repro_torch.serving import Engine, PrefixCache, state_bytes_for
    from repro_torch.serving.spec import SpecConfig

    cfg32 = cfg.replace(dtype="float32")
    reqs = serve_requests(cfg32, n_req, (256, 640), gen)
    kw = dict(slots=4, max_len=640 + gen + 8, block=8, seed=0, device=device)
    plain = Engine(cfg32, params, **kw).run(reqs)
    spec = Engine(cfg32, params, spec=SpecConfig(
        k=SPEC_K, drafter=_wrong_drafter(), breaker_zero_rounds=2**31), **kw)
    got, _ = _no_launches(device, f"spec {cfg.mixer}",
                          lambda: spec.run(reqs))
    st = spec.stats
    parted = [r.rid for r, p in zip(got, plain) if r.tokens != p.tokens]
    log(f"(c) {cfg.mixer} fp32 speculative greedy, always-wrong drafter, k "
        f"{SPEC_K}: {n_req - len(parted)} of {n_req} streams equal plain "
        f"greedy; {st['spec_rounds']} rounds, {st['spec_replays']} rolled "
        f"back, {st['spec_replay_steps']} replay steps, breaker trips "
        f"{st['breaker_trips']}")
    if parted or st["spec_replays"] != st["spec_rounds"] or \
            not st["spec_rounds"] or st["breaker_trips"]:
        raise AssertionError(f"spec streams {parted} part from plain, or "
                             "not every round rolled back")

    fe = frontend_requests(cfg32, FE_SUFFIXES, gen)
    fkw = dict(kw, max_len=FE_PREFIX + 256 + gen + 8)
    cold = Engine(cfg32, params, **fkw).run(fe)
    cache = PrefixCache(granularity=FE_CHUNK, budget_bytes=1 << 40)
    warm = Engine(cfg32, params, cache=cache, **fkw)
    warm.run(fe)  # fills the cache at each prompt's aligned boundary
    warm.obs.reset()
    got, _ = _no_launches(device, f"cache {cfg.mixer}", lambda: warm.run(fe))
    hits = dict(sorted((e["rid"], e["cached_prefix"])
                       for e in warm.obs.events("request.admitted")))
    parted = [r.rid for r, c in zip(got, cold) if r.tokens != c.tokens]
    entries, nbytes = int(cache.stats()["entries"]), int(cache.stats()["bytes"])
    entry = nbytes // max(entries, 1)
    log(f"(c) {cfg.mixer} fp32 prefix cache (granularity {FE_CHUNK}): hits "
        f"(rid: prefix) {hits}; {len(fe) - len(parted)} of {len(fe)} hit "
        f"streams equal cold; {entries} entries of {entry:,} bytes "
        f"(state_bytes_for {state_bytes_for(cfg32):,})")
    if parted or not all(hits.values()) or not entries or \
            nbytes != entries * state_bytes_for(cfg32):
        raise AssertionError(f"cache hit streams {parted} part from cold, a "
                             "request missed, or an entry's bytes differ")
    return entry


def family_phase(device):
    """Phase 11: (a) core identities, (b) full-width model identities and
    the scan route, (c) serving with each plain record, (d) training
    ``hla3``.  Returns the summary numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.param import init_params

    t0 = time.perf_counter()
    family_core_phase(device)
    cfg = get_config("hla-1b")
    params = init_params(lm.lm_specs(cfg), 0, device)
    family_model_phase(params, cfg, device)
    served = {m: family_serve(params, cfg.replace(mixer=m), device)
              for m in FAMILY}
    entry = family_exact_serving(params, cfg.replace(mixer="hla3"), device)
    del params
    # (d) at 12 of the 24 layers, to keep the whole script near 600 s
    _, trained = train(device, cfg.replace(mixer="hla3", n_layers=12),
                       steps=3)
    log(f"phase 11 took {time.perf_counter() - t0:.1f}s")
    return dict(served=served, trained=trained, hla3_entry_bytes=entry)


# --------------------------------------------------------------------------
# phase 12: softmax attention and the dense public configs (after phase 11)
# --------------------------------------------------------------------------


# fp32 decode logits against one cache prefill over the same tokens, both
# reading bf16 KV caches (the reference's numerics).  Readings (H100, 700
# W): codeqwen1.5-7b 1.88e-6 at 32 layers; nemotron-4-15b 9.52e-5 at 2,
# where layer 0's prompt K/V from GEMMs of 256 and 272 rows round to other
# bf16 values in 373 elements and the difference spreads to 4% of layer
# 1's.  It cannot tell codeqwen's planted position fault (1.68e-4) from
# that rounding, so TOL_CACHE_FP32 carries the fault check
TOL_CACHE = 3e-4
# the same comparison with fp32 caches, the rounding taken out: readings
# 1.41e-6 and 3.63e-6; each planted fault must part by more than this
TOL_CACHE_FP32 = 2e-5
# fp32 decode logits against the train-mode forward, whose K/V are not
# rounded to bf16: the reference's own tolerance for this comparison
# (tests/test_archs.py::test_decode_matches_full_forward)
TOL_CACHE_VS_TRAIN = 5e-2
# the planted faults: decode() keyword arguments
FAULTS = (("decode positions + 1", dict(pos_shift=1)),
          ("cache length + 1", dict(len_shift=1)))
FAULT_STEPS = 4  # decode steps of each planted fault
# the configs phase 12 runs, each at full width
PUBLIC = ("codeqwen1.5-7b", "internvl2-2b", "nemotron-4-15b")


def _free(device):
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def dropin_serve(device, cfg, mixers=("hla2", "ahla"),
                 tag="profile_codeqwen"):
    """(a) ``cfg`` (codeqwen1.5-7b; phase 13: the MoE configs) with each of
    ``mixers`` in place of its attention (one set of weights: they share a
    layout): fp32 prefill(L) + a decode step equals prefill(L + 1) (an MoE
    config with no pair dropped, ``_no_drop``, and all its routes alike),
    then phase 4's 8 requests in bf16 through ``Engine``, every one
    ``ok``, exactly ``n_layers`` chunk launches per admission and step
    launches per decode step, no plain version, and with ``hla2`` a
    profile of decode steps (``tag``, none if None); ``Engine`` refuses the
    config's own ``attn``.  Returns each mixer's summary numbers (with the
    identity's logit error and routing agreement)."""
    from repro_torch.models import lm
    from repro_torch.models.param import init_params
    from repro_torch.serving.engine import Engine

    params = init_params(lm.lm_specs(cfg.replace(mixer="hla2")), 0, device)
    out = {}
    for mixer in mixers:
        mcfg = cfg.replace(mixer=mixer)
        e_id, agree = check_identity(
            params, _no_drop(mcfg).replace(dtype="float32"))
        plain_calls, restore = _count_plain_calls(SERVE_PLAINS)
        try:
            launches, served = serve(params, mcfg.replace(dtype="bfloat16"),
                                     device)
        finally:
            restore()
        if device.type == "cuda" and plain_calls:
            raise AssertionError(f"plain versions called: {plain_calls}")
        if mixer == "hla2" and device.type == "cuda" and tag:
            # where a 32-layer decode step's time goes (phase 4b's method)
            profile_decode(params, mcfg.replace(dtype="bfloat16"), device,
                           tag=tag)
        served.pop("streams")
        out[mixer] = dict(served, launches=launches, identity=e_id,
                          routing=agree)
        _free(device)
    try:
        Engine(cfg, params, device=device)
    except ValueError as e:
        log(f"(a) Engine on {cfg.name}'s own attn refuses: {e}")
    else:
        raise AssertionError("Engine accepted the non-streaming attn op")
    return out


def _profile_calls(device, fn, calls=2):
    """``torch.profiler`` (CPU and CUDA activity) over ``fn(0)``, ...,
    ``fn(calls - 1)``: a call's kernel launches, aten ops, device busy ms
    (the device rows' own time) and wall ms under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for j in range(calls):
            fn(j)
        _sync(device)
        wall = time.perf_counter() - t0
    table = prof.key_averages()
    launch_keys = ("cudaLaunchKernel", "cuLaunchKernelEx",
                   "cudaLaunchKernelExC")
    return dict(
        launches=sum(e.count for e in table if e.key in launch_keys) / calls,
        aten_ops=sum(e.count for e in table
                     if e.key.startswith("aten::")) / calls,
        device_ms=sum(e.self_device_time_total for e in table
                      if e.device_type == DeviceType.CUDA) / 1e3 / calls,
        wall_ms=1e3 * wall / calls)


@contextlib.contextmanager
def _fp32_kv_cache():
    """Every KV cache made inside holds fp32 K/V: the control that takes
    the bf16 cache's rounding out of a comparison."""
    from repro_torch.models import attention

    made = attention.init_kv_cache

    def fp32(*args, **kw):
        c = made(*args, **kw)
        return c._replace(k=c.k.float(), v=c.v.float())

    attention.init_kv_cache = fp32
    try:
        yield
    finally:
        attention.init_kv_cache = made


def _kv_parted(a, b, prompt, n):
    """The K/V elements of two stacked bf16 caches that differ over
    positions [0, n), in layer 0 and in every layer, for the prompt's
    positions and the decoded ones: ``{region: (parted in layer 0, its
    elements, parted in all, their elements, the largest difference over
    the largest magnitude)}``."""
    import torch

    out = {}
    for region, sl in (("prompt", slice(0, prompt)),
                       ("decoded", slice(prompt, n))):
        xs = torch.stack([a.k[:, :, :, sl], a.v[:, :, :, sl]])
        ys = torch.stack([b.k[:, :, :, sl], b.v[:, :, :, sl]])
        parted = xs != ys
        out[region] = (int(parted[:, 0].sum()), parted[:, 0].numel(),
                       int(parted.sum()), parted.numel(), rel_err(xs, ys))
    return out


def attn_decode(device, cfg, prompt=300, steps=16, bf16=True, tag=None):
    """(b), (e): ``cfg`` with softmax attention, fp32 parameters, 2 rows:
    an fp32 ``lm_prefill`` of ``prompt`` tokens into a KV cache, then
    ``steps`` greedy decode steps (``lm_apply(mode="decode",
    positions=...)``); their logits equal one cache prefill over all the
    tokens (``TOL_CACHE``), the same with fp32 caches
    (``TOL_CACHE_FP32``) and the train-mode forward
    (``TOL_CACHE_VS_TRAIN``, its K/V unrounded).  Logged: the K/V elements
    whose bf16 rounding differs between the two caches, and the planted
    ``FAULTS`` in either cache dtype; with fp32 caches each must part from
    the cache prefill by more than ``TOL_CACHE_FP32``.  With ``bf16`` the
    same decode in bf16 activations, logging ms a decode step, and one
    more decode step under the contracts' watch: no host transfer, no sync
    warning.  None of the six kernels launches.  Returns the summary
    numbers."""
    import torch

    from repro_torch.analysis.contracts import _watch
    from repro_torch.models import lm
    from repro_torch.models.param import init_params

    cfg32 = cfg.replace(dtype="float32")
    params = init_params(lm.lm_specs(cfg), 0, device)
    B = 2
    gen = torch.Generator(device=device).manual_seed(7)
    prompt_tok = torch.randint(2, cfg.vocab, (B, prompt), device=device,
                               generator=gen)
    cuda = device.type == "cuda"
    tag = tag or ("b" if bf16 else "e")

    def decode(c, p, n_steps, feed=None, pos_shift=0, len_shift=0):
        """Prefill, then ``n_steps`` decode steps, greedy or fed ``feed``'s
        tokens; ``pos_shift`` and ``len_shift`` plant a fault (the decode
        positions, every layer's cache length, off by that much).  Returns
        (the decode logits (B, n_steps, vocab), every token fed, the
        states, seconds a step)."""
        last, st = lm.lm_prefill(p, prompt_tok, c)
        if len_shift:
            st.length.add_(len_shift)
        tok = last.argmax(-1, keepdim=True)
        fed, logits, secs = [prompt_tok], [], []
        for j in range(n_steps):
            if feed is not None:
                tok = feed[:, j:j + 1]
            pos = torch.full((B, 1), prompt + j + pos_shift, device=device)
            _sync(device)
            t0 = time.perf_counter()
            lg, st, _ = lm.lm_apply(p, tok, c, states=st, positions=pos,
                                    mode="decode")
            _sync(device)
            secs.append(time.perf_counter() - t0)
            fed.append(tok)
            logits.append(lg)
            tok = lg[:, -1].argmax(-1, keepdim=True)
        return torch.cat(logits, 1), torch.cat(fed, 1), st, secs

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        (dec, toks, st_dec, secs32), _ = _no_launches(
            device, f"{cfg.name} fp32 decode",
            lambda: decode(cfg32, params, steps))
        (full, st_full, _), _ = _no_launches(
            device, f"{cfg.name} fp32 cache prefill",
            lambda: lm.lm_apply(params, toks, cfg32, mode="prefill"))
        trained, _, _ = lm.lm_apply(params, toks, cfg32)
        e_cache = rel_err(dec, full[:, prompt:])
        e_train = rel_err(dec, trained[:, prompt:])
        parted = _kv_parted(st_dec, st_full, prompt, prompt + steps)
        del trained, st_dec, st_full

        def planted(full, toks):
            """Each fault's fed decode logits against the cache prefill."""
            feed = toks[:, prompt:prompt + FAULT_STEPS]
            return {label: rel_err(
                decode(cfg32, params, FAULT_STEPS, feed=feed, **kw)[0],
                full[:, prompt:prompt + FAULT_STEPS])
                for label, kw in FAULTS}

        faults = planted(full, toks)
        del full
        with _fp32_kv_cache():
            dec_c, toks_c, _, _ = decode(cfg32, params, steps)
            full_c, _, _ = lm.lm_apply(params, toks_c, cfg32, mode="prefill")
            e_fp32_cache = rel_err(dec_c, full_c[:, prompt:])
            faults_fp32 = planted(full_c, toks_c)
        del dec_c, full_c
    out = dict(fp32_ms=1e3 * statistics.median(secs32), e_cache=e_cache,
               e_train=e_train, e_fp32_cache=e_fp32_cache, parted=parted,
               faults=faults, faults_fp32=faults_fp32)
    log(f"({tag}) {cfg.name} (attn; {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"{cfg.mlp}) fp32, {B} rows: prefill {prompt} + {steps} greedy "
        f"decode steps vs one cache prefill of {prompt + steps}: logits rel "
        f"{e_cache:.2e} (tol {TOL_CACHE:.0e}); with fp32 caches "
        f"{e_fp32_cache:.2e} (tol {TOL_CACHE_FP32:.0e}); vs the train-mode "
        f"forward (unrounded K/V) rel {e_train:.2e} (tol "
        f"{TOL_CACHE_VS_TRAIN:.0e}); a decode step {out['fp32_ms']:.2f} ms")
    for region, (p0, n0, pa, na, e_kv) in parted.items():
        log(f"({tag}) {cfg.name} K/V elements of the {region} positions "
            f"that round to other bf16 values in the decode route's cache "
            f"than in the cache prefill's: layer 0 {p0:,} of {n0:,}, all "
            f"layers {pa:,} of {na:,} ({pa / na:.2e}); K/V rel {e_kv:.2e}")
    for label, _ in FAULTS:
        log(f"({tag}) {cfg.name} planted fault, {label}, {FAULT_STEPS} fed "
            f"decode steps vs the cache prefill: logits rel "
            f"{faults[label]:.2e} with bf16 caches; "
            f"{faults_fp32[label]:.2e} with fp32 caches (must exceed "
            f"TOL_CACHE_FP32 {TOL_CACHE_FP32:.0e})")
    if not bool(dec.isfinite().all()) or e_cache > TOL_CACHE or \
            e_fp32_cache > TOL_CACHE_FP32 or e_train > TOL_CACHE_VS_TRAIN:
        raise AssertionError("attn decode != cache prefill / forward")
    if min(faults_fp32.values()) <= TOL_CACHE_FP32:
        raise AssertionError("TOL_CACHE_FP32 passes a planted fault")
    if bf16:
        cfg16 = cfg.replace(dtype="bfloat16")
        p16 = lm.cast_params(params, cfg16)
        del params
        _free(device)
        with torch.no_grad():
            (dec16, _, st, secs), _ = _no_launches(
                device, f"{cfg.name} bf16 decode",
                lambda: decode(cfg16, p16, steps))
            nxt = dec16[:, -1].argmax(-1, keepdim=True)

            def step(j):
                pos = torch.full((B, 1), prompt + steps + j, device=device)
                return lm.lm_apply(p16, nxt, cfg16, states=st,
                                   positions=pos, mode="decode")

            prof = _profile_calls(device, step, calls=2)
            with _watch(device) as w:
                step(2)
        transfers = sum(w.transfers.values())
        out.update(bf16_ms=1e3 * statistics.median(secs),
                   transfers=transfers, sync_warnings=w.sync_warnings)
        out.update(prof)
        log(f"({tag}) {cfg.name} bf16 decode: {out['bf16_ms']:.2f} ms a step "
            f"({out['bf16_ms'] / B:.2f} ms a token, {B} rows, context "
            f"{prompt}-{prompt + steps}); profiled: {prof['launches']:.0f} "
            f"kernel launches and {prof['aten_ops']:.0f} aten ops a step, "
            f"device busy {prof['device_ms']:.2f} of {prof['wall_ms']:.2f} "
            f"ms; one step under the watch: {transfers} host transfers, "
            f"{w.sync_warnings} sync warnings")
        if transfers or w.sync_warnings:
            raise AssertionError("an attn decode step synced the host")
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 \
        if cuda else 0.0
    log(f"{cfg.name} attn decode peak memory {out['peak_gib']:.2f} GiB")
    return out


def public_phase(device, configs):
    """Phase 12 on ``configs``, which maps each arch of ``PUBLIC`` to its
    config (the full ones on the card; ``reduced()`` ones rehearse on the
    CPU): (a) codeqwen1.5-7b served with hla2/ahla, (b) its own attn
    decoding, (c) internvl2-2b training with attn and vis_embed, (d)
    codeqwen1.5-7b training with hla2 at 4 layers, (e) nemotron-4-15b at 2
    layers decoding with attn.  Returns the summary numbers."""
    t0 = time.perf_counter()
    codeqwen = configs["codeqwen1.5-7b"]
    _free(device)
    served = dropin_serve(device, codeqwen)
    _free(device)
    decoded = attn_decode(device, codeqwen)
    _free(device)
    vlm_launches, vlm = train(device, configs["internvl2-2b"], steps=3)
    _free(device)
    dropin_launches, dropin_trained = train(
        device, codeqwen.replace(mixer="hla2", n_layers=4), steps=3)
    _free(device)
    nemotron = attn_decode(device,
                           configs["nemotron-4-15b"].replace(n_layers=2),
                           prompt=128, steps=8, bf16=False)
    log(f"phase 12 took {time.perf_counter() - t0:.1f}s")
    return dict(served=served, decoded=decoded, vlm=vlm,
                vlm_launches=vlm_launches, dropin_trained=dropin_trained,
                dropin_launches=dropin_launches, nemotron=nemotron)


# --------------------------------------------------------------------------
# phase 13: GLA and the mixture-of-experts configs (after phase 12)
# --------------------------------------------------------------------------


# the MoE configs phase 13 runs, each at full width
MOE = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
# qwen3-moe-30b-a3b's depth: all 48 layers (30.5 B, 122 GB fp32) need
# several cards; 12 (8.10 B) fit one 80 GB card, and 6 keep the whole
# script near its time budget once phase 15 runs (its widths stay whole)
QWEN3_LAYERS = 6


def gla_phase(device, cfg):
    """(g) ``cfg`` (hla-1b) with ``gla``, plain torch: phase 4's requests
    through ``Engine`` and one AdamW step at 2 x 2048 (its time), none of
    the six kernels launched.  Returns the summary numbers."""
    from repro_torch.models import lm
    from repro_torch.models.param import init_params

    gcfg = cfg.replace(mixer="gla")
    params = init_params(lm.lm_specs(gcfg), 0, device)
    served = family_serve(params, gcfg, device)
    served.pop("streams")
    del params
    _free(device)
    launches, trained = train(device, gcfg, steps=1)
    if launches:
        raise AssertionError(f"gla training launched {launches}")
    return dict(served=served, trained=trained)


def moe_phase(device, configs):
    """Phase 13 on ``configs``, which maps each arch of ``MOE`` and
    ``"hla-1b"`` to its config (the full ones on the card; ``reduced()``
    ones rehearse on the CPU): (a) granite-moe-3b-a800m served with ``hla2``
    and ``ahla`` in place of its attention, with (b) the fp32 identity and
    its routing agreement first; (c) its own ``attn`` decoding (no pair
    dropped); (d) its training at full depth with ``attn``, ``hla2`` and
    ``ahla``; (e) qwen3-moe-30b-a3b at ``QWEN3_LAYERS`` layers served with
    ``hla2`` after its identity; (f) granite's entry points' contracts
    with ``hla2``; (g) hla-1b with ``gla``.  Returns the summary
    numbers."""
    from repro_torch.analysis import contracts

    t0 = time.perf_counter()
    granite = configs["granite-moe-3b-a800m"]
    qwen3 = configs["qwen3-moe-30b-a3b"]
    qwen3 = qwen3.replace(n_layers=min(qwen3.n_layers, QWEN3_LAYERS))
    _free(device)
    served = dropin_serve(device, granite, tag="profile_granite")
    _free(device)
    decoded = attn_decode(device, _no_drop(granite), tag="c")
    _free(device)
    trained, train_launches = {}, {}
    for mixer in ("softmax", "hla2", "ahla"):
        train_launches[mixer], trained[mixer] = train(
            device, granite.replace(mixer=mixer), steps=3)
        _free(device)
    qwen3_served = dropin_serve(device, qwen3, mixers=("hla2",), tag=None)
    _free(device)
    reports = contracts.check_entry_points(granite.replace(mixer="hla2"),
                                           device=device)
    for r in reports:
        log(f"(f) contract {granite.name} hla2 "
            f"{contracts.format_report(r)}")
    bad = {r.name: r.violations for r in reports if not r.ok}
    if bad:
        raise AssertionError(f"contracts violated ({granite.name}): {bad}")
    _free(device)
    gla = gla_phase(device, configs["hla-1b"])
    _free(device)
    log(f"phase 13 took {time.perf_counter() - t0:.1f}s")
    return dict(served=served, decoded=decoded, trained=trained,
                train_launches=train_launches, qwen3_served=qwen3_served,
                contracts=[r.syncs for r in reports], gla=gla)


# --------------------------------------------------------------------------
# phase 14: Mamba, RWKV-6 and the hybrid group stack (after phase 13)
# --------------------------------------------------------------------------


# the configs phase 14 runs
HYBRID = ("rwkv6-7b", "jamba-1.5-large-398b")
# rwkv6-7b trains at 8 of its 32 layers: AdamW's fp32 parameters,
# gradients and two moments take 16 B a parameter, 121 GB for all 7.53 B
# (2.29 B, ~37 GB at 8)
RWKV_TRAIN_LAYERS = 8
# jamba-1.5-large-398b on one 80 GB card: one group (8 layers) at full
# width with 4 of its 16 experts (top 2 kept) holds 16.25 B parameters,
# 32.5 GB in its bf16 (a full-width group with all 16 is 45.2 B)
JAMBA_EXPERTS = 4
# jamba trains at half width (``_jamba_half``: d_model 4096, 32 heads of
# 128, 4 KV heads, d_ff 12288 dense and per expert, 4 experts): 4.33 B
# parameters, ~35 GB of bf16 parameters, gradients and two moments; even a
# full-width group with 2 experts (11.42 B) would need ~91 GB
# bf16 storage swallows an update under half an ulp: at 1e-5 a step moves a
# weight of ~0.016 by ~1e-5, below bf16's half ulp there (3e-5), so the
# weights would not change; jamba trains at the reference's default lr
JAMBA_LR = 3e-4
HYBRID_STEPS = 16  # greedy decode steps after the jamba prefill


def _jamba_cut(cfg, **kw):
    """``cfg`` at one group (8 layers) and ``JAMBA_EXPERTS`` experts, top 2
    kept; ``kw`` replaces more fields (the training cut's widths)."""
    moe = dataclasses.replace(cfg.moe, n_experts=min(cfg.moe.n_experts,
                                                     JAMBA_EXPERTS))
    if "d_ff" in kw:
        moe = dataclasses.replace(moe, d_ff=kw["d_ff"])
    return cfg.replace(n_layers=cfg.group_size, moe=moe, **kw)


def _jamba_half(cfg):
    """The training cut: ``_jamba_cut`` at half of every width but the
    head dim (half the heads, half the KV heads, half of d_ff)."""
    return _jamba_cut(cfg, mixer="hla2", d_model=cfg.d_model // 2,
                      n_heads=cfg.n_heads // 2,
                      n_kv_heads=cfg.n_kv_heads // 2, d_ff=cfg.d_ff // 2)


def _attn_view(params, cfg):
    """``params`` (an HLA mixer at the attention position) as ``cfg``'s
    op reads them: for ``attn``, the position's ``wq``/``wk``/``wv``/``wo``
    under the record's own key (the same tensors; ``out_scale`` and
    ``decay_a`` unused)."""
    from repro_torch.models import seq_op

    op = seq_op.op_for(cfg)
    if op.param_key == "mixer":
        return params
    key = f"pos{cfg.attn_index}"
    pos = dict(params["groups"][key])
    mix = pos.pop("mixer")
    pos[op.param_key] = {k: mix[k] for k in ("wq", "wk", "wv", "wo")}
    return dict(params, groups=dict(params["groups"], **{key: pos}))


def _params_to(params, dtype):
    """Every leaf of ``params`` cast to ``dtype`` in place of the old one
    (leaf by leaf, so the two copies never coexist)."""
    for key, x in params.items():
        if isinstance(x, dict):
            _params_to(x, dtype)
        else:
            params[key] = x.to(dtype)
    return params


def rwkv_serve(params, cfg, device):
    """(a) phase 4's 8 requests in bf16 through ``Engine``, 4 slots, no
    kernel launch; then a profile of one decode step of the 4 slots
    (launches, aten ops, device busy).  Returns the summary numbers."""
    import torch

    from repro_torch.models import lm

    bf = cfg.replace(dtype="bfloat16")
    served = family_serve(params, bf, device)
    served.pop("streams")
    _free(device)
    cast = lm.cast_params(params, bf)
    st = lm.lm_init_states(bf, 4, device)
    tok = torch.full((4, 1), 7, dtype=torch.long, device=device)
    with torch.no_grad():
        prof = _profile_calls(device, lambda j: lm.lm_apply(
            cast, tok, bf, states=st, mode="decode"))
    log(f"(a) {cfg.name} one decode step of 4 slots under torch.profiler: "
        f"{prof['launches']:.0f} launches, {prof['aten_ops']:.0f} aten ops, "
        f"device busy {prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} "
        f"ms wall")
    del cast, st
    return dict(served, profile=prof)


def rwkv_spec(params, cfg, device, n_req=2, gen=32):
    """(b) fp32: ``n_req`` requests whose prompts repeat a 16-token motif
    (so the n-gram drafter proposes), served speculatively (``ngram``, k
    ``SPEC_K``), equal plain greedy token for token; no kernel launch."""
    import numpy as np

    from repro_torch.serving.engine import Engine, GenRequest
    from repro_torch.serving.spec import SpecConfig

    cfg32 = cfg.replace(dtype="float32")
    rs = np.random.RandomState(5)
    reqs = [GenRequest(rid=i, prompt=np.tile(rs.randint(2, cfg.vocab, 16),
                                             16), max_new=gen)
            for i in range(n_req)]
    kw = dict(slots=n_req, max_len=256 + gen + 8, block=8, seed=0,
              device=device)
    plain = Engine(cfg32, params, **kw).run(reqs)
    spec = Engine(cfg32, params, spec=SpecConfig(
        k=SPEC_K, drafter="ngram", breaker_zero_rounds=2**31), **kw)
    got, _ = _no_launches(device, f"spec {cfg.name}", lambda: spec.run(reqs))
    st = spec.stats
    parted = [r.rid for r, p in zip(got, plain) if r.tokens != p.tokens]
    log(f"(b) {cfg.name} fp32 speculative greedy, ngram drafter, k "
        f"{SPEC_K}: {n_req - len(parted)} of {n_req} streams equal plain "
        f"greedy; {st['spec_rounds']} rounds, {st['spec_replays']} rolled "
        f"back, {st['spec_accepted']} drafts accepted of "
        f"{st['spec_drafted']}")
    if parted or not st["spec_rounds"] or st["breaker_trips"]:
        raise AssertionError(f"spec streams {parted} part from plain greedy")
    return dict(rounds=st["spec_rounds"], replays=st["spec_replays"])


def hybrid_decode(params, cfg, device, prompt=300, steps=HYBRID_STEPS,
                  rows=2):
    """(d) ``cfg`` (jamba at its serving cut, bf16): ``rows`` prompts of
    ``prompt`` tokens through ``lm_prefill``, then ``steps`` greedy
    decode steps through ``lm_apply`` (the engine refuses hybrid stacks).
    With ``hla2`` exactly one ``hla2_chunk_fwd`` a prefill and one
    ``hla2_step`` a decode step (one group), no plain version on a CUDA
    tensor; with ``attn`` no launch.  Returns the summary numbers."""
    import torch

    from repro_torch.models import lm

    cast = lm.cast_params(params, cfg)
    gen = torch.Generator(device=device).manual_seed(2)
    toks = torch.randint(2, cfg.vocab, (rows, prompt), generator=gen,
                         device=device)
    want = ({"hla2_chunk_fwd": 1}, {"hla2_step": 1}) \
        if cfg.mixer == "hla2" else ({}, {})
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        (last, st), pre_l, pre_s = _run_counted(
            device, lambda: lm.lm_prefill(cast, toks, cfg))
        tok = last.argmax(-1, keepdim=True)
        step_s, step_l = [], []
        for t in range(steps):
            pos = torch.full((rows, 1), prompt + t, device=device)
            (logits, _, _), l_t, s_t = _run_counted(
                device, lambda: lm.lm_apply(cast, tok, cfg, states=st,
                                            positions=pos, mode="decode"))
            tok = logits[:, -1].argmax(-1, keepdim=True)
            step_s.append(s_t)
            step_l.append({k: v for k, v in l_t.items() if v})
    peak = torch.cuda.max_memory_allocated(device) / 2**30 \
        if device.type == "cuda" else 0.0
    pre_l = {k: v for k, v in pre_l.items() if v}
    ms = 1e3 * sorted(step_s)[len(step_s) // 2]
    log(f"(d) {cfg.name} ({cfg.mixer}; {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe.n_experts} experts top {cfg.moe.top_k}, "
        f"{cfg.param_dtype} parameters, {cfg.dtype}): prefill {rows} x "
        f"{prompt} in {1e3 * pre_s:.1f} ms (launches {pre_l}), {steps} "
        f"greedy decode steps, p50 {ms:.2f} ms a step (launches a step "
        f"{step_l[0]}) | peak memory {peak:.2f} GiB")
    if device.type == "cuda" and (pre_l != want[0] or any(
            x != want[1] for x in step_l)):
        raise AssertionError(f"launches {pre_l} / {step_l}, want {want}")
    if not bool(logits.isfinite().all()):
        raise AssertionError("non-finite decode logits")
    return dict(prefill_ms=1e3 * pre_s, step_ms=ms, peak_gib=peak,
                launches={k: pre_l.get(k, 0) + sum(x.get(k, 0)
                                                   for x in step_l)
                          for k in set(pre_l) | set(step_l[0])})


def hybrid_phase(device, configs):
    """Phase 14 on ``configs``, which maps each arch of ``HYBRID`` to its
    config (the full ones on the card; ``reduced()`` ones rehearse on the
    CPU): (a) rwkv6-7b at full size served through ``Engine`` and a
    one-step profile; (b) its fp32 identity and speculative streams; (c)
    its training at ``RWKV_TRAIN_LAYERS`` layers; (e) jamba's fp32
    identity at its serving cut with ``hla2`` and (d) that cut in bf16
    decoding with ``hla2`` and its own ``attn``; (f) jamba training at
    half width with ``hla2``.  Returns the summary numbers."""
    import torch

    from repro_torch.distributed.steps import model_specs
    from repro_torch.models import lm
    from repro_torch.models.param import init_params, param_count
    from repro_torch.serving.engine import check_servable

    t0 = time.perf_counter()
    rwkv = configs["rwkv6-7b"]
    jamba = configs["jamba-1.5-large-398b"]
    _free(device)
    params = init_params(model_specs(rwkv), 0, device)
    log(f"(a) {rwkv.name}: {rwkv.n_layers} layers, "
        f"{param_count(lm.lm_specs(rwkv)) / 1e9:.2f} B parameters")
    served = rwkv_serve(params, rwkv, device)
    _free(device)
    e_id, _ = check_identity(params, rwkv.replace(dtype="float32"))
    spec = rwkv_spec(params, rwkv, device)
    del params
    _free(device)
    rwkv_launches, rwkv_trained = train(
        device, rwkv.replace(n_layers=min(rwkv.n_layers, RWKV_TRAIN_LAYERS),
                             remat="full"), steps=3)
    if rwkv_launches:
        raise AssertionError(f"rwkv6 training launched {rwkv_launches}")
    _free(device)

    cut = _jamba_cut(jamba, mixer="hla2")
    for mixer in (None, "hla2"):
        try:
            check_servable(cut if mixer else cut.replace(mixer=jamba.mixer))
        except ValueError as e:
            log(f"(d) Engine refuses {cut.name} ({mixer or jamba.mixer}): "
                f"{e}")
        else:
            raise AssertionError("Engine accepted a hybrid stack")
    # (e) first, in fp32: the same weights then serve (d) rounded to bf16
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = init_params(lm.lm_specs(cut), 0, device)
    log(f"(e) {cut.name} at one group, {cut.moe.n_experts} experts: "
        f"{param_count(lm.lm_specs(cut)) / 1e9:.2f} B parameters")
    e_jamba, agree = check_identity(params, _no_drop(cut).replace(
        dtype="float32"))
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        log(f"(e) peak memory {peak:.2f} GiB")
    _params_to(params, torch.bfloat16)
    _free(device)
    decoded = {}
    for mixer in ("hla2", jamba.mixer):
        mcfg = cut.replace(mixer=mixer, dtype="bfloat16",
                           param_dtype="bfloat16")
        decoded[mixer] = hybrid_decode(_attn_view(params, mcfg), mcfg,
                                       device)
        _free(device)
    del params
    _free(device)
    half = _jamba_half(jamba)
    log(f"(f) {half.name} at half width: "
        f"{param_count(lm.lm_specs(half)) / 1e9:.2f} B parameters")
    jamba_launches, jamba_trained = train(device, half, steps=3,
                                          seq=1024, lr=JAMBA_LR)
    log(f"phase 14 took {time.perf_counter() - t0:.1f}s")
    return dict(served=served, rwkv_identity=e_id, spec=spec,
                rwkv_trained=rwkv_trained, jamba_identity=e_jamba,
                routing=agree, decoded=decoded, jamba_trained=jamba_trained,
                jamba_train_launches=jamba_launches)


# --------------------------------------------------------------------------
# phase 15: whisper-small, encoder and decoder (after phase 14)
# --------------------------------------------------------------------------


# the decoder's self-attention phase 15 runs: its own softmax, then the two
# kernel mixers in its place
WHISPER_MIXERS = ("softmax", "hla2", "ahla")
# decoder prompt lengths: one partial 64-token chunk, and 3.5 chunks
WHISPER_PROMPTS = (4, 224)
WHISPER_GEN = 64  # greedy tokens a served row: the prefill's, then steps
WHISPER_ROWS = 4  # served rows, each with its own 1500 frames
# training: rows x decoder tokens (448 is whisper's max_target_positions,
# its own decoder context in the public openai/whisper-small config)
WHISPER_TRAIN = (8, 448)
# softmax's identity with its bf16 KV cache: the prompt's K/V come from
# GEMMs of 2L and 2(L + 1) rows and some elements round to neighbouring
# bf16 values; at L = 4 (5 keys a row) that moved the logits by 3.06e-4
# (H100, 700 W), past phase 12's TOL_CACHE (300 keys).  One bf16 rounding
# bounds it; the same identity with fp32 caches holds TOL_FP32
TOL_WHISPER_CACHE = TOL_BF16
# each HLA mixer's (prefill, decode-step) kernel
WHISPER_SERVE = {"hla2": ("hla2_chunk_fwd", "hla2_step"),
                 "ahla": ("ahla_chunk_fwd", "ahla_step")}


def _frames(cfg, rows, device, seed=6):
    """The stub frontend's input: seeded ``(rows, enc_frames, d_model)``
    frame embeddings x 0.1."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((rows, cfg.enc_frames, cfg.d_model), generator=gen,
                       device=device) * 0.1


def whisper_identity(params, cfg, device, L, rows=2, tol=TOL_FP32,
                     note=""):
    """(b) fp32: ``whisper_apply(mode="prefill")`` over ``L`` tokens, then
    one ``mode="decode"`` step, equals the last logits of a prefill over
    ``L + 1``, within ``tol`` (``note`` names the run in the log)."""
    import torch

    from repro_torch.models import whisper

    gen = torch.Generator(device=device).manual_seed(3)
    tok = torch.randint(2, cfg.vocab, (rows, L + 1), generator=gen,
                        device=device)
    fr = _frames(cfg, rows, device)
    with torch.no_grad():
        _, st, _ = whisper.whisper_apply(params, tok[:, :L], fr, cfg,
                                         mode="prefill")
        step, _, _ = whisper.whisper_apply(
            params, tok[:, L:], None, cfg, states=st,
            positions=torch.full((rows, 1), L, device=device),
            mode="decode")
        full, _, _ = whisper.whisper_apply(params, tok, fr, cfg,
                                           mode="prefill")
    step, full = step[:, -1], full[:, -1]
    if not bool(step.isfinite().all()):
        raise AssertionError("non-finite decode logits")
    e = rel_err(step, full)
    log(f"(b) {cfg.name} ({cfg.mixer}{note}) fp32, {rows} rows: "
        f"prefill({L}) + step vs prefill({L + 1}) logits rel {e:.2e} "
        f"(tol {tol:.0e}), "
        f"argmax {step.argmax(-1).tolist()} vs {full.argmax(-1).tolist()}")
    if not e <= tol:
        raise AssertionError("whisper prefill + step != longer prefill")
    return e


def whisper_serve(params, cfg, device, prompt, rows=WHISPER_ROWS,
                  gen=WHISPER_GEN):
    """(c) bf16 (``params`` cast): ``rows`` rows of ``enc_frames`` frames
    and a ``prompt``-token decoder prompt through ``whisper_apply`` (the
    encoder and the prefill: the time to the first token), then ``gen -
    1`` greedy decode steps.  With an HLA mixer exactly 12 chunk-forward
    launches per prefill and 12 step launches per decode step, with
    ``softmax`` none of the six; no plain version on the card.  Returns
    the summary numbers and the tokens."""
    import torch

    from repro_torch.models import whisper

    g = torch.Generator(device=device).manual_seed(8)
    tok = torch.randint(2, cfg.vocab, (rows, prompt), generator=g,
                        device=device)
    fr = _frames(cfg, rows, device)
    want_pre = want_step = {}
    if cfg.mixer in WHISPER_SERVE:
        chunk, step = WHISPER_SERVE[cfg.mixer]
        want_pre, want_step = {chunk: cfg.n_layers}, {step: cfg.n_layers}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        (logits, st, _), pre_l, ttft = _run_counted(
            device, lambda: whisper.whisper_apply(params, tok, fr, cfg,
                                                  mode="prefill"))
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        out, step_s, step_l = [nxt], [], []
        for t in range(gen - 1):
            pos = torch.full((rows, 1), prompt + t, device=device)
            (logits, _, _), l_t, s_t = _run_counted(
                device, lambda: whisper.whisper_apply(
                    params, nxt, None, cfg, states=st, positions=pos,
                    mode="decode"))
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            out.append(nxt)
            step_s.append(s_t)
            step_l.append({k: v for k, v in l_t.items() if v})
    peak = torch.cuda.max_memory_allocated(device) / 2**30 \
        if device.type == "cuda" else 0.0
    pre_l = {k: v for k, v in pre_l.items() if v}
    ms = 1e3 * statistics.median(step_s)
    tok_s = rows * len(step_s) / sum(step_s)
    log(f"(c) {cfg.name} ({cfg.mixer}) bf16, {rows} rows x "
        f"{cfg.enc_frames} frames, prompt {prompt}, {gen} greedy tokens: "
        f"time to first token (encoder + prefill) {1e3 * ttft:.1f} ms "
        f"(launches {pre_l}), decode p50 {ms:.2f} ms a step, {tok_s:.1f} "
        f"tok/s, launches a step {step_l[0]} | peak memory {peak:.2f} GiB")
    if device.type == "cuda" and (pre_l != want_pre or any(
            x != want_step for x in step_l)):
        raise AssertionError(f"launches {pre_l} / {step_l}, want "
                             f"{want_pre} / {want_step}")
    if not bool(logits.isfinite().all()):
        raise AssertionError("non-finite decode logits")
    launches = {k: pre_l.get(k, 0) + sum(x.get(k, 0) for x in step_l)
                for k in set(pre_l) | set(step_l[0])}
    return dict(ttft_ms=1e3 * ttft, step_ms=ms, tok_s=tok_s, peak_gib=peak,
                launches=launches, tokens=torch.cat(out, 1), inputs=(tok, fr))


def whisper_steps_stream(params, cfg, device, inputs, gen=WHISPER_GEN):
    """(c) one greedy stream through ``make_prefill_step`` and
    ``make_serve_step`` on ``whisper_serve``'s inputs.  Returns its
    tokens."""
    import torch

    from repro_torch.distributed.steps import (make_prefill_step,
                                               make_serve_step)

    tok, fr = inputs
    prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
    rows, prompt = tok.shape
    with torch.no_grad():
        logits, st = prefill(params, {"tokens": tok, "frames": fr})
        nxt = logits.argmax(-1, keepdim=True)
        out = [nxt]
        for t in range(gen - 1):
            pos = torch.full((rows, 1), prompt + t, device=device)
            logits, st = serve(params, {"tokens": nxt, "positions": pos}, st)
            nxt = logits.argmax(-1, keepdim=True)
            out.append(nxt)
    return torch.cat(out, 1)


def whisper_phase(device, cfg, prompts=WHISPER_PROMPTS, train_shape=None):
    """Phase 15 on ``cfg`` (full whisper-small on the card; ``reduced()``
    rehearses on the CPU), with each decoder of ``WHISPER_MIXERS``: (b) the
    fp32 identity at each prompt length (softmax with its bf16 KV cache,
    within ``TOL_WHISPER_CACHE``, and with fp32 caches within
    ``TOL_FP32``); (c)
    bf16 serving at each prompt length, and for ``hla2`` the step
    factories' stream against ``whisper_apply``'s; (d) 3 AdamW steps at
    ``train_shape`` (default ``WHISPER_TRAIN``) with the config's remat.
    Returns the summary numbers."""
    import torch

    from repro_torch.distributed.steps import model_specs
    from repro_torch.models import lm, whisper
    from repro_torch.models.param import init_params, param_count

    t0 = time.perf_counter()
    batch, seq = train_shape or WHISPER_TRAIN
    served, trained, train_launches, ident = {}, {}, {}, {}
    for mixer in WHISPER_MIXERS:
        mcfg = cfg.replace(mixer=mixer)
        _free(device)
        params = init_params(whisper.whisper_specs(mcfg), 0, device)
        log(f"{mcfg.name} ({mixer}): {mcfg.enc_layers} + {mcfg.n_layers} "
            f"layers, d_model {mcfg.d_model}, {mcfg.n_heads} heads of "
            f"{mcfg.head_dim}, {mcfg.enc_frames} frames, "
            f"{param_count(whisper.whisper_specs(mcfg)) / 1e9:.4f} B "
            "parameters")
        f32 = mcfg.replace(dtype="float32")
        for L in prompts:
            if mixer == "softmax":
                ident[(mixer, L)] = whisper_identity(
                    params, f32, device, L, tol=TOL_WHISPER_CACHE,
                    note=", bf16 KV cache")
                with _fp32_kv_cache():
                    ident[(mixer + "_fp32_cache", L)] = whisper_identity(
                        params, f32, device, L, note=", fp32 KV cache")
            else:
                ident[(mixer, L)] = whisper_identity(params, f32, device, L)
        bf = mcfg.replace(dtype="bfloat16")
        cast = lm.cast_params(params, bf)
        for L in prompts:
            served[(mixer, L)] = whisper_serve(cast, bf, device, L)
            if mixer == "hla2" and L == prompts[0]:
                got = whisper_steps_stream(cast, bf, device,
                                           served[(mixer, L)]["inputs"])
                same = torch.equal(got, served[(mixer, L)]["tokens"])
                log(f"(c) {bf.name} (hla2) make_prefill_step + "
                    f"make_serve_step, prompt {L}: tokens equal "
                    f"whisper_apply's: {same}")
                if not same:
                    raise AssertionError("the step factories' stream parts "
                                         "from whisper_apply's")
            _free(device)
        del params, cast
        _free(device)
        train_launches[mixer], trained[mixer] = train(
            device, mcfg, steps=3, batch=batch, seq=seq)
    serve_launches = {}
    for summary in served.values():
        for k, v in summary.pop("launches").items():
            serve_launches[k] = serve_launches.get(k, 0) + v
        summary.pop("tokens")
        summary.pop("inputs")
    log(f"phase 15 took {time.perf_counter() - t0:.1f}s; serving launches "
        f"{serve_launches}, training launches {train_launches}")
    return dict(identity=ident, served=served, trained=trained,
                serve_launches=serve_launches, train_launches=train_launches)


# --------------------------------------------------------------------------
# phase 16: hla-1b under a device mesh (after phase 15)
# --------------------------------------------------------------------------

MESH_TRAIN = (2, 2048)  # (a): rows x tokens, the config's remat="full"
MESH_STEPS = 2
MESH_SERVE = dict(n_req=4, slots=4, lens=(256, 640), gen=32)
# (c): the dry-run cells, (arch, mixer override, shape) on each mesh ("1x4":
# 4 ranks as (1, 4); None: the production 16 x 16).  train_4k only: with
# decode_32k too the script grew past phase 16's budget (949 s in all, 225
# s over the run before it; the decode cells' lines in PERF.md come from
# launch/dryrun.py run on its own)
DRYRUN_CELLS = tuple(
    (arch, mixer, "train_4k", mesh)
    for arch, mixer in (("hla-1b", None), ("qwen2-72b", None),
                        ("codeqwen1.5-7b", "hla2"))
    for mesh in ("1x4", None))
DRYRUN_WORKERS = 6  # concurrent dry-run processes (host cores, niced)
DRYRUN_TIMEOUT = 900


def start_dryruns(cells=DRYRUN_CELLS, reduced=False):
    """Start phase 16 (c)'s dry runs: one ``repro_torch.launch.dryrun``
    process a cell on a fake process group, ``DRYRUN_WORKERS`` at a time,
    at the lowest CPU priority.  They are the host's work (no card): the
    script starts them after phase 16 (a) and (b), whose host times they
    would move, so they run beside phase 17 (exact checks) and phase 7
    (device-timed).  Returns ``(pool, futures)`` for ``collect_dryruns``."""
    import os
    import tempfile

    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")

    def one(cell):
        arch, mixer, shape, mesh = cell
        path = out_dir / f"{arch}_{shape}_{mesh or 'prod'}.json"
        cmd = ["nice", "-n", "19", sys.executable, "-m",
               "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--json", str(path)]
        cmd += ["--mesh", mesh] if mesh else []
        cmd += ["--mixer", mixer] if mixer else []
        cmd += ["--reduced"] if reduced else []
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=DRYRUN_TIMEOUT)
        wall = time.perf_counter() - t0
        if proc.returncode:
            return cell, None, wall, proc.stderr[-3000:]
        return cell, json.loads(path.read_text()), wall, None

    pool = ThreadPoolExecutor(DRYRUN_WORKERS)
    return pool, [pool.submit(one, c) for c in cells]


def collect_dryruns(handle):
    """Wait for the dry runs and print one line a cell."""
    pool, futures = handle
    try:
        done = [f.result() for f in futures]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    lines = []
    failed = [(cell, err) for cell, _, _, err in done if err is not None]
    for cell, err in failed:
        log(f"[dryrun] {cell} failed: {err}")
    for (arch, mixer, shape, _), res, wall, _ in done:
        if res is None:
            continue
        mem, roof = res["memory"], res["roofline"]
        coll = ", ".join(f"{k} {v / 2**30:.2f} GiB"
                         for k, v in res["collectives"]["bytes"].items())
        line = (f"[dryrun] {arch}{'/' + mixer if mixer else ''} x {shape} "
                f"on mesh{res['mesh']}: {mem['peak_bytes'] / 2**30:.2f} GiB "
                f"a rank at peak (params {mem['param_bytes'] / 2**30:.2f}, "
                f"grads {mem['grad_bytes'] / 2**30:.2f}, moments "
                f"{mem['moment_bytes'] / 2**30:.2f}, inputs "
                f"{mem['input_bytes'] / 2**30:.2f}), "
                f"{'fits' if res['fits_80gb'] else 'does not fit'} in 80 GB "
                f"| collectives {coll} | {res['cost']['flops'] / 1e12:.1f} "
                f"TFLOP a rank | roofline compute {roof['compute_s']:.3f}s, "
                f"memory {roof['memory_s']:.3f}s, collective "
                f"{roof['collective_s']:.3f}s: {roof['bottleneck']} "
                f"(host work, {wall:.0f}s)")
        log(line)
        lines.append(line)
    if failed:
        raise AssertionError(f"dry runs failed: {[c for c, _ in failed]}")
    return lines


def _host(tree):
    from repro_torch.distributed.sharding import full
    from repro_torch.models.param import tree_map

    return tree_map(lambda x: full(x).detach().cpu(), tree)


def _max_diff(a, b):
    from repro_torch.models.param import leaf_paths

    return max(0.0 if x.equal(y) else
               float((x.double() - y.double()).abs().max())
               for (_, x), (_, y) in zip(leaf_paths(a), leaf_paths(b)))


def mesh_train(device, mesh, cfg, shape=MESH_TRAIN, steps=MESH_STEPS,
               lr=1e-5):
    """(a) ``steps`` AdamW steps of ``cfg`` with the parameters and moments
    as DTensors on ``mesh`` against the same steps unsharded, from the same
    seeded weights: the step-0 loss and every gradient leaf, each step's
    loss and the final parameters.  Returns the summary numbers."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps as S
    from repro_torch.models.param import init_params
    from repro_torch.optim import adamw

    batch, seq = shape
    host = SyntheticStream(DataConfig(cfg.vocab, seq, batch, seed=0)).batch(0)
    data = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    opt_cfg = adamw.OptConfig(lr=lr, warmup_steps=1, total_steps=steps)
    ps, ms = S.make_shardings(cfg, mesh)

    def run(sharded):
        params = init_params(S.model_specs(cfg), 0, device)
        state = adamw.init_opt_state(params, cfg.moment_dtype)
        batch_ = data
        if sharded:
            params = shd.distribute(params, ps, mesh)
            state = adamw.OptState(0, shd.distribute(state.mu, ms, mesh),
                                   shd.distribute(state.nu, ms, mesh))
            batch_ = {k: shd.distribute_leaf(
                v, mesh, shd.batch_sharding(mesh, v.shape))
                for k, v in data.items()}
        with shd.use_mesh(mesh if sharded else None):
            loss0, _, _, grads = S.accumulate_grads(params, batch_, cfg)
            loss0, grads = float(shd.full(loss0)), _host(grads)
            step = S.make_train_step(cfg, opt_cfg,
                                     grad_shardings=ps if sharded else None)
            losses, step_s = [], []
            _sync(device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)

            def steps_():
                nonlocal params, state
                for _ in range(steps):
                    t0 = time.perf_counter()
                    params, state, m = step(params, state, batch_)
                    losses.append(float(m["loss"]))  # waits for the step
                    step_s.append(time.perf_counter() - t0)

            _, launches = _count_train(device, cfg, steps_)
        peak = torch.cuda.max_memory_allocated(device) / 2**30 \
            if device.type == "cuda" else 0.0
        return dict(loss0=loss0, grads=grads, losses=losses,
                    params=_host(params), launches=launches, peak_gib=peak,
                    step_p50_s=float(np.percentile(step_s, 50)))

    t0 = time.perf_counter()
    plain = run(False)
    t1 = time.perf_counter()
    got = run(True)
    t2 = time.perf_counter()
    out = dict(
        loss0_diff=abs(got["loss0"] - plain["loss0"]),
        grad_diff=_max_diff(got["grads"], plain["grads"]),
        loss_diff=max(abs(a - b) for a, b in zip(got["losses"],
                                                 plain["losses"])),
        param_diff=_max_diff(got["params"], plain["params"]),
        losses=got["losses"], launches=got["launches"],
        step_p50_s=got["step_p50_s"], peak_gib=got["peak_gib"],
        plain_step_p50_s=plain["step_p50_s"], plain_peak_gib=plain["peak_gib"])
    log(f"mesh train {cfg.name} ({cfg.mixer}; {cfg.n_layers} layers, "
        f"{cfg.dtype} activations, remat {cfg.remat}) on "
        f"mesh{dict(zip(mesh.mesh_dim_names, mesh.shape))}: {steps} AdamW "
        f"steps at {batch} x {seq}: loss "
        f"{' '.join(f'{x:.4f}' for x in got['losses'])} | largest "
        f"difference from the unsharded step: step-0 loss "
        f"{out['loss0_diff']:.3g}, gradient {out['grad_diff']:.3g}, losses "
        f"{out['loss_diff']:.3g}, parameters {out['param_diff']:.3g} | step "
        f"p50 {got['step_p50_s']:.3f}s (unsharded {plain['step_p50_s']:.3f}s)"
        f" | peak {got['peak_gib']:.2f} GiB (unsharded "
        f"{plain['peak_gib']:.2f}) | launches {got['launches']} | "
        f"{t1 - t0:.1f}s unsharded, {t2 - t1:.1f}s on the mesh")
    want = _want_train(cfg, steps)
    for name, launches in (("sharded", got["launches"]),
                           ("unsharded", plain["launches"])):
        if launches != want:
            raise AssertionError(f"{name} launches {launches}, want {want}")
    if max(out["loss0_diff"], out["grad_diff"], out["loss_diff"],
           out["param_diff"]) > 0:
        # a one-rank mesh runs every op on the whole tensors, so any
        # difference is a bug; log the leaf at fault for the record
        raise AssertionError(f"the mesh run differs from the unsharded: "
                             f"{out}")
    return out


def mesh_serve(device, mesh, params, cfg, n_req=4, slots=4, lens=(256, 640),
               gen=32, block=8):
    """(b) ``Engine(mesh=)`` against the unsharded engine: greedy streams
    equal, one chunk launch a layer and admission and one step launch a
    layer and decode step, one host transfer an admission and one a decode
    block (``analysis.contracts``' counts).  Returns the summary numbers."""
    import numpy as np
    import torch

    from repro_torch.analysis.contracts import _watch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, GenRequest

    reqs = serve_requests(cfg, n_req, lens, gen)
    chunk_name, step_name = SERVE_KERNELS[cfg.mixer]
    runs = {}
    for sharded in (False, True):
        t0 = time.perf_counter()
        p = shd.distribute(params, shd.param_shardings(
            lm.lm_specs(cfg), mesh), mesh) if sharded else params
        engine = Engine(cfg, p, slots=slots, max_len=lens[1] + gen + 8,
                        block=block, seed=0, device=device,
                        mesh=mesh if sharded else None)
        engine.run([GenRequest(rid=-1, prompt=reqs[0].prompt,
                               max_new=block)])
        engine.obs.reset()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        results, launches, wall = _run_counted(device,
                                               lambda: engine.run(reqs))
        bad = [(r.rid, r.status, r.error) for r in results
               if r.status != "ok" or len(r.tokens) != gen]
        if bad:
            raise AssertionError(f"requests not served: {bad}")
        st = engine.stats
        want = {chunk_name: cfg.n_layers * n_req,
                step_name: cfg.n_layers * st["decode_steps"]}
        if device.type == "cuda" and launches != want:
            raise AssertionError(f"launches {launches}, want {want}")
        peak = torch.cuda.max_memory_allocated(device) / 2**30 \
            if device.type == "cuda" else 0.0
        syncs = {}
        with _watch(device) as w:
            engine.admit(0, GenRequest(rid=-2, prompt=reqs[0].prompt,
                                       max_new=2 * block))
        syncs["admission"] = w
        with _watch(device) as w:
            engine.step_block()
        syncs["decode block"] = w
        for where, w in syncs.items():
            n = sum(w.transfers.values())
            if n != 1 or (w.sync_warnings is not None
                          and w.sync_warnings != n):
                raise AssertionError(
                    f"{'mesh' if sharded else 'plain'} {where}: {n} host "
                    f"transfers {dict(w.transfers)}, {w.sync_warnings} sync "
                    f"warnings at {w.sync_sites}; want 1")
        runs[sharded] = dict(
            streams=[r.tokens for r in results], launches=launches,
            ttft_p50_ms=1e3 * float(np.percentile(
                [r.ttft_s for r in results], 50)),
            decode_tok_s=(st["generated_tokens"] - n_req) / st["decode_s"],
            peak_gib=peak, wall_s=wall, took_s=time.perf_counter() - t0)
        del engine, p
    got, plain = runs[True], runs[False]
    if got["streams"] != plain["streams"]:
        raise AssertionError("the mesh engine's streams differ from the "
                             "unsharded engine's")
    log(f"mesh serve {cfg.name} ({cfg.mixer}, {cfg.dtype}) on "
        f"mesh{dict(zip(mesh.mesh_dim_names, mesh.shape))}: {n_req} greedy "
        f"requests, {slots} slots, prompts {lens[0]}-{lens[1]}, gen {gen}: "
        f"streams equal the unsharded engine's | TTFT p50 "
        f"{got['ttft_p50_ms']:.1f} ms (unsharded {plain['ttft_p50_ms']:.1f}) "
        f"| decode {got['decode_tok_s']:.1f} tok/s (unsharded "
        f"{plain['decode_tok_s']:.1f}) | peak {got['peak_gib']:.2f} GiB "
        f"(unsharded {plain['peak_gib']:.2f}) | one host transfer an "
        f"admission and a decode block | launches {got['launches']} | "
        f"{plain['took_s']:.1f}s unsharded, {got['took_s']:.1f}s on the "
        "mesh")
    return got


def mesh_phase(device, configs=None, train_shape=MESH_TRAIN, serve_kw=None):
    """Phase 16 (a) and (b): hla-1b at full size under a one-rank ``(data,
    model)`` mesh (NCCL on the card, gloo on a CPU rehearsal), with both
    kernel mixers: ``mesh_train``, ``mesh_serve``.  (c) is
    ``start_dryruns`` / ``collect_dryruns``.  Returns the kernels'
    launches under the mesh and the summaries."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.param import init_params

    t0 = time.perf_counter()
    configs = configs or {m: get_config("hla-1b", mixer=m)
                          for m in ("hla2", "ahla")}
    serve_kw = serve_kw or MESH_SERVE
    launches, out = {}, {}
    with _one_rank_group(device):
        mesh = make_mesh((1, 1), ("data", "model"), device_type=device.type)
        for mixer, cfg in configs.items():
            trained = mesh_train(device, mesh, cfg, shape=train_shape)
            params = init_params(lm.lm_specs(cfg), 0, device)
            served = mesh_serve(device, mesh, params, cfg, **serve_kw)
            del params
            out[mixer] = dict(train=trained, serve=served)
            for d in (trained["launches"], served["launches"]):
                _add(launches, d)
    log(f"phase 16 (a), (b) took {time.perf_counter() - t0:.1f}s; launches "
        f"under the mesh {launches}")
    return launches, out


# --------------------------------------------------------------------------
# phase 17: the rest of the multi-device code under the one-rank mesh
# (after phase 16 (a), (b))
# --------------------------------------------------------------------------

# (a): phase 5's first requests, its fp32 streams cut to ``gen`` tokens
MESH_SPEC = dict(n_req=4, lens=(256, 640), gen=16)
# (c): a train step's loss and gradients at rows x tokens, then a prefill
# of FAMILY_PREFILL tokens and FAMILY_STEPS serve steps, per family
FAMILY_TRAIN = (2, 128)
FAMILY_PREFILL, FAMILY_STEPS = 16, 2
# (d): the pipeline's shapes (the reference test's): layers, microbatches,
# rows a microbatch, tokens, width
PIPE = (8, 4, 2, 8, 16)


@contextlib.contextmanager
def _one_rank_group(device):
    """A process group of one rank for the block (NCCL on the card, gloo
    on a CPU rehearsal), rendezvous through a file in a temporary
    directory."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, **({"device_id": device} if cuda else {}))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _transfers(device, fn):
    """Host transfers of ``fn()`` (``analysis.contracts``' count; on the
    card the sync debug mode's warnings must agree)."""
    from repro_torch.analysis.contracts import _watch

    with _watch(device) as w:
        fn()
    n = sum(w.transfers.values())
    if w.sync_warnings is not None and w.sync_warnings != n:
        raise AssertionError(f"{n} host transfers {dict(w.transfers)} but "
                             f"{w.sync_warnings} sync warnings at "
                             f"{w.sync_sites}")
    return n


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def mesh_spec(device, mesh, params, cfg, fp32_streams, n_req=4,
              lens=(256, 640), gen=16):
    """(a) ``Engine(mesh=, spec=)`` with the n-gram and the LM drafter,
    fp32 greedy: the streams equal phase 5's plain fp32 greedy streams of
    the same requests (cut to ``gen`` tokens); ``serve_spec``'s launch
    checks (verify chunk launches, replay and draft steps from the stats);
    one host transfer an admission, one a round and a second when the
    round rolled back.  Returns the launches under the mesh."""
    from repro_torch.serving.engine import GenRequest

    cfg32 = cfg.replace(dtype="float32")
    want = [s[:gen] for s in fp32_streams[:n_req]]
    # phase 5's first requests (its prompts are drawn after all the lengths)
    reqs = [GenRequest(rid=r.rid, prompt=r.prompt, max_new=gen) for r in
            serve_requests(cfg32, len(fp32_streams), lens, gen)[:n_req]]
    launches = {}
    for drafter in ("ngram", "lm"):
        out = serve_spec(params, cfg32, device, drafter, gen=gen, mesh=mesh,
                         reqs=reqs)
        engine = out.pop("engine")
        parted = [i for i, (a, b) in enumerate(zip(out["streams"], want))
                  if a != b]
        if parted:
            raise AssertionError(f"(a) {cfg.mixer} {drafter}: streams "
                                 f"{parted} part from phase 5's fp32 greedy")
        prompt = serve_requests(cfg32, 1, lens, gen)[0].prompt
        adm = _transfers(device, lambda: engine.admit(
            0, GenRequest(rid=-2, prompt=prompt, max_new=4 * SPEC_K)))
        before = engine.stats["spec_replays"]
        rnd = _transfers(device, engine.step_block)
        replayed = engine.stats["spec_replays"] - before
        log(f"(a) {cfg.mixer} {drafter} on the mesh: {n_req} streams equal "
            f"phase 5's fp32 greedy; host transfers: admission {adm}, a "
            f"round {rnd} ({'rolled back' if replayed else 'no rollback'})")
        if adm != 1 or rnd != 1 + replayed:
            raise AssertionError(f"(a) host transfers: admission {adm}, "
                                 f"round {rnd} (rollback {replayed})")
        _add(launches, out["launches"])
        del engine
    return launches


def mesh_cache(device, mesh, params, cfg, exact, gen=16):
    """(b) ``Engine(mesh=, cache=)`` on phase 8 (a)'s shared-prefix
    requests, with its injected ``cache.corrupt``: phase 8 (a)'s streams,
    the same hits at the same prompt positions, launches exact.  Returns
    the launches."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.obs import Obs
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    from repro_torch.serving import Engine, PrefixCache

    cfg32 = cfg.replace(dtype="float32")
    reqs = frontend_requests(cfg32, FE_SUFFIXES, gen)
    p = shd.distribute(params, shd.param_shardings(lm.lm_specs(cfg32), mesh),
                       mesh)
    engine = Engine(cfg32, p, cache=PrefixCache(granularity=FE_CHUNK,
                                                budget_bytes=1 << 40),
                    obs=Obs(), faults=FaultPlan(FaultSpec("cache.corrupt",
                                                          at=1)),
                    slots=4, max_len=FE_PREFIX + 256 + gen + 8, block=8,
                    seed=0, device=device, mesh=mesh)
    got, launches, wall = _run_counted(device, lambda: engine.run(reqs))
    admitted = _admitted(engine)
    want, advances = _want_launches(cfg32, engine, admitted)
    hits = {rid: hit for rid, (_, hit) in admitted.items() if hit}
    log(f"(b) {cfg.mixer} cache on the mesh: {len(reqs)} requests in "
        f"{wall:.2f}s; hits (rid: prefix) {hits}, {advances} carry "
        f"advances; launches {launches}")
    if [r.tokens for r in got] != exact["streams"]:
        raise AssertionError("(b) the mesh engine's cached streams differ "
                             "from phase 8 (a)'s")
    if admitted != exact["admitted"]:
        raise AssertionError(f"(b) admissions {admitted}, phase 8 (a)'s "
                             f"{exact['admitted']}")
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"(b) launches {launches}, want {want}")
    return launches


def family_configs(get_config):
    """(c)'s configs: qwen3-moe-30b-a3b at 2 layers with ``hla2``, jamba's
    one group at half width (``_jamba_half``, the ``hla2`` drop-in; bf16
    parameters), rwkv6-7b at 2 layers, whisper-small with ``hla2``; every
    width else as published."""
    return {
        "qwen3-moe-30b-a3b": get_config("qwen3-moe-30b-a3b",
                                        mixer="hla2").replace(n_layers=2),
        "jamba-1.5-large-398b": _jamba_half(
            get_config("jamba-1.5-large-398b")),
        "rwkv6-7b": get_config("rwkv6-7b").replace(n_layers=2),
        "whisper-small": get_config("whisper-small", mixer="hla2"),
    }


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms for the block (``warn_only``: an op with
    none warns).  The MoE dispatch's backward scatters each token's top-k
    slot gradients into its row with atomic adds, whose order, and so
    whose fp32 sum, changes from run to run for k > 2 (qwen3's 8)."""
    import torch

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def mesh_family(device, mesh, cfg, train=FAMILY_TRAIN,
                prefill=FAMILY_PREFILL, steps=FAMILY_STEPS):
    """(c) one family on the mesh against the same calls unsharded, from
    the same seeded weights: a train step's loss and every gradient leaf
    (``accumulate_grads``), then a prefill and ``steps`` serve steps'
    logits (``make_prefill_step``, ``make_serve_step``), all bit for bit
    (both under ``_deterministic``).  Returns the launches under the
    mesh."""
    import numpy as np
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps as S
    from repro_torch.models.param import init_params

    rows, seq = train
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (rows, seq + 1))) \
        .to(device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.enc_layers:
        batch["frames"] = torch.from_numpy(rng.randn(
            rows, cfg.enc_frames, cfg.d_model).astype(np.float32) * 0.5) \
            .to(device)
    params = init_params(S.model_specs(cfg), 0, device)
    ps, _ = S.make_shardings(cfg, mesh)
    runs = {}
    for sharded in (False, True):
        m = mesh if sharded else None
        p = shd.distribute(params, ps, mesh) if sharded else params
        b = {k: shd.batch_rows(v, m) for k, v in batch.items()}
        t0 = time.perf_counter()
        with shd.use_mesh(m), _deterministic():
            (loss, _, aux, grads), train_l = _count_train(
                device, cfg, lambda: S.accumulate_grads(p, b, cfg))
            loss, aux, grads = float(shd.full(loss)), float(shd.full(aux)), \
                _host(grads)

            @torch.no_grad()
            def decode():
                pb = {"tokens": shd.batch_rows(batch["tokens"][:, :prefill],
                                               m)}
                if cfg.enc_layers:
                    pb["frames"] = b["frames"]
                logits, states = S.make_prefill_step(cfg)(p, pb)
                outs = [shd.full(logits).float().cpu()]
                serve = S.make_serve_step(cfg)
                for t in range(prefill, prefill + steps):
                    logits, states = serve(p, {
                        "tokens": shd.batch_rows(batch["tokens"][:, t:t + 1],
                                                 m),
                        "positions": shd.batch_rows(torch.full(
                            (rows, 1), t, device=device), m)}, states)
                    outs.append(shd.full(logits).float().cpu())
                return outs

            logits, serve_l, _ = _run_counted(device, decode)
        runs[sharded] = dict(loss=loss, aux=aux, grads=grads, logits=logits,
                             launches={**train_l, **{
                                 k: train_l.get(k, 0) + v
                                 for k, v in serve_l.items()}},
                             took_s=time.perf_counter() - t0)
        del p, grads
    got, plain = runs[True], runs[False]
    diffs = dict(
        loss=abs(got["loss"] - plain["loss"]),
        aux=abs(got["aux"] - plain["aux"]),
        grads=_max_diff(got["grads"], plain["grads"]),
        logits=max(float((a - b).abs().max())
                   for a, b in zip(got["logits"], plain["logits"])))
    log(f"(c) {cfg.name} ({cfg.mixer}; {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype} activations, {cfg.param_dtype} "
        f"parameters) on the mesh: loss {got['loss']:.6f}, aux "
        f"{got['aux']:.6f}; a {rows} x {seq} train step's loss and gradients"
        f", a {prefill}-token prefill and {steps} steps' logits; largest "
        f"difference from unsharded {diffs} | launches {got['launches']} "
        f"(unsharded {plain['launches']}) | {plain['took_s']:.1f}s "
        f"unsharded, {got['took_s']:.1f}s on the mesh")
    if max(diffs.values()) > 0:
        raise AssertionError(f"(c) {cfg.name}: the mesh run differs from "
                             f"the unsharded: {diffs}")
    if got["launches"] != plain["launches"]:
        raise AssertionError(f"(c) {cfg.name}: launches {got['launches']}"
                             f", unsharded {plain['launches']}")
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return got["launches"]


def mesh_collectives(device, mesh):
    """(d) ``compression.int8_allreduce_mean`` over the mesh's "data" axis
    (one rank) against ``quantize_dequantize``, and ``pipelined_forward``
    with S = 1 (a ``("pipe",)`` mesh of the rank) against the serial stack,
    forward and gradients."""
    import torch

    from repro_torch.distributed import compression, pipeline_par
    from repro_torch.launch.mesh import make_mesh

    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(1 << 20, generator=gen, device=device)
    red, err = compression.int8_allreduce_mean(
        x, torch.zeros_like(x), group=mesh.get_group("data"))
    want = compression.quantize_dequantize(x)
    step = float(x.abs().max()) / 127
    e_red = float((red - want).abs().max())
    e_err = float((err - (x - want)).abs().max())
    L, M, mb, n, d = PIPE
    Ws = (torch.randn(L, d, d, generator=gen, device=device)
          * d ** -0.5).requires_grad_(True)
    xs = torch.randn(M, mb, n, d, generator=gen, device=device)
    pmesh = make_mesh((1,), ("pipe",), device_type=device.type)
    y = pipeline_par.pipelined_forward(lambda w, h: torch.tanh(h @ w), Ws,
                                       xs, pmesh)
    g, = torch.autograd.grad((y ** 2).sum(), Ws)
    h = xs
    for i in range(L):
        h = torch.tanh(h @ Ws[i])
    g_ref, = torch.autograd.grad((h ** 2).sum(), Ws)
    e_y = float((y - h).abs().max())
    e_g = float((g - g_ref).abs().max() / g_ref.abs().max())
    log(f"(d) int8 error-feedback all-reduce over one rank ({x.numel():,} "
        f"fp32): mean vs quantize_dequantize {e_red:.3g}, error {e_err:.3g} "
        f"(one quantization step {step:.3g}); pipelined_forward S = 1, "
        f"L {L}, M {M}: forward {e_y:.3g}, gradients rel {e_g:.3g}")
    if e_red > 1e-6 * step * 127 or e_err > 1e-6 * step * 127 or \
            e_y > 1e-5 or e_g > 1e-4:
        raise AssertionError("(d) the compression or the pipeline "
                             "disagrees with its oracle")


def mesh_rest_phase(device, spec_fp32, exact, configs=None, families=None,
                    spec_kw=None):
    """Phase 17 under a one-rank ``(data, model)`` mesh: (a) ``mesh_spec``
    and (b) ``mesh_cache`` for each mixer of ``configs`` (full hla-1b by
    default) against phase 5's and 8 (a)'s results (``spec_fp32``,
    ``exact``: by mixer), (c) ``mesh_family`` for each of ``families``,
    (d) ``mesh_collectives``.  Returns the launches under the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.param import init_params

    t0 = time.perf_counter()
    configs = configs or {m: get_config("hla-1b", mixer=m)
                          for m in ("hla2", "ahla")}
    families = families if families is not None else \
        family_configs(get_config)
    launches = {}
    with _one_rank_group(device):
        mesh = make_mesh((1, 1), ("data", "model"), device_type=device.type)
        params = init_params(lm.lm_specs(next(iter(configs.values()))), 0,
                             device)
        for mixer, cfg in configs.items():
            sub = mesh_spec(device, mesh, params, cfg, spec_fp32[mixer],
                            **(spec_kw or MESH_SPEC))
            sub2 = mesh_cache(device, mesh, params, cfg, exact[mixer])
            for d in (sub, sub2):
                _add(launches, d)
        del params
        t1 = time.perf_counter()
        for name, cfg in families.items():
            _add(launches, mesh_family(device, mesh, cfg))
        t2 = time.perf_counter()
        mesh_collectives(device, mesh)
    log(f"phase 17 took {time.perf_counter() - t0:.1f}s ((a), (b) "
        f"{t1 - t0:.1f}s, (c) {t2 - t1:.1f}s); launches under the mesh "
        f"{launches}")
    return launches


# --------------------------------------------------------------------------
# phase 7: timing
# --------------------------------------------------------------------------


def median_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median device time of ``fn(i)`` over ``iters`` calls, from CUDA events
    around each call.  Before each call a device-side sleep holds the
    stream for twice the host's measured time to issue one call, so the
    events bracket the call's device work only, not the host's issuing."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)  # on an idle stream: the host's time to issue one call
    host_ms = 1e3 * (time.perf_counter() - t0)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    cycles_per_ms = 1e7 / a.elapsed_time(b)
    hold = int(cycles_per_ms * (2 * host_ms + 1.0))
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(iters)]
    for i, (start, end) in enumerate(marks):
        torch.cuda._sleep(hold)
        start.record()
        fn(i)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def chunk_fmas(n, d, dv, w=64, has_init=False):
    """FMAs one row of hla2_chunk_fwd needs for bf16 inputs (gamma, no
    normalize, no lam), split by operand type: ``(bf16 x bf16, bf16 x fp32,
    fp32 x fp32)``.

    Per chunk of r tokens of the kernel's schedule: only the causal
    triangles of the masked products, the upper triangle of S's update
    (S = sum k k^T is symmetric), and no products with the carry on the
    first chunk when there is no initial state.  K Q^T multiplies two
    inputs.  A product of an input with a decay-weighted term counts as
    bf16 x fp32: a diagonal decay factor moves to the fp32 side.  The O(r d)
    vector terms (m, h) are left out.
    """
    def tri(x):  # entries of a causal triangle, diagonal included
        return x * (x + 1) // 2

    bb = bf = ff = 0
    for c0 in range(0, n, w):
        r = min(w, n - c0)
        bb += r * r * d                   # K Q^T: both triangles are used
        ff += r * (r + 1) * (r + 2) // 6  # T3 weights, j <= i <= t
        bf += tri(r) * dv + tri(r - 1) * dv  # P V, N (g V)
        bf += tri(d) * r + 2 * d * dv * r    # S, C, G updates
        if has_init or c0 > 0:
            bf += r * d * d + tri(r) * d     # Q S0, T2 weights (Q S0) Q^T
            ff += r * d * dv                 # (Q S0) C0
            bf += 2 * r * d * dv             # Q G0, K C0
    return bb, bf, ff


def chunk_bwd_fmas(n, d, dv, w=64):
    """FMAs one row of hla2_chunk_bwd needs for bf16 inputs (gamma, no
    normalize, no lam), split by operand type: ``(bf16 x bf16, bf16 x fp32,
    fp32 x fp32)``.

    Per chunk of r tokens, the products of the adjoint in
    ``chunk_math.hla2_chunk_math_bwd``, as the kernel groups them, with
    only the causal triangles of the masked ones.  Left out where the data
    makes them zero or unused: products with the carry on the first chunk
    (its carry is zero) and the carry cotangent it would hand back (the
    forward's initial carry is no input), and products with the incoming
    carry cotangent on the last chunk (the final carry's cotangent is
    zero).  K Q^T and dO V^T multiply two inputs; a product of an input
    (Q, K, V, dO) with a decay-weighted or fp32 term counts as bf16 x fp32.
    O(r d) vector terms are left out.
    """
    def tri(x):  # entries of a causal triangle, diagonal included
        return x * (x + 1) // 2

    bb = bf = ff = 0
    for c0 in range(0, n, w):
        r = min(w, n - c0)
        first, last = c0 == 0, c0 + r == n
        bb += r * r * d + tri(r) * dv      # K Q^T, E = dO V^T
        ff += 3 * r * (r + 1) * (r + 2) // 6  # A Bm, dA, dBm
        bf += tri(r) * dv + 4 * tri(r) * d  # wgt^T dO; dBm, dA into dq, dk
        if not last:  # products with the incoming carry cotangent
            # Kg dG, V dC^T, Qg dC; Kg dS, K dS^T | Z dG^T
            bf += 3 * r * d * dv + 2 * r * d * d
            ff += r * d * dv
            # N (r V), dN; dN Q, dN^T K | N^T (Kg dG)
            bf += 2 * tri(r - 1) * dv + 2 * tri(r - 1) * d
            ff += tri(r - 1) * dv
            if not first:  # rho K C0, K^T (Kg dG) | rho (Kg dG) C0^T
                bf += 2 * r * d * dv
                ff += r * d * dv
        if not first:  # products with the carry, and the cotangent of it
            bf += r * d * d + tri(r) * d  # Q S0, Q S0 Q^T
            bf += 2 * r * d * dv          # dO C0^T, dO G0^T
            bf += tri(r) * d              # dQS0 = (E . Lg) Q
            ff += tri(r) * d + 2 * r * d * d  # dX2^T Q S0; (dO C0^T) S0^T,
            #                                  dQS0 S0^T
            bf += 2 * d * dv * r + d * d * r  # dC, dG, dS updates
    return bb, bf, ff


def ahla_chunk_fmas(n, d, dv, w=64, has_init=False):
    """FMAs one row of ahla_chunk_fwd needs for bf16 inputs (gamma, no
    normalize), split by operand type: ``(bf16 x bf16, bf16 x fp32, fp32 x
    fp32)``.

    Per chunk of r tokens (``chunk_math.ahla_chunk_math``): Q K^T over its
    causal triangle (two inputs), A [V | 1] and A R over the triangle (A
    and R are fp32), the [P | m] and [E | n] updates (K with its decay
    moved to the other side), and the products with the carry (Q [P | m],
    Q E0) except on the first chunk when there is no initial state (its
    carry is zero).  The den column of A R and of Q E0 is needed under
    normalize only.
    """
    bb = bf = ff = 0
    for c0 in range(0, n, w):
        r = min(w, n - c0)
        tri = r * (r + 1) // 2
        bb += tri * d                        # Q K^T
        bf += tri * (dv + 1)                 # A [V | 1]
        ff += tri * dv                       # A R
        bf += 2 * d * (dv + 1) * r           # [P | m], [E | n] updates
        if has_init or c0 > 0:
            bf += r * d * (dv + 1) + r * d * dv  # Q [P | m], Q E0
    return bb, bf, ff


def ahla_chunk_bwd_fmas(n, d, dv, w=64):
    """FMAs one row of ahla_chunk_bwd needs for bf16 inputs (gamma, no
    normalize), split by operand type: ``(bf16 x bf16, bf16 x fp32, fp32 x
    fp32)``.

    Per chunk of r tokens, the products of the adjoint in
    ``chunk_math.ahla_chunk_math_bwd``, with only the causal triangles of
    the masked ones and without the den column (its cotangents are zero
    unnormalised).  Left out where the data makes them zero or unused:
    products with the carry on the first chunk (its checkpoint is zero) and
    the carry cotangent it would hand back (the forward's initial carry is
    no input), and products with the incoming carry cotangent on the last
    chunk (the final carry's cotangent is zero).  Q K^T multiplies two
    inputs; a product of an input (Q, K, V, dO) with an fp32 term counts as
    bf16 x fp32.
    """
    bb = bf = ff = 0
    for c0 in range(0, n, w):
        r = min(w, n - c0)
        first, last = c0 == 0, c0 + r == n
        tri = r * (r + 1) // 2
        bb += tri * d               # Q K^T
        # A V, A^T dO, dO R^T, dR V^T; (dA . Lg) K, (dA . Lg)^T Q | A^T dR
        bf += 4 * tri * dv + 2 * tri * d
        ff += tri * dv
        if not first:  # Q P0, Q E0, dO E0^T, the dP, dE updates | dR P0^T
            bf += 5 * r * d * dv
            ff += r * d * dv
        if not last:  # K dE1, K dP1, V dP1^T | R dE1^T
            bf += 3 * r * d * dv
            ff += r * d * dv
        if not (first or last):  # d rho: <dP1, P0> + <dE1, E0>
            ff += 2 * d * dv
    return bb, bf, ff


def _bound(nbytes, fmas, rows, rates=CHUNK_RATES):
    """The least time (ms) and what sets it: ``nbytes`` at the memory rate,
    or the FMAs of ``rows`` rows, ``fmas[i]`` of them at ``rates[i]``.  The
    chunk kernels' counts ``(bf16 x bf16, bf16 x fp32, fp32 x fp32)`` are
    priced at ``CHUNK_RATES``, the card's fastest route for each operand
    type at fp32 accuracy, so no kernel of the function could beat it.  The
    step kernels' products are priced at the 67 TFLOP/s SIMT rate (they are
    bound by bytes either way)."""
    t_b = 1e3 * nbytes / PEAK_BYTES_S
    t_f = 1e3 * 2 * rows * sum(f / r for f, r in zip(fmas, rates))
    return max(t_b, t_f), "bytes" if t_b > t_f else "operations"


def _ops_text(fmas, rows):
    """The GFLOP of a chunk kernel's bound by operand type, for its log."""
    bb, bf, ff = (2 * rows * f / 1e9 for f in fmas)
    return (f"{bb:.3f} GFLOP bf16 x bf16 at 989 TFLOP/s + {bf:.3f} bf16 x "
            f"fp32 at 989/3 + {ff:.3f} fp32 x fp32 at 495/3")


def time_train_kernels(device, mixer, bwd_abs, ckpt_abs, launches, rows=32,
                       n=2048, d=128):
    """``mixer``'s forward with checkpoints and its backward, and their
    plain versions, at the train phase's shapes (bf16 inputs, gamma)."""
    import importlib

    import torch

    mod_name, fwd_name, bwd_name = TRAIN_KERNELS[mixer]
    mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
    fwd, fwd_plain = getattr(mod, fwd_name), getattr(mod, f"{fwd_name}_plain")
    bwd, bwd_plain = getattr(mod, bwd_name), getattr(mod, f"{bwd_name}_plain")
    gen = torch.Generator(device=device).manual_seed(7)
    q, k, v, g = _inputs(gen, rows, n, d, d, torch.bfloat16, device)
    do = torch.randn(v.shape, generator=gen, device=device).to(v.dtype)
    ms_f = median_ms(lambda i: fwd(q, k, v, g, save_chunk_states=True), 10)
    plain_f = median_ms(lambda i: fwd_plain(q, k, v, g,
                                            save_chunk_states=True), 3)
    _, st, ck = fwd(q, k, v, g, save_chunk_states=True)
    ms_b = median_ms(lambda i: bwd(q, k, v, g, do, ck), 10)
    plain_b = median_ms(lambda i: bwd_plain(q, k, v, g, do, ck), 3)
    st_bytes = 4 * sum(x.numel() for x in st)  # the final carry, fp32
    ck_bytes = 4 * sum(x.numel() for x in ck)  # the checkpoints, fp32
    io = 2 * rows * n * 4 * d  # q, k, v and o (or do), bf16
    fwd_fmas, bwd_fmas = {
        "hla2": (chunk_fmas, chunk_bwd_fmas),
        "ahla": (ahla_chunk_fmas, ahla_chunk_bwd_fmas)}[mixer]
    fmas_f, fmas_b = fwd_fmas(n, d, d), bwd_fmas(n, d, d)
    bound_f, by_f = _bound(io + st_bytes + ck_bytes + 4 * rows, fmas_f, rows)
    # q, k, v, do in; dq, dk, dv out (bf16); checkpoints in; gamma, dgamma
    bound_b, by_b = _bound(io + 2 * rows * n * 3 * d + ck_bytes + 8 * rows,
                           fmas_b, rows)
    fwd_src, bwd_src, fwd_line, bwd_line = {
        "hla2": (CHUNK_SRC, BWD_SRC, "src/repro/kernels/hla2_chunk.py:176",
                 "src/repro/kernels/hla2_chunk.py:378"),
        "ahla": (AHLA_CHUNK_SRC, AHLA_BWD_SRC,
                 "src/repro/kernels/ahla_chunk.py:100",
                 "src/repro/kernels/ahla_chunk.py:284")}[mixer]
    log(f"{fwd_name} with checkpoints at rows {rows} n {n} d {d}, bf16 "
        f"in: {ms_f:.4f} ms, plain {plain_f:.4f} ms, bound {bound_f:.4f} ms "
        f"({by_f}: {_ops_text(fmas_f, rows)}; checkpoints "
        f"{ck_bytes / 1e6:.1f} MB)")
    log(f"{bwd_name} at rows {rows} n {n} d {d}, bf16 in: {ms_b:.4f} ms, "
        f"plain {plain_b:.4f} ms, bound {bound_b:.4f} ms ({by_b}: "
        f"{_ops_text(fmas_b, rows)})")
    return [
        dict(name=f"{fwd_name}[save_chunk_states]", route="cuda",
             source=fwd_src, replaces=fwd_line,
             launches=launches.get(fwd_name, 0), max_abs_err=ckpt_abs,
             ms=ms_f, plain_ms=plain_f, bound_ms=bound_f, bound_by=by_f,
             library_ms=None),
        dict(name=bwd_name, route="cuda", source=bwd_src, replaces=bwd_line,
             launches=launches.get(bwd_name, 0), max_abs_err=bwd_abs,
             ms=ms_b, plain_ms=plain_b, bound_ms=bound_b, bound_by=by_b,
             library_ms=None)]


def time_step(device, mixer, gen, rows, d=128, plain=True):
    """``mixer``'s step kernel (and its plain version) at ``rows`` rows, bf16
    q, k, v, gamma, fp32 state.  Returns ``(ms, plain_ms, bound_ms,
    bound_by)``, ``plain_ms`` None unless ``plain``."""
    import torch

    from repro_torch.kernels import decode_step, ops
    from repro_torch.kernels.hla2_chunk import hla2_chunk_fwd

    bf = torch.bfloat16
    q, k, v, g = _inputs(gen, rows, 1, d, d, bf, device)
    q, k, v = (x[:, 0].contiguous() for x in (q, k, v))
    qp, kp, vp, _ = _inputs(gen, rows, 64, d, d, bf, device)
    if mixer == "hla2":
        _, st0 = hla2_chunk_fwd(qp, kp, vp, g)
        # FMAs per row: 2 per element of S (update, u), 4 per element of C
        # (k, u, q reductions, update), 2 per element of G (update, q
        # reduction)
        fmas = 8 * d * d
    else:
        _, st0 = ops.ahla_prefill(qp[None], kp[None], vp[None], g)
        st0 = [x[0] for x in st0]
        # FMAs per row: 2 per element of P and of E (update, q reduction),
        # 1 per element of R
        fmas = 5 * d * d
    step = getattr(decode_step, f"{mixer}_step")
    step_plain = getattr(decode_step, f"{mixer}_step_plain")
    # one state per layer of a 24-layer stack would not fit in L2: rotate
    # over copies twice the 50 MB L2 (8 x 12.6 MB = 101 MB at 64 rows, 32 x
    # 3.2 MB at 16) so every launch finds its state cold
    state_bytes = 4 * sum(x.numel() for x in st0)
    n_st = max(8, -(-100_000_000 // state_bytes))
    states = [[x.clone() for x in st0] for _ in range(n_st)]
    ms = median_ms(lambda i: step(states[i % n_st], q, k, v, g), 40)
    plain_ms = median_ms(
        lambda i: step_plain(states[i % n_st], q, k, v, g), 10) \
        if plain else None
    # the fp32 state read and written once; q, k, v in and o out, counted
    # as bf16 (2 bytes: only the bf16 case is timed); gamma in
    nbytes = 2 * state_bytes + 2 * rows * 4 * d + 4 * rows
    bound, by = _bound(nbytes, (fmas,), rows, (PEAK_FP32_FLOP_S,))
    log(f"{mixer}_step at rows {rows} d {d}, bf16 in, fp32 state, {n_st} "
        f"states rotated: {ms:.4f} ms"
        + (f", plain {plain_ms:.4f} ms" if plain else "")
        + f", bound {bound:.4f} ms ({by}: {nbytes / 1e6:.2f} MB at 3.35 "
        f"TB/s; {nbytes / ms / 1e9:.2f} TB/s achieved)")
    return ms, plain_ms, bound, by


def time_kernels(device, chunk_abs, step_abs, launches, rows_chunk=16,
                 n=512, rows_step=64, d=128):
    import torch

    from repro_torch.kernels.hla2_chunk import (
        hla2_chunk_fwd, hla2_chunk_fwd_plain)

    gen = torch.Generator(device=device).manual_seed(4)
    bf = torch.bfloat16
    q, k, v, g = _inputs(gen, rows_chunk, n, d, d, bf, device)
    ms = median_ms(lambda i: hla2_chunk_fwd(q, k, v, g), 20)
    plain = median_ms(lambda i: hla2_chunk_fwd_plain(q, k, v, g), 5)
    fmas = chunk_fmas(n, d, d)
    state_bytes = 4 * rows_chunk * (3 * d * d + 2 * d)
    nbytes = 2 * rows_chunk * n * (2 * d + 2 * d) + state_bytes + 4 * rows_chunk
    bound, by = _bound(nbytes, fmas, rows_chunk)
    chunk = dict(
        name="hla2_chunk_fwd", route="cuda", source=CHUNK_SRC,
        replaces="src/repro/kernels/hla2_chunk.py:176",
        launches=launches.get("hla2_chunk_fwd", 0), max_abs_err=chunk_abs,
        ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None)
    log(f"hla2_chunk_fwd at rows {rows_chunk} n {n} d {d}, bf16 in: "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms ({by}: "
        f"{_ops_text(fmas, rows_chunk)}; {nbytes / 1e6:.2f} MB at 3.35 TB/s)")

    ms_s, plain_s, bound_s, by_s = time_step(device, "hla2", gen, rows_step,
                                             d)
    step = dict(
        name="hla2_step", route="cuda", source=STEP_SRC,
        replaces="src/repro/kernels/decode_step.py:127",
        launches=launches.get("hla2_step", 0), max_abs_err=step_abs,
        ms=ms_s, plain_ms=plain_s, bound_ms=bound_s, bound_by=by_s,
        library_ms=None)
    time_step(device, "hla2", gen, 16, d, plain=False)  # one slot
    return [chunk, step]


def time_ahla_kernels(device, chunk_abs, step_abs, launches, rows_chunk=16,
                      n=512, rows_step=64, d=128):
    """ahla_chunk_fwd and ahla_step, and their plain versions, at the AHLA
    serve run's shapes (bf16 inputs, gamma, fp32 carry)."""
    import torch

    from repro_torch.kernels.ahla_chunk import (
        ahla_chunk_fwd, ahla_chunk_fwd_plain)

    gen = torch.Generator(device=device).manual_seed(12)
    bf = torch.bfloat16
    q, k, v, g = _inputs(gen, rows_chunk, n, d, d, bf, device)
    ms = median_ms(lambda i: ahla_chunk_fwd(q, k, v, g), 20)
    plain = median_ms(lambda i: ahla_chunk_fwd_plain(q, k, v, g), 5)
    fmas = ahla_chunk_fmas(n, d, d)
    # q, k, v in and o out (bf16), the fp32 carry out, gamma in
    state_bytes = 4 * rows_chunk * (2 * d * d + 2 * d)
    nbytes = 2 * rows_chunk * n * 4 * d + state_bytes + 4 * rows_chunk
    bound, by = _bound(nbytes, fmas, rows_chunk)
    chunk = dict(
        name="ahla_chunk_fwd", route="cuda", source=AHLA_CHUNK_SRC,
        replaces="src/repro/kernels/ahla_chunk.py:100",
        launches=launches.get("ahla_chunk_fwd", 0), max_abs_err=chunk_abs,
        ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None)
    log(f"ahla_chunk_fwd at rows {rows_chunk} n {n} d {d}, bf16 in: "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms ({by}: "
        f"{_ops_text(fmas, rows_chunk)}; {nbytes / 1e6:.2f} MB at 3.35 TB/s)")

    ms_s, plain_s, bound_s, by_s = time_step(device, "ahla", gen, rows_step,
                                             d)
    step = dict(
        name="ahla_step", route="cuda", source=AHLA_STEP_SRC,
        replaces="src/repro/kernels/decode_step.py:250",
        launches=launches.get("ahla_step", 0), max_abs_err=step_abs,
        ms=ms_s, plain_ms=plain_s, bound_ms=bound_s, bound_by=by_s,
        library_ms=None)
    time_step(device, "ahla", gen, 16, d, plain=False)  # one slot
    return [chunk, step]


def time_verify(device, mixer, verify_abs, launches, rows=64, n=SPEC_K + 1,
                d=128):
    """``mixer``'s chunk kernel at the verify shape, one (k+1)-token chunk
    resumed from a carry (bf16 inputs, gamma), and its plain version.  The
    carries rotate over copies twice the 50 MB L2, as the pool's 24 layers
    do in a verify pass, so every launch finds its carry cold.  Its bound
    counts the carry read and the new carry written (fp32), q, k, v in and
    o out (bf16) and gamma.  ``launches``: the kernel's verify launches in
    phase 5's bf16 n-gram run (its admissions run the serve shape)."""
    import importlib

    import torch

    mod_name, fwd_name, _ = TRAIN_KERNELS[mixer]
    mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
    fwd, fwd_plain = getattr(mod, fwd_name), getattr(mod, f"{fwd_name}_plain")
    gen = torch.Generator(device=device).manual_seed(15)
    q, k, v, g = _inputs(gen, rows, n, d, d, torch.bfloat16, device)
    _, carry = fwd_plain(*_inputs(gen, rows, 64, d, d, torch.float32,
                                  device))
    state_bytes = 4 * sum(x.numel() for x in carry)
    n_st = max(8, -(-100_000_000 // state_bytes))
    carries = [[x.clone() for x in carry] for _ in range(n_st)]
    ms = median_ms(lambda i: fwd(q, k, v, g,
                                 initial_state=carries[i % n_st]), 20)
    plain = median_ms(lambda i: fwd_plain(q, k, v, g,
                                          initial_state=carries[i % n_st]), 5)
    nbytes = 2 * state_bytes + 2 * rows * n * 4 * d + 4 * rows
    fmas = {"hla2": chunk_fmas, "ahla": ahla_chunk_fmas}[mixer](
        n, d, d, has_init=True)
    bound, by = _bound(nbytes, fmas, rows)
    src, line = {"hla2": (CHUNK_SRC, "src/repro/kernels/hla2_chunk.py:176"),
                 "ahla": (AHLA_CHUNK_SRC,
                          "src/repro/kernels/ahla_chunk.py:100")}[mixer]
    log(f"{fwd_name} at the verify shape, rows {rows} n {n} d {d} with a "
        f"carry, bf16 in, {n_st} carries rotated: {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bound:.4f} ms ({by}: {nbytes / 1e6:.2f} MB "
        f"at 3.35 TB/s, the carry {state_bytes / 1e6:.2f} MB read and "
        f"written; {_ops_text(fmas, rows)}; {nbytes / ms / 1e9:.2f} TB/s "
        "achieved)")
    return dict(name=f"{fwd_name}[verify]", route="cuda", source=src,
                replaces=line, launches=launches,
                max_abs_err=verify_abs, ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None)


def time_d64(device, d64, moe):
    """The six kernels at granite-moe-3b-a800m's heads (d = dv = 64) and
    phase 13's rows: the forwards at an admission's 24 rows x 512, the
    steps at a decode step's 96, the forwards with checkpoints and the
    backwards at (d)'s 48 rows x 2048.  ``d64`` holds phase 2's errors at
    these shapes, ``moe`` phase 13's summary (its launches).  Each row's
    name carries ``[d=64]``."""
    g = moe["served"]
    rows = time_kernels(device, d64["chunk"], d64["step"],
                        g["hla2"]["launches"], rows_chunk=24, rows_step=96,
                        d=64)
    rows += time_train_kernels(device, "hla2", *d64["bwd"],
                               moe["train_launches"]["hla2"], rows=48, d=64)
    rows += time_ahla_kernels(device, d64["ahla_chunk"], d64["ahla_step"],
                              g["ahla"]["launches"], rows_chunk=24,
                              rows_step=96, d=64)
    rows += time_train_kernels(device, "ahla", *d64["ahla_bwd"],
                               moe["train_launches"]["ahla"], rows=48, d=64)
    for r in rows:
        r["name"] += "[d=64]"
    return rows


def time_jamba(device, jamba_abs, hybrid):
    """The three HLA2 kernels at phase 14's jamba shapes (d = dv = 128):
    the forward at a 2-row prefill's 128 rows x 300 tokens, the step at a
    decode step's 128 rows, the forward with checkpoints and the backward
    at the half-width training's 64 rows x 1024.  ``jamba_abs`` holds
    phase 2's errors at these shapes, ``hybrid`` phase 14's summary (its
    launches).  Each row's name carries ``[jamba]``."""
    rows = time_kernels(device, jamba_abs["chunk"], jamba_abs["step"],
                        hybrid["decoded"]["hla2"]["launches"],
                        rows_chunk=128, n=300, rows_step=128)
    rows += time_train_kernels(device, "hla2", *jamba_abs["bwd"],
                               hybrid["jamba_train_launches"], rows=64,
                               n=1024)
    for r in rows:
        r["name"] += "[jamba]"
    return rows


def time_whisper(device, whisper_abs, phase):
    """The six kernels at whisper-small's heads (12 of d = dv = 64) and
    phase 15's rows: the forwards at a 224-token prefill's 48 rows (4 rows
    x 12 heads), the steps at a decode step's 48, the forwards with
    checkpoints and the backwards at (d)'s 96 rows x 448.  ``whisper_abs``
    holds phase 2's errors at these shapes, ``phase`` phase 15's summary
    (its launches).  Each row's name carries ``[whisper]``."""
    served, trained = phase["serve_launches"], phase["train_launches"]
    n = max(WHISPER_PROMPTS)
    rows = time_kernels(device, whisper_abs["chunk"], whisper_abs["step"],
                        served, rows_chunk=48, n=n, rows_step=48, d=64)
    rows += time_train_kernels(device, "hla2", *whisper_abs["bwd"],
                               trained["hla2"], rows=96, n=448, d=64)
    rows += time_ahla_kernels(device, whisper_abs["ahla_chunk"],
                              whisper_abs["ahla_step"], served, rows_chunk=48,
                              n=n, rows_step=48, d=64)
    rows += time_train_kernels(device, "ahla", *whisper_abs["ahla_bwd"],
                               trained["ahla"], rows=96, n=448, d=64)
    for r in rows:
        r["name"] += "[whisper]"
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.models.param import init_params

    device = torch.device("cuda", 0)
    global CARD
    CARD = smi = card()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN: fp32 references run in full fp32")

    from repro_torch.kernels import ahla_chunk, decode_step, hla2_chunk

    t0 = time.perf_counter()
    builds = [("hla2_chunk_fwd", hla2_chunk._SIG),
              ("hla2_step", decode_step._SIG),
              ("hla2_chunk_bwd", hla2_chunk._BWD_SIG),
              ("ahla_chunk_fwd", ahla_chunk._SIG),
              ("ahla_step", decode_step._AHLA_SIG),
              ("ahla_chunk_bwd", ahla_chunk._BWD_SIG)]
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per source
        list(pool.map(lambda a: _build.load(*a), builds))
    log(f"built {len(builds)} kernels in {time.perf_counter() - t0:.1f}s")
    for name, _ in builds:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name} ptxas: {line.strip()}")
    for name in ("hla2_step", "ahla_step"):
        spills = re.findall(r"(\d+) bytes spill", _build.build_log(name))
        if not spills or any(int(x) for x in spills):
            raise AssertionError(f"{name}: ptxas reports spills {spills}")
    for name in ("hla2_chunk_fwd", "hla2_chunk_bwd", "ahla_chunk_fwd",
                 "ahla_chunk_bwd"):
        fn = getattr(_build.load(name, dict(builds)[name]), f"{name}_smem_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_long
        smem = {dt: fn(128, int(dt == "bf16")) for dt in ("bf16", "fp32")}
        log(f"{name} shared memory at d = 128: {smem['bf16']:,} bytes with "
            f"bf16 inputs, {smem['fp32']:,} with fp32 (limit {SMEM_LIMIT:,})")
        if max(smem.values()) > SMEM_LIMIT:
            raise AssertionError(f"{name} asks for more shared memory than "
                                 "a block may use")

    chunk_abs = check_chunk(device)
    # the verify shape: 4 slots x 16 heads, k+1 tokens, resumed from a carry
    verify_abs = check_chunk(device, rows=64, ns=(SPEC_K + 1, 1),
                             main_init=True)
    step_abs = check_step(device)
    check_chunk(device, rows=8, d=16, ns=(130, 7))  # reduced hla-1b heads
    check_step(device, rows=8, d=16, n_prior=70)
    # ragged: d != dv, and the last column slice of each narrower
    check_step(device, rows=6, d=72, dv=40, n_prior=70)
    bwd_abs, ckpt_abs = check_chunk_bwd(device)
    check_chunk_bwd(device, rows=8, d=16, ns=(130, 7), small=True)
    # normalize and lam across four column tiles, ragged
    check_chunk_bwd(device, rows=4, d=128, ns=(300,), small=True)
    ahla_chunk_abs = check_ahla_chunk(device)
    ahla_verify_abs = check_ahla_chunk(device, rows=64, ns=(SPEC_K + 1, 1),
                                       main_init=True)
    ahla_step_abs = check_ahla_step(device)
    check_ahla_chunk(device, rows=8, d=16, ns=(130, 7))
    check_ahla_step(device, rows=8, d=16, n_prior=70)
    check_ahla_step(device, rows=6, d=72, dv=40, n_prior=70)  # ragged
    ahla_bwd_abs, ahla_ckpt_abs = check_ahla_chunk_bwd(device)
    check_ahla_chunk_bwd(device, rows=8, d=16, ns=(130, 7), small=True)
    # normalize across four value tiles and the one-column den tile, ragged
    check_ahla_chunk_bwd(device, rows=4, d=128, ns=(300,), small=True)
    # phase 12's rows at codeqwen1.5-7b's 32 heads: an admission's 32, a
    # decode step's 128 (4 slots), (d)'s training 64 (the backward and the
    # forward with checkpoints)
    check_chunk(device, rows=32)
    check_ahla_chunk(device, rows=32)
    check_step(device, rows=128)
    check_ahla_step(device, rows=128)
    check_chunk_bwd(device, rows=64)
    # phase 13's rows at granite-moe-3b-a800m's 24 heads of d = dv = 64 (two
    # 32-column tiles a row, 16 columns per cluster CTA in the steps): an
    # admission's 24, a decode step's 96 (4 slots), (d)'s training 48
    d64 = dict(
        chunk=check_chunk(device, rows=24, d=64),
        ahla_chunk=check_ahla_chunk(device, rows=24, d=64),
        step=check_step(device, rows=96, d=64),
        ahla_step=check_ahla_step(device, rows=96, d=64),
        bwd=check_chunk_bwd(device, rows=48, d=64),
        ahla_bwd=check_ahla_chunk_bwd(device, rows=48, d=64))
    # phase 14's rows at jamba's 64 heads of 128 (8 KV heads broadcast): a
    # 2-row prefill's 128 at 300 tokens (a ragged tail), a decode step's
    # 128, the half-width training's 2 x 32 = 64 at 1024 tokens
    jamba_abs = dict(chunk=check_chunk(device, rows=128, ns=(300,)),
                     step=check_step(device, rows=128),
                     bwd=check_chunk_bwd(device, rows=64, ns=(1024,)))
    # phase 15's rows at whisper-small's 12 heads of d = dv = 64: a 4-row
    # prefill's 48 at 224 tokens and at 4 (one partial chunk, no carry), a
    # decode step's 48, (d)'s training 8 x 12 = 96 at 448 tokens
    whisper_abs = dict(
        chunk=check_chunk(device, rows=48, d=64, ns=(224, 4)),
        ahla_chunk=check_ahla_chunk(device, rows=48, d=64, ns=(224, 4)),
        step=check_step(device, rows=48, d=64),
        ahla_step=check_ahla_step(device, rows=48, d=64),
        bwd=check_chunk_bwd(device, rows=96, d=64, ns=(448,)),
        ahla_bwd=check_ahla_chunk_bwd(device, rows=96, d=64, ns=(448,)))
    torch.cuda.synchronize()

    check_small_model(device)
    check_small_model(device, mixer="ahla")
    check_small_train(device)
    check_small_train(device, mixer="ahla")
    cfg = get_config("hla-1b")
    ahla_cfg = get_config("hla-1b", mixer="ahla")
    # the two mixers share one parameter layout: one set of weights serves
    params = init_params(lm.lm_specs(cfg), 0, device)
    check_identity(params, cfg.replace(dtype="float32"))
    check_identity(params, ahla_cfg.replace(dtype="float32"))

    launches, plain = serve(params, cfg, device)
    profile_decode(params, cfg, device)
    ahla_launches, ahla_plain = serve(params, ahla_cfg, device)
    spec = spec_phase(params, cfg, device, plain["streams"])
    ahla_spec = spec_phase(params, ahla_cfg, device, ahla_plain["streams"])
    exact = {"hla2": frontend_phase(params, cfg, device, spec=True)[2],
             "ahla": frontend_phase(params, ahla_cfg, device)[2]}
    del params
    train_launches, trained = train_phase(device)
    ahla_train_launches, ahla_trained = train_phase(device, mixer="ahla")
    accum_remat_phase(device)
    restart_phase(device)
    tooling_phase(device, {"hla2": plain, "ahla": ahla_plain},
                  {"hla2": trained, "ahla": ahla_trained})
    family_phase(device)
    public_phase(device, {a: get_config(a) for a in PUBLIC})
    moe = moe_phase(device, {a: get_config(a) for a in MOE + ("hla-1b",)})
    hybrid = hybrid_phase(device, {a: get_config(a) for a in HYBRID})
    whisper = whisper_phase(device, get_config("whisper-small"))
    mesh_phase(device)
    # phase 16 (c)'s dry runs: host work, beside phase 17 (whose checks are
    # exact, not timed) and phase 7, whose device times a busy host does
    # not move; 16 (a) and (b) time the host, so they run before on a quiet
    # one
    dryruns = start_dryruns()
    mesh_rest_phase(device, {"hla2": spec["fp32"], "ahla": ahla_spec["fp32"]},
                    exact)
    kernels = time_kernels(device, chunk_abs, step_abs, launches)
    kernels.append(time_verify(device, "hla2", verify_abs,
                               cfg.n_layers * spec["ngram"]["rounds"]))
    kernels += time_train_kernels(device, "hla2", bwd_abs, ckpt_abs,
                                  train_launches)
    kernels += time_ahla_kernels(device, ahla_chunk_abs, ahla_step_abs,
                                 ahla_launches)
    kernels.append(time_verify(device, "ahla", ahla_verify_abs,
                               cfg.n_layers * ahla_spec["ngram"]["rounds"]))
    kernels += time_train_kernels(device, "ahla", ahla_bwd_abs, ahla_ckpt_abs,
                                  ahla_train_launches)
    kernels += time_d64(device, d64, moe)
    kernels += time_jamba(device, jamba_abs, hybrid)
    kernels += time_whisper(device, whisper_abs, whisper)
    t0 = time.perf_counter()
    collect_dryruns(dryruns)
    log(f"phase 16 (c): waited {time.perf_counter() - t0:.1f}s for the dry "
        "runs after phase 7")
    log(f"all phases passed in {time.perf_counter() - T0:.0f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
