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
   column tiles of d = 128;
3. check the port against its plain path on a small model (card vs CPU):
   prefill + decode logits, and the training loss and every parameter's
   gradient, with either mixer; and at full width that prefill(L) + one
   decode step equals prefill(L + 1) for hla-1b with either mixer (24
   layers, seeded random weights, fp32);
4. serve 8 hla-1b requests through the port's ``Engine`` (bf16, 4 slots),
   once with the HLA2 mixer and once with AHLA (``mixer="ahla"``), count
   the kernel launches of each run and time the chunk kernel's launches in
   it;
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
6. train hla-1b at full width and depth for 5 AdamW steps on one repeated
   2 x 2048 batch, once with either mixer, count the kernel launches of
   each run (24 forward + 24 backward per step of its mixer's kernels, no
   other, no plain version) and check the loss falls;
7. time each kernel and its plain version at its path's shapes (the step
   kernels also at 16 rows, one slot; the chunk forwards also at the
   verify shape, ``[verify]``).

The second-to-last line is the ``kernels`` JSON, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, the script exits nonzero before printing any result.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

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
        step, _ = lm.lm_apply(p, t[:, -1:], cfg, states=st, mode="decode")
        out.append((last.cpu(), step[:, -1].cpu()))
    e = max(rel_err(a, b) for a, b in zip(*out))
    log(f"reduced hla-1b ({cfg.mixer}) fp32, prefill 149 + 1 step: {device} "
        f"kernels vs cpu plain logits rel {e:.2e} (tol {TOL_FP32:.0e})")
    if not e <= TOL_FP32:
        raise AssertionError("the model on the card disagrees with the CPU")


def _loss_grads(params, batch, cfg):
    """The model's loss and its gradient for every parameter leaf (in
    ``leaf_paths`` order)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.param import leaf_paths, tree_map

    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, _ = lm.lm_loss(live, batch["tokens"], batch["labels"], cfg)
    flat = [x for _, x in leaf_paths(live)]
    return loss.detach(), torch.autograd.grad(loss, flat)


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


def check_identity(params, cfg, L=300):
    """prefill(L) + decode step == prefill(L + 1) on the last logits."""
    import torch

    from repro_torch.models import lm

    dev = params["embed"]["embedding"].device
    tok = torch.randint(2, cfg.vocab, (1, L + 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    _, st = lm.lm_prefill(params, tok[:, :L], cfg)
    step, _ = lm.lm_apply(params, tok[:, L:], cfg, states=st, mode="decode")
    full, _ = lm.lm_prefill(params, tok, cfg)
    step = step[:, -1]
    if step.shape != full.shape or not bool(step.isfinite().all()):
        raise AssertionError(f"bad logits {tuple(step.shape)}")
    e = rel_err(step, full)
    log(f"{cfg.name} ({cfg.mixer}) {cfg.n_layers} layers d_model "
        f"{cfg.d_model} {cfg.dtype}: prefill({L}) + step vs prefill({L + 1}) "
        "logits rel "
        f"{e:.2e} (tol {TOL_LOGITS:.0e}), argmax "
        f"{int(step.argmax())} vs {int(full.argmax())}")
    if not e <= TOL_LOGITS:
        raise AssertionError("prefill + step != longer prefill")


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
    engine.reset_stats()
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
    # admissions run in request order (FIFO), so ttft_s[i] is request i's
    lens_served = [len(r.prompt) for r in reqs]
    for L, ttft, ms in zip(lens_served, st["ttft_s"], per_adm):
        log(f"admission of {L} tokens: TTFT {1e3 * ttft:.2f} ms, chunk "
            f"kernel {ms:.2f} ms over {cfg.n_layers} launches "
            f"({ms / (1e3 * ttft):.1%})")
    out = dict(
        wall_s=wall,
        ttft_p50_ms=1e3 * float(np.percentile(st["ttft_s"], 50)),
        prompt_p50=float(np.percentile(lens_served, 50)),
        chunk_share_of_prefill=sum(per_adm) / (1e3 * st["prefill_s"]),
        decode_tok_s=(st["generated_tokens"] - n_req) / st["decode_s"],
        prefill_tok_s=st["prompt_tokens"] / st["prefill_s"],
        decode_steps=st["decode_steps"], peak_gib=peak,
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
               lens=(256, 640), gen=64, block=8):
    """Serve the serve phase's requests speculatively (``drafter``: "ngram",
    "lm" or an instance; k = ``SPEC_K``).  On the card, the run's kernel
    launches must equal the counts its stats imply, with no plain-version
    call and no breaker trip.  Returns its summary numbers and streams."""
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
    engine = Engine(cfg, params, slots=slots, max_len=lens[1] + gen + 8,
                    block=block, seed=0, device=device, spec=spec)
    reqs = serve_requests(cfg, n_req, lens, gen)
    engine.run([GenRequest(rid=-1, prompt=reqs[0].prompt, max_new=block)])
    engine.reset_stats()
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
        streams=[r.tokens for r in results])
    log(f"speculative serve, {cfg.mixer}, {cfg.dtype}, drafter {name}, k "
        f"{SPEC_K}: {n_req} requests in {wall:.2f}s | decode "
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
        logits, _ = lm.lm_apply(params, t[:, j:j + 1], cfg, states=st,
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
    both routes.  Returns the n-gram bf16 run's numbers."""
    from repro_torch.models import lm

    cfg32 = cfg.replace(dtype="float32")
    kw = dict(n_req=n_req, lens=lens, gen=gen)
    _, plain32 = serve(params, cfg32, device, **kw)
    for drafter in ("ngram", _wrong_drafter()):
        out = serve_spec(params, cfg32, device, drafter, **kw)
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
    runs = {}
    for drafter in ("ngram", "lm"):
        out = serve_spec(params, cfg, device, drafter, **kw)
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
# phase 6: training
# --------------------------------------------------------------------------


# each mixer's training kernels: (module under repro_torch.kernels, forward,
# backward)
TRAIN_KERNELS = {"hla2": ("hla2_chunk", "hla2_chunk_fwd", "hla2_chunk_bwd"),
                 "ahla": ("ahla_chunk", "ahla_chunk_fwd", "ahla_chunk_bwd")}


def train(device, mixer="hla2", steps=5, batch=2, seq=2048):
    """AdamW steps of full-width hla-1b with ``mixer`` (24 layers, bf16
    activations, fp32 parameters and moments) on one repeated synthetic
    batch.  Returns the launch counts of the run and its summary numbers."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels.ops import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.models.param import init_params
    from repro_torch.optim import adamw

    cfg = get_config("hla-1b", mixer=mixer)
    mod_name, fwd, bwd = TRAIN_KERNELS[mixer]
    params = init_params(lm.lm_specs(cfg), 0, device)
    # with one warmup step, the default lr 3e-4 moves every weight by ~lr
    # at once: on this random-weight model the loss rose 11.0 -> 18.2 and
    # the gradient norm 109 -> 28757 (H100, 700 W); 1e-5 stays in the
    # regime where a step follows the gradient
    opt_cfg = adamw.OptConfig(lr=1e-5, warmup_steps=1, total_steps=steps)
    state = adamw.init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg)
    host = SyntheticStream(DataConfig(cfg.vocab, seq, batch, seed=0)).batch(0)
    data = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    # count calls of the plain versions too: the run must make none
    plain_calls, restore = _count_plain_calls(
        [(mod_name, f"{fwd}_plain"), (mod_name, f"{bwd}_plain")])
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    LAUNCHES.clear()  # count the main path only
    losses, norms, step_s = [], [], []
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, data)
            losses.append(float(m["loss"]))  # waits for the step
            step_s.append(time.perf_counter() - t0)
            norms.append(float(m["grad_norm"]))
    finally:
        restore()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    p50 = float(np.percentile(step_s, 50))
    log(f"trained {cfg.name} ({cfg.mixer}; {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype} activations, fp32 parameters and "
        f"moments) for {steps} AdamW steps on one {batch} x {seq} batch: loss "
        f"{' '.join(f'{x:.4f}' for x in losses)} | grad norm "
        f"{' '.join(f'{x:.3f}' for x in norms)} | step "
        f"{' '.join(f'{x:.3f}' for x in step_s)} s | step p50 {p50:.3f}s "
        f"| {batch * seq / p50:.0f} tok/s | peak memory {peak:.2f} GiB | "
        f"launches {launches} | plain calls {len(plain_calls)}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError("non-finite loss or gradient norm")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on the repeated batch")
    want = {fwd: cfg.n_layers * steps, bwd: cfg.n_layers * steps}
    if launches != want or plain_calls:
        raise AssertionError(f"kernel launches {launches}, want {want}; "
                             f"plain calls {plain_calls}")
    return launches, dict(step_p50_s=p50, tok_s=batch * seq / p50,
                          peak_gib=peak, losses=losses)


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
    ahla_launches, ahla_plain = serve(params, ahla_cfg, device)
    spec = spec_phase(params, cfg, device, plain["streams"])
    ahla_spec = spec_phase(params, ahla_cfg, device, ahla_plain["streams"])
    del params
    train_launches, _ = train(device)
    ahla_train_launches, _ = train(device, mixer="ahla")
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
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
