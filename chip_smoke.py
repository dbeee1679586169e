#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code nonzero, no result line):

1. build the hand-written kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once) and print nvcc's register/shared-memory report;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (hla-1b rows, head dim 128);
3. check the port against its plain path on a small model (card vs CPU),
   and at full width that prefill(L) + one decode step equals
   prefill(L + 1) for hla-1b (24 layers, seeded random weights, fp32);
4. serve 8 hla-1b requests through the port's ``Engine`` (bf16, 4 slots),
   count the kernel launches of that run and time the chunk kernel's
   launches in it;
5. time each kernel and its plain version at the main path's shapes.

The second-to-last line is the ``kernels`` JSON, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, the script exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import statistics
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet) for the lower bounds
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_FP32_FLOP_S = 67e12

# kernel vs plain tolerances, relative to max|plain|:
# fp32 outputs and every fp32 state differ only by summation order
# (SIMT tiles vs cuBLAS, over up to 640 tokens and 128-wide dots): ~1e-6
TOL_FP32 = 1e-4
# bf16 outputs are the fp32 results rounded to bf16 (2^-8 relative), and a
# last-place difference in fp32 may flip a rounding: at most one bf16 ulp
TOL_BF16 = 1e-2
# logits after 24 fp32 layers, kernels vs kernels in two summation orders
TOL_LOGITS = 2e-3

CHUNK_SRC = "src/repro_torch/csrc/hla2_chunk_fwd.cu"
STEP_SRC = "src/repro_torch/csrc/hla2_step.cu"


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


def check_chunk(device, rows=16, d=128, ns=(512, 300)):
    """hla2_chunk_fwd vs hla2_chunk_fwd_plain.  Returns the max absolute
    output error of the main-path case (bf16, first n, no carry)."""
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
        if main_abs is None:
            main_abs = abs_err(o_k, o_p)
    return main_abs


def check_step(device, rows=64, d=128, n_prior=300):
    """hla2_step vs hla2_step_plain after a prefill, both in place.  Returns
    the max absolute output error of the main-path case (bf16)."""
    import torch

    from repro_torch.kernels.decode_step import hla2_step, hla2_step_plain
    from repro_torch.kernels.hla2_chunk import hla2_chunk_fwd

    gen = torch.Generator(device=device).manual_seed(1)
    main_abs = None
    for dt, norm, lam, use_gamma in ((torch.bfloat16, False, 0.0, True),
                                     (torch.float32, False, 0.0, True),
                                     (torch.float32, True, 0.2, True),
                                     (torch.float32, False, 0.0, False)):
        qp, kp, vp, g = _inputs(gen, rows, n_prior, d, d, dt, device,
                                positive=norm)
        g = g if use_gamma else None
        _, st0 = hla2_chunk_fwd(qp, kp, vp, g)  # the prefill the step resumes
        q, k, v, _ = _inputs(gen, rows, 1, d, d, dt, device, positive=norm)
        q, k, v = q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous()
        s_k = [x.clone() for x in st0]
        s_p = [x.clone() for x in st0]
        ptrs = [x.data_ptr() for x in s_k]
        o_k = hla2_step(s_k, q, k, v, g, normalize=norm, lam=lam)
        o_p = hla2_step_plain(s_p, q, k, v, g, normalize=norm, lam=lam)
        if [x.data_ptr() for x in s_k] != ptrs or any(
                torch.equal(a, b) for a, b in zip(s_k, st0)):
            raise AssertionError("hla2_step did not update its state in place")
        e_o = rel_err(o_k, o_p)
        e_s = max(rel_err(a, b) for a, b in zip(s_k, s_p))
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_FP32
        log(f"hla2_step {str(dt)[6:]} rows={rows} d={d} after prefill "
            f"{n_prior} gamma={use_gamma} normalize={norm} lam={lam}: "
            f"o rel {e_o:.2e} (tol {tol:.0e}), "
            f"state rel {e_s:.2e} (tol {TOL_FP32:.0e})")
        if not (e_o <= tol and e_s <= TOL_FP32):
            raise AssertionError("hla2_step disagrees with its plain version")
        if main_abs is None:
            main_abs = abs_err(o_k, o_p)
    return main_abs


# --------------------------------------------------------------------------
# phase 3: the model, against its plain path and against itself
# --------------------------------------------------------------------------


def check_small_model(device):
    """Reduced hla-1b (fp32): prefill + one decode step on ``device`` (the
    kernels) vs on the CPU (the plain versions), same weights."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.param import init_params

    cfg = get_config("hla-1b", reduced=True)
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
    log(f"reduced hla-1b fp32, prefill 149 + 1 step: {device} kernels vs cpu "
        f"plain logits rel {e:.2e} (tol {TOL_FP32:.0e})")
    if not e <= TOL_FP32:
        raise AssertionError("the model on the card disagrees with the CPU")


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
    log(f"{cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.dtype}: prefill({L}) + step vs prefill({L + 1}) logits rel "
        f"{e:.2e} (tol {TOL_LOGITS:.0e}), argmax "
        f"{int(step.argmax())} vs {int(full.argmax())}")
    if not e <= TOL_LOGITS:
        raise AssertionError("prefill + step != longer prefill")


# --------------------------------------------------------------------------
# phase 4: serving
# --------------------------------------------------------------------------


def serve(params, cfg, device, n_req=8, slots=4, lens=(256, 640), gen=64,
          block=8):
    """Serve ``n_req`` greedy requests; returns the launch counts of that
    run and its summary numbers."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import LAUNCHES
    from repro_torch.serving.engine import Engine, GenRequest

    engine = Engine(cfg, params, slots=slots, max_len=lens[1] + gen + 8,
                    block=block, seed=0, device=device)
    rng = np.random.RandomState(0)
    reqs = [GenRequest(rid=i, prompt=rng.randint(2, cfg.vocab, size=L),
                       max_new=gen)
            for i, L in enumerate(rng.randint(lens[0], lens[1] + 1, n_req))]
    engine.run([GenRequest(rid=-1, prompt=reqs[0].prompt, max_new=block)])
    engine.reset_stats()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    # CUDA events around each chunk-kernel call of the run: the stream is
    # busy with the layer before, so each pair brackets the launch's device
    # time (plus the wrapper's host time where the stream ran dry)
    marks = []
    kernel = ops.hla2_chunk_fwd

    def timed(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = kernel(*args, **kw)
        end.record()
        marks.append((start, end))
        return out

    ops.hla2_chunk_fwd = timed
    LAUNCHES.clear()  # count the main path only
    t0 = time.perf_counter()
    try:
        results = engine.run(reqs)
    finally:
        ops.hla2_chunk_fwd = kernel
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    bad = [(r.rid, r.status, len(r.tokens), r.error) for r in results
           if r.status != "ok" or len(r.tokens) != gen]
    if bad:
        raise AssertionError(f"requests not served: {bad}")
    st = engine.stats
    want = {"hla2_chunk_fwd": cfg.n_layers * n_req,
            "hla2_step": cfg.n_layers * st["decode_steps"]}
    if any(launches.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"kernel launches {launches}, want {want}")
    peak = torch.cuda.max_memory_allocated(device) / 2**30
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
        decode_steps=st["decode_steps"], peak_gib=peak)
    log(f"served {n_req} requests (prompts {lens[0]}-{lens[1]}, gen {gen}, "
        f"{slots} slots, block {block}, {cfg.dtype}) in {wall:.2f}s: TTFT "
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
# phase 5: timing
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
    normalize, no lam), split by operand type: ``(bf16 x bf16, fp32)``.

    Per chunk of r tokens of the kernel's schedule: only the causal
    triangles of the masked products, the upper triangle of S's update
    (S = sum k k^T is symmetric), and no products with the carry on the
    first chunk when there is no initial state.  K Q^T multiplies two
    inputs (bf16); every other product has an fp32 operand (the carry, or
    a decay-weighted term).  The O(r d) vector terms (m, h) are left out.
    """
    def tri(x):  # entries of a causal triangle, diagonal included
        return x * (x + 1) // 2

    bf16 = fp32 = 0
    for c0 in range(0, n, w):
        r = min(w, n - c0)
        bf16 += r * r * d                 # K Q^T: both triangles are used
        fp32 += r * (r + 1) * (r + 2) // 6  # T3 weights, j <= i <= t
        fp32 += tri(r) * dv + tri(r - 1) * dv  # P V, N (g V)
        fp32 += tri(d) * r + 2 * d * dv * r   # S, C, G updates
        if has_init or c0 > 0:
            fp32 += r * d * d + tri(r) * d    # Q S0, T2 weights
            fp32 += 3 * r * d * dv            # (Q S0) C0, Q G0, K C0
    return bf16, fp32


def time_kernels(device, chunk_abs, step_abs, launches, rows_chunk=16,
                 n=512, rows_step=64, d=128):
    import torch

    from repro_torch.kernels.decode_step import hla2_step, hla2_step_plain
    from repro_torch.kernels.hla2_chunk import (
        hla2_chunk_fwd, hla2_chunk_fwd_plain)

    gen = torch.Generator(device=device).manual_seed(4)
    bf = torch.bfloat16
    q, k, v, g = _inputs(gen, rows_chunk, n, d, d, bf, device)
    ms = median_ms(lambda i: hla2_chunk_fwd(q, k, v, g), 20)
    plain = median_ms(lambda i: hla2_chunk_fwd_plain(q, k, v, g), 5)
    bf16_fma, fp32_fma = chunk_fmas(n, d, d)
    state_bytes = 4 * rows_chunk * (3 * d * d + 2 * d)
    nbytes = 2 * rows_chunk * n * (2 * d + 2 * d) + state_bytes + 4 * rows_chunk
    t_b = 1e3 * nbytes / PEAK_BYTES_S
    t_f = 1e3 * 2 * rows_chunk * (bf16_fma / PEAK_BF16_FLOP_S
                                  + fp32_fma / PEAK_FP32_FLOP_S)
    chunk = dict(
        name="hla2_chunk_fwd", route="cuda", source=CHUNK_SRC,
        replaces="src/repro/kernels/hla2_chunk.py:176",
        launches=launches.get("hla2_chunk_fwd", 0), max_abs_err=chunk_abs,
        ms=ms, plain_ms=plain, bound_ms=max(t_b, t_f),
        bound_by="bytes" if t_b > t_f else "operations", library_ms=None)
    log(f"hla2_chunk_fwd at rows {rows_chunk} n {n} d {d}, bf16 in: "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{chunk['bound_ms']:.4f} ms ({chunk['bound_by']}: "
        f"{2 * rows_chunk * bf16_fma / 1e9:.3f} GFLOP bf16 x bf16 at 989 "
        f"TFLOP/s + {2 * rows_chunk * fp32_fma / 1e9:.3f} GFLOP fp32 at 67 "
        f"TFLOP/s; {nbytes / 1e6:.2f} MB at 3.35 TB/s)")

    # one state per layer of a 24-layer stack would not fit in L2; rotate
    # over 8 copies (~100 MB) so every launch finds its state cold
    q, k, v, g = _inputs(gen, rows_step, 1, d, d, bf, device)
    q, k, v = q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous()
    _, st0 = hla2_chunk_fwd(*_inputs(gen, rows_step, 64, d, d, bf, device))
    states = [[x.clone() for x in st0] for _ in range(8)]
    ms_s = median_ms(lambda i: hla2_step(states[i % 8], q, k, v, g), 40)
    plain_s = median_ms(
        lambda i: hla2_step_plain(states[i % 8], q, k, v, g), 10)
    state_bytes = 4 * rows_step * (3 * d * d + 2 * d)
    nbytes = 2 * state_bytes + 2 * rows_step * 4 * d + 4 * rows_step
    # FMAs per row: 2 per element of S (update, u), 4 per element of C
    # (k, u, q reductions, update), 2 per element of G (update, q reduction)
    flops = 2 * rows_step * (2 * d * d + 6 * d * d)
    t_b, t_f = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * flops / PEAK_FP32_FLOP_S
    step = dict(
        name="hla2_step", route="cuda", source=STEP_SRC,
        replaces="src/repro/kernels/decode_step.py:127",
        launches=launches.get("hla2_step", 0), max_abs_err=step_abs,
        ms=ms_s, plain_ms=plain_s, bound_ms=max(t_b, t_f),
        bound_by="bytes" if t_b > t_f else "operations", library_ms=None)
    log(f"hla2_step at rows {rows_step} d {d}, bf16 in, fp32 state, 8 states "
        f"rotated: {ms_s:.4f} ms, plain {plain_s:.4f} ms, bound "
        f"{step['bound_ms']:.4f} ms ({step['bound_by']})")
    return [chunk, step]


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

    from repro_torch.kernels import decode_step, hla2_chunk

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, at once
        list(pool.map(lambda a: _build.load(*a),
                      [("hla2_chunk_fwd", hla2_chunk._SIG),
                       ("hla2_step", decode_step._SIG)]))
    log(f"built both kernels in {time.perf_counter() - t0:.1f}s")
    for name in ("hla2_chunk_fwd", "hla2_step"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name} ptxas: {line.strip()}")

    chunk_abs = check_chunk(device)
    step_abs = check_step(device)
    check_chunk(device, rows=8, d=16, ns=(130, 7))  # reduced hla-1b heads
    check_step(device, rows=8, d=16, n_prior=70)
    torch.cuda.synchronize()

    check_small_model(device)
    cfg = get_config("hla-1b")
    params = init_params(lm.lm_specs(cfg), 0, device)
    check_identity(params, cfg.replace(dtype="float32"))

    launches, _ = serve(params, cfg, device)
    del params
    kernels = time_kernels(device, chunk_abs, step_abs, launches)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
