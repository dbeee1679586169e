"""Perf observability: roofline utilization, profiler capture, bench
history.

Own copy of ``repro/obs/perf.py``:

* **Roofline** — ``device_peak()`` (a table of published NVIDIA H100 rates,
  a calibrated fallback measured on the device itself) and
  ``roofline_utilization(tok_per_s, cost, peak)``, which turns a measured
  throughput plus an ``obs.costs`` OpCost into achieved FLOP/s, achieved
  bytes/s, utilization fractions and the bound (compute vs memory).

* **Profiler capture** — ``profile_capture(profile_dir, obs=...)`` wraps a
  region in a ``torch.profiler`` window (CPU activity, and CUDA activity
  when a card is present) and writes one Chrome trace into
  ``profile_dir``; it mirrors the boundaries as ``profile.start`` /
  ``profile.stop`` events on the obs tracer, so the profiler timeline
  lines up against the ``repro.obs.events/v1`` spans (both carry
  wall-clock stamps).  The tracer's spans appear in that trace under their
  own names (``trace.Tracer`` forwards them to
  ``torch.profiler.record_function``).  No-op when ``profile_dir`` is
  falsy.  Exposed as ``--profile-dir`` on ``launch/serve.py`` and
  ``launch/train.py``.

* **Bench history** — an append-only JSONL (schema
  ``repro.obs.bench/v1``): each bench invocation appends one ``run``
  header record carrying the env fingerprint (git sha, torch and CUDA
  versions, backend, device count/kind, power limit) followed by one
  ``row`` record per metric (name, value, unit, direction, dispersion,
  sample count).  ``BenchHistory`` writes it, ``read_bench`` /
  ``validate_bench_record`` parse it (also for ``obs.validate --bench``),
  and ``obs.perfcheck`` compares two runs.  Either package reads the
  other's history: the fingerprint keeps the reference's required keys
  (``jax_version`` is ``"unavailable"`` here).

Import-purity contract: importing this module must NOT import torch —
``perfcheck`` and ``validate`` run in bare-stdlib contexts.  All torch
use is inside functions.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
import uuid
from typing import Optional

BENCH_SCHEMA = "repro.obs.bench/v1"

#: direction of goodness for a bench row
DIRECTIONS = ("higher", "lower")

#: dense (no sparsity) bf16 tensor-core FLOP/s and HBM bytes/s of the cards
#: the port runs on, keyed by substrings of ``torch.cuda.get_device_name``.
#: Source: NVIDIA H100 Tensor Core GPU data sheet (the sparsity figures
#: halved): SXM 1,979 TFLOP/s bf16 and 3.35 TB/s; NVL 1,671 and 3.9 TB/s;
#: PCIe 1,513 and 2.0 TB/s.  The rates assume the card's full power limit.
_KNOWN_PEAKS = (
    ("H100 NVL", 835.5e12, 3.9e12),
    ("H100 PCIe", 756.5e12, 2.0e12),
    ("H100 80GB HBM3", 989e12, 3.35e12),  # H100 SXM
)

#: card-to-card bytes/s one way, the rate the dry run's ``collective_s``
#: divides a rank's collective bytes by (a ring collective sends and
#: receives at once, so each direction carries its share).  Published, not
#: measured.  Source: the same data sheet's interconnect row, halved for one
#: direction: SXM NVLink 900 GB/s, NVL NVLink bridge 600 GB/s, PCIe Gen5
#: 128 GB/s.  NVLink joins the 8 cards of one HGX board; a mesh beyond them
#: crosses the network, slower than this.
_KNOWN_LINKS = (
    ("H100 NVL", 300e9),
    ("H100 PCIe", 64e9),
    ("H100 80GB HBM3", 450e9),
)

_peak_cache: dict = {}


def _calibrate_cpu_peak(d: int = 1024, copy_mb: int = 32, repeats: int = 3):
    """Measure an achievable matmul FLOP/s + copy-bandwidth on this host.

    CPU 'peak' is meaningless from spec sheets under pytest-grade noise;
    a short calibration gives a *reachable* ceiling so CPU utilization
    numbers are comparable across runs on the same host.  FLOP/s comes
    from a BLAS matmul (best-of-N); bytes/s from a large memcpy (read +
    write counted) — the two ceilings are measured independently because
    a compute-bound matmul says nothing about memory bandwidth.
    """
    import numpy as np

    a = np.random.default_rng(0).standard_normal((d, d), dtype=np.float32)
    b = np.random.default_rng(1).standard_normal((d, d), dtype=np.float32)
    a @ b  # warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        a @ b
        best = min(best, time.perf_counter() - t0)
    flops = 2.0 * d ** 3 / best

    src = np.zeros(copy_mb * (1 << 20) // 4, dtype=np.float32)
    dst = np.empty_like(src)
    np.copyto(dst, src)  # warm
    best_cp = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best_cp = min(best_cp, time.perf_counter() - t0)
    membw = 2.0 * src.nbytes / best_cp
    return flops, membw


def _calibrate_cuda_peak(device, d: int = 8192, copy_mb: int = 1024,
                         repeats: int = 5):
    """An achievable bf16 matmul FLOP/s and copy bandwidth measured on the
    card itself (CUDA events, best of ``repeats``), for a card the table
    does not know.  The copy is larger than any L2 cache and counts its
    read and its write."""
    import torch

    def best_ms(fn):
        fn()  # warm
        times = []
        for _ in range(repeats):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times)

    with torch.cuda.device(device):
        a = torch.randn((d, d), device=device, dtype=torch.bfloat16)
        b = torch.randn((d, d), device=device, dtype=torch.bfloat16)
        flops = 2.0 * d ** 3 / (best_ms(lambda: a @ b) * 1e-3)
        del a, b
        src = torch.empty(copy_mb << 20, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        membw = 2.0 * src.numel() / (best_ms(lambda: dst.copy_(src)) * 1e-3)
    return flops, membw


def published_peak(kind: str) -> dict:
    """The published rates of a card the tables know, by (a substring of)
    its name: ``{"flops_per_s", "bytes_per_s", "link_bytes_per_s",
    "kind", "source": "published"}``.  Needs no card (the dry run)."""
    for (key, flops, membw), (_, link) in zip(_KNOWN_PEAKS, _KNOWN_LINKS):
        if key in kind:
            return {"flops_per_s": flops, "bytes_per_s": membw,
                    "link_bytes_per_s": link, "kind": key,
                    "source": "published"}
    raise KeyError(f"no published rates for {kind!r}")


def device_peak(device=None) -> dict:
    """``{"flops_per_s", "bytes_per_s", "kind", "source"}`` for a device
    (a ``torch.device`` or its name; default the first card, else the CPU).

    A card the table knows gives its published rates (``source:
    "table"``); any other card is calibrated on itself and the CPU on the
    host, marked ``source: "calibrated"`` so readers know the ceiling is
    achievable-not-peak."""
    import torch

    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        for key, flops, membw in _KNOWN_PEAKS:
            if key in kind:
                return {"flops_per_s": flops, "bytes_per_s": membw,
                        "kind": kind, "source": "table"}
        if kind not in _peak_cache:
            _peak_cache[kind] = _calibrate_cuda_peak(device)
    else:
        kind = device.type
        if kind not in _peak_cache:
            _peak_cache[kind] = _calibrate_cpu_peak()
    flops, membw = _peak_cache[kind]
    return {"flops_per_s": flops, "bytes_per_s": membw,
            "kind": kind, "source": "calibrated"}


def roofline_utilization(tok_per_s: float, cost, peak: Optional[dict] = None
                         ) -> dict:
    """Achieved-vs-roofline for one (throughput, OpCost) pair.

    ``cost`` is an ``obs.costs.OpCost`` (or any object with
    ``flops_per_token`` / ``bytes_per_token``).  Utilization is measured
    against whichever resource the cost model says binds (the roofline
    ridge): ``bound`` is "compute" when the arithmetic intensity
    exceeds the device's ridge intensity, else "memory".
    """
    if peak is None:
        peak = device_peak()
    achieved_flops = tok_per_s * cost.flops_per_token
    achieved_bytes = tok_per_s * cost.bytes_per_token
    compute_util = achieved_flops / peak["flops_per_s"]
    memory_util = achieved_bytes / peak["bytes_per_s"]
    intensity = cost.flops_per_token / max(cost.bytes_per_token, 1e-9)
    ridge = peak["flops_per_s"] / peak["bytes_per_s"]
    bound = "compute" if intensity >= ridge else "memory"
    return {
        "tok_per_s": tok_per_s,
        "flops_per_token": cost.flops_per_token,
        "bytes_per_token": cost.bytes_per_token,
        "achieved_flops_per_s": achieved_flops,
        "achieved_bytes_per_s": achieved_bytes,
        "compute_util": compute_util,
        "memory_util": memory_util,
        "utilization": compute_util if bound == "compute" else memory_util,
        "bound": bound,
        "peak": dict(peak),
    }


@contextlib.contextmanager
def profile_capture(profile_dir, obs=None):
    """``torch.profiler`` trace of the wrapped region into
    ``profile_dir/trace.json`` (Chrome trace format), or a no-op if
    ``profile_dir`` is falsy.  Yields the profiler (None when off), so a
    caller can read ``key_averages()`` after the region.

    Emits ``profile.start`` / ``profile.stop`` events on ``obs`` whose
    ``wall_ns`` is the moment on the tracer's clock
    (``perf_counter_ns() + Tracer.epoch_offset_ns``, the profiler's time
    base), so the captured timeline lines up with the obs span stream.
    """
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    if obs is not None:
        obs.event("profile.start", profile_dir=str(profile_dir),
                  wall_ns=time.perf_counter_ns() + obs.tracer.epoch_offset_ns)
    try:
        yield prof
    finally:
        if obs is not None:
            obs.event("profile.stop", profile_dir=str(profile_dir),
                      wall_ns=time.perf_counter_ns()
                      + obs.tracer.epoch_offset_ns)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(str(profile_dir),
                                              "trace.json"))


# --------------------------------------------------------------------------
# env fingerprint + bench history
# --------------------------------------------------------------------------


def _power_limit_w() -> Optional[float]:
    """The first card's power limit in watts from ``nvidia-smi``, or None
    where there is no card or no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0:
            return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return None


def env_fingerprint() -> dict:
    """Where a bench number came from: git sha, torch and CUDA versions,
    backend, device count and kind, the card's power limit.  Keeps the
    reference's required keys (``jax_version`` is "unavailable": the port
    runs no JAX).  Every field degrades to a sentinel rather than raising
    — history must be writable from bare CI runners."""
    fp = {"git_sha": "unknown", "jax_version": "unavailable",
          "backend": "none", "device_count": 0, "device_kind": "unknown",
          "torch_version": "unavailable", "cuda_version": "none",
          "power_limit_w": None}
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        if sha.returncode == 0:
            fp["git_sha"] = sha.stdout.strip()
    except Exception:
        pass
    try:
        import torch

        fp["torch_version"] = torch.__version__
        fp["cuda_version"] = torch.version.cuda or "none"
        if torch.cuda.is_available():
            fp["backend"] = "cuda"
            fp["device_count"] = torch.cuda.device_count()
            fp["device_kind"] = torch.cuda.get_device_name(0)
            fp["power_limit_w"] = _power_limit_w()
        else:
            fp["backend"] = "cpu"
            fp["device_count"] = 1
            fp["device_kind"] = "cpu"
    except Exception:
        pass
    return fp


class BenchHistory:
    """Append-only ``repro.obs.bench/v1`` writer for one bench run.

    One instance == one run: the ``run`` header (env fingerprint) is
    written lazily on the first ``bench_row``, so pointing ``--history``
    at a bench that produces no rows leaves the file untouched.
    """

    def __init__(self, path, env: Optional[dict] = None,
                 run_id: Optional[str] = None):
        self.path = str(path)
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self._env = env
        self._started = False
        self.rows_written = 0

    def _append(self, rec: dict):
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")

    def _start(self):
        if self._started:
            return
        self._started = True
        self._append({
            "kind": "run", "schema": BENCH_SCHEMA, "run_id": self.run_id,
            "ts": time.time(), "env": self._env or env_fingerprint(),
        })

    def bench_row(self, name: str, value: float, *, unit: str,
                  direction: str = "lower", dispersion: float = 0.0,
                  n: int = 1, **extra):
        """Append one metric row.  ``direction`` says which way is good
        ("higher" for tok/s, "lower" for latency); ``dispersion`` is the
        IQR (same unit as ``value``) from the adaptive timer."""
        if direction not in DIRECTIONS:
            raise ValueError(f"direction {direction!r} not in {DIRECTIONS}")
        self._start()
        rec = {
            "kind": "row", "run_id": self.run_id, "name": name,
            "value": float(value), "unit": unit, "direction": direction,
            "dispersion": float(dispersion), "n": int(n),
        }
        if extra:
            rec["extra"] = extra
        self._append(rec)
        self.rows_written += 1


def read_bench(path) -> list:
    """Parse a ``repro.obs.bench/v1`` file into a list of runs, oldest
    first: ``[{"run_id", "ts", "env", "rows": {name: row}}, ...]``.
    Raises ValueError on malformed records (perfcheck wants hard
    failures, not silent skips)."""
    runs = []
    by_id = {}
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON: {e}") from None
            err = validate_bench_record(rec)
            if err:
                raise ValueError(f"{path}:{i}: {err}")
            if rec["kind"] == "run":
                run = {"run_id": rec["run_id"], "ts": rec.get("ts"),
                       "env": rec.get("env", {}), "rows": {}}
                runs.append(run)
                by_id[rec["run_id"]] = run
            else:
                run = by_id.get(rec["run_id"])
                if run is None:
                    raise ValueError(
                        f"{path}:{i}: row for unknown run_id "
                        f"{rec['run_id']!r} (missing run header?)"
                    )
                run["rows"][rec["name"]] = rec
    return runs


def validate_bench_record(rec) -> Optional[str]:
    """One-record schema check; returns an error string or None.
    Stdlib-only — shared by ``read_bench`` and ``repro.obs.validate``."""
    if not isinstance(rec, dict):
        return "record is not an object"
    rec_kind = rec.get("kind")
    if rec_kind == "run":
        if rec.get("schema") != BENCH_SCHEMA:
            return f"run.schema != {BENCH_SCHEMA!r}: {rec.get('schema')!r}"
        if not isinstance(rec.get("run_id"), str) or not rec["run_id"]:
            return "run.run_id missing"
        env = rec.get("env")
        if not isinstance(env, dict):
            return "run.env missing"
        for key in ("git_sha", "jax_version", "backend", "device_count"):
            if key not in env:
                return f"run.env.{key} missing"
        return None
    if rec_kind == "row":
        for key, typ in (("run_id", str), ("name", str), ("unit", str),
                         ("value", (int, float)),
                         ("dispersion", (int, float)), ("n", int)):
            if not isinstance(rec.get(key), typ) or (
                typ is str and not rec[key]
            ):
                return f"row.{key} missing or mistyped"
            if typ == (int, float) and isinstance(rec[key], bool):
                return f"row.{key} missing or mistyped"
        if rec.get("direction") not in DIRECTIONS:
            return f"row.direction not in {DIRECTIONS}: " \
                   f"{rec.get('direction')!r}"
        return None
    return f"record.kind not in ('run', 'row'): {rec_kind!r}"
