"""Perf observability, the part the serving path needs: profiler capture
and the bench-history reader.

Own copy of part of ``repro/obs/perf.py``:

* **Profiler capture** — ``profile_capture(profile_dir, obs=...)`` wraps a
  region in a ``torch.profiler`` window (CPU activity, and CUDA activity
  when a card is present) and writes one Chrome trace into
  ``profile_dir``; it mirrors the boundaries as ``profile.start`` /
  ``profile.stop`` events on the obs tracer, so the profiler timeline
  lines up against the ``repro.obs.events/v1`` spans (both carry
  wall-clock stamps).  The tracer's spans appear in that trace under their
  own names (``trace.Tracer`` forwards them to
  ``torch.profiler.record_function``).  No-op when ``profile_dir`` is
  falsy.  Exposed as ``--profile-dir`` on ``launch/serve.py``.

* **Bench history reader** — ``read_bench`` / ``validate_bench_record``
  parse the append-only ``repro.obs.bench/v1`` JSONL (``run`` headers
  with an env fingerprint, ``row`` records per metric) for
  ``obs.validate --bench``.  The writer (``BenchHistory``), the roofline
  (``device_peak``, ``roofline_utilization``) and ``env_fingerprint`` are
  not ported yet.

Import-purity contract: importing this module must NOT import torch —
``validate`` runs in bare-stdlib contexts.  All torch use is inside
functions.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

BENCH_SCHEMA = "repro.obs.bench/v1"

#: direction of goodness for a bench row
DIRECTIONS = ("higher", "lower")


@contextlib.contextmanager
def profile_capture(profile_dir, obs=None):
    """``torch.profiler`` trace of the wrapped region into
    ``profile_dir/trace.json`` (Chrome trace format), or a no-op if
    ``profile_dir`` is falsy.  Yields the profiler (None when off), so a
    caller can read ``key_averages()`` after the region.

    Emits ``profile.start`` / ``profile.stop`` events (with wall-clock
    ``wall_ns`` payloads) on ``obs`` so the captured timeline can be
    correlated with the obs span stream.
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
                  wall_ns=time.time_ns())
    try:
        yield prof
    finally:
        if obs is not None:
            obs.event("profile.stop", profile_dir=str(profile_dir),
                      wall_ns=time.time_ns())
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(str(profile_dir),
                                              "trace.json"))


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
