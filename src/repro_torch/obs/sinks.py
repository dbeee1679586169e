"""Pluggable sinks: JSONL event log, console summary, Prometheus text.

Sinks consume the two schemas the obs layer exports:

* ``repro.obs.events/v1`` — span/event records from ``trace.Tracer``
  (one JSON object per line via ``JsonlSink``);
* ``repro.obs.metrics/v1`` — ``Registry.snapshot()`` dicts
  (``write_metrics`` JSON dump, ``prometheus_text`` exposition,
  ``console_summary`` one-liners).

Own copy of ``repro/obs/sinks.py``.  Everything is host-side file/string
work — sinks never touch torch.
"""

from __future__ import annotations

import io
import json
from typing import Optional, TextIO

from .trace import _epoch_offset_ns


class JsonlSink:
    """Write-through JSONL event log.

    The first line is a header record carrying the schema id and the
    ``perf_counter`` -> epoch offset, so consumers can anchor the
    monotonic ``ts`` fields to wall-clock time::

        {"kind": "header", "schema": "repro.obs.events/v1",
         "epoch_offset": <seconds>, "epoch_offset_ns": <nanoseconds>}

    Pass the offset of the tracer that feeds the sink
    (``epoch_offset_ns=obs.tracer.epoch_offset_ns``) so the log and the
    profiler share one clock; without it the sink reads its own.

    ``emit`` is called on the tracer's hot path: one ``json.dumps`` and
    one buffered ``write`` per record, flushed on ``flush``/``close``
    (and optionally every ``flush_every`` records so tailing a live run
    works).
    """

    def __init__(self, path_or_file, flush_every: int = 64,
                 epoch_offset_ns: Optional[int] = None):
        if isinstance(path_or_file, (str, bytes)):
            self._f: TextIO = open(path_or_file, "w")
            self._owns = True
        else:
            self._f = path_or_file
            self._owns = False
        self.flush_every = flush_every
        self._n = 0
        if epoch_offset_ns is None:
            epoch_offset_ns = _epoch_offset_ns()
        self.emit({
            "kind": "header", "schema": "repro.obs.events/v1",
            "epoch_offset": epoch_offset_ns / 1e9,
            "epoch_offset_ns": epoch_offset_ns,
        })

    def emit(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, default=float) + "\n")
        self._n += 1
        if self.flush_every and self._n % self.flush_every == 0:
            self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str):
    """Load a JSONL event log, validating and dropping the header."""
    events = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if i == 0:
                if rec.get("schema") != "repro.obs.events/v1":
                    raise ValueError(
                        f"{path}: expected repro.obs.events/v1 header, "
                        f"got {rec!r}"
                    )
                continue
            events.append(rec)
    return events


# -- metrics snapshot sinks -------------------------------------------------


def write_metrics(snapshot: dict, path: str) -> None:
    """Dump a ``Registry.snapshot()`` as JSON (``--metrics-out``)."""
    with open(path, "w") as f:
        json.dump(snapshot, f, indent=1, default=float)
        f.write("\n")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def prometheus_text(snapshot: dict) -> str:
    """Prometheus text exposition (v0.0.4) of a metrics snapshot —
    written to a file for a node-exporter-style textfile collector; no
    HTTP server, no client library dependency."""
    if snapshot.get("schema") != "repro.obs.metrics/v1":
        raise ValueError(f"unknown schema {snapshot.get('schema')!r}")
    out = io.StringIO()
    for name, entry in snapshot["metrics"].items():
        kind = entry["kind"]
        if entry.get("help"):
            out.write(f"# HELP {name} {entry['help']}\n")
        out.write(f"# TYPE {name} {kind}\n")
        if kind in ("counter", "gauge"):
            for s in entry["series"]:
                out.write(f"{name}{_fmt_labels(s['labels'])} {s['value']}\n")
            continue
        edges = entry["buckets"]
        for s in entry["series"]:
            base = dict(s["labels"])
            cum = 0
            for edge, c in zip(edges, s["bucket_counts"]):
                cum += c
                lab = _fmt_labels({**base, "le": repr(float(edge))})
                out.write(f"{name}_bucket{lab} {cum}\n")
            lab = _fmt_labels({**base, "le": "+Inf"})
            out.write(f"{name}_bucket{lab} {s['count']}\n")
            out.write(f"{name}_sum{_fmt_labels(base)} {s['sum']}\n")
            out.write(f"{name}_count{_fmt_labels(base)} {s['count']}\n")
    return out.getvalue()


def write_prometheus(snapshot: dict, path: str) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(snapshot))


def console_summary(snapshot: dict, prefix: Optional[str] = None) -> str:
    """Human one-liners from a metrics snapshot: one line per metric,
    totals for counters, last value for gauges, count/mean for
    histograms.  ``prefix`` filters by metric-name prefix."""
    lines = []
    for name, entry in snapshot["metrics"].items():
        if prefix and not name.startswith(prefix):
            continue
        if entry["kind"] in ("counter", "gauge"):
            parts = [
                f"{_fmt_labels(s['labels']) or 'total'}={s['value']:g}"
                for s in entry["series"]
            ]
            if parts:
                lines.append(f"{name}: " + " ".join(parts))
            continue
        for s in entry["series"]:
            if not s["count"]:
                continue
            mean = s["sum"] / s["count"]
            lines.append(
                f"{name}{_fmt_labels(s['labels'])}: count={s['count']} "
                f"mean={mean:.4g} min={s['min']:.4g} max={s['max']:.4g}"
            )
    return "\n".join(lines)
