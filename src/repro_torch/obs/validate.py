"""Schema validator for obs artifacts — the CI metrics-smoke gate.

    python -m repro.obs.validate --metrics M.json --events E.jsonl \
        --bench history.jsonl \
        --expect-counter serving_quarantined_total=1 \
        --expect-terminal-statuses ok,error \
        --expect-requests 3

Checks (exit non-zero with a message naming the first violation):

* the metrics JSON is a well-formed ``repro.obs.metrics/v1`` snapshot
  (kinds, series shapes, histogram bucket-count lengths);
* the events JSONL is a well-formed ``repro.obs.events/v1`` log (header
  line, per-record required fields);
* ``--bench PATH`` — the file is a well-formed ``repro.obs.bench/v1``
  history (run headers with env fingerprints, typed rows attached to a
  known run; see ``repro.obs.perf``);
* ``--expect-counter NAME=V`` — the counter's total (summed over label
  series) equals ``V``;
* ``--expect-counter-min NAME=V`` — the counter's total is at least
  ``V`` (for inherently trace-dependent tallies like cache hits, where
  the exact count is policy but "it happened" is the contract);
* ``--expect-requests N`` — at least N distinct rids have a terminal
  ``request.done`` event, every terminal status is one of the four
  legal ones, and every rid with ANY lifecycle event also has a
  terminal event (no request ever vanishes from the log);
* ``--expect-terminal-statuses a,b`` — the SET of statuses present
  equals exactly this set.

Own copy of ``repro/obs/validate.py``, run as ``python -m
repro_torch.obs.validate``.  Pure stdlib: runs anywhere the artifacts can
be copied, no torch import.
"""

from __future__ import annotations

import argparse
import json
import sys

from .perf import read_bench
from .sinks import read_jsonl
from .timeline import TERMINAL_STATUSES, request_timelines, terminal_events

_KINDS = ("counter", "gauge", "histogram")


def validate_metrics(snapshot: dict) -> None:
    if snapshot.get("schema") != "repro.obs.metrics/v1":
        raise ValueError(
            f"metrics schema is {snapshot.get('schema')!r}, expected "
            "repro.obs.metrics/v1"
        )
    for name, entry in snapshot.get("metrics", {}).items():
        if entry.get("kind") not in _KINDS:
            raise ValueError(f"metric {name}: bad kind {entry.get('kind')!r}")
        series = entry.get("series")
        if not isinstance(series, list):
            raise ValueError(f"metric {name}: series must be a list")
        for s in series:
            if not isinstance(s.get("labels"), dict):
                raise ValueError(f"metric {name}: series without labels dict")
            if entry["kind"] == "histogram":
                edges = entry.get("buckets")
                if not isinstance(edges, list) or not edges:
                    raise ValueError(f"metric {name}: histogram needs buckets")
                if len(s.get("bucket_counts", [])) != len(edges) + 1:
                    raise ValueError(
                        f"metric {name}: bucket_counts length "
                        f"{len(s.get('bucket_counts', []))} != "
                        f"len(buckets)+1 = {len(edges) + 1}"
                    )
                if s.get("count") != sum(s["bucket_counts"]):
                    raise ValueError(
                        f"metric {name}: count {s.get('count')} != sum of "
                        f"bucket_counts {sum(s['bucket_counts'])}"
                    )
            elif not isinstance(s.get("value"), (int, float)):
                raise ValueError(f"metric {name}: series without value")


def validate_events(events) -> None:
    for e in events:
        for field in ("kind", "name", "ts", "seq"):
            if field not in e:
                raise ValueError(f"event missing {field!r}: {e}")
        if e["kind"] not in ("span", "event"):
            raise ValueError(f"bad event kind {e['kind']!r}: {e}")
        if e["kind"] == "span" and "dur_s" not in e:
            raise ValueError(f"span without dur_s: {e}")


def counter_total(snapshot: dict, name: str) -> float:
    entry = snapshot["metrics"].get(name)
    if entry is None:
        raise ValueError(f"counter {name!r} not in snapshot")
    if entry["kind"] != "counter":
        raise ValueError(f"{name!r} is a {entry['kind']}, not a counter")
    return sum(s["value"] for s in entry["series"])


def check_requests(events, min_requests: int) -> None:
    done = terminal_events(events)
    if len(done) < min_requests:
        raise ValueError(
            f"{len(done)} requests with terminal events, expected >= "
            f"{min_requests} (rids: {sorted(done)})"
        )
    for rid, e in done.items():
        if e.get("status") not in TERMINAL_STATUSES:
            raise ValueError(
                f"request {rid}: terminal status {e.get('status')!r} not in "
                f"{TERMINAL_STATUSES}"
            )
    for rid in request_timelines(events):
        if rid not in done:
            raise ValueError(
                f"request {rid} has lifecycle events but no request.done — "
                "a request vanished from the log"
            )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--metrics", default=None,
                    help="registry snapshot JSON (--metrics-out artifact)")
    ap.add_argument("--events", default=None,
                    help="JSONL event log (--events-out artifact)")
    ap.add_argument("--bench", default=None,
                    help="repro.obs.bench/v1 history JSONL "
                         "(benchmarks/run.py --history artifact)")
    ap.add_argument("--expect-counter", action="append", default=[],
                    metavar="NAME=VALUE")
    ap.add_argument("--expect-counter-min", action="append", default=[],
                    metavar="NAME=VALUE")
    ap.add_argument("--expect-requests", type=int, default=None)
    ap.add_argument("--expect-terminal-statuses", default=None,
                    metavar="S1,S2,...")
    args = ap.parse_args(argv)
    if not args.metrics and not args.events and not args.bench:
        ap.error("nothing to validate: pass --metrics, --events and/or "
                 "--bench")
    try:
        snapshot = None
        if args.metrics:
            with open(args.metrics) as f:
                snapshot = json.load(f)
            validate_metrics(snapshot)
            print(f"[obs.validate] {args.metrics}: "
                  f"{len(snapshot['metrics'])} metrics ok")
        events = None
        if args.events:
            events = read_jsonl(args.events)
            validate_events(events)
            print(f"[obs.validate] {args.events}: {len(events)} events ok")
        if args.bench:
            runs = read_bench(args.bench)  # raises on schema violations
            if not runs:
                raise ValueError(f"{args.bench}: no bench runs")
            nrows = sum(len(r["rows"]) for r in runs)
            print(f"[obs.validate] {args.bench}: {len(runs)} run(s), "
                  f"{nrows} rows ok")
        for spec in args.expect_counter:
            if snapshot is None:
                raise ValueError("--expect-counter needs --metrics")
            name, want = spec.split("=", 1)
            got = counter_total(snapshot, name)
            if got != float(want):
                raise ValueError(
                    f"counter {name} total = {got}, expected {want}"
                )
            print(f"[obs.validate] counter {name} == {want} ok")
        for spec in args.expect_counter_min:
            if snapshot is None:
                raise ValueError("--expect-counter-min needs --metrics")
            name, want = spec.split("=", 1)
            got = counter_total(snapshot, name)
            if got < float(want):
                raise ValueError(
                    f"counter {name} total = {got}, expected >= {want}"
                )
            print(f"[obs.validate] counter {name} >= {want} ok "
                  f"(got {got})")
        if args.expect_requests is not None:
            if events is None:
                raise ValueError("--expect-requests needs --events")
            check_requests(events, args.expect_requests)
            print(f"[obs.validate] >= {args.expect_requests} requests with "
                  "terminal events ok")
        if args.expect_terminal_statuses is not None:
            if events is None:
                raise ValueError("--expect-terminal-statuses needs --events")
            want = set(args.expect_terminal_statuses.split(","))
            got = {e.get("status") for e in terminal_events(events).values()}
            if got != want:
                raise ValueError(
                    f"terminal statuses {sorted(got)} != expected "
                    f"{sorted(want)}"
                )
            print(f"[obs.validate] terminal statuses == {sorted(want)} ok")
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"[obs.validate] FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
