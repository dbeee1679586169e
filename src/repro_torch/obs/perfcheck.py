"""Noise-aware bench regression gate over ``repro.obs.bench/v1`` history.

Own copy of ``repro/obs/perfcheck.py``.

``python -m repro_torch.obs.perfcheck OLD NEW [--tol 0.25] [--noise-mult 3.0]``
compares the *latest run* in each history file row-by-row and exits
nonzero iff any shared row regressed significantly.

Significance: a row regresses iff it moved in the bad
direction (per the row's recorded ``direction``) by more than

    max(tol * old.value,
        min(noise_mult * (old.dispersion + new.dispersion),
            max_rel * old.value))

i.e. the change must clear BOTH a relative tolerance and a multiple of
the two runs' combined IQRs — a wide-IQR noisy row needs a bigger move
to fail than a tight one, which is what makes the gate usable on shared
CI runners.  The noise allowance is CAPPED at ``max_rel`` (default
0.75) of the old value: an IQR comparable to the median means the
measurement is junk, but a 2x shift of the median is still a
regression — without the cap, the noisiest benches could never fail.
Rows present in only one file are reported but never fail the gate
(benches come and go across PRs).

Pure stdlib (imports only ``obs.perf``, itself stdlib at import): runs
anywhere, including bare CI python with no torch.  Either package's history
files compare (same schema).
"""

from __future__ import annotations

import argparse
import json
import sys

from .perf import read_bench


def compare_rows(old_row: dict, new_row: dict, *, tol: float,
                 noise_mult: float, max_rel: float = 0.75) -> dict:
    """Compare one row across runs; see module docstring for the rule."""
    old_v, new_v = old_row["value"], new_row["value"]
    direction = new_row.get("direction", old_row.get("direction", "lower"))
    delta = new_v - old_v
    bad = delta < 0 if direction == "higher" else delta > 0
    noise = noise_mult * (old_row.get("dispersion", 0.0)
                          + new_row.get("dispersion", 0.0))
    threshold = max(tol * abs(old_v), min(noise, max_rel * abs(old_v)))
    regressed = bad and abs(delta) > threshold
    return {
        "name": new_row["name"], "old": old_v, "new": new_v,
        "unit": new_row.get("unit", ""), "direction": direction,
        "delta": delta,
        "ratio": (new_v / old_v) if old_v else float("inf"),
        "threshold": threshold, "regressed": regressed,
        "improved": (not bad) and abs(delta) > threshold,
    }


def compare_runs(old_run: dict, new_run: dict, *, tol: float = 0.25,
                 noise_mult: float = 3.0, max_rel: float = 0.75) -> dict:
    """Row-by-row comparison of two parsed runs (``perf.read_bench``
    elements)."""
    old_rows, new_rows = old_run["rows"], new_run["rows"]
    shared = [n for n in new_rows if n in old_rows]
    results = [
        compare_rows(old_rows[n], new_rows[n],
                     tol=tol, noise_mult=noise_mult, max_rel=max_rel)
        for n in shared
    ]
    return {
        "compared": results,
        "regressions": [r for r in results if r["regressed"]],
        "improvements": [r for r in results if r["improved"]],
        "only_old": sorted(set(old_rows) - set(new_rows)),
        "only_new": sorted(set(new_rows) - set(old_rows)),
        "old_env": old_run.get("env", {}), "new_env": new_run.get("env", {}),
    }


def _latest_run(path: str) -> dict:
    runs = read_bench(path)
    if not runs:
        raise ValueError(f"{path}: no runs")
    return runs[-1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.perfcheck",
        description="Compare the latest runs of two repro.obs.bench/v1 "
                    "history files; exit 1 on significant regressions.",
    )
    p.add_argument("old", help="baseline history file (JSONL)")
    p.add_argument("new", help="candidate history file (JSONL)")
    p.add_argument("--tol", type=float, default=0.25,
                   help="relative tolerance (default 0.25 = 25%%)")
    p.add_argument("--noise-mult", type=float, default=3.0,
                   help="multiple of combined IQRs a change must also "
                        "clear (default 3.0)")
    p.add_argument("--max-rel", type=float, default=0.75,
                   help="cap on the noise allowance as a fraction of the "
                        "old value (default 0.75) — keeps very noisy "
                        "rows fail-able")
    p.add_argument("--json", action="store_true",
                   help="emit the full comparison as JSON on stdout")
    args = p.parse_args(argv)

    try:
        old_run = _latest_run(args.old)
        new_run = _latest_run(args.new)
    except (OSError, ValueError) as e:
        print(f"perfcheck: {e}", file=sys.stderr)
        return 2

    cmp = compare_runs(old_run, new_run, tol=args.tol,
                       noise_mult=args.noise_mult, max_rel=args.max_rel)
    if args.json:
        print(json.dumps(cmp, indent=2, sort_keys=True))
    else:
        oe, ne = cmp["old_env"], cmp["new_env"]
        print(f"perfcheck: {args.old} ({oe.get('git_sha')}) -> "
              f"{args.new} ({ne.get('git_sha')}), "
              f"{len(cmp['compared'])} shared rows, "
              f"tol={args.tol} noise_mult={args.noise_mult}")
        if oe.get("backend") != ne.get("backend") or \
                oe.get("device_kind") != ne.get("device_kind"):
            print(f"perfcheck: WARNING: env mismatch "
                  f"({oe.get('backend')}/{oe.get('device_kind')} vs "
                  f"{ne.get('backend')}/{ne.get('device_kind')}) — "
                  f"numbers may not be comparable")
        for r in cmp["compared"]:
            tag = "REGRESSED" if r["regressed"] else (
                "improved" if r["improved"] else "ok")
            print(f"  {tag:9s} {r['name']}: {r['old']:.6g} -> "
                  f"{r['new']:.6g} {r['unit']} "
                  f"(x{r['ratio']:.3f}, {r['direction']}-is-better)")
        for name in cmp["only_new"]:
            print(f"  new       {name} (no baseline)")
        for name in cmp["only_old"]:
            print(f"  dropped   {name} (baseline only)")
    n_reg = len(cmp["regressions"])
    if n_reg:
        print(f"perfcheck: FAIL — {n_reg} significant regression(s)",
              file=sys.stderr)
        return 1
    print(f"perfcheck: OK — no significant regressions "
          f"({len(cmp['improvements'])} improvement(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
