"""CLI: ``python -m repro_torch.analysis.checks [src/repro_torch] [options]``.

Exit status is the contract CI keys on: 0 when every finding is
baselined (or there are none), 1 when any NEW finding exists, 2 on
usage errors.  ``--write-baseline`` accepts the current state so the
linter can land on an imperfect tree without weakening the rules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .findings import Baseline, to_json
from .runner import make_baseline, run_checks, select_rules
from .rules import ALL_RULES

#: the package this linter ships in (``src/repro_torch``), as a path
#: relative to the working directory
DEFAULT_PATH = os.path.relpath(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.checks",
        description="Rule-based invariant linter (RPR rules) for the "
                    "repro_torch tree.",
    )
    p.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                   help="files or directories to lint "
                        "(default: this package, src/repro_torch)")
    p.add_argument("--format", choices=("console", "json"),
                   default="console", dest="fmt")
    p.add_argument("--baseline", metavar="FILE",
                   help="baseline JSON; matching findings do not fail "
                        "the run")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="fingerprint all current findings into FILE and "
                        "exit 0")
    p.add_argument("--rules", metavar="RPR001,RPR004",
                   help="comma-separated subset of rules to run")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.code}  {rule.name}")
            print(f"        {rule.description}")
        return 0

    codes = None
    if args.rules:
        codes = [c.strip() for c in args.rules.split(",") if c.strip()]
        try:
            select_rules(codes)
        except KeyError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2

    paths = args.paths or [DEFAULT_PATH]

    if args.write_baseline:
        bl = make_baseline(paths, rules=codes)
        bl.save(args.write_baseline)
        print(f"wrote {len(bl.fingerprints)} fingerprint(s) to "
              f"{args.write_baseline}")
        return 0

    baseline = None
    if args.baseline:
        try:
            baseline = Baseline.load(args.baseline)
        except (OSError, ValueError) as e:
            print(f"error: cannot load baseline: {e}", file=sys.stderr)
            return 2

    findings = run_checks(paths, rules=codes, baseline=baseline)
    new = [f for f in findings if not f.baselined]

    if args.fmt == "json":
        print(json.dumps(to_json(findings), indent=2))
    else:
        for f in findings:
            print(f.render())
        checked = ", ".join(paths)
        if new:
            print(f"\n{len(new)} new finding(s) "
                  f"({len(findings) - len(new)} baselined) in {checked}")
        else:
            print(f"clean: 0 new findings "
                  f"({len(findings)} baselined) in {checked}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
