"""Collect modules, run rules, apply suppressions and the baseline.

Own copy of ``repro/analysis/checks/runner.py``.  The unit of work is a
``Module``: one parsed Python file plus the two paths the rules need —
``report_path`` (relative to the scan root, for humans and baselines) and
``pkg_path`` (relative to the ``repro_torch`` package root, for scoping).
On the real tree they differ (``repro_torch/serving/engine.py`` vs
``serving/engine.py``); on a test fixture tree whose root *is* the package
root they coincide, which is what lets every rule be exercised against
tiny synthetic trees.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, List, Optional, Sequence

from .findings import Baseline, Finding, fingerprint, suppressed_codes
from .rules import ALL_RULES, RULES_BY_CODE, Rule

#: the package whose root scopes the rules
PACKAGE = "repro_torch"


@dataclasses.dataclass
class Module:
    path: str          # absolute
    report_path: str   # relative to the scan root (or as given)
    pkg_path: str      # relative to the repro_torch package root
    text: str
    lines: List[str]
    tree: ast.AST


def _pkg_path(report_path: str) -> str:
    """Path relative to the ``repro_torch`` package root.

    If a ``repro_torch`` component appears in the path, everything after
    its last occurrence; otherwise the report path itself (fixture trees
    are their own package root).
    """
    parts = report_path.replace(os.sep, "/").split("/")
    if PACKAGE in parts:
        idx = len(parts) - 1 - parts[::-1].index(PACKAGE)
        tail = parts[idx + 1:]
        if tail:
            return "/".join(tail)
    return "/".join(parts)


def collect_modules(paths: Sequence[str]) -> List[Module]:
    """Parse every ``.py`` under ``paths`` (files or directories).  A
    directory's files are reported relative to it, or, for the package
    directory itself (``src/repro_torch``), relative to its parent, so the
    package's name stays in the path and ``pkg_path`` finds its root.

    A file that does not parse yields a Module with ``tree=None``; the
    runner turns that into an RPR000 finding rather than crashing.
    """
    files: List[tuple] = []  # (abspath, report_path)
    for root in paths:
        root = os.path.normpath(root)
        if os.path.isfile(root):
            files.append((os.path.abspath(root), root))
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in ("__pycache__", ".git")
            )
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(
                    full, os.path.dirname(root)
                    if os.path.basename(root) == PACKAGE else root)
                files.append((os.path.abspath(full), rel))
    mods: List[Module] = []
    for full, rel in files:
        with open(full, encoding="utf-8") as f:
            text = f.read()
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError:
            tree = None
        mods.append(Module(
            path=full,
            report_path=rel.replace(os.sep, "/"),
            pkg_path=_pkg_path(rel),
            text=text,
            lines=text.splitlines(),
            tree=tree,
        ))
    return mods


def select_rules(codes: Optional[Iterable[str]] = None) -> List[Rule]:
    if codes is None:
        return list(ALL_RULES)
    out = []
    for code in codes:
        if code not in RULES_BY_CODE:
            raise KeyError(
                f"unknown rule {code!r}; known: {sorted(RULES_BY_CODE)}"
            )
        out.append(RULES_BY_CODE[code])
    return out


def run_checks(
    paths: Sequence[str],
    *,
    rules: Optional[Iterable[str]] = None,
    baseline: Optional[Baseline] = None,
) -> List[Finding]:
    """Run the rule set; return ALL findings (suppressed ones removed,
    baselined ones kept but stamped ``baselined=True``).

    The exit-status question — "any NEW findings?" — is then just
    ``any(not f.baselined for f in findings)``.
    """
    mods = collect_modules(paths)
    active = select_rules(rules)
    raw: List[Finding] = []
    for mod in mods:
        if mod.tree is None:
            err = "file does not parse — rules skipped"
            raw.append(Finding(rule="RPR000", path=mod.report_path,
                               line=1, col=0, message=err))
            continue
        for rule in active:
            raw.extend(rule.check_module(mod))
    parsed = [m for m in mods if m.tree is not None]
    for rule in active:
        raw.extend(rule.check_tree(parsed))

    lines_by_path = {m.report_path: m.lines for m in mods}
    out: List[Finding] = []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.rule)):
        file_lines = lines_by_path.get(f.path, [])
        if 1 <= f.line <= len(file_lines) and \
                f.rule in suppressed_codes(file_lines[f.line - 1]):
            continue
        if baseline is not None and fingerprint(f, file_lines) in baseline:
            f = dataclasses.replace(f, baselined=True)
        out.append(f)
    return out


def make_baseline(paths: Sequence[str],
                  rules: Optional[Iterable[str]] = None) -> Baseline:
    """Fingerprint every current (unsuppressed) finding."""
    mods = collect_modules(paths)
    lines_by_path = {m.report_path: m.lines for m in mods}
    findings = run_checks(paths, rules=rules)
    return Baseline(
        fingerprint(f, lines_by_path.get(f.path, [])) for f in findings
    )
