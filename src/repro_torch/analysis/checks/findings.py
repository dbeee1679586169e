"""Findings schema, per-line suppressions, and the baseline file.

Own copy of ``repro/analysis/checks/findings.py`` (the same schemas, so
either package's tools read the other's files).  One ``Finding`` per rule
violation.  Three mechanisms keep the linter
adoptable without weakening it:

* **Suppressions** — ``# noqa: RPR004`` (comma-separated codes) on the
  *flagged line* silences exactly those codes at exactly that site.  A
  bare ``# noqa`` (no codes) is deliberately NOT honored: every
  suppression names what it suppresses.
* **Annotations** — some rules accept a semantic annotation instead of a
  suppression (RPR004's ``# sync-point: <reason>``): the annotation both
  silences the finding and documents the invariant at the site.  Rules
  own their annotation grammar; this module only provides the line-level
  comment scanner.
* **Baseline** — a JSON file of finding fingerprints.  ``--baseline``
  findings are reported as ``baselined`` and do not fail the run; new
  findings do.  Fingerprints hash (rule, path, line *content*, the
  occurrence index of that content in the file) — renumbering lines by
  editing elsewhere in the file does not invalidate the baseline, while
  a new copy of the same bad pattern does fail.

The JSON export schema is ``repro.checks.findings/v1``:

    {"schema": "repro.checks.findings/v1",
     "findings": [{"rule": "RPR004", "path": "serving/engine.py",
                   "line": 478, "col": 36, "message": "...",
                   "snippet": "...", "baselined": false}, ...],
     "counts": {"RPR004": 1, ...}}
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Dict, Iterable, List, Optional

SCHEMA = "repro.checks.findings/v1"
BASELINE_SCHEMA = "repro.checks.baseline/v1"

_NOQA_RE = re.compile(r"#\s*noqa:\s*([A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``path`` is the path as reported (relative to the scan root);
    ``line``/``col`` are 1-based/0-based per the ast convention.
    ``baselined`` is stamped by the runner, never by rules.
    """

    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""
    baselined: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = " (baselined)" if self.baselined else ""
        return f"{self.path}:{self.line}:{self.col}: " \
               f"{self.rule} {self.message}{tag}"


def suppressed_codes(line_text: str) -> List[str]:
    """Codes named by a ``# noqa: RPR0xx[, ...]`` comment on this line."""
    m = _NOQA_RE.search(line_text)
    if not m:
        return []
    return [c.strip() for c in m.group(1).split(",")]


def line_annotation(line_text: str, key: str) -> Optional[str]:
    """Value of a ``# <key>: <reason>`` comment on this line (stripped),
    or None.  An empty reason returns None — annotations must say why."""
    m = re.search(rf"#\s*{re.escape(key)}:\s*(\S.*)", line_text)
    if not m:
        return None
    reason = m.group(1).strip()
    return reason or None


def fingerprint(finding: Finding, file_lines: List[str]) -> str:
    """Stable identity for baselining: rule + path + the flagged line's
    stripped content + which occurrence of that content this is."""
    idx = finding.line - 1
    content = file_lines[idx].strip() if 0 <= idx < len(file_lines) else ""
    occurrence = sum(
        1 for i in range(min(idx, len(file_lines)))
        if file_lines[i].strip() == content
    )
    h = hashlib.sha256(
        f"{finding.rule}\x00{finding.path}\x00{content}\x00{occurrence}"
        .encode()
    )
    return h.hexdigest()[:16]


class Baseline:
    """Set of accepted finding fingerprints, persisted as JSON."""

    def __init__(self, fingerprints: Iterable[str] = ()):
        self.fingerprints = set(fingerprints)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path) as f:
            data = json.load(f)
        if data.get("schema") != BASELINE_SCHEMA:
            raise ValueError(
                f"{path}: unknown baseline schema {data.get('schema')!r}"
            )
        return cls(data.get("fingerprints", []))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"schema": BASELINE_SCHEMA,
                 "fingerprints": sorted(self.fingerprints)},
                f, indent=2,
            )
            f.write("\n")

    def __contains__(self, fp: str) -> bool:
        return fp in self.fingerprints


def to_json(findings: List[Finding]) -> dict:
    counts: Dict[str, int] = {}
    for f in findings:
        if not f.baselined:
            counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "schema": SCHEMA,
        "findings": [f.to_dict() for f in findings],
        "counts": dict(sorted(counts.items())),
    }
