"""Puts the checkout's root and ``src`` on ``sys.path`` for the benchmark's
tests (pytest imports them from their own folder)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
