"""The port's invariant linter (``repro_torch/analysis/checks``): each RPR
rule catches its torch form in a fixture tree (the lines marked ``# !``
and no other), its annotation or ``noqa`` clears it, and ``src/repro_torch``
lints clean with no baseline file."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis.checks import collect_modules, run_checks
from repro_torch.analysis.checks.cli import main

ROOT = Path(__file__).resolve().parents[1]

FIXTURES = {
    "RPR001": {
        "serving/a.py": """
            def f():
                print("x")  # !
                print("y")  # noqa: RPR001
            """,
        "launch/cli.py": """
            print("a CLI may print")
            """,
    },
    "RPR002": {
        "models/a.py": """
            def f(variant, cfg):
                if variant == "hla2":  # !
                    return 1
                return cfg.kind == "x"
            """,
        "models/seq_op.py": """
            def f(variant):
                return variant == "hla2"
            """,
    },
    "RPR003": {
        "serving/engine.py": """
            class Engine:
                def run(self, requests):
                    while requests:
                        raise RuntimeError("boom")  # !
                    raise ValueError("outside the loop is fine")
            """,
    },
    "RPR004": {
        "serving/a.py": """
            import numpy as np
            import torch
            import torch.nn.functional as F


            def block(x, steps):
                y = torch.ones(3)
                a = y.item()  # !
                b = y.tolist()  # !
                c = y.cpu()  # !
                d = c.numpy()
                e = int(y.sum())  # !
                g = bool(torch.isfinite(y).all())  # !
                h = float(F.relu(x).max())  # !
                torch.cuda.synchronize()  # !
                k = y.cpu()  # sync-point: the block's one transfer
                # sync-point: the round's second transfer (replayed
                # health), named above the call
                m = y.cpu()
                n = y.item()  # noqa: RPR004
                p = int(len(steps)) + np.asarray([1]).tolist()[0]
                return a, b, d, e, g, h, k, m, n, p
            """,
        "kernels/b.py": """
            import torch


            def f(x):
                return torch.zeros(2).numpy()  # !
            """,
        "obs/c.py": """
            import torch


            def f():
                return torch.zeros(2).item()
            """,
    },
    "RPR005": {
        "kernels/a.py": """
            import random
            import time

            import numpy as np
            import torch
            from torch.utils.checkpoint import checkpoint


            class Op(torch.autograd.Function):
                @staticmethod
                def forward(ctx, x):
                    ctx.t = time.time()  # !
                    return x

                @staticmethod
                def backward(ctx, g):
                    return g * random.random()  # !


            def block(x):
                return x + np.random.rand()  # !


            def run(x):
                return checkpoint(block, x, use_reentrant=False)


            def op_plain(x):
                return x * time.perf_counter()  # !


            def host_timer():
                return time.perf_counter()
            """,
    },
    "RPR006": {
        "runtime/faults.py": """
            FAULT_POINTS = {
                "engine.prefill": "admission failure",
                "engine.dead": "never fired",  # !
            }
            """,
        "serving/scheduler.py": """
            def admit(plan):
                plan.raise_if("engine.prefill")
                plan.hit("engine.typo")  # !
            """,
    },
    "RPR007": {
        "serving/a.py": """
            def f(obs):
                obs.counter("serving_requests_total")
                obs.counter("serving_requests")  # !
                obs.histogram("serving_ttft_seconds")
                obs.histogram("serving_ttft")  # !
                obs.event("request.done")
                obs.event("RequestDone")  # !
                obs.bench_row("bench_decode/tok_s", 1.0, unit="tok/s")
                obs.bench_row("decode tok/s", 1.0, unit="tok/s")  # !
            """,
    },
}


def _tree(tmp_path, files):
    marked = set()
    for rel, src in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        text = textwrap.dedent(src).lstrip("\n")
        path.write_text(text)
        marked |= {(rel, i) for i, line in enumerate(text.splitlines(), 1)
                   if line.rstrip().endswith("# !")}
    return marked


@pytest.mark.parametrize("code", sorted(FIXTURES))
def test_rule_catches_its_torch_form(tmp_path, code):
    want = _tree(tmp_path, FIXTURES[code])
    found = run_checks([str(tmp_path)], rules=[code])
    assert {(f.path, f.line) for f in found} == want
    assert all(f.rule == code for f in found)
    # every other rule is quiet on the fixture
    others = [f for f in run_checks([str(tmp_path)]) if f.rule != code]
    assert others == []


def test_unparsable_file_is_reported(tmp_path):
    (tmp_path / "serving").mkdir()
    (tmp_path / "serving" / "a.py").write_text("def f(:\n")
    assert [f.rule for f in run_checks([str(tmp_path)])] == ["RPR000"]


def test_pkg_path_is_relative_to_the_port():
    mods = {m.report_path: m.pkg_path
            for m in collect_modules([str(ROOT / "src" / "repro_torch")])}
    assert mods["repro_torch/serving/engine.py"] == "serving/engine.py"
    assert mods["repro_torch/runtime/faults.py"] == "runtime/faults.py"


def test_port_lints_clean_without_a_baseline(capsys):
    assert not list((ROOT / "src" / "repro_torch").rglob("*baseline*"))
    assert run_checks([str(ROOT / "src" / "repro_torch")]) == []
    # the CLI's default path is the port, from the checkout's root
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.checks"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean: 0 new findings (0 baselined) in src/repro_torch" in \
        out.stdout
    assert main(["--list-rules"]) == 0
    assert "RPR005  recompute-purity" in capsys.readouterr().out
