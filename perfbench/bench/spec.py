"""``BENCHMARK.json`` and the files its names lead to."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

#: the benchmark's own folder and the checkout's root
HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load_benchmark(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench, workload):
    """``(workload entry, config entry, config dict, traffic dict)``."""
    w = by_name(bench["workloads"], workload, "workload")
    ce = by_name(bench["configs"], w["config"], "configuration")
    c = json.loads((ROOT / ce["file"]).read_text())
    t = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return w, ce, c, t


def metrics_of(bench, workload, section):
    """The ``section`` metrics (``end_to_end`` or ``per_layer``) this cell
    reports: those listing it, or listing no cells."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def limits(workload):
    """The cell's limits on the numbers its check compares."""
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric):
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    return load_module(HERE / "metrics" / f"{metric}.py",
                       "perfbench_metric_" + metric.replace(".", "_"))


def reference(c):
    """The configuration's plain reference, ``reference/<name>.py``."""
    return importlib.import_module(f"perfbench.reference.{c['reference']}")
