"""Every name in ``BENCHMARK.json`` leads to its file, and the file keeps
to the benchmark's contract: names, units, the cells each metric lists,
and the cells' end-to-end metrics."""

import json
import re

import _paths  # noqa: F401
import pytest

from perfbench.bench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "perfbench/run.py"]
    assert all((spec.ROOT / p).is_dir() for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_resolve(cfg):
    path = spec.ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("perfbench/")
    c = json.loads(path.read_text())
    assert (spec.HERE / "reference" / f"{c['reference']}.py").is_file()
    assert NAME.match(cfg["name"]) and all(NAME.match(k)
                                           for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cells_resolve(cell):
    w, _, _, t = spec.cell(BENCH, cell)
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    limits = spec.limits(cell)
    assert limits and all(v["limit"] > 0 for v in limits.values())
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, cell, "per_layer")
    assert t["kind"] in ("train", "closed_loop")


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metrics_keep_to_the_contract(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert spec.reader(m["name"]).read  # metrics/<name>.py
        moved = spec.by_name(BENCH["end_to_end"], m["moves"], "metric")
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_names_are_unique_and_layers_consistent():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    # every roofline's moved metric has an mfu metric beside it
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       for o in BENCH["per_layer"])
