"""The four readers of the engine's child spans: their values on a
synthetic traced run, ``None`` where the spans are absent (a program
without them), and all four in the result line of a small traced run of a
serve cell on the CPU."""

from types import SimpleNamespace

import _paths  # noqa: F401
import numpy as np
import pytest

from perfbench.bench import cell, spec
from perfbench.bench.trace import Trace

BENCH = spec.load_benchmark()
NEW = ("engine.decode_dispatch_ms", "engine.block_sync_ms",
       "engine.prefill_dispatch_ms_per_ktok", "engine.queue_wait_p95_ms")
MS = 1_000_000  # nanoseconds


def _run(spans, admissions=(1000, 3000)):
    """A traced run view over host spans ``(name, start_ns, end_ns)`` and
    no device operation."""
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: [])))
    tr = Trace(prof, (0, 1000 * MS), spans)
    out = {"window_s": 1.0, "work": {"admissions": list(admissions)}}
    return cell.RunView("hla1b.serve.chat", {}, {}, out, tr)


def _parent_spans():
    """What a program without the child spans records."""
    return [("engine.prefill", 0, 10 * MS), ("engine.prefill", 20 * MS,
                                             30 * MS),
            ("engine.decode_block", 40 * MS, 140 * MS),
            ("perfbench.clients", 150 * MS, 151 * MS)]


def _child_spans():
    waits = [("engine.queue_wait", 0, k * MS) for k in range(1, 21)]
    return _parent_spans() + waits + [
        ("engine.prefill_dispatch", 0, 3 * MS),
        ("engine.prefill_sync", 3 * MS, 10 * MS),
        ("engine.prefill_dispatch", 20 * MS, 25 * MS),
        ("engine.prefill_sync", 25 * MS, 30 * MS),
        ("engine.decode_step", 40 * MS, 80 * MS),
        ("engine.decode_step", 80 * MS, 124 * MS),
        ("engine.block_sync", 124 * MS, 140 * MS)]


def _read(name, run):
    return spec.reader(name).read(run)


def test_readers_on_synthetic_spans():
    run = _run(_child_spans())
    assert _read("engine.decode_dispatch_ms", run) == pytest.approx(42.0)
    assert _read("engine.block_sync_ms", run) == pytest.approx(16.0)
    # 8 ms of dispatch over 4,000 prompt tokens
    assert _read("engine.prefill_dispatch_ms_per_ktok", run) == \
        pytest.approx(2.0)
    assert _read("engine.queue_wait_p95_ms", run) == pytest.approx(
        float(np.percentile(np.arange(1, 21), 95)))


@pytest.mark.parametrize("name", NEW)
def test_readers_return_none_without_the_spans(name):
    assert _read(name, _run(_parent_spans())) is None
    assert _read(name, _run([])) is None
    bare = _run(_child_spans())
    bare.trace = None
    assert _read(name, bare) is None


def test_readers_skip_a_window_without_admissions():
    run = _run(_child_spans(), admissions=())
    assert _read("engine.prefill_dispatch_ms_per_ktok", run) is None
    assert _read("engine.queue_wait_p95_ms", run) is not None


@pytest.mark.parametrize("name", NEW)
def test_entries_name_the_serve_cells(name):
    m = spec.by_name(BENCH["per_layer"], name, "metric")
    assert m["source"] == "program_span"
    assert m["workloads"] == ["hla1b.serve.chat", "hla1b.serve.longdoc"]


def test_traced_serve_run_reports_the_four():
    """A small chat cell, traced on the CPU: the engine's child spans reach
    the readers through the harness as it stands."""
    import test_perfbench_faults as faults

    c, t = faults.small("hla1b.serve.chat")
    result, _ = cell.run_cell(BENCH, "hla1b.serve.chat", faults.SEED, 0.3,
                              True, "cpu", c=c, t=t)
    got = result["metrics"]
    assert all(got[n]["value"] > 0 for n in NEW), got
    # a block's steps and its sync tile it: per step they make its time
    per_step = got["engine.decode_dispatch_ms"]["value"] \
        + got["engine.block_sync_ms"]["value"] / t["block"]
    assert per_step <= got["engine.decode_step_ms"]["value"] * 1.05
