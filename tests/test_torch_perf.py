"""The port's roofline, bench history and regression gate
(``repro_torch/obs/perf.py``, ``obs/perfcheck.py``) against the
reference's (``repro/obs/perf.py``, ``obs/perfcheck.py``).

* a history the port writes reads back through the reference's
  ``read_bench`` and its validator, and the reverse;
* ``device_peak``: the H100 rows by device name, an unknown card
  calibrated on itself, the CPU calibrated on the host;
* ``roofline_utilization`` picks the bound from the ridge;
* ``perfcheck`` passes identical runs and fails a planted 2x slowdown,
  with ``torch`` blocked from import.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.obs import perf as ref_perf
from repro.obs import perfcheck as ref_perfcheck
from repro_torch.obs import perf

ROOT = Path(__file__).resolve().parents[1]


def _write(history_cls, path, scale=1.0, env=None):
    h = history_cls(path, env=env)
    h.bench_row("bench_train_step/hla2/step", 0.8 * scale, unit="s",
                dispersion=0.01, n=5)
    h.bench_row("bench_decode/hla2/tok_s", 238.0 / scale, unit="tok/s",
                direction="higher", dispersion=2.0, n=5, slots=4)
    return h


def test_port_history_reads_in_reference(tmp_path):
    path = tmp_path / "h.jsonl"
    h = _write(perf.BenchHistory, path)
    for rec in map(json.loads, path.read_text().splitlines()):
        assert ref_perf.validate_bench_record(rec) is None
    runs = ref_perf.read_bench(path)
    assert len(runs) == 1 and runs[0]["run_id"] == h.run_id
    env = runs[0]["env"]
    assert env["jax_version"] == "unavailable"
    assert env["torch_version"] == torch.__version__
    assert {"git_sha", "backend", "device_count", "cuda_version",
            "device_kind", "power_limit_w"} <= set(env)
    rows = runs[0]["rows"]
    assert rows["bench_decode/hla2/tok_s"]["extra"] == {"slots": 4}
    assert h.rows_written == 2


def test_reference_history_reads_in_port(tmp_path):
    path = tmp_path / "h.jsonl"
    h = _write(ref_perf.BenchHistory, path)
    _write(ref_perf.BenchHistory, path, scale=2.0)
    runs = perf.read_bench(path)
    assert [r["run_id"] for r in runs][0] == h.run_id and len(runs) == 2
    assert runs == ref_perf.read_bench(path)


def test_no_rows_no_file(tmp_path):
    perf.BenchHistory(tmp_path / "h.jsonl")
    assert not (tmp_path / "h.jsonl").exists()
    with pytest.raises(ValueError, match="direction"):
        perf.BenchHistory(tmp_path / "h.jsonl").bench_row(
            "a/b", 1.0, unit="s", direction="sideways")


def test_env_fingerprint_never_raises_without_a_card():
    fp = perf.env_fingerprint()
    assert fp["jax_version"] == "unavailable"
    assert fp["backend"] in ("cpu", "cuda")
    if fp["backend"] == "cpu":
        assert fp["device_kind"] == "cpu" and fp["power_limit_w"] is None


@pytest.mark.parametrize("name, flops, membw", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756.5e12, 2.0e12),
    ("NVIDIA H100 NVL", 835.5e12, 3.9e12),
])
def test_device_peak_h100_rows(monkeypatch, name, flops, membw):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: name)
    peak = perf.device_peak("cuda:0")
    assert peak == {"flops_per_s": flops, "bytes_per_s": membw,
                    "kind": name, "source": "table"}


def test_device_peak_unknown_card_is_calibrated_on_it(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device: "NVIDIA Future GPU")
    monkeypatch.setattr(perf, "_peak_cache", {})
    monkeypatch.setattr(perf, "_calibrate_cuda_peak",
                        lambda device: seen.append(device) or (1e15, 4e12))
    peak = perf.device_peak(torch.device("cuda", 0))
    assert peak["source"] == "calibrated" and peak["flops_per_s"] == 1e15
    assert seen == [torch.device("cuda", 0)]
    perf.device_peak("cuda:0")
    assert len(seen) == 1  # cached per kind


def test_device_peak_cpu_is_calibrated():
    peak = perf.device_peak("cpu")
    assert peak["source"] == "calibrated" and peak["kind"] == "cpu"
    assert peak["flops_per_s"] > 0 and peak["bytes_per_s"] > 0


class _Cost:
    def __init__(self, flops, nbytes):
        self.flops_per_token, self.bytes_per_token = flops, nbytes


@pytest.mark.parametrize("flops, nbytes, bound", [
    (9.089e9, 1.4e7, "compute"),   # hla-1b train step: ~650 FLOP/B
    (3.8e9, 1.575e9, "memory"),    # hla-1b decode at 4 slots: ~2.4 FLOP/B
])
def test_roofline_bound_from_ridge(flops, nbytes, bound):
    peak = {"flops_per_s": 989e12, "bytes_per_s": 3.35e12, "kind": "x",
            "source": "table"}
    got = perf.roofline_utilization(1000.0, _Cost(flops, nbytes), peak)
    want = ref_perf.roofline_utilization(1000.0, _Cost(flops, nbytes), peak)
    assert got == want and got["bound"] == bound
    share = got["compute_util"] if bound == "compute" else got["memory_util"]
    assert got["utilization"] == share
    assert got["achieved_flops_per_s"] == 1000.0 * flops


def _perfcheck(*args):
    """``python -m repro_torch.obs.perfcheck`` in a fresh interpreter where
    ``import torch`` fails."""
    code = ("import runpy, sys\n"
            "sys.modules['torch'] = None\n"
            "sys.argv = ['perfcheck'] + sys.argv[1:]\n"
            "runpy.run_module('repro_torch.obs.perfcheck', "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code, *map(str, args)],
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_perfcheck_without_torch(tmp_path):
    env = {"git_sha": "x", "jax_version": "unavailable", "backend": "cuda",
           "device_count": 1}
    old, same, slow = (tmp_path / f"{n}.jsonl" for n in ("a", "b", "c"))
    _write(perf.BenchHistory, old, env=env)
    _write(perf.BenchHistory, same, env=env)
    _write(perf.BenchHistory, slow, scale=2.0, env=env)
    ok = _perfcheck(old, same)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "OK" in ok.stdout
    bad = _perfcheck(old, slow)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert bad.stdout.count("REGRESSED") == 2
    # the reference's gate reads the port's files the same way
    assert ref_perfcheck.main([str(old), str(slow)]) == 1
    assert _perfcheck(old, tmp_path / "missing.jsonl").returncode == 2
