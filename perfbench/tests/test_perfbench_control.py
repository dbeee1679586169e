"""The control, small and on the CPU: the plain reference put in the
program's place in float8 (the step below the configurations' bf16
activations) fails at least one of each cell's limits."""

import json

import _paths  # noqa: F401
import numpy as np
import pytest

from perfbench.bench import checks, serve, spec, train

BENCH = spec.load_benchmark()
SEED = 2**31 + 99


def small(workload):
    _, _, c, t = spec.cell(BENCH, workload)
    c = dict(c, n_layers=2, d_model=256, n_heads=4, d_ff=512, vocab=512)
    c["n_kv_heads"] = 2 if c.get("moe") else 4
    if c.get("moe"):
        c["moe"] = dict(c["moe"], n_experts=4, top_k=2, d_ff=128)
    return c, t


@pytest.mark.parametrize("workload", ["hla1b.train.s4096",
                                      "granite-moe.hla2.train.s2048"])
def test_train_control_fails(workload):
    c, t = small(workload)
    t = dict(t, seq_len=256)
    ref = train.reference_readings(c, t, SEED, "cpu")
    fp8 = train.reference_readings(c, t, SEED, "cpu", prec="fp8")
    numbers, _ = checks.compare_train(fp8, ref)
    ok, judged = checks.judge(numbers, spec.limits(workload))
    assert not ok, json.dumps(judged)


@pytest.mark.parametrize("workload", ["hla1b.serve.chat",
                                      "hla1b.serve.longdoc"])
def test_serve_control_fails(workload):
    # eight layers: the control's mean gap grows with depth (0.017 at two
    # layers, 0.043 at eight, 0.098 at the configuration's full size)
    c, _ = small(workload)
    c["n_layers"] = 8
    rng = np.random.default_rng(5)
    reqs = [{"prompt": rng.integers(0, c["vocab"], 96),
             "tokens": rng.integers(0, c["vocab"], 64).tolist()}
            for _ in range(3)]
    found, count = serve.gaps(c, reqs, SEED, "cpu", ("fp32", "fp8"))
    assert count == 192
    fp8 = found["fp8"]
    ok, judged = checks.judge({"logit_gap_mean": fp8["mean"],
                               "logit_gap": fp8["widest"]},
                              spec.limits(workload))
    assert not ok, json.dumps(judged)
