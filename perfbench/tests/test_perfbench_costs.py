"""The frozen cost and roofline arithmetic, against counts by hand at small
shapes and against the program's own cost model at full size."""

import json

import _paths  # noqa: F401
import pytest

from perfbench.bench import spec
from perfbench.costs import kernels, model, peaks

BENCH = spec.load_benchmark()


def config(name):
    ce = spec.by_name(BENCH["configs"], name, "configuration")
    return json.loads((spec.ROOT / ce["file"]).read_text())


def test_chunk_fmas_by_hand():
    # one chunk of 2 tokens, d = dv = 2: K Q^T 2*2*2; T3 weights 2*3*4/6;
    # P V and N (g V) 3*2 + 1*2; S, C, G updates 3*2 + 2*2*2*2
    assert kernels.chunk_fmas(2, 2, 2) == (8, 30, 4)
    # with a carry: Q S0 and (Q S0) Q^T 8 + 6, Q G0 and K C0 16; (Q S0) C0 8
    assert kernels.chunk_fmas(2, 2, 2, has_init=True) == (8, 60, 12)
    # two chunks of 64: the second one has the carry terms
    one = kernels.chunk_fmas(64, 4, 4)
    two = kernels.chunk_fmas(128, 4, 4)
    carry = kernels.chunk_fmas(64, 4, 4, has_init=True)
    assert two == tuple(a + b for a, b in zip(one, carry))


def test_chunk_bwd_fmas_single_chunk_by_hand():
    # one chunk is first and last: K Q^T + E = dO V^T, 2*2*2 + 3*2; A Bm,
    # dA, dBm 3*4; wgt^T dO 3*2 and dBm, dA into dq, dk 4*3*2
    assert kernels.chunk_bwd_fmas(2, 2, 2) == (14, 30, 12)


def test_least_seconds_takes_the_longer_bound():
    t, by = kernels.least_seconds(3.35e12, (0, 0, 0), 1)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = kernels.least_seconds(0, (989e12 / 2, 0, 0), 1)
    assert by == "operations" and t == pytest.approx(1.0)
    t, _ = kernels.least_seconds(0, (0, 0, 495e12 / 6), 1)
    assert t == pytest.approx(1.0)


def test_step_bytes_by_hand():
    # one row, d = dv = 2: the carry 4*(4 + 8 + 4) bytes read and written,
    # q, k, v, o 2*8, gamma 4
    t, by = kernels.step_seconds(1, 2, 2)
    assert by == "bytes"
    assert t == pytest.approx((2 * 64 + 16 + 4) / peaks.HBM_BYTES_S)


def test_param_counts_by_hand():
    d, V, f = 2048, 50304, 5504
    layer = 2 * d + 4 * d * d + 16 * 128 + 16 + 3 * d * f
    assert model.param_count(config("hla-1b.hla2")) == \
        2 * V * d + 24 * layer + d
    d, V = 1536, 49155
    layer = 2 * d + 2 * d * d + 2 * d * 512 + 24 * 64 + 24 \
        + 40 * d + 3 * 40 * d * 512
    assert model.param_count(config("granite-moe-3b-a800m.hla2")) == \
        V * d + 32 * layer + d


def test_train_flops_per_token():
    c = config("hla-1b.hla2")
    cost = model.model_cost(c, mode="train_step", seq_len=4096, batch=2)
    assert cost.flops_per_token == pytest.approx(9.09e9, rel=2e-3)


@pytest.mark.parametrize("name", ["hla-1b.hla2", "granite-moe-3b-a800m.hla2"])
@pytest.mark.parametrize("mode,n,b", [("train_step", 2048, 2),
                                      ("prefill", 300, 1),
                                      ("decode_step", 1, 128)])
def test_matches_the_programs_cost_model(name, mode, n, b):
    from perfbench.bench import program
    from repro_torch.obs import costs

    c = config(name)
    ours = model.model_cost(c, mode=mode, seq_len=n, batch=b)
    theirs = costs.model_cost(program.model_config(c), mode=mode,
                              seq_len=n, batch=b)
    assert ours.flops_per_token == pytest.approx(theirs.flops_per_token,
                                                 rel=1e-9)
    assert ours.bytes_per_token == pytest.approx(theirs.bytes_per_token,
                                                 rel=1e-9)
