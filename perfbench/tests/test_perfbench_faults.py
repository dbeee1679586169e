"""A run of each cell, small, in float32 and on the CPU past the harness's
look for a card, with the timed path broken underneath: ``correct`` comes
out false for every fault the cell can have, and true for the sound
path, against the cell's own limits."""

import copy
import json

import _paths  # noqa: F401
import pytest
import torch

from perfbench.bench import cell, spec

BENCH = spec.load_benchmark()
SEED = 2**31 + 77


def small(workload):
    _, _, c, t = spec.cell(BENCH, workload)
    c = dict(c, n_layers=2, d_model=64, n_heads=4, d_ff=96, vocab=256,
             dtype="float32")
    c["n_kv_heads"] = 2 if c.get("moe") else 4
    if c.get("moe"):
        c["moe"] = dict(c["moe"], n_experts=4, top_k=2, d_ff=32)
    if t["kind"] == "train":
        return c, dict(t, seq_len=64)
    out = dict(t["output"], min=6, max=12)
    if out["dist"] == "lognormal":
        out["median"] = 8
    return c, dict(t, clients=3, slots=3, block=4, max_len=64, warm_ticks=1,
                   prompt=dict(t["prompt"], median=16, min=8, max=32),
                   output=out, check={"min_requests": 3, "min_tokens": 20})


def run(workload, fault=None):
    c, t = small(workload)
    result, checks = cell.run_cell(BENCH, workload, SEED, 0.3, False, "cpu",
                                   fault=fault, c=c, t=t)
    return result["correct"], checks


# -- train faults: wrappers around the program's train step


def unchanged(step):
    """A step that returns its state unchanged."""
    def broken(params, state, batch):
        keep = copy.deepcopy((params, state))
        _, _, metrics = step(params, state, batch)
        with torch.no_grad():
            for a, b in zip(_leaves(params), _leaves(keep[0])):
                a.copy_(b)
            for a, b in zip(_leaves(state.mu) + _leaves(state.nu),
                            _leaves(keep[1].mu) + _leaves(keep[1].nu)):
                a.copy_(b)
        return params, keep[1], metrics
    return broken


def half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(params, state, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(params, state, half)
    return broken


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# -- serve faults: patched into the program under the engine


def stale_state(engine):
    """A decode step that returns its state unchanged."""
    from repro_torch.kernels import ops

    real = ops.hla2_decode_step

    def broken(state, *args, **kw):
        _, o = real(type(state)(*(x.clone() for x in state)), *args, **kw)
        return state, o

    _patch(ops, "hla2_decode_step", broken)


def altered_tokens(engine):
    """Every sampled token altered where it is produced."""
    from repro_torch.serving import engine as engine_mod

    real = engine_mod.sample

    def broken(logits, gen, cfg):
        return (real(logits, gen, cfg) + 1) % logits.shape[-1]

    _patch(engine_mod, "sample", broken)


_PATCHED = []


def _patch(mod, name, fn):
    _PATCHED.append((mod, name, getattr(mod, name)))
    setattr(mod, name, fn)


@pytest.fixture(autouse=True)
def _restore():
    yield
    while _PATCHED:
        mod, name, fn = _PATCHED.pop()
        setattr(mod, name, fn)


TRAIN = ["hla1b.train.s4096", "granite-moe.hla2.train.s2048"]
SERVE = ["hla1b.serve.chat", "hla1b.serve.longdoc"]


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_the_sound_path_is_correct(workload):
    ok, checks = run(workload)
    assert ok, json.dumps(checks)


@pytest.mark.parametrize("fault", [unchanged, half_batch],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", TRAIN)
def test_train_faults_are_caught(workload, fault):
    ok, checks = run(workload, fault)
    assert not ok, json.dumps(checks)


@pytest.mark.parametrize("fault", [stale_state, altered_tokens],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", SERVE)
def test_serve_faults_are_caught(workload, fault):
    ok, checks = run(workload, fault)
    assert not ok, json.dumps(checks)
