"""The traffic generator: deterministic by seed, the same work for every
seed, and the parameters of the mixes' data files."""

import collections

import _paths  # noqa: F401
import pytest
import torch

from perfbench.bench import spec, traffic

BENCH = spec.load_benchmark()
SERVE = [w["name"] for w in BENCH["workloads"]
         if spec.cell(BENCH, w["name"])[3]["kind"] == "closed_loop"]
TRAIN = [w["name"] for w in BENCH["workloads"]
         if spec.cell(BENCH, w["name"])[3]["kind"] == "train"]


@pytest.mark.parametrize("workload", SERVE)
def test_closed_loop_is_deterministic_and_in_range(workload):
    _, _, c, t = spec.cell(BENCH, workload)
    a, b = (traffic.ClosedLoop(t, c["vocab"], 2**31 + 11) for _ in range(2))
    for client in (0, t["clients"] - 1):
        for k in range(3):
            ra, rb = a.request(client, k), b.request(client, k)
            assert (ra.prompt == rb.prompt).all() and ra.max_new == rb.max_new
            assert t["prompt"]["min"] <= len(ra.prompt) <= t["prompt"]["max"]
            assert 0 <= ra.prompt.min() and ra.prompt.max() < c["vocab"]
            assert len(ra.prompt) + ra.max_new <= t["max_len"]
            if k:
                assert t["output"]["min"] <= ra.max_new <= t["output"]["max"]


@pytest.mark.parametrize("workload", SERVE)
def test_every_seed_does_the_same_work(workload):
    _, _, c, t = spec.cell(BENCH, workload)
    loops = [traffic.ClosedLoop(t, c["vocab"], seed)
             for seed in (1, 2, 2**31 + 5)]
    schedules = [[[loop.lengths(client, k) for client in range(t["clients"])]
                  for k in range(4)] for loop in loops]
    assert schedules[0] == schedules[1] == schedules[2]
    assert schedules[0][1] != schedules[0][2]
    # the seed draws the prompts' token ids
    one, other = loops[0].request(3, 1), loops[1].request(3, 1)
    assert len(one.prompt) == len(other.prompt)
    assert not (one.prompt == other.prompt).all()
    # another schedule seed deals the same lengths in another order
    moved = traffic.ClosedLoop(dict(t, schedule_seed=t["schedule_seed"] + 1),
                               c["vocab"], 1)
    r1 = [moved.lengths(client, 1) for client in range(t["clients"])]
    assert r1 != schedules[0][1]
    assert collections.Counter(p for p, _ in r1) == \
        collections.Counter(p for p, _ in schedules[0][1])


@pytest.mark.parametrize("workload", SERVE)
def test_lognormal_medians_match_the_mix(workload):
    _, _, c, t = spec.cell(BENCH, workload)
    for key in ("prompt", "output"):
        d = t[key]
        if d["dist"] == "lognormal":
            assert traffic.quantile(d, 0.5) == d["median"]
        assert traffic.quantile(d, 1e-9) == d["min"]
        assert traffic.quantile(d, 1 - 1e-9) == d["max"]


@pytest.mark.parametrize("workload", TRAIN)
def test_train_batches_are_deterministic_and_distinct(workload):
    _, _, c, t = spec.cell(BENCH, workload)
    t = dict(t, seq_len=32)
    b0 = traffic.train_batch(t, c["vocab"], 7, 0, "cpu")
    again = traffic.train_batch(t, c["vocab"], 7, 0, "cpu")
    b1 = traffic.train_batch(t, c["vocab"], 7, 1, "cpu")
    assert b0["tokens"].shape == (t["batch"], 32)
    assert torch.equal(b0["tokens"], again["tokens"])
    assert torch.equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert not torch.equal(b0["tokens"][0], b0["tokens"][1])
