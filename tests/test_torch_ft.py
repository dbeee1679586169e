"""The rest of the port's training path against the reference: the
fault-tolerant loop (``repro_torch.runtime.ft``), exact microbatch
accumulation, per-layer remat, and the train CLI's fail-and-resume.

* Loop: twins of ``tests/test_substrate.py``'s FT cases,
  ``tests/test_chaos.py::test_ft_loop_restart_via_registry`` and
  ``tests/test_obs.py::TestLoopMetrics``; each schedule also runs through
  the reference's loop, which must give the same counters (wall-clock
  seconds aside), histogram counts and event sequence.
* Microbatches: reduced hla-1b (fp32) with the reference's weights, one
  8 x 32 batch whose labels are masked unevenly across the microbatch
  boundaries (as ``tests/test_distributed.py`` does).  The port's step
  with 4 microbatches against the reference's jitted one on one CPU
  device: loss within 1e-5 relative, gradient norm within ``TOL`` = 1e-4
  relative, every parameter within 5e-5 absolute (``test_torch_train.py``'s
  bounds for a step); and against the port's own 1-microbatch step, loss
  within 1e-6 relative and every gradient leaf within 1e-5 of its max|g|
  (two fp32 summation orders of one function).
* Remat: ``remat="full"`` against ``"none"`` in fp64, loss and every
  gradient leaf within 1e-6 relative, and the exact count of forward and
  backward calls (on the CPU the kernel wrappers run the plain versions,
  which are counted).
* CLI: ``--fail-at-step 9`` then a rerun that resumes from step 7 and ends
  at step 11 (the reference's ``test_train_cli_failure_restart``
  sequence, on one device); the metrics and events pass the validator.
"""

import os
import re
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticStream as RefStream
from repro.distributed import steps as ref_steps
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro.optim import adamw as ref_adamw
from repro.runtime.faults import FaultPlan as RefPlan
from repro.runtime.faults import FaultSpec as RefFaultSpec
from repro.runtime.faults import InjectedFault as RefInjectedFault
from repro.runtime.ft import FaultTolerantLoop as RefLoop
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.distributed.steps import accumulate_grads, make_train_step
from repro_torch.kernels import ahla_chunk, hla2_chunk
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import (
    from_jax_params,
    init_params,
    leaf_paths,
    tree_map,
)
from repro_torch.optim import adamw
from repro_torch.runtime.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.runtime.ft import FaultTolerantLoop, StragglerWatchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4  # test_torch_train.py's
PARAM_TOL = 5e-5  # absolute, test_torch_train.py's step bound


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def quiet(*a, **k):
    pass


# -- the loop ----------------------------------------------------------------


def _port_sum_step(params, opt_state, batch):
    return ({"w": params["w"] + int(batch["tokens"].sum())}, opt_state,
            {"loss": torch.zeros(())})


@pytest.mark.parametrize("steps, every, at", [(10, 3, 7), (8, 2, 5)])
def test_ft_loop_failure_and_resume(tmp_path, steps, every, at):
    """Twins of ``test_ft_loop_failure_and_resume`` (10 steps, a save every
    3, a fault at 7) and ``test_ft_loop_restart_via_registry`` (8, 2, 5):
    the restarted run reproduces the uninterrupted run's final state."""
    stream = SyntheticStream(DataConfig(vocab=50, seq_len=4, global_batch=2,
                                        seed=3))
    p0 = {"w": torch.zeros((), dtype=torch.int64)}
    ref = p0
    for s in range(steps):
        ref, _, _ = _port_sum_step(ref, None, stream.batch(s))
    ck = str(tmp_path / "ck")
    loop = FaultTolerantLoop(
        _port_sum_step, stream, ck, ckpt_every=every,
        faults=FaultPlan(FaultSpec("train.step", at=at)), log=quiet)
    with pytest.raises(InjectedFault, match="train.step"):
        loop.run(p0, None, steps)
    loop2 = FaultTolerantLoop(_port_sum_step, stream, ck, ckpt_every=every,
                              log=quiet)
    params, _, last = loop2.run(p0, None, steps)
    assert last == steps - 1
    assert int(params["w"]) == int(ref["w"])


def test_ft_loop_restores_signal_handlers(tmp_path):
    """``run`` installs its SIGTERM/SIGINT handlers for its own length only:
    the caller's are back after a run that ends and after one that dies."""
    def mine(signum, frame):
        pass

    stream = SyntheticStream(DataConfig(vocab=50, seq_len=4, global_batch=2,
                                        seed=3))
    p0 = {"w": torch.zeros((), dtype=torch.int64)}
    old = {s: signal.signal(s, mine) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for faults in (FaultPlan(FaultSpec("train.step", at=1)), None):
            loop = FaultTolerantLoop(_port_sum_step, stream,
                                     str(tmp_path / "ck"), ckpt_every=2,
                                     faults=faults, log=quiet)
            try:
                loop.run(p0, None, 3)
            except InjectedFault:
                assert faults is not None
            assert signal.getsignal(signal.SIGTERM) is mine
            assert signal.getsignal(signal.SIGINT) is mine
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def test_straggler_watchdog_logs():
    logs = []
    wd = StragglerWatchdog(factor=2.0, log=logs.append)
    wd.observe(0, 1.0)
    wd.observe(1, 1.1)
    assert not logs
    wd.observe(2, 10.0)  # straggler
    assert any("straggler" in m for m in logs)


def _loop_view(obs):
    """Counters and gauges (seconds aside), histogram counts, the sequence
    of (kind, name, step, point) of every record but the ``ckpt.save``
    spans, and those spans' steps (the save thread closes them, so where
    they fall among the loop's records depends on timing)."""
    nums = {}
    for name, m in obs.snapshot()["metrics"].items():
        for s in m["series"]:
            key = (name, tuple(sorted(s["labels"].items())))
            if m["kind"] == "histogram":
                nums[key] = s["count"]
            elif not name.endswith("_seconds"):
                nums[key] = s["value"]
    seq = [(e["kind"], e["name"], e.get("step"), e.get("point"))
           for e in obs.events() if e["name"] != "ckpt.save"]
    saves = sorted(e["step"] for e in obs.events(name="ckpt.save"))
    return nums, seq, saves


def _run_loops(tmp, make_loop, p0, o0, raises, schedule):
    """Run ``schedule`` (a list of (num_steps, fault at or None)) through
    fresh loops over one directory; returns each loop's view and last
    step."""
    out = []
    for n, at in schedule:
        loop = make_loop(str(tmp), at)
        last = None
        if at is None:
            last = loop.run(p0, o0, n)[2]
        else:
            with pytest.raises(raises):
                loop.run(p0, o0, n)
        out.append((_loop_view(loop.obs), last))
    return out


class _Stream:
    def batch(self, step):
        return {"tokens": np.ones((2, 8), np.int32),
                "labels": np.ones((2, 8), np.int32)}


@pytest.mark.parametrize("schedule", [
    [(4, None), (6, None)],  # TestLoopMetrics::test_step_and_restart_metrics
    [(8, 5), (8, None)],  # test_ft_loop_restart_via_registry
], ids=["restart_metrics", "fault_then_resume"])
def test_loop_metrics_and_events_match_reference(tmp_path, schedule):
    def port_loop(d, at):
        return FaultTolerantLoop(
            lambda p, o, b: (p, o, {"loss": torch.tensor(0.5)}), _Stream(),
            d, ckpt_every=2, log=quiet, faults=None if at is None else
            FaultPlan(FaultSpec("train.step", at=at)))

    def ref_loop(d, at):
        return RefLoop(
            lambda p, o, b: (p, o, {"loss": jnp.asarray(0.5)}), _Stream(),
            d, ckpt_every=2, log=quiet, faults=None if at is None else
            RefPlan(RefFaultSpec("train.step", at=at)))

    got = _run_loops(tmp_path / "port", port_loop, {"w": torch.zeros(2)},
                     {"m": torch.zeros(2)}, InjectedFault, schedule)
    want = _run_loops(tmp_path / "ref", ref_loop, {"w": jnp.zeros(2)},
                      {"m": jnp.zeros(2)}, RefInjectedFault, schedule)
    assert got == want
    (first, _), ((nums, seq, _), last) = got
    assert last == schedule[1][0] - 1
    assert nums[("train_restarts_total", ())] == 1
    assert seq.count(("event", "train.resumed", schedule[0][0] - 1
                      if schedule[0][1] is None else 3, None)) == 1
    if schedule[0][1] is None:  # TestLoopMetrics' own numbers
        nums, _, saves = first
        assert saves == [1, 3]
        assert nums[("train_steps_total", ())] == 4
        assert nums[("train_tokens_total", ())] == 4 * 2 * 8
        assert nums[("train_step_seconds", ())] == 4
        assert nums[("train_loss", ())] == 0.5
        assert nums[("ckpt_saves_total", ())] == 2  # steps 1 and 3


# -- config and remat --------------------------------------------------------


def test_config_remat_fields_match_reference():
    for reduced in (False, True):
        ref, cfg = (ref_get_config("hla-1b", reduced=reduced),
                    get_config("hla-1b", reduced=reduced))
        assert cfg.remat == ref.remat
    assert get_config("hla-1b").remat == "full"
    with pytest.raises(ValueError, match="'dots'.*not ported"):
        get_config("hla-1b").replace(remat="dots")
    with pytest.raises(ValueError, match="remat must be"):
        ModelConfig("x", 1, 8, 1, 1, 8, 8, remat="some")


def _counted(monkeypatch, mod, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_remat_matches_no_remat(monkeypatch, rng, mixer):
    """fp64, 2 layers: the same loss and gradients, and with remat each
    layer's forward runs twice (its recompute in backward) while the
    backward runs once."""
    mod, fwd, bwd = {"hla2": (hla2_chunk, "hla2_chunk_fwd_plain",
                              "hla2_chunk_bwd_plain"),
                     "ahla": (ahla_chunk, "ahla_chunk_fwd_plain",
                              "ahla_chunk_bwd_plain")}[mixer]
    cfg = get_config("hla-1b", reduced=True, mixer=mixer).replace(
        dtype="float64")
    params = tree_map(lambda x: x.double(),
                      init_params(lm.lm_specs(cfg), 0, "cpu"))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 70)))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 70)))
    batch = {"tokens": toks, "labels": labels}
    out = {}
    for remat in ("none", "full"):
        calls = _counted(monkeypatch, mod, [fwd, bwd])
        loss, _, grads = accumulate_grads(params, batch,
                                          cfg.replace(remat=remat))
        out[remat] = loss, grads
        assert calls == {fwd: cfg.n_layers * (2 if remat == "full" else 1),
                         bwd: cfg.n_layers}, remat
        monkeypatch.undo()
    (l0, g0), (l1, g1) = out["none"], out["full"]
    assert _rel(l1, l0) <= 1e-6
    for (path, a), (_, b) in zip(leaf_paths(g0), leaf_paths(g1)):
        assert _rel(b, a) <= 1e-6, path


# -- microbatches ------------------------------------------------------------


@pytest.fixture(scope="module")
def uneven():
    """Reduced hla-1b with the reference's weights and an 8 x 32 batch
    masked unevenly across microbatch boundaries."""
    ref_cfg = ref_get_config("hla-1b", reduced=True)
    cfg = get_config("hla-1b", reduced=True)
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    host = RefStream(RefDataConfig(cfg.vocab, 32, 8, seed=2)).batch(0)
    host["labels"] = host["labels"].copy()
    host["labels"][:3, :11] = -1
    return ref_cfg, ref_params, cfg, params, host


def _ref_leaves(tree):
    return {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_microbatches_match_reference(uneven):
    ref_cfg, ref_params, cfg, params, host = uneven
    oc = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    ref_step = jax.jit(ref_steps.make_train_step(
        ref_cfg, ref_adamw.OptConfig(**oc), microbatches=4))
    r_params, _, r_m = ref_step(ref_params,
                                ref_adamw.init_opt_state(ref_params),
                                {k: jnp.asarray(v) for k, v in host.items()})
    step = make_train_step(cfg, adamw.OptConfig(**oc), microbatches=4)
    params = tree_map(torch.clone, params)  # the step updates in place
    p_params, _, m = step(params, adamw.init_opt_state(params),
                          {k: torch.from_numpy(v) for k, v in host.items()})
    assert m.keys() == r_m.keys()
    assert m["aux"] == 0.0 and float(r_m["aux"]) == 0.0
    assert _rel(m["loss"], r_m["loss"]) <= 1e-5
    assert _rel(m["ce"], r_m["ce"]) <= 1e-5
    assert _rel(m["grad_norm"], r_m["grad_norm"]) <= TOL
    want = _ref_leaves(r_params)
    for path, x in leaf_paths(p_params):
        assert np.abs(x.numpy() - want[path]).max() <= PARAM_TOL, path


def test_microbatches_match_one_batch(uneven):
    _, _, cfg, params, host = uneven
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    l1, c1, g1 = accumulate_grads(params, batch, cfg, 1)
    l4, c4, g4 = accumulate_grads(params, batch, cfg, 4)
    assert _rel(l4, l1) <= 1e-6 and _rel(c4, c1) <= 1e-6
    for (path, a), (_, b) in zip(leaf_paths(g1), leaf_paths(g4)):
        assert b.dtype == torch.float32
        assert _rel(b, a) <= 1e-5, path
    with pytest.raises(ValueError, match="does not split into 3"):
        accumulate_grads(params, batch, cfg, 3)


# -- the CLI -----------------------------------------------------------------


def _cli(*extra, ok=True):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
         "--ckpt-every", "4", *extra],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert (p.returncode == 0) == ok, p.stderr[-2000:]
    return p


def test_train_cli_failure_restart(tmp_path):
    ck = str(tmp_path / "ck")
    p1 = _cli("--ckpt-dir", ck, "--fail-at-step", "9", ok=False)
    assert "injected fault at point 'train.step'" in p1.stderr
    m, e = str(tmp_path / "m.json"), str(tmp_path / "e.jsonl")
    p2 = _cli("--ckpt-dir", ck, "--metrics-out", m, "--events-out", e)
    assert "resumed from step 7" in p2.stdout
    assert re.search(r"\[train\] finished at step 11 \| step p50 [\d.]+s "
                     r"p99 [\d.]+s \| \d+ tok/s \| loss \d+\.\d{4}",
                     p2.stdout), p2.stdout
    v = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", "--metrics", m,
         "--events", e], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert v.returncode == 0, v.stdout + v.stderr
