"""The port's four examples (``examples/torch_quickstart.py``,
``torch_long_context_decode.py``, ``torch_hla_vs_baselines.py``,
``torch_train_hla_100m.py``) run on the CPU with short arguments and print
their reference twins' lines; the models the quickstart, the recall
comparison (each of its five mixers) and the 100M example train have the
reference's parameter counts, and the KV-cache figure of the long-context
example equals the reference's ``eval_shape`` of a softmax
``lm_init_states`` byte for byte.  The 100M example rebinds
``configs.hla_1b.reduced`` when it is loaded, so it runs in a subprocess,
and the loads that read its config restore the attribute."""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.distributed import steps as ref_steps
from repro.models import lm as ref_lm
from repro.models.param import param_count as ref_param_count
from repro_torch.configs import get_config
from repro_torch.distributed import steps
from repro_torch.models.param import param_count

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_bytes(tree):
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(tree))


def test_quickstart_runs_on_cpu(capsys):
    _example("torch_quickstart").main(
        ["--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    ref_cfg = ref_get_config("hla-1b", reduced=True).replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512)
    n = ref_param_count(ref_lm.lm_specs(ref_cfg))
    assert f"model: hla-1b ({n:,} params, mixer=hla2)" in out
    assert re.search(r"step    0  loss \d+\.\d{4}  lr 1\.50e-04", out), out
    assert "uniform baseline ln(512) = 6.238" in out
    assert re.search(r"loss: \d+\.\d{3} -> \d+\.\d{3} \((OK: learning|"
                     r"WARN: check setup)\)", out), out


def test_long_context_decode_runs_on_cpu(capsys):
    _example("torch_long_context_decode").main(
        ["--ctx", "64", "--device", "cpu", "--sampling", "top_k",
         "--top-k", "5"])
    out = capsys.readouterr().out
    assert "HLA2 state:      0.05 MiB  (constant in context)" in out
    assert "KV cache @ 64:     0.06 MiB  (linear in context)" in out
    assert len(re.findall(r"ctx +(16|32|64): +\d+\.\d tok/s, state still "
                          r"0\.05 MiB", out)) == 3, out
    assert "decode state never grew" in out


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "hla-1b"])
@pytest.mark.parametrize("B, ctx", [(2, 4096), (1, 100), (4, 64)])
def test_kv_cache_bytes_equal_reference(reduced, B, ctx):
    mod = _example("torch_long_context_decode")
    ref_cfg = ref_get_config("hla-1b", reduced=reduced)
    kv = jax.eval_shape(lambda: ref_lm.lm_init_states(
        ref_cfg.replace(mixer="softmax"), B, ctx))
    cfg = get_config("hla-1b", reduced=reduced)
    assert mod.kv_cache_bytes(cfg, B, ctx) == _ref_bytes(kv)
    # and the HLA2 state the example prints is the reference's
    import torch

    from repro_torch.models import lm

    ours = mod.state_bytes(lm.lm_init_states(cfg, B, torch.device("meta")))
    assert ours == _ref_bytes(jax.eval_shape(
        lambda: ref_lm.lm_init_states(ref_cfg, B, ctx)))


def test_hla_vs_baselines_runs_on_cpu(capsys):
    mod = _example("torch_hla_vs_baselines")
    mod.main(["--steps", "2", "--batch", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    got = re.findall(r"^(\w+) +recall accuracy: +\d+\.\d%  \(final loss "
                     r"\d+\.\d{3}\)$", out, re.M)
    assert got == ["softmax", "linattn", "hla2", "ahla", "hla3"], out
    for mixer in got:  # the reference example's config, mixer by mixer
        ref_cfg = ref_get_config("hla-1b", reduced=True).replace(
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
            vocab=64)
        if mixer != "hla2":
            ref_cfg = ref_cfg.replace(mixer=mixer)
        assert param_count(steps.model_specs(mod.config(mixer))) == \
            ref_param_count(ref_steps.model_specs(ref_cfg)), mixer


def _load_100m(monkeypatch, path, hla_1b):
    """The 100M example at ``path`` loaded for its ``_reduced_100m``, with
    ``sys.argv`` and ``hla_1b.reduced`` restored after the test."""
    monkeypatch.setattr(sys, "argv", ["pytest"])
    monkeypatch.setattr(hla_1b, "reduced", hla_1b.reduced)
    spec = importlib.util.spec_from_file_location("example_100m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._reduced_100m()


def test_train_hla_100m_has_reference_config(monkeypatch):
    import repro.configs.hla_1b as ref_hla_1b
    import repro_torch.configs.hla_1b as hla_1b
    from repro_torch.models import lm

    ref_cfg = _load_100m(monkeypatch, ROOT / "examples" /
                         "train_hla_100m.py", ref_hla_1b)
    cfg = _load_100m(monkeypatch, ROOT / "examples" /
                     "torch_train_hla_100m.py", hla_1b)
    n = param_count(lm.lm_specs(cfg))
    assert n == ref_param_count(ref_lm.lm_specs(ref_cfg))
    assert 90e6 < n < 110e6
    for f in ("n_layers", "d_model", "n_heads", "d_ff", "vocab", "remat",
              "dtype", "mixer"):
        assert getattr(cfg, f) == getattr(ref_cfg, f), f


def test_train_hla_100m_runs_on_cpu(tmp_path):
    env = dict(os.environ, STEPS="1", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_hla_100m.py"),
         "--batch", "1", "--seq", "64", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ck"), "--ckpt-every", "1", "--metrics",
         str(tmp_path / "m.jsonl")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # the loop's last step index, as the reference prints it
    assert "[train] finished at step 0 |" in out.stdout, out.stdout
    assert os.listdir(tmp_path / "ck") == ["step_00000000"]
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 1
