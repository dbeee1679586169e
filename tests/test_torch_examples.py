"""The port's two examples (``examples/torch_quickstart.py``,
``examples/torch_long_context_decode.py``) run on the CPU with short
arguments and print their reference twins' lines; the model the quickstart
trains has the reference's parameter count, and the KV-cache figure of the
long-context example equals the reference's ``eval_shape`` of a softmax
``lm_init_states`` byte for byte."""

import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models.param import param_count as ref_param_count
from repro_torch.configs import get_config

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
