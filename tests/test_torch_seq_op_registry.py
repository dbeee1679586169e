"""The port's ``SequenceOp`` registry (``repro_torch/models/seq_op.py``),
twin of the HLA-family parts of ``tests/test_seq_op_registry.py``:
registration errors and hints, the capability flags against the
reference's records, the state trees against the reference's, and for
every record (the HLA family, ``mamba`` and the self-contained ``rwkv6``)
that forward-then-step equals forward and that forward resumes from a
carry.  Sublayer parameters are the reference's (``from_jax_params``).

Tolerance: fp32, 1e-4 (the reference test's), and the same against the
reference's records.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import seq_op as ref_seq_op
from repro.models.config import MambaConfig as RefMambaConfig
from repro.models.param import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.models import seq_op
from repro_torch.models.config import MambaConfig
from repro_torch.models.param import from_jax_params
from repro_torch.models.state_tree import leaves

FAMILY = ("ahla", "hla2", "hla3", "hla3_paper", "linattn")
# the registry's cases: the HLA family, Mamba and the self-contained RWKV-6
OPS = FAMILY + ("mamba", "rwkv6")
TOL = 1e-4
FLAGS = ("streaming", "has_fused_kernels", "spec_decodable",
         "needs_positions", "self_contained", "prealloc_state", "param_key")


def _op(name):
    ref_cfg = ref_get_config("hla-1b", reduced=True).replace(mixer=name)
    cfg = get_config("hla-1b", reduced=True, mixer=name)
    if name == "mamba":  # as tests/test_seq_op_registry.py's _cfg_for
        ref_cfg = ref_cfg.replace(mamba=RefMambaConfig(d_state=8))
        cfg = cfg.replace(mamba=MambaConfig(d_state=8))
    ref_op, op = ref_seq_op.get_op(name), seq_op.get_op(name)
    ref_p = ref_init_params(ref_op.specs(ref_cfg), jax.random.key(0))
    p = from_jax_params(jax.device_get(ref_p), op.specs(cfg), device="cpu")
    return ref_cfg, ref_op, ref_p, cfg, op, p


def _x(seed, B=2, n=16, d=64):
    return np.random.RandomState(seed).randn(B, n, d).astype(np.float32) * 0.1


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_hla_family_registered():
    assert seq_op.registered_op_names() == ("ahla", "attn", "gla") + \
        FAMILY[1:] + ("mamba", "rwkv6")
    assert seq_op.streaming_op_names() == ("ahla", "gla") + FAMILY[1:] + \
        ("mamba", "rwkv6")
    assert set(seq_op.registered_op_names()) <= set(
        ref_seq_op.registered_op_names())


def test_duplicate_registration_raises():
    with pytest.raises(seq_op.SequenceOpError, match="already registered"):
        seq_op.register_op(seq_op.get_op("hla2"))
    with pytest.raises(TypeError, match="SequenceOp"):
        seq_op.register_op("hla2")


def test_unknown_op_lists_registry_and_suggests():
    with pytest.raises(seq_op.SequenceOpError) as ei:
        seq_op.get_op("hla3_papr")
    msg = str(ei.value)
    assert "did you mean 'hla3_paper'" in msg and "registered ops" in msg
    assert isinstance(ei.value, KeyError)
    # a config typo fails through the same path with the same hint
    cfg = get_config("hla-1b", reduced=True, mixer="linatn")
    with pytest.raises(seq_op.SequenceOpError, match="'linattn'"):
        seq_op.op_for(cfg)


def test_softmax_is_spelt_attn():
    """``"softmax"`` resolves to the registered ``attn`` record; an unknown
    name still raises with the registry listed (no silent fallback)."""
    cfg = get_config("codeqwen1.5-7b", reduced=True)
    assert cfg.mixer == "softmax"
    assert seq_op.op_name_for(cfg) == "attn"
    assert seq_op.op_for(cfg) is seq_op.get_op("attn")
    assert seq_op.op_name_for(cfg.replace(mixer="hla3")) == "hla3"
    with pytest.raises(seq_op.SequenceOpError, match="registered ops") as ei:
        seq_op.op_name_for(cfg.replace(mixer="softmx"))
    assert "'attn'" in str(ei.value)


def test_streaming_registration_requires_step():
    with pytest.raises(seq_op.SequenceOpError, match="step"):
        seq_op.SequenceOp(name="bogus", specs=lambda cfg: {},
                          forward=lambda *a, **k: None,
                          init_state=lambda *a, **k: None, streaming=True)
    op = seq_op.SequenceOp(name="bogus", specs=lambda cfg: {},
                           forward=lambda *a, **k: None,
                           init_state=lambda *a, **k: None)
    assert op.param_key == "bogus" and not op.streaming
    for name in FAMILY:
        assert seq_op.get_op(name).step is not None


@pytest.mark.parametrize("name", OPS)
def test_flags_and_state_tree_match_reference(name):
    """The capability flags equal the reference record's, and the state
    tree has the reference's structure, leaf shapes and dtypes (nested for
    hla3)."""
    ref_cfg, ref_op, _, cfg, op, _ = _op(name)
    for flag in FLAGS:
        assert getattr(op, flag) == getattr(ref_op, flag), flag
    ref_st = jax.eval_shape(lambda: ref_op.init_state(ref_cfg, 3))
    st = op.init_state(cfg, 3, torch.device("meta"))
    assert type(st).__name__ == type(ref_st).__name__
    assert [tuple(x.shape) for x in leaves(st)] == \
        [tuple(x.shape) for x in jax.tree.leaves(ref_st)]
    assert all(x.dtype == torch.float32 for x in leaves(st))


@pytest.mark.parametrize("name", OPS)
def test_forward_then_step_matches_forward(name):
    """prefix forward + per-token steps (in place) == one forward over the
    whole sequence, and == the reference's record over it."""
    ref_cfg, ref_op, ref_p, cfg, op, p = _op(name)
    x = _x(0)
    want, _ = ref_op.forward(ref_p, jnp.asarray(x), ref_cfg, want_state=True)
    tx = torch.from_numpy(x)
    y_full, _ = op.forward(p, tx, cfg, want_state=True)
    _close(y_full, want)
    t = 7
    y1, st = op.forward(p, tx[:, :t], cfg, want_state=True)
    pieces = [y1]
    for j in range(t, x.shape[1]):
        yj, st2 = op.step(p, tx[:, j:j + 1], st, cfg)
        assert st2 is st  # decode updates the state in place
        pieces.append(yj)
    _close(torch.cat(pieces, 1), y_full)


@pytest.mark.parametrize("name", OPS)
def test_forward_resumes_from_carry(name):
    """forward(state=mid_carry) == the tail of one full forward, states
    included, and the carry is left as it was."""
    ref_cfg, ref_op, ref_p, cfg, op, p = _op(name)
    tx = torch.from_numpy(_x(2))
    t = 8
    y_full, st_full = op.forward(p, tx, cfg, want_state=True)
    _, st1 = op.forward(p, tx[:, :t], cfg, want_state=True)
    kept = [x.clone() for x in leaves(st1)]
    y2, st2 = op.forward(p, tx[:, t:], cfg, state=st1, want_state=True)
    _close(y2, y_full[:, t:])
    for a, b in zip(leaves(st2), leaves(st_full)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)
    for a, b in zip(leaves(st1), kept):
        assert torch.equal(a, b)
    _, ref_st = ref_op.forward(ref_p, jnp.asarray(_x(2)), ref_cfg,
                               want_state=True)
    for a, b in zip(leaves(st_full), jax.tree.leaves(ref_st)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-3)
