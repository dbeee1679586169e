"""Mamba (``repro_torch/models/ssm.py``), the port against the reference
(``repro/models/ssm.py``) on the same numpy inputs and, for the block and
the model, the reference's own weights (``from_jax_params``):

* ``chunked_linear_recurrence`` in fp64, over several chunks and over one
  chunk of a ragged length;
* ``mamba_apply`` over a ragged length (a padded tail chunk), resumed from
  a state (a split prefill equals the whole one, the state only read),
  and token by token (the record's step, in place);
* reduced ``hla-1b --mixer mamba`` (``MambaConfig(d_state=8)``, as
  ``tests/test_seq_op_registry.py``): the loss and every gradient leaf;
* an fp32 decode keeps the reference's conv values: the port's ``conv``
  leaf is fp32 from the start, where the reference's turns fp32 after its
  bf16 zeros;
* ``Engine(spec=ngram)`` with ``mamba`` equals plain greedy token for
  token, and the verify pass (``lm_score_block``, a prefill over the
  committed states) leaves those states as they were.

Tolerances: fp64 1e-10 and fp32 1e-4, relative to max|want|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
from repro.models.config import MambaConfig as RefMambaConfig
from repro.models.param import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.distributed.steps import accumulate_grads
from repro_torch.models import lm, seq_op, ssm
from repro_torch.models.config import MambaConfig
from repro_torch.models.param import from_jax_params, leaf_paths
from repro_torch.models.state_tree import leaves
from repro_torch.serving.engine import Engine, GenRequest
from repro_torch.serving.spec import SpecConfig

TOL = 1e-4
TOL64 = 1e-10


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("n, chunk", [(64, 16), (45, 128)],
                         ids=["four_chunks", "ragged_one_chunk"])
def test_chunked_linear_recurrence_matches_reference(n, chunk):
    rs = np.random.RandomState(0)
    a = rs.uniform(0.5, 1.0, (2, n, 3, 4))
    b = rs.randn(2, n, 3, 4)
    h0 = rs.randn(2, 3, 4)
    want_h, want_f = ref_ssm.chunked_linear_recurrence(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), chunk=chunk)
    h, hf = ssm.chunked_linear_recurrence(
        *map(torch.from_numpy, (a, b, h0)), chunk=chunk)
    assert h.dtype == torch.float64
    assert _rel(h, want_h) <= TOL64 and _rel(hf, want_f) <= TOL64
    # the serial recurrence, as a third opinion
    ht, serial = torch.from_numpy(h0), []
    for t in range(n):
        ht = torch.from_numpy(a[:, t]) * ht + torch.from_numpy(b[:, t])
        serial.append(ht)
    assert _rel(h, torch.stack(serial, 1)) <= TOL64


def test_chunked_linear_recurrence_refuses_a_partial_chunk():
    a = torch.ones(1, 45, 2)
    with pytest.raises(ValueError, match="multiple"):
        ssm.chunked_linear_recurrence(a, a, torch.zeros(1, 2), chunk=16)


def _cfgs(d_state=8):
    ref_cfg = ref_get_config("hla-1b", reduced=True).replace(
        mixer="mamba", mamba=RefMambaConfig(d_state=d_state))
    cfg = get_config("hla-1b", reduced=True, mixer="mamba").replace(
        mamba=MambaConfig(d_state=d_state))
    return ref_cfg, cfg


@functools.lru_cache(maxsize=None)
def _block():
    ref_cfg, cfg = _cfgs()
    ref_p = ref_init_params(ref_ssm.mamba_specs(ref_cfg), jax.random.key(0))
    tree = jax.device_get(ref_p)
    # nonzero conv bias and A_log, so every term of the block is exercised
    rs = np.random.RandomState(9)
    tree["conv_b"] = (rs.randn(*tree["conv_b"].shape) * 0.1).astype(
        np.float32)
    tree["A_log"] = (rs.randn(*tree["A_log"].shape) * 0.5).astype(np.float32)
    ref_p = jax.tree.map(jnp.asarray, tree)
    p = from_jax_params(tree, ssm.mamba_specs(cfg), device="cpu")
    return ref_cfg, ref_p, cfg, p


def _x(seed, B=2, n=150, d=64):
    return np.random.RandomState(seed).randn(B, n, d).astype(np.float32) * 0.5


def test_mamba_apply_matches_reference():
    """n = 150: one full 128-token chunk and a padded tail."""
    ref_cfg, ref_p, cfg, p = _block()
    x = _x(0)
    want, want_st = ref_ssm.mamba_apply(ref_p, jnp.asarray(x), ref_cfg)
    y, st = ssm.mamba_apply(p, torch.from_numpy(x), cfg)
    assert _rel(y, want) <= TOL
    assert _rel(st.h, want_st.h) <= TOL and _rel(st.conv, want_st.conv) <= TOL


def test_mamba_apply_resumes_from_state():
    """A split prefill (ragged pieces, several chunks each at chunk 16)
    equals the whole one and the reference's resume; the state it resumes
    from is only read."""
    ref_cfg, ref_p, cfg, p = _block()
    x = _x(1, n=90)
    tx = torch.from_numpy(x)
    y_full, st_full = ssm.mamba_apply(p, tx, cfg, chunk=16)
    y1, st1 = ssm.mamba_apply(p, tx[:, :37], cfg, chunk=16)
    kept = [t.clone() for t in st1]
    y2, st2 = ssm.mamba_apply(p, tx[:, 37:], cfg, state=st1, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(st1, kept))
    assert _rel(torch.cat([y1, y2], 1), y_full) <= TOL
    assert _rel(st2.h, st_full.h) <= TOL
    assert _rel(st2.conv, st_full.conv) <= TOL
    _, ref_st1 = ref_ssm.mamba_apply(ref_p, jnp.asarray(x[:, :37]), ref_cfg,
                                     chunk=16)
    want, want_st = ref_ssm.mamba_apply(ref_p, jnp.asarray(x[:, 37:]),
                                        ref_cfg, state=ref_st1, chunk=16)
    assert _rel(y2, want) <= TOL and _rel(st2.h, want_st.h) <= TOL


def test_mamba_step_by_step_decode():
    """The record: a prefix forward, then one step a token (state updated
    in place) equals one forward over the whole sequence and the
    reference's."""
    ref_cfg, ref_p, cfg, p = _block()
    op = seq_op.get_op("mamba")
    x = _x(2, n=24)
    tx = torch.from_numpy(x)
    y_full, _ = op.forward(p, tx, cfg)
    y1, st = op.forward(p, tx[:, :9], cfg)
    pieces = [y1]
    for t in range(9, 24):
        yt, st2 = op.step(p, tx[:, t:t + 1], st, cfg)
        assert st2 is st
        pieces.append(yt)
    assert _rel(torch.cat(pieces, 1), y_full) <= TOL
    want, _ = ref_ssm.mamba_apply(ref_p, jnp.asarray(x), ref_cfg)
    assert _rel(torch.cat(pieces, 1), want) <= TOL


@functools.lru_cache(maxsize=None)
def _model():
    ref_cfg, cfg = _cfgs()
    tree = jax.device_get(ref_init_params(ref_lm.lm_specs(ref_cfg),
                                          jax.random.key(0)))
    return (ref_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            from_jax_params(tree, lm.lm_specs(cfg), device="cpu"))


def test_mamba_lm_loss_and_grads_match_reference():
    ref_cfg, ref_params, cfg, params = _model()
    rs = np.random.RandomState(3)
    toks = rs.randint(1, cfg.vocab, (2, 40))
    labels = rs.randint(1, cfg.vocab, (2, 40))
    labels[1, :5] = -1
    (want, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.lm_loss(p, jnp.asarray(toks), jnp.asarray(labels),
                                 ref_cfg), has_aux=True))(ref_params)
    loss, _, _, grads = accumulate_grads(
        params, {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labels)}, cfg)
    assert _rel(loss, want) <= TOL
    want_g = dict(leaf_paths(jax.device_get(ref_grads)))
    got_g = dict(leaf_paths(grads))
    assert set(got_g) == set(want_g)
    assert ("layers", "mamba", "A_log") in got_g
    for path, g in got_g.items():
        assert _rel(g, want_g[path]) <= TOL, "/".join(path)


def test_fp32_decode_keeps_reference_conv_values():
    """Prefill 11 tokens, then 5 decode steps, in both packages: the logits
    and every state leaf agree, and the port's conv leaf is fp32 all along
    (the reference's starts bf16, so a port that kept bf16 would round the
    conv tail at every step)."""
    ref_cfg, ref_params, cfg, params = _model()
    toks = np.random.RandomState(4).randint(1, cfg.vocab, (2, 16))
    init = lm.lm_init_states(cfg, 2, "cpu")
    assert init.conv.dtype == torch.float32
    _, ref_st, _ = ref_lm.lm_apply(ref_params, jnp.asarray(toks[:, :11]),
                                   ref_cfg, mode="prefill")
    _, st, _ = lm.lm_apply(params, torch.from_numpy(toks[:, :11]), cfg,
                           mode="prefill")
    ref_step = jax.jit(lambda t, s: ref_lm.lm_apply(
        ref_params, t, ref_cfg, states=s, mode="decode")[:2])
    for t in range(11, 16):
        want, ref_st = ref_step(jnp.asarray(toks[:, t:t + 1]), ref_st)
        got, st2, _ = lm.lm_apply(params, torch.from_numpy(toks[:, t:t + 1]),
                                  cfg, states=st, mode="decode")
        assert st2 is st and st.conv.dtype == torch.float32
        assert _rel(got, want) <= TOL
    assert ref_st.conv.dtype == jnp.float32
    for a, b in zip(leaves(st), jax.tree.leaves(ref_st)):
        assert _rel(a, b) <= TOL


def test_spec_greedy_exact_and_verify_reads_states_only():
    """Speculative greedy (n-gram drafts) equals plain greedy, and a verify
    pass over the slots' committed states does not write into them (a
    rejected round rolls back to those states)."""
    _, _, cfg, params = _model()
    rs = np.random.RandomState(5)
    prompts = [np.tile(rs.randint(2, cfg.vocab, 4), 5) for _ in range(2)]

    def reqs():
        return [GenRequest(rid=i, prompt=p, max_new=10)
                for i, p in enumerate(prompts)]

    plain = Engine(cfg, params, slots=2, max_len=64, block=4, seed=0,
                   device="cpu").run(reqs())
    spec = Engine(cfg, params, slots=2, max_len=64, block=4, seed=0,
                  device="cpu", spec=SpecConfig(drafter="ngram", k=3))
    got = spec.run(reqs())
    assert [r.tokens for r in got] == [r.tokens for r in plain]
    assert spec.stats["spec_rounds"] > 0
    with torch.no_grad():
        _, st = lm.lm_prefill(params, torch.from_numpy(np.stack(prompts)),
                              cfg)
        kept = [x.clone() for x in leaves(st)]
        block = torch.from_numpy(rs.randint(2, cfg.vocab, (2, 4)))
        _, new = lm.lm_score_block(params, block, cfg, states=st)
    assert all(torch.equal(a, b) for a, b in zip(leaves(st), kept))
    assert not any(torch.equal(a, b) for a, b in zip(leaves(new), kept))
