"""Whisper in the port (``repro_torch/models/whisper.py``, the cross and
non-causal paths of ``models/attention.py``, ``blocks.sinusoidal_pos``,
the step factories of ``distributed/steps.py``) against the reference's, at
``whisper_small.reduced()`` (2 encoder and 2 decoder layers, d 64, 16
frames, fp32) with the reference's weights (``from_jax_params``):

* ``sinusoidal_pos``, ``cross_kv_apply``, the encoder's non-causal and the
  decoder's cross ``attention_apply``, and ``whisper_encode``;
* with ``softmax``, ``hla2``, ``ahla`` and ``linattn`` in the decoder's
  self-attention: the train logits, ``whisper_loss`` and every gradient
  leaf (through ``accumulate_grads``, as a train step takes it, the frames
  split over 2 microbatches); a prefill over 4 tokens then 4 decode steps:
  the logits and every state leaf, the cross K/V's dtype included;
* ``make_prefill_step`` then ``make_serve_step`` for whisper (``softmax``,
  whose cache the prefill step sizes to the prompt exactly, and ``hla2``)
  and for reduced hla-1b;
* ``mixer="rwkv6"`` (self-contained) raises ``SequenceOpError`` in both;
* the serve CLIs build the same decoder-only stack for ``--arch
  whisper-small --mixer hla2``: the same config, the same parameters.

Tolerances, relative to max|want|: 1e-4 for fp32 against the reference (as
``tests/test_torch_archs.py``); a bf16 KV-cache leaf 1e-2 (one bf16 ulp: an
element whose fp32 value differs in the last bit may round to the
neighbouring bf16 value); the sinusoidal table 1e-4 (fp32 angles up to 15
rad at this size, up to 1.5e3 at full size, where one ulp of the angle
moves a sine by ~1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed import steps as ref_steps
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import seq_op as ref_seq_op
from repro.models import whisper as ref_whisper
from repro.models.param import init_params as ref_init_params
from repro.models.param import is_spec
from repro.models.param import param_count as ref_param_count
from repro_torch.configs import get_config
from repro_torch.distributed import steps
from repro_torch.models import attention, seq_op, whisper
from repro_torch.models.blocks import sinusoidal_pos
from repro_torch.models.param import from_jax_params, leaf_paths
from repro_torch.models.param import param_count, unstack
from repro_torch.models.state_tree import leaves

MIXERS = ("softmax", "hla2", "ahla", "linattn")
TOL = 1e-4
TOL_BF16 = 1e-2
B, N, PROMPT = 2, 8, 4


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _model(arch, mixer):
    """(ref_cfg, ref_params, cfg, params) of the reduced arch."""
    ref_cfg = ref_get_config(arch, reduced=True, mixer=mixer)
    cfg = get_config(arch, reduced=True, mixer=mixer)
    ref_specs = ref_steps.model_specs(ref_cfg)
    tree = jax.device_get(ref_init_params(ref_specs, jax.random.key(0)))
    return (ref_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            from_jax_params(tree, steps.model_specs(cfg), device="cpu"))


def _inputs(cfg):
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, cfg.vocab, (B, N))
    labels = rs.randint(0, cfg.vocab, (B, N))
    labels[0, :3] = -1  # ignored positions
    frames = (rs.randn(B, cfg.enc_frames, cfg.d_model) * 0.1).astype(
        np.float32)
    return tokens, labels, frames


def _check_states(got, want):
    """Every leaf of the port's state tree against the reference's, in tree
    order: same dtype; the KV cache's ``length`` exactly, a bf16 leaf
    within one ulp, the rest within ``TOL``."""
    got, want = leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype) or (
            g.dtype == torch.int32 and w.dtype in (jnp.int32, jnp.int64))
        if not g.dtype.is_floating_point:
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            tol = TOL_BF16 if g.dtype == torch.bfloat16 else TOL
            assert _rel(g, w) <= tol


@functools.lru_cache(maxsize=None)
def _reference_run(mixer):
    """The reference's outputs for one mixer, computed once: train logits,
    loss and gradients, and a prefill over ``PROMPT`` tokens followed by
    decode steps to ``N`` (logits per step, the final states)."""
    ref_cfg, ref_params, cfg, _ = _model("whisper-small", mixer)
    tokens, labels, frames = _inputs(cfg)
    jt, jl, jf = (jnp.asarray(x) for x in (tokens, labels, frames))
    logits = jax.jit(lambda p: ref_whisper.whisper_apply(
        p, jt, jf, ref_cfg)[0])(ref_params)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_whisper.whisper_loss(p, jt, jl, jf, ref_cfg),
        has_aux=True))(ref_params)
    pre, states, _ = jax.jit(lambda p: ref_whisper.whisper_apply(
        p, jt[:, :PROMPT], jf, ref_cfg, mode="prefill"))(ref_params)
    prefill_states = jax.device_get(states)
    dec = jax.jit(lambda p, tok, st, pos: ref_whisper.whisper_apply(
        p, tok, None, ref_cfg, states=st, positions=pos, mode="decode")[:2])
    outs = []
    for t in range(PROMPT, N):
        lg, states = dec(ref_params, jt[:, t:t + 1], states,
                         jnp.full((B, 1), t))
        outs.append(lg)
    return dict(logits=logits, loss=loss, grads=jax.device_get(grads),
                prefill=pre, prefill_states=prefill_states, decode=outs,
                states=jax.device_get(states))


def test_sinusoidal_pos_matches_reference():
    for n, d in ((16, 64), (1500, 768)):
        want = ref_blocks.sinusoidal_pos(n, d)
        assert _rel(sinusoidal_pos(n, d), want) <= TOL
    got = sinusoidal_pos(16, 64, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _rel(got, ref_blocks.sinusoidal_pos(16, 64, jnp.bfloat16)) <= \
        TOL_BF16


def test_attention_paths_and_encoder_match_reference():
    """``cross_kv_apply``, the non-causal and the cross ``attention_apply``
    on layer 0's weights, and the whole encoder."""
    ref_cfg, ref_params, cfg, params = _model("whisper-small", "softmax")
    _, _, frames = _inputs(cfg)
    rs = np.random.RandomState(1)
    x = rs.randn(B, 5, cfg.d_model).astype(np.float32)
    enc = jax.tree.map(lambda t: t[0], ref_params["enc_layers"])
    dec = jax.tree.map(lambda t: t[0], ref_params["dec_layers"])
    t_enc = unstack(params["enc_layers"])[0]
    t_dec = unstack(params["dec_layers"])[0]
    want, _ = ref_attn.attention_apply(enc["attn"], jnp.asarray(x), ref_cfg,
                                       causal=False, use_rope=False)
    got, cache = attention.attention_apply(
        t_enc["attn"], torch.from_numpy(x), cfg, causal=False,
        use_rope=False)
    assert cache is None and _rel(got, want) <= TOL
    ref_kv = ref_attn.cross_kv_apply(dec["cross_kv"], jnp.asarray(frames),
                                     ref_cfg)
    kv = attention.cross_kv_apply(t_dec["cross_kv"],
                                  torch.from_numpy(frames), cfg)
    for g, w in zip(kv, ref_kv):
        assert g.shape == (B, cfg.n_kv_heads, cfg.enc_frames, cfg.head_dim)
        assert _rel(g, w) <= TOL
    want, _ = ref_attn.attention_apply(dec["cross_q"], jnp.asarray(x),
                                       ref_cfg, cross_kv=ref_kv,
                                       use_rope=False)
    got, cache = attention.attention_apply(t_dec["cross_q"],
                                           torch.from_numpy(x), cfg,
                                           cross_kv=kv, use_rope=False)
    assert cache is None and _rel(got, want) <= TOL
    want = ref_whisper.whisper_encode(ref_params, jnp.asarray(frames),
                                      ref_cfg)
    got = whisper.whisper_encode(params, torch.from_numpy(frames), cfg)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("mixer", MIXERS)
def test_logits_loss_and_grads_match_reference(mixer):
    _, _, cfg, params = _model("whisper-small", mixer)
    ref = _reference_run(mixer)
    tokens, labels, frames = _inputs(cfg)
    got, _, _ = whisper.whisper_apply(params, torch.from_numpy(tokens),
                                      torch.from_numpy(frames), cfg)
    assert got.shape == (B, N, cfg.vocab)
    assert _rel(got, ref["logits"]) <= TOL
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels),
             "frames": torch.from_numpy(frames)}
    loss, _, aux, grads = steps.accumulate_grads(params, batch, cfg,
                                                 microbatches=2)
    assert float(aux) == 0.0 and _rel(loss, ref["loss"]) <= TOL
    want = dict(leaf_paths(ref["grads"]))
    got = dict(leaf_paths(grads))
    assert set(got) == set(want)
    for path, g in got.items():
        assert _rel(g, want[path]) <= TOL, "/".join(path)


@pytest.mark.parametrize("mixer", MIXERS)
def test_prefill_then_decode_matches_reference(mixer):
    _, _, cfg, params = _model("whisper-small", mixer)
    ref = _reference_run(mixer)
    tokens, _, frames = _inputs(cfg)
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        pre, states, _ = whisper.whisper_apply(
            params, t[:, :PROMPT], torch.from_numpy(frames), cfg,
            mode="prefill")
        assert _rel(pre, ref["prefill"]) <= TOL
        # computed from the encoder in the activation dtype, not rounded
        # into the bf16 buffers the prefill was given
        assert states["cross_k"].dtype == states["cross_v"].dtype == \
            torch.float32
        _check_states(states, ref["prefill_states"])
        for i, step in enumerate(range(PROMPT, N)):
            lg, states, _ = whisper.whisper_apply(
                params, t[:, step:step + 1], None, cfg, states=states,
                positions=torch.full((B, 1), step), mode="decode")
            assert _rel(lg, ref["decode"][i]) <= TOL
    _check_states(states, ref["states"])


@pytest.mark.parametrize("arch, mixer", [
    ("whisper-small", "softmax"), ("whisper-small", "hla2"),
    ("hla-1b", None)], ids=["whisper_softmax", "whisper_hla2", "hla-1b"])
def test_prefill_and_serve_steps_match_reference(arch, mixer):
    """The step factories against the reference's, unjitted: a prefill step
    over 4 tokens, then 2 serve steps.  With ``softmax`` the prefill step's
    cache holds the prompt exactly, so each serve step writes at the
    clamped start 3, over the last key, in both packages."""
    ref_cfg, ref_params, cfg, params = _model(arch, mixer)
    tokens, _, frames = _inputs(cfg)
    jbatch = {"tokens": jnp.asarray(tokens[:, :PROMPT])}
    tbatch = {"tokens": torch.from_numpy(tokens[:, :PROMPT])}
    if cfg.enc_layers:
        jbatch["frames"], tbatch["frames"] = (jnp.asarray(frames),
                                              torch.from_numpy(frames))
    want, ref_st = ref_steps.make_prefill_step(ref_cfg)(ref_params, jbatch)
    ref_serve = ref_steps.make_serve_step(ref_cfg)
    serve = steps.make_serve_step(cfg)
    with torch.no_grad():
        got, st = steps.make_prefill_step(cfg)(params, tbatch)
        assert got.shape == (B, cfg.vocab) and _rel(got, want) <= TOL
        for t in range(PROMPT, PROMPT + 2):
            tok, pos = tokens[:, t:t + 1], np.full((B, 1), t)
            want, ref_st = ref_serve(ref_params, {
                "tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
                ref_st)
            got, st = serve(params, {"tokens": torch.from_numpy(tok),
                                     "positions": torch.from_numpy(pos)}, st)
            assert _rel(got, want) <= TOL
    _check_states(st, jax.device_get(ref_st))


def test_self_contained_op_is_refused():
    with pytest.raises(ref_seq_op.SequenceOpError, match="rwkv6"):
        ref_whisper.whisper_specs(ref_get_config(
            "whisper-small", reduced=True, mixer="rwkv6"))
    with pytest.raises(seq_op.SequenceOpError, match="self-contained"):
        whisper.whisper_specs(get_config("whisper-small", reduced=True,
                                         mixer="rwkv6"))


def test_serve_clis_build_the_same_decoder_stack(monkeypatch):
    """``launch.serve --arch whisper-small --mixer hla2``: both CLIs build
    ``lm_specs`` of the same config (no encoder); each stops at its
    ``init_params``."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve

    seen = {}

    class Built(Exception):
        pass

    def capture(name, get):
        def fn(*a, **kw):
            cfg = get(*a, **kw)
            seen[name + "_cfg"] = cfg
            return cfg
        return fn

    def stop(name):
        def fn(specs, *a, **kw):
            seen[name] = specs
            raise Built
        return fn

    monkeypatch.setattr(ref_serve, "get_config",
                        capture("ref", ref_serve.get_config))
    monkeypatch.setattr(serve, "get_config", capture("port",
                                                     serve.get_config))
    monkeypatch.setattr(ref_serve, "init_params", stop("ref"))
    monkeypatch.setattr(serve, "init_params", stop("port"))
    argv = ["--arch", "whisper-small", "--mixer", "hla2", "--reduced"]
    for main in (lambda: ref_serve.main(argv),
                 lambda: serve.main(argv + ["--device", "cpu"])):
        with pytest.raises(Built):
            main()
    ref_cfg, cfg = seen["ref_cfg"], seen["port_cfg"]
    assert ref_cfg.enc_layers == cfg.enc_layers == 2
    for f in ("name", "mixer", "n_layers", "d_model", "n_heads", "d_ff",
              "vocab", "mlp", "tie_embeddings", "param_dtype"):
        assert getattr(cfg, f) == getattr(ref_cfg, f), f
    assert "enc_layers" not in seen["port"]  # the decoder-only stack
    assert param_count(seen["port"]) == ref_param_count(seen["ref"])
    flat, _ = jax.tree_util.tree_flatten_with_path(seen["ref"],
                                                   is_leaf=is_spec)
    ref_paths = sorted(tuple(k.key for k in path) for path, _ in flat)
    assert [path for path, _ in leaf_paths(seen["port"])] == ref_paths
