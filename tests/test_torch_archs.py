"""The nine public configs (the dense codeqwen1.5-7b, qwen2-72b,
deepseek-67b, nemotron-4-15b, internvl2-2b; the MoE granite-moe-3b-a800m and
qwen3-moe-30b-a3b; the attention-free rwkv6-7b; the hybrid Mamba/attention
MoE jamba-1.5-large-398b) at ``reduced()``, the port against the reference
with the reference's weights (``from_jax_params``; the biases, which the
reference initialises to constants, drawn at random in both):

* logits, the loss (with the MoE aux term) and every gradient leaf
  (internvl2-2b with ``vis_embed``): the counterpart of
  ``tests/test_archs.py::test_arch_forward_and_train_step``; plus reduced
  qwen3-moe-30b-a3b at ``d_head=32`` in both packages, where ``n_heads *
  d_head`` (128) differs from ``d_model`` (64) as at full width;
* token-by-token decode equals the full forward (``:102``, codeqwen and
  granite-moe) and prefill then decode continues it (``:135``, on an
  ``attn`` config; qwen3-moe), and both equal the reference's decode; the
  MoE configs at the reference's raised capacity factor (16), so no pair
  drops in the full forward (a one-token decode never drops);
* the drop-in overrides whose archs are ported (``:71``, granite-moe with
  ``hla2`` among them) against the reference's loss, and qwen3-moe with
  ``hla2`` at ``d_head=32``;
* ``Engine`` refuses ``attn`` (``tests/test_seq_op_registry.py:376``) and
  jamba's hybrid stack, with its own ``attn`` or with ``hla2``, as the
  reference's does; ``get_config`` refuses a mixer override on rwkv6-7b
  ("attention-free", ``tests/test_archs.py:89``);
* jamba: every MoE layer's expert ids (``gate_e``) in the full forward
  equal the reference's, layer by layer; the drop-in ``("jamba-1.5-large-
  398b", "hla2")`` (``tests/test_archs.py:79``); rwkv6-7b and jamba decode
  continues the full forward (``tests/test_archs.py:99``), jamba after an
  8-token prefill (its Mamba positions resume from their prefill states,
  its attention position from a KV cache), at the reference's capacity
  factor of 16.

Tolerances, relative to max|want|: 1e-4 for fp32 against the reference
(as ``tests/test_torch_model.py``); decode against the full forward
5e-2, the reference's own (decode reads the bf16 KV cache, the full
forward unrounded K/V); port decode against reference decode 1e-3 (a
K/V element whose fp32 values differ in the last bit may round to
neighbouring bf16 values).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.steps import accumulate_grads
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params, leaf_paths
from repro_torch.serving.engine import Engine

ARCHS = ("codeqwen1.5-7b", "deepseek-67b", "granite-moe-3b-a800m",
         "internvl2-2b", "jamba-1.5-large-398b", "nemotron-4-15b",
         "qwen2-72b", "qwen3-moe-30b-a3b", "rwkv6-7b")
# the reference's capacity factor for decode against the full forward
DECODE_CAPACITY = 16.0
TOL = 1e-4
TOL_DECODE_FULL = 5e-2
TOL_DECODE_REF = 1e-3


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _random_biases(tree, rs):
    if not isinstance(tree, dict):
        return tree
    return {k: (rs.randn(*v.shape) * 0.1).astype(np.float32)
            if k == "bias" else _random_biases(v, rs) for k, v in tree.items()}


def _override(cfg, d_head, capacity_factor):
    if d_head is not None:
        cfg = cfg.replace(d_head=d_head)
    if capacity_factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


@functools.lru_cache(maxsize=None)
def _model(arch, mixer=None, d_head=None, capacity_factor=None):
    """(ref_cfg, ref_params, cfg, params) of the reduced arch, with
    ``d_head`` and the MoE ``capacity_factor`` overridden in both packages
    when given."""
    ref_cfg = _override(ref_get_config(arch, reduced=True, mixer=mixer),
                        d_head, capacity_factor)
    cfg = _override(get_config(arch, reduced=True, mixer=mixer), d_head,
                    capacity_factor)
    tree = jax.device_get(ref_init_params(ref_lm.lm_specs(ref_cfg),
                                          jax.random.key(0)))
    tree = _random_biases(tree, np.random.RandomState(7))
    ref_params = jax.tree.map(jnp.asarray, tree)
    return ref_cfg, ref_params, cfg, from_jax_params(tree, lm.lm_specs(cfg),
                                                     device="cpu")


def _inputs(cfg, B=2, n=16, seed=0):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg.vocab, (B, n))
    labels = rs.randint(0, cfg.vocab, (B, n))
    labels[0, :3] = -1  # ignored positions
    vis = (rs.randn(B, cfg.vis_tokens, cfg.d_model) * 0.1).astype(
        np.float32) if cfg.vis_tokens else None
    return tokens, labels, vis


def test_archs_registered():
    from repro.configs import list_archs as ref_list_archs

    assert list_archs() == ref_list_archs()  # all 11, whisper-small too
    for arch in ARCHS + ("whisper-small",):
        ref, cfg = ref_get_config(arch), get_config(arch)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "mixer", "mlp", "qkv_bias", "tie_embeddings",
                  "rope_theta", "vis_tokens", "remat", "dtype", "head_dim",
                  "group_size", "attn_index", "rwkv_head_dim", "param_dtype",
                  "moment_dtype", "grad_accum_dtype", "attn_free",
                  "enc_layers", "enc_frames"):
            assert getattr(cfg, f) == getattr(ref, f), (arch, f)
        for sub in ("moe", "mamba"):
            a, b = getattr(cfg, sub), getattr(ref, sub)
            assert (a is None) == (b is None), (arch, sub)
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b), arch


@pytest.mark.parametrize("arch, d_head", [(a, None) for a in ARCHS]
                         + [("qwen3-moe-30b-a3b", 32)],
                         ids=list(ARCHS) + ["qwen3-moe-30b-a3b-d_head32"])
def test_arch_logits_loss_and_grads_match_reference(arch, d_head):
    ref_cfg, ref_params, cfg, params = _model(arch, d_head=d_head)
    tokens, labels, vis = _inputs(cfg)
    jvis = None if vis is None else jnp.asarray(vis)
    tvis = None if vis is None else torch.from_numpy(vis)
    want = jax.jit(lambda p: ref_lm.lm_apply(
        p, jnp.asarray(tokens), ref_cfg, vis_embed=jvis)[0])(ref_params)
    got, _, _ = lm.lm_apply(params, torch.from_numpy(tokens), cfg,
                            vis_embed=tvis)
    assert got.shape == (2, 16 + cfg.vis_tokens, cfg.vocab)
    assert _rel(got, want) <= TOL
    if cfg.group_size:
        ref_e, got_e = _layer_routes(ref_params, ref_cfg, params, cfg, tokens)
        assert len(got_e) == len(ref_e) == cfg.n_layers // cfg.moe.every
        for a, b in zip(got_e, ref_e):
            assert torch.equal(a, torch.from_numpy(
                np.asarray(b).astype(np.int64)))
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.lm_loss(p, jnp.asarray(tokens), jnp.asarray(labels),
                                 ref_cfg, vis_embed=jvis),
        has_aux=True))(ref_params)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    if vis is not None:
        batch["vis_embed"] = tvis
    # the train step's gradient, vis_embed passed through
    loss, _, _, grads = accumulate_grads(params, batch, cfg)
    assert _rel(loss, ref_loss) <= TOL
    ref_g = dict(leaf_paths(jax.device_get(ref_grads)))
    got_g = dict(leaf_paths(grads))
    assert set(ref_g) == set(got_g)
    for path, g in got_g.items():
        assert _rel(g, ref_g[path]) <= TOL, "/".join(path)


def _layer_routes(ref_params, ref_cfg, params, cfg, tokens):
    """Every MoE layer's expert ids in a train-mode forward, in layer
    order: ``(reference's, port's)``.  The reference's come from its
    ``layer_apply`` called position by position in one jitted function
    that returns them (its group scan would keep them inside the scan),
    each MoE call's routing recomputed from the call's own input as
    ``moe_apply`` computes it."""
    from repro.models import moe as ref_moe
    from repro_torch.models import moe

    ref_seen, seen = [], []
    ref_made, made = ref_moe.moe_apply, moe.route

    def ref_apply(p, x, c):
        logits = jnp.einsum("bnd,de->bne", x.astype(jnp.float32),
                            p["router"]["kernel"].astype(jnp.float32))
        ref_seen.append(jax.lax.top_k(jax.nn.softmax(logits, -1),
                                      c.moe.top_k)[1])
        return ref_made(p, x, c)

    def route(*a, **kw):
        out = made(*a, **kw)
        seen.append(out[2])
        return out

    def ref_forward(rp, toks):
        x = rp["embed"]["embedding"][toks].astype(jnp.dtype(ref_cfg.dtype))
        pos = jnp.arange(toks.shape[1])[None]
        for g in range(ref_cfg.n_layers // ref_cfg.group_size):
            gp = jax.tree.map(lambda t: t[g], rp["groups"])
            for i, (op, use_moe) in enumerate(ref_lm._group_layout(ref_cfg)):
                x, _, _ = ref_lm.layer_apply(gp[f"pos{i}"], x, ref_cfg, op,
                                             use_moe, positions=pos)
        return list(ref_seen)

    ref_moe.moe_apply, moe.route = ref_apply, route
    try:
        ref_e = jax.jit(ref_forward)(ref_params, jnp.asarray(tokens))
        lm.lm_apply(params, torch.from_numpy(tokens), cfg)
    finally:
        ref_moe.moe_apply, moe.route = ref_made, made
    return ref_e, seen


def _decode(apply, tokens, states, start, to_x):
    """Decode ``tokens[:, start:]`` one at a time through ``apply(tokens,
    states, positions) -> (logits, states, ...)``; the logits per step."""
    outs = []
    for t in range(start, tokens.shape[1]):
        pos = np.full((tokens.shape[0], 1), t)
        res = apply(to_x(tokens[:, t:t + 1]), states, to_x(pos))
        outs.append(res[0])
        states = res[1]
    return outs


@pytest.mark.parametrize("arch, cut", [
    ("codeqwen1.5-7b", 0), ("qwen2-72b", 8),
    ("granite-moe-3b-a800m", 0), ("qwen3-moe-30b-a3b", 8)],
    ids=["decode_all", "prefill_then_decode", "moe_decode_all",
         "moe_prefill_then_decode"])
def test_decode_continues_full_forward(arch, cut):
    """From empty states (``cut`` 0, 8 decode steps) or after an 8-token
    prefill (4 decode steps): decode logits equal the full forward's at the
    reference's tolerance and the reference's decode at ``TOL_DECODE_REF``;
    the port's decode writes the caches in place.  MoE configs at
    ``DECODE_CAPACITY``."""
    moe = get_config(arch).moe is not None
    ref_cfg, ref_params, cfg, params = _model(
        arch, capacity_factor=DECODE_CAPACITY if moe else None)
    tokens, _, _ = _inputs(cfg, n=12 if cut else 8, seed=1)
    B, n = tokens.shape
    full, _, _ = lm.lm_apply(params, torch.from_numpy(tokens), cfg)
    if cut:
        _, ref_st, _ = ref_lm.lm_apply(ref_params,
                                       jnp.asarray(tokens[:, :cut]), ref_cfg,
                                       mode="prefill")
        _, st, _ = lm.lm_apply(params, torch.from_numpy(tokens[:, :cut]), cfg,
                               mode="prefill")
        assert st.k.shape[3] == cut + 64  # prefill allocates n + 64
    else:
        ref_st = ref_lm.lm_init_states(ref_cfg, B, n)
        st = lm.lm_init_states(cfg, B, "cpu", max_len=n)
    ref_step = jax.jit(lambda t, s, pos: ref_lm.lm_apply(
        ref_params, t, ref_cfg, states=s, positions=pos, mode="decode"))
    want = jnp.concatenate(_decode(ref_step, tokens, ref_st, cut,
                                   jnp.asarray), 1)
    got = torch.cat(_decode(
        lambda t, s, pos: lm.lm_apply(params, t, cfg, states=s,
                                      positions=pos, mode="decode"),
        tokens, st, cut, torch.from_numpy), 1)
    assert st.length.tolist() == [n] * cfg.n_layers
    assert _rel(got, full[:, cut:]) <= TOL_DECODE_FULL
    assert _rel(got, want) <= TOL_DECODE_REF


@pytest.mark.parametrize("arch, cut, tol", [
    ("rwkv6-7b", 0, TOL), ("jamba-1.5-large-398b", 8, TOL_DECODE_FULL)],
    ids=["rwkv6_decode_all", "hybrid_prefill_then_decode"])
def test_new_arch_decode_continues_full_forward(arch, cut, tol):
    """rwkv6-7b token by token from zero states (fp32 throughout, so at the
    fp32 tolerance); jamba after an 8-token prefill, at the reference's
    capacity factor and its tolerance (the attention position reads the
    bf16 KV cache).  Both equal the reference's decode; decode updates the
    states in place."""
    moe = get_config(arch).moe is not None
    ref_cfg, ref_params, cfg, params = _model(
        arch, capacity_factor=DECODE_CAPACITY if moe else None)
    tokens, _, _ = _inputs(cfg, n=12 if cut else 8, seed=1)
    B, n = tokens.shape
    full, _, _ = lm.lm_apply(params, torch.from_numpy(tokens), cfg)
    if cut:
        _, ref_st, _ = ref_lm.lm_apply(ref_params,
                                       jnp.asarray(tokens[:, :cut]), ref_cfg,
                                       mode="prefill")
        _, st, _ = lm.lm_apply(params, torch.from_numpy(tokens[:, :cut]), cfg,
                               mode="prefill")
    else:
        ref_st = ref_lm.lm_init_states(ref_cfg, B, n)
        st = lm.lm_init_states(cfg, B, "cpu", max_len=n)
    ref_step = jax.jit(lambda t, s, pos: ref_lm.lm_apply(
        ref_params, t, ref_cfg, states=s, positions=pos, mode="decode"))
    want = jnp.concatenate(_decode(ref_step, tokens, ref_st, cut,
                                   jnp.asarray), 1)
    kept = st
    got = torch.cat(_decode(
        lambda t, s, pos: lm.lm_apply(params, t, cfg, states=s,
                                      positions=pos, mode="decode"),
        tokens, st, cut, torch.from_numpy), 1)
    assert kept is st
    if cfg.group_size:
        assert sorted(st) == [f"pos{i}" for i in range(cfg.group_size)]
        assert st["pos4"].length.tolist() == [n] * (cfg.n_layers //
                                                    cfg.group_size)
    assert _rel(got, full[:, cut:]) <= tol
    assert _rel(got, want) <= TOL_DECODE_REF


DROPIN = (("qwen2-72b", "hla2", None), ("deepseek-67b", "ahla", None),
          ("nemotron-4-15b", "hla3", None),
          ("codeqwen1.5-7b", "linattn", None),
          ("granite-moe-3b-a800m", "hla2", None),
          ("qwen3-moe-30b-a3b", "hla2", 32),
          ("jamba-1.5-large-398b", "hla2", None))


@pytest.mark.parametrize(
    "arch, mixer, d_head", DROPIN,
    ids=[f"{a}-{m}" + (f"-d_head{d}" if d else "") for a, m, d in DROPIN])
def test_hla_dropin_override_matches_reference(arch, mixer, d_head):
    """Paper Section 5.2: an HLA mixer in place of the attention sublayer,
    the HLA records carrying qkv biases where the arch has them (the MoE
    configs' loss with its aux term)."""
    ref_cfg, ref_params, cfg, params = _model(arch, mixer, d_head)
    assert cfg.mixer == mixer
    layer = params["groups"][f"pos{cfg.attn_index}"] if cfg.group_size \
        else params["layers"]
    has_bias = "bias" in layer["mixer"]["wq"]
    assert has_bias == cfg.qkv_bias
    tokens, labels, _ = _inputs(cfg, seed=2)
    ref_loss, _ = jax.jit(lambda p: ref_lm.lm_loss(
        p, jnp.asarray(tokens), jnp.asarray(labels), ref_cfg))(ref_params)
    loss, _ = lm.lm_loss(params, torch.from_numpy(tokens),
                         torch.from_numpy(labels), cfg)
    assert _rel(loss, ref_loss) <= TOL


def test_engine_rejects_attn():
    _, _, cfg, params = _model("codeqwen1.5-7b")
    with pytest.raises(ValueError, match="streaming-state ops"):
        Engine(cfg, params, slots=2, max_len=32, device="cpu")


def test_hybrid_group_remat_matches_no_remat():
    """``remat="full"`` on a hybrid stack recomputes a whole group (Mamba's
    per-chunk recompute nested inside): the loss and every gradient leaf
    equal the run without remat, and the hla2 position's forward runs
    twice a group (the forward, the recompute), its backward once."""
    from repro_torch.kernels import hla2_chunk

    _, _, cfg, params = _model("jamba-1.5-large-398b", "hla2")
    tokens, labels, _ = _inputs(cfg, seed=3)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    calls = []
    made = hla2_chunk.hla2_chunk_fwd_plain

    def counted(*a, **kw):
        calls.append(1)
        return made(*a, **kw)

    out = {}
    for remat in ("none", "full"):
        calls.clear()
        hla2_chunk.hla2_chunk_fwd_plain = counted
        try:
            out[remat] = accumulate_grads(params, batch,
                                          cfg.replace(remat=remat))
        finally:
            hla2_chunk.hla2_chunk_fwd_plain = made
        out[remat + "_fwd"] = len(calls)
    assert (out["none_fwd"], out["full_fwd"]) == (1, 2)
    assert torch.equal(out["none"][0], out["full"][0])
    want = dict(leaf_paths(out["none"][3]))
    for path, g in leaf_paths(out["full"][3]):
        assert _rel(g, want[path].numpy()) <= 1e-6, "/".join(path)


@pytest.mark.parametrize("mixer", [None, "hla2"], ids=["attn", "hla2"])
def test_engine_rejects_hybrid_stack(mixer):
    """jamba's groups share a pooled state length across slots whatever
    its attention position holds; the reference's engine refuses it
    too, with the same message."""
    from repro.serving.engine import Engine as RefEngine

    ref_cfg, ref_params, cfg, params = _model("jamba-1.5-large-398b", mixer)
    with pytest.raises(ValueError, match="group_size=8") as got:
        Engine(cfg, params, slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="group_size=8") as want:
        RefEngine(ref_cfg, ref_params, slots=2, max_len=32)
    assert str(got.value) == str(want.value)


def test_rwkv6_rejects_mixer_override():
    for get in (get_config, ref_get_config):
        with pytest.raises(ValueError, match="attention-free"):
            get("rwkv6-7b", reduced=True, mixer="hla2")
    assert get_config("rwkv6-7b", mixer="rwkv6").mixer == "rwkv6"
