"""The seven public configs (the dense codeqwen1.5-7b, qwen2-72b,
deepseek-67b, nemotron-4-15b, internvl2-2b; the MoE granite-moe-3b-a800m and
qwen3-moe-30b-a3b) at ``reduced()``, the port against the reference with
the reference's weights (``from_jax_params``; the qkv biases, which the
reference initialises to 0, drawn at random in both):

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
* ``Engine`` refuses ``attn`` (``tests/test_seq_op_registry.py:376``).

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
         "internvl2-2b", "nemotron-4-15b", "qwen2-72b", "qwen3-moe-30b-a3b")
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
    assert set(ARCHS) < set(list_archs())
    for arch in ARCHS:
        ref, cfg = ref_get_config(arch), get_config(arch)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "mixer", "mlp", "qkv_bias", "tie_embeddings",
                  "rope_theta", "vis_tokens", "remat", "dtype", "head_dim"):
            assert getattr(cfg, f) == getattr(ref, f), (arch, f)
        assert (cfg.moe is None) == (ref.moe is None), arch
        if cfg.moe is not None:
            assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(
                ref.moe), arch


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


DROPIN = (("qwen2-72b", "hla2", None), ("deepseek-67b", "ahla", None),
          ("nemotron-4-15b", "hla3", None),
          ("codeqwen1.5-7b", "linattn", None),
          ("granite-moe-3b-a800m", "hla2", None),
          ("qwen3-moe-30b-a3b", "hla2", 32))


@pytest.mark.parametrize(
    "arch, mixer, d_head", DROPIN,
    ids=[f"{a}-{m}" + (f"-d_head{d}" if d else "") for a, m, d in DROPIN])
def test_hla_dropin_override_matches_reference(arch, mixer, d_head):
    """Paper Section 5.2: an HLA mixer in place of the attention sublayer,
    the HLA records carrying qkv biases where the arch has them (the MoE
    configs' loss with its aux term)."""
    ref_cfg, ref_params, cfg, params = _model(arch, mixer, d_head)
    assert cfg.mixer == mixer
    has_bias = "bias" in params["layers"]["mixer"]["wq"]
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
