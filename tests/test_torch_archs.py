"""The five dense public configs (codeqwen1.5-7b, qwen2-72b, deepseek-67b,
nemotron-4-15b, internvl2-2b) at ``reduced()``, the port against the
reference with the reference's weights (``from_jax_params``; the qkv
biases, which the reference initialises to 0, drawn at random in both):

* logits, the loss and every gradient leaf (internvl2-2b with
  ``vis_embed``): the counterpart of ``tests/test_archs.py::
  test_arch_forward_and_train_step``;
* token-by-token decode equals the full forward (``:102``, codeqwen) and
  prefill then decode continues it (``:135``, on an ``attn`` config), and
  both equal the reference's decode;
* the drop-in overrides whose archs are ported (``:71``) against the
  reference's loss;
* ``Engine`` refuses ``attn`` (``tests/test_seq_op_registry.py:376``).

Tolerances, relative to max|want|: 1e-4 for fp32 against the reference
(as ``tests/test_torch_model.py``); decode against the full forward
5e-2, the reference's own (decode reads the bf16 KV cache, the full
forward unrounded K/V); port decode against reference decode 1e-3 (a
K/V element whose fp32 values differ in the last bit may round to
neighbouring bf16 values).
"""

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

ARCHS = ("codeqwen1.5-7b", "deepseek-67b", "internvl2-2b",
         "nemotron-4-15b", "qwen2-72b")
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


@functools.lru_cache(maxsize=None)
def _model(arch, mixer=None):
    """(ref_cfg, ref_params, cfg, params) of the reduced arch."""
    ref_cfg = ref_get_config(arch, reduced=True, mixer=mixer)
    cfg = get_config(arch, reduced=True, mixer=mixer)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_logits_loss_and_grads_match_reference(arch):
    ref_cfg, ref_params, cfg, params = _model(arch)
    tokens, labels, vis = _inputs(cfg)
    jvis = None if vis is None else jnp.asarray(vis)
    tvis = None if vis is None else torch.from_numpy(vis)
    want = jax.jit(lambda p: ref_lm.lm_apply(
        p, jnp.asarray(tokens), ref_cfg, vis_embed=jvis)[0])(ref_params)
    got, _ = lm.lm_apply(params, torch.from_numpy(tokens), cfg,
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
    loss, _, grads = accumulate_grads(params, batch, cfg)
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


@pytest.mark.parametrize("arch, cut", [("codeqwen1.5-7b", 0),
                                       ("qwen2-72b", 8)],
                         ids=["decode_all", "prefill_then_decode"])
def test_decode_continues_full_forward(arch, cut):
    """From empty states (``cut`` 0, 8 decode steps) or after an 8-token
    prefill (4 decode steps): decode logits equal the full forward's at the
    reference's tolerance and the reference's decode at ``TOL_DECODE_REF``;
    the port's decode writes the caches in place."""
    ref_cfg, ref_params, cfg, params = _model(arch)
    tokens, _, _ = _inputs(cfg, n=12 if cut else 8, seed=1)
    B, n = tokens.shape
    full, _ = lm.lm_apply(params, torch.from_numpy(tokens), cfg)
    if cut:
        _, ref_st, _ = ref_lm.lm_apply(ref_params,
                                       jnp.asarray(tokens[:, :cut]), ref_cfg,
                                       mode="prefill")
        _, st = lm.lm_apply(params, torch.from_numpy(tokens[:, :cut]), cfg,
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


@pytest.mark.parametrize("arch, mixer", [
    ("qwen2-72b", "hla2"), ("deepseek-67b", "ahla"),
    ("nemotron-4-15b", "hla3"), ("codeqwen1.5-7b", "linattn")])
def test_hla_dropin_override_matches_reference(arch, mixer):
    """Paper Section 5.2: an HLA mixer in place of the attention sublayer,
    the HLA records carrying qkv biases where the arch has them."""
    ref_cfg, ref_params, cfg, params = _model(arch, mixer)
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
