"""Softmax attention in the port (``repro_torch/models/attention.py``,
``blocks.rope``) against the reference's (``repro/models/attention.py``,
``repro/models/blocks.py``), on the same numpy inputs and weights.

* ``flash_attention``: causal and not, GQA (G = 2), keys not a multiple of
  ``kv_block``, ``q_offset``/``kv_len`` decode masking with device
  tensors, bf16 inputs;
* ``rope`` at ``rope_theta`` 1e6, with and without a heads dim;
* ``attention_apply`` with a KV cache: K/V written at ``length`` (a bf16
  cache whatever the activations), ``length`` advanced in place, a prefill
  then a decode step;
* an ``attn`` decode step through ``lm_apply`` reads nothing back to the
  host (the contracts' transfer counter).

Tolerances, relative to max|want|: fp32 1e-5 (summation order only);
bf16 1e-2 (one bf16 rounding of the output or a stored probability);
rope 1e-4 (fp32 angles up to ~1e3 rad: one ulp of a frequency moves an
angle by ~6e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models.param import init_params as ref_init_params
from repro_torch.analysis.contracts import _watch
from repro_torch.configs import get_config
from repro_torch.models import attention, lm
from repro_torch.models.blocks import rope
from repro_torch.models.param import from_jax_params, init_params

TOL_FP32 = 1e-5
TOL_BF16 = 1e-2
TOL_ROPE = 1e-4


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pair(x, dtype):
    """The same values as a reference array and a port tensor."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(dtype)


# (B, H, Hk, nq, nk, causal, kv_block, q_offset, kv_len, dtype)
CASES = {
    "causal": (2, 4, 4, 13, 13, True, 8, None, None, torch.float32),
    "noncausal": (2, 4, 4, 13, 13, False, 8, None, None, torch.float32),
    "gqa": (2, 4, 2, 13, 13, True, 8, None, None, torch.float32),
    "one_block": (1, 2, 1, 7, 7, True, 512, None, None, torch.float32),
    "decode_mask": (2, 4, 2, 1, 16, True, 8, 10, 11, torch.float32),
    "prefill_in_cache": (2, 4, 2, 5, 16, True, 8, 3, 8, torch.float32),
    "bf16": (2, 4, 2, 13, 13, True, 8, None, None, torch.bfloat16),
    "bf16_decode": (2, 4, 2, 1, 20, True, 8, 12, 13, torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_reference(case):
    B, H, Hk, nq, nk, causal, blk, q_off, kv_len, dt = CASES[case]
    rs = np.random.RandomState(sorted(CASES).index(case))
    dh = 8
    q = rs.randn(B, H, nq, dh).astype(np.float32)
    k = rs.randn(B, Hk, nk, dh).astype(np.float32)
    v = rs.randn(B, Hk, nk, dh).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dt) for x in (q, k, v))
    ref_kw, kw = dict(causal=causal, kv_block=blk), dict(causal=causal,
                                                         kv_block=blk)
    if q_off is not None:  # the decode path passes device scalars
        ref_kw.update(q_offset=jnp.int32(q_off), kv_len=jnp.int32(kv_len))
        kw.update(q_offset=torch.tensor(q_off, dtype=torch.int32),
                  kv_len=torch.tensor(kv_len, dtype=torch.int32))
    want = ref_attn.flash_attention(jq, jk, jv, **ref_kw)
    got = attention.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == dt
    tol = TOL_BF16 if dt == torch.bfloat16 else TOL_FP32
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "flat"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_rope_matches_reference(heads, dtype):
    rs = np.random.RandomState(3)
    shape = (2, 9, 3, 16) if heads else (2, 9, 16)
    x = rs.randn(*shape).astype(np.float32)
    pos = rs.randint(0, 1000, (2, 9))
    jx, tx = _pair(x, dtype)
    want = ref_blocks.rope(jx, jnp.asarray(pos), 1e6)
    got = rope(tx, torch.from_numpy(pos), 1e6)
    assert got.dtype == dtype
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_ROPE
    assert _rel(got, want) <= tol


def _attn_model(arch):
    """(ref_cfg, ref_params, cfg, params) of one reduced ``attn`` sublayer,
    the qkv biases drawn at random (the reference initialises them 0)."""
    ref_cfg = ref_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    ref_p = jax.device_get(ref_init_params(ref_attn.attention_specs(ref_cfg),
                                           jax.random.key(0)))
    rs = np.random.RandomState(1)
    for name in ("wq", "wk", "wv"):
        if "bias" in ref_p[name]:
            ref_p[name]["bias"] = (rs.randn(*ref_p[name]["bias"].shape)
                                   * 0.1).astype(np.float32)
    params = from_jax_params(ref_p, attention.attention_specs(cfg),
                             device="cpu")
    return ref_cfg, ref_p, cfg, params


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "qwen2-72b"])
def test_attention_apply_with_cache_matches_reference(arch):
    """A 6-token prefill into a 16-slot cache, then one decode token: the
    outputs, the bf16 K/V written at ``length``, and ``length``; the port
    writes in place and returns the same cache."""
    ref_cfg, ref_p, cfg, params = _attn_model(arch)
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 7, cfg.d_model) * 0.5).astype(np.float32)
    B, Hk, dh = 2, cfg.n_kv_heads, cfg.head_dim
    ref_cache = ref_attn.init_kv_cache(B, Hk, 16, dh)
    cache = attention.init_kv_cache(B, Hk, 16, dh, device="cpu")
    assert cache.k.dtype == torch.bfloat16
    assert ref_cache.k.dtype == jnp.bfloat16
    ref_apply = jax.jit(lambda x_, pos, c: ref_attn.attention_apply(
        ref_p, x_, ref_cfg, positions=pos, cache=c))
    for lo, hi in ((0, 6), (6, 7)):
        pos = np.broadcast_to(np.arange(lo, hi), (B, hi - lo))
        want, ref_cache = ref_apply(jnp.asarray(x[:, lo:hi]),
                                    jnp.asarray(pos), ref_cache)
        got, same = attention.attention_apply(
            params, torch.from_numpy(x[:, lo:hi]), cfg,
            positions=torch.from_numpy(pos.copy()), cache=cache)
        assert same is cache and int(cache.length) == hi
        assert _rel(got, want) <= TOL_FP32
        for a, b in ((cache.k, ref_cache.k), (cache.v, ref_cache.v)):
            assert _rel(a, b) <= TOL_BF16
            assert not a[:, :, hi:].any()  # nothing written past length
    # without a cache (train mode) K/V are not rounded to bf16
    want, _ = jax.jit(lambda x_: ref_attn.attention_apply(
        ref_p, x_, ref_cfg))(jnp.asarray(x))
    got, none = attention.attention_apply(params, torch.from_numpy(x), cfg)
    assert none is None and _rel(got, want) <= TOL_FP32


def test_attn_decode_step_makes_no_host_transfer():
    """One ``lm_apply(mode="decode")`` step with ``attn`` after a prefill:
    the KV write and the masks index by device tensors, so no ``.item()``,
    ``.cpu()``, ``.tolist()`` or ``.numpy()`` is called."""
    cfg = get_config("codeqwen1.5-7b", reduced=True)
    params = init_params(lm.lm_specs(cfg), 0, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 9),
                        generator=torch.Generator().manual_seed(0))
    _, states = lm.lm_prefill(params, tok[:, :8], cfg)
    pos = torch.full((2, 1), 8)
    with _watch(torch.device("cpu")) as w:
        logits, out, _ = lm.lm_apply(params, tok[:, 8:], cfg, states=states,
                                     positions=pos, mode="decode")
    assert out is states and logits.shape == (2, 1, cfg.vocab)
    assert sum(w.transfers.values()) == 0, dict(w.transfers)
    assert states.length.tolist() == [9] * cfg.n_layers
    with pytest.raises(ValueError, match="positions"):
        lm.lm_apply(params, tok[:, 8:], cfg, states=states, mode="decode")
