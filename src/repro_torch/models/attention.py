"""Softmax attention: blockwise (flash-style) GQA and KV-cache decode, and
the ``attn`` record (twin of ``repro/models/attention.py``).

``flash_attention`` never materializes the (n, n) score matrix: a Python
loop over KV blocks carries (acc, row_max, row_sum) in fp32, as the
reference's ``lax.scan`` does.  It is plain torch because the reference's
is plain jnp; the numerics are the reference's (probabilities stored in
bf16 for bf16 inputs, ``NEG_INF`` masking, a bf16 KV cache), which is why
no library attention call stands in for it.

A KV cache is one per layer, ``KVCache(k, v, length)`` with one ``length``
shared by every row.  The cache is written in place at ``length`` through
device-side indices and attended over its whole ``max_len`` under the
``kv_pos < kv_len`` mask, so a decode step never reads a value back to
the host.  Whisper's encoder attends with ``causal=False``, and its
decoder's cross-attention reads the encoder's K/V (``cross_kv_apply``)
through ``attention_apply(cross_kv=)``: no cache, no RoPE, all keys.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.shard_ops import call_sharded
from ..distributed.sharding import constrain, contiguous_stride, local_block
from . import seq_op
from .blocks import dense_apply, dense_specs, rope, split_heads
from .param import Axes

NEG_INF = -1e30


def attention_specs(cfg):
    d, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_specs(d, H * dh, axes=("embed", "q_heads_flat"),
                          bias=cfg.qkv_bias),
        "wk": dense_specs(d, Hk * dh, axes=("embed", "kv_heads_flat"),
                          bias=cfg.qkv_bias),
        "wv": dense_specs(d, Hk * dh, axes=("embed", "kv_heads_flat"),
                          bias=cfg.qkv_bias),
        "wo": dense_specs(H * dh, d, axes=("q_heads_flat", "embed")),
    }


def flash_attention(q, k, v, *, causal: bool = True, kv_block: int = 512,
                    q_offset=0, kv_len: Optional[torch.Tensor] = None):
    """Blockwise softmax attention with online renormalization.

    ``q (B, H, nq, dh)``, ``k``/``v (B, Hk, nk, dh)``; query head ``h``
    reads KV head ``h // (H // Hk)``.  ``q_offset`` is the absolute
    position of ``q[..., 0, :]`` (causal masking) and ``kv_len`` the
    number of valid keys (decode masking); either may be a device tensor.
    Inputs and probabilities are stored in bf16 for bf16 inputs, else in
    fp32; products, sums and ``acc`` are fp32.
    """
    score_dtype = torch.bfloat16 if q.dtype == torch.bfloat16 \
        else torch.float32
    B, H, nq, dh = q.shape
    Hk, nk = k.shape[1], k.shape[2]
    G = H // Hk
    # (B, Hk, G * nq, dh): query head h = hk * G + g
    qg = q.to(score_dtype).reshape(B, Hk, G * nq, dh).float()
    scale = 1.0 / math.sqrt(dh)
    blk = min(kv_block, nk)
    if nk % blk:  # pad the keys to a block multiple (masked out below)
        pad = blk - nk % blk
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    dev = q.device
    q_pos = q_offset + torch.arange(nq, device=dev)
    blk_pos = torch.arange(blk, device=dev)
    valid_len = kv_len if kv_len is not None else nk
    acc = torch.zeros((B, Hk, G * nq, dh), dtype=torch.float32, device=dev)
    mx = torch.full((B, Hk, G, nq), NEG_INF, dtype=torch.float32,
                    device=dev)
    sm = torch.zeros((B, Hk, G, nq), dtype=torch.float32, device=dev)
    for start in range(0, k.shape[2], blk):
        kv_pos = start + blk_pos
        kb = k[:, :, start:start + blk].to(score_dtype).float()
        vb = v[:, :, start:start + blk].to(score_dtype).float()
        s = ((qg @ kb.transpose(-1, -2)) * scale).view(B, Hk, G, nq, blk)
        mask = kv_pos[None, :] < valid_len
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, NEG_INF)
        new_mx = torch.maximum(mx, s.amax(-1))
        # probabilities stored in score_dtype; sums and acc in fp32
        p = torch.exp(s - new_mx[..., None]).to(score_dtype).float()
        corr = torch.exp(mx - new_mx)
        sm = sm * corr + p.sum(-1)
        acc = acc * corr.reshape(B, Hk, G * nq, 1) + \
            p.reshape(B, Hk, G * nq, blk) @ vb
        mx = new_mx
    out = acc / sm.reshape(B, Hk, G * nq, 1).clamp_min(1e-30)
    return out.reshape(B, H, nq, dh).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Hk, max_len, dh)
    v: torch.Tensor  # (B, Hk, max_len, dh)
    length: torch.Tensor  # () int32: tokens currently valid, every row


def init_kv_cache(B, Hk, max_len, dh, device="cuda") -> KVCache:
    """An empty cache.  K/V are bf16 whatever the activations are, as the
    reference's (its ``attn`` record passes no dtype)."""
    bf16 = torch.bfloat16
    return KVCache(
        k=torch.zeros((B, Hk, max_len, dh), dtype=bf16, device=device),
        v=torch.zeros((B, Hk, max_len, dh), dtype=bf16, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def _kv_for_heads(q, kv):
    """``kv (B, Hk, m, dh)`` as ``q (B, H, ...)``'s head split needs it.
    Under a mesh whose "model" split of the query heads does not fall on
    KV-head boundaries (64 query heads and 8 KV heads on 16 ranks), each
    rank takes the KV head of each of its own query heads (``H / Hk``
    copies, the GQA broadcast), so the attention of a rank's heads stays
    on that rank; otherwise ``kv`` as it is."""
    if not isinstance(q, DTensor) or not isinstance(kv, DTensor):
        return kv
    H, Hk = q.shape[1], kv.shape[1]
    mesh = q.device_mesh
    sizes, coord = list(mesh.shape), mesh.get_coordinate()
    over = [i for i, pl in enumerate(q.placements) if pl.is_shard(1)]
    split = math.prod(sizes[i] for i in over)
    if H == Hk or split == 1 or Hk % split == 0:
        return kv
    rep = tuple(Replicate() if pl.is_shard(1) else pl for pl in kv.placements)
    # each rank's gradient holds its own query heads' share: a sum over the
    # head split
    loc = kv.redistribute(mesh, rep).to_local(grad_placements=tuple(
        Partial() if i in over else p for i, p in enumerate(rep)))
    first = 0
    for i in over:
        first = first * sizes[i] + coord[i]
    Hl = H // split
    heads = (torch.arange(Hl, device=loc.device) + first * Hl) // (H // Hk)
    pl = tuple(Shard(1) if i in over else p for i, p in enumerate(rep))
    shape = (kv.shape[0], H) + tuple(kv.shape[2:])
    return DTensor.from_local(loc[:, heads], mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _write_cache(buf, idx, new):
    """``buf[:, :, idx] = new`` in place (``index_copy_`` along time).  On
    a mesh each rank writes its own block: ``new`` is brought to the
    cache's placements (batch and KV heads; time is never split) and the
    copy is local, which needs no DTensor rule for ``index_copy_``."""
    new = new.to(buf.dtype)
    if not isinstance(buf, DTensor):
        buf.index_copy_(2, idx, new)
        return
    if isinstance(new, DTensor):
        new = new.redistribute(buf.device_mesh, buf.placements).to_local()
    else:
        new = local_block(new, buf.device_mesh, buf.placements)
    if isinstance(idx, DTensor):
        idx = idx.full_tensor()
    buf.to_local().index_copy_(2, idx, new)


def attention_apply(p, x, cfg, *, positions=None,
                    cache: Optional[KVCache] = None, cross_kv=None,
                    causal: bool = True, use_rope: bool = True):
    """Self- or cross-attention sublayer over ``x (B, n, d_model)``.

    Self-attention (``cross_kv`` None) attends causally unless ``causal``
    is False (whisper's encoder).  With a ``cache``, K/V are written into
    it at ``cache.length`` and ``cache.length`` advances by n, in place;
    attention then runs over the whole cache.  Cross-attention projects
    only q and attends over ``cross_kv = (k, v)``, each ``(B, Hk, ne,
    dh)``, non-causally, with no cache and no RoPE.  Returns ``(out,
    cache)`` (``cache`` None without one)."""
    B, n, _ = x.shape
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(dense_apply(p["wq"], x), H, dh)
    if cross_kv is not None:
        kc, vc = cross_kv
        q = q.transpose(1, 2)
        out = call_sharded(functools.partial(flash_attention, causal=False),
                           q, _kv_for_heads(q, kc), _kv_for_heads(q, vc))
        out = constrain(_merge_heads(out), ("batch", None, "q_heads_flat"))
        return dense_apply(p["wo"], out), None
    if positions is None:
        positions = torch.arange(n, device=x.device)[None]
    k = split_heads(dense_apply(p["wk"], x), Hk, dh)
    v = split_heads(dense_apply(p["wv"], x), Hk, dh)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = constrain(q.transpose(1, 2), ("batch", "q_heads", None, None))
    k = constrain(k.transpose(1, 2), ("batch", "kv_heads", None, None))
    v = constrain(v.transpose(1, 2), ("batch", "kv_heads", None, None))
    if cache is None:
        out = call_sharded(functools.partial(flash_attention, causal=causal),
                           q, _kv_for_heads(q, k), _kv_for_heads(q, v))
    else:
        max_len = cache.k.shape[2]
        if n > max_len:
            raise ValueError(f"{n} tokens do not fit a KV cache of "
                             f"{max_len}")
        # the reference's dynamic_update_slice: the start clamps so the
        # block fits
        start = cache.length.clamp(0, max_len - n).long()
        idx = start + torch.arange(n, device=x.device)
        _write_cache(cache.k, idx, k)
        _write_cache(cache.v, idx, v)
        q_offset = cache.length.clone()
        cache.length.add_(n)
        out = call_sharded(
            lambda q_, k_, v_, off, n_: flash_attention(
                q_, k_, v_, causal=causal, q_offset=off, kv_len=n_),
            q, _kv_for_heads(q, cache.k), _kv_for_heads(q, cache.v),
            q_offset, cache.length)
    out = constrain(_merge_heads(out), ("batch", None, "q_heads_flat"))
    return dense_apply(p["wo"], out), cache


def _merge_heads(out):
    """``(B, H, n, dh)`` -> ``(B, n, H * dh)``.  One token goes through its
    row, a plain view laid out alike on one device and on a mesh, so the
    output projection runs the same GEMM either way."""
    B, H, n, dh = out.shape
    if n == 1:
        return out[:, :, 0].reshape(B, 1, H * dh)
    return out.transpose(1, 2).reshape(B, n, H * dh)


# --------------------------------------------------------------------------
# SequenceOp registration: softmax attention as "attn"
# --------------------------------------------------------------------------


def _attn_forward(p, x, cfg, *, state=None, want_state=False,
                  positions=None):
    """Train (``state`` None) or prefill/decode (``state`` a ``KVCache``,
    filled in place at ``state.length``; decode is this forward over one
    token, so the record needs no ``step``)."""
    return attention_apply(p, x, cfg, positions=positions, cache=state)


def kv_cache_axes() -> KVCache:
    """Logical axes of the cache's leaves: batch over data, KV heads over
    model, time and features replicated; the shared ``length`` scalar
    replicated."""
    return KVCache(k=Axes(("batch", "kv_heads", None, None)),
                   v=Axes(("batch", "kv_heads", None, None)),
                   length=Axes(()))


def _attn_init_state(cfg, B, device, max_len=0):
    return init_kv_cache(B, cfg.n_kv_heads, max_len, cfg.head_dim,
                         device=device)


seq_op.register_op(seq_op.SequenceOp(
    name="attn",
    specs=attention_specs,
    forward=_attn_forward,
    init_state=_attn_init_state,
    state_axes=lambda cfg: kv_cache_axes(),
    streaming=False,  # the cache grows with the context and its one
    #   ``length`` is shared by every row, so the engine's per-slot
    #   continuous batching cannot admit it
    spec_decodable=False,
    needs_positions=True,
    prealloc_state=True,  # prefill fills a preallocated cache
))


def cross_kv_specs(cfg):
    d, Hk, dh = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    return {"wk": dense_specs(d, Hk * dh, axes=("embed", "kv_heads_flat")),
            "wv": dense_specs(d, Hk * dh, axes=("embed", "kv_heads_flat"))}


def cross_kv_apply(p, enc_out, cfg):
    """The encoder output's K/V for cross-attention, each ``(B, Hk, ne,
    dh)`` in ``enc_out``'s dtype."""
    Hk, dh = cfg.n_kv_heads, cfg.head_dim
    spec = ("batch", "kv_heads", None, None)
    k = split_heads(dense_apply(p["wk"], enc_out), Hk, dh)
    v = split_heads(dense_apply(p["wv"], enc_out), Hk, dh)
    return constrain(k.transpose(1, 2), spec), constrain(v.transpose(1, 2),
                                                         spec)
