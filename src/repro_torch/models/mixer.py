"""The HLA mixer sublayers: the ``hla2``, ``ahla``, ``hla3``,
``hla3_paper`` and ``linattn`` records of ``repro/models/mixer.py``.

Multi-head projections around the operator's core: q scaled by
``head_dim**-0.5``, K/V heads repeated to the query heads (GQA), per-head
decay ``gamma = sigmoid(decay_a)`` (or fixed, or none), and a per-head RMS
output norm with a learned ``out_scale``.  Every record shares that wrapper
(``_sublayer_forward``, ``_sublayer_step``) and the parameter layout, and
differs only in its core calls.

``hla2`` and ``ahla`` run hand-written kernels.  The full-sequence path is
one chunk-parallel kernel launch per call: stateless for training
(``kernels.ops.hla2_attention``, ``ahla_attention``: one forward launch
with chunk checkpoints, then one backward launch), or returning the carry
for prefill (``hla2_prefill``, ``ahla_prefill``); the one-token path one
batched decode-step launch that updates the state in place
(``hla2_decode_step``, ``ahla_decode_step``).  With ``cfg.hla.impl ==
"scan"`` their full-sequence path is the paper's token-level associative
scan in plain torch (``hla2_scan``, ``ahla_scan``); decode stays the
kernel, as in the reference.  Every kernel call goes through
``distributed.shard_ops.call_sharded``: under a mesh (``sharding.use_mesh``)
each rank runs the kernel on its own (batch, head) row block, and q, k, v
and the output are constrained to their logical axes, as in the
reference; off-mesh it is the plain call.

``hla3`` (the exact third order), ``hla3_paper`` (Algorithm 4's chunk
path, at gamma = 1 whatever ``cfg.hla.decay`` says: its ``decay_a`` goes
unused) and ``linattn`` are plain torch at ``cfg.hla.chunk``, as the
reference's are plain jnp, and go through ``call_sharded`` as well, so
under a mesh each rank runs its (batch, head) rows.  Their steps are
functional; the shared step wrapper writes the new state into the
caller's tensors, since decode updates states in place.

The core functions are imported by name: ``repro_torch.core`` does not
re-export the front ends ``hla2``/``ahla``/``hla3``, so no submodule is
shadowed (the reference binds its submodules through ``importlib`` for
that reason).
"""

from __future__ import annotations

import functools
import types

import torch

from ..core.ahla import AHLAState, ahla_init_state, ahla_scan
from ..core.hla2 import HLA2State, hla2_init_state, hla2_scan
from ..core.hla3 import (
    HLA3ChunkState,
    HLA3ExactState,
    hla3_chunk_init_state,
    hla3_exact_chunkwise,
    hla3_exact_init_state,
    hla3_exact_step,
    hla3_paper_chunk_step,
    hla3_paper_chunkwise,
)
from ..core.linear_attn import (
    LinAttnState,
    linattn_chunkwise,
    linattn_init_state,
    linattn_step,
)
from ..distributed import shard_ops
from ..distributed.sharding import constrain
from ..kernels import ops as kops
from ..obs import costs
from . import seq_op
from .blocks import dense_apply, dense_specs, split_heads
from .param import Axes, Spec
from .state_tree import leaves

OUT_NORM_EPS = 1e-6
HLA_EPS = 1e-6


def mixer_specs(cfg):
    d, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": dense_specs(d, H * dh, axes=("embed", "q_heads_flat"),
                          bias=cfg.qkv_bias),
        "wk": dense_specs(d, Hk * dh, axes=("embed", "kv_heads_flat"),
                          bias=cfg.qkv_bias),
        "wv": dense_specs(d, Hk * dh, axes=("embed", "kv_heads_flat"),
                          bias=cfg.qkv_bias),
        "wo": dense_specs(H * dh, d, axes=("q_heads_flat", "embed")),
        "out_scale": Spec((H, dh), ("q_heads", "head_dim"), init="ones"),
    }
    if cfg.hla.decay == "learned":
        s["decay_a"] = Spec((H,), ("q_heads",), init="constant", const=3.0)
    return s


def _gamma(p, cfg, B, device):
    if cfg.hla.decay == "none":
        return None
    if cfg.hla.decay == "fixed":
        g = torch.full((cfg.n_heads,), cfg.hla.fixed_gamma,
                       dtype=torch.float32, device=device)
    else:
        g = torch.sigmoid(p["decay_a"].float())
    return g[None].expand(B, cfg.n_heads)


def _project(p, x, cfg):
    B, n, _ = x.shape
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(dense_apply(p["wq"], x), H, dh).transpose(1, 2)
    k = split_heads(dense_apply(p["wk"], x), Hk, dh).transpose(1, 2)
    v = split_heads(dense_apply(p["wv"], x), Hk, dh).transpose(1, 2)
    q = q * dh**-0.5
    if Hk != H:  # GQA: broadcast KV heads to query heads
        k = k.repeat_interleave(H // Hk, dim=1)
        v = v.repeat_interleave(H // Hk, dim=1)
    spec = ("batch", "q_heads", None, None)
    return constrain(q, spec), constrain(k, spec), constrain(v, spec)


def _out_norm(p, o):
    """Per-head RMS norm + learned scale (stabilizes unnormalized HLA)."""
    o32 = o.float()
    o32 = o32 * torch.rsqrt(o32.square().mean(-1, keepdim=True) + OUT_NORM_EPS)
    return (o32 * p["out_scale"][None, :, None, :]).to(o.dtype)


def _sublayer_forward(core_fwd):
    def forward(p, x, cfg, *, state=None, want_state=True):
        """Full-sequence path (train / prefill) over ``x (B, n, d_model)``;
        ``state`` is an optional carry to resume from.  Returns ``(y,
        final_state)``; with no carry in and none wanted (training) the
        final state is None."""
        B, n, _ = x.shape
        q, k, v = _project(p, x, cfg)
        o, st = core_fwd(q, k, v, _gamma(p, cfg, B, x.device), cfg.hla,
                         state=state,
                         want_state=want_state or state is not None)
        o = _out_norm(p, o.to(x.dtype))
        o = o.transpose(1, 2).reshape(B, n, cfg.n_heads * cfg.head_dim)
        o = constrain(o, ("batch", None, "q_heads_flat"))
        return dense_apply(p["wo"], o), st

    return forward


def _sublayer_step(core_step):
    def step(p, x_t, state, cfg):
        """One-token decode over ``x_t (B, 1, d_model)``; ``state`` is
        updated in place.  Returns ``(y, state)``."""
        B = x_t.shape[0]
        q, k, v = _project(p, x_t, cfg)
        new, o = core_step(state, q[:, :, 0], k[:, :, 0], v[:, :, 0],
                           _gamma(p, cfg, B, x_t.device), cfg.hla)
        for dst, src in zip(leaves(state), leaves(new)):
            if src is not dst:  # a functional core step: write its result
                dst.copy_(src)
        o = _out_norm(p, o[:, :, None, :].to(x_t.dtype))
        # (B, H, 1, dh) -> (B, 1, H * dh) through the one token's row: a
        # plain view, laid out alike on one device and on a mesh, so the
        # projection runs the same GEMM either way
        o = o[:, :, 0].reshape(B, 1, cfg.n_heads * cfg.head_dim)
        return dense_apply(p["wo"], o), state

    return step


# -- the kernel calls: each one goes through ``shard_ops.call_sharded``, so
# under a mesh every rank runs the kernel on its own (batch, head) row
# block; off-mesh it is the plain call.  The ``fake`` stand-ins give the
# dry run (fake tensors) the kernels' output shapes and FLOPs.


def _row_flops(fwd, d, c):
    """FLOPs of one (batch, head) row and token: ``obs.costs``' per-head
    state math (``fwd(cfg, c, n)``, d = dv) on a one-head stand-in
    config."""
    return fwd(types.SimpleNamespace(n_heads=1, head_dim=d), c, None)


class _ShapeOnly(torch.autograd.Function):
    """The training call's shapes under fake tensors: ``o (B, H, n, dv)``
    and gradients for its inputs; counts the forward's FLOPs, and twice
    them for the backward (``obs.costs``' ``train_bwd`` scale)."""

    @staticmethod
    def forward(ctx, name, flops, q, k, v, gamma):
        ctx.meta = (name, flops, [None if x is None else (x.shape, x.dtype)
                                  for x in (q, k, v, gamma)])
        shard_ops.count_flops(name, flops)
        return v.new_empty(q.shape[:3] + v.shape[3:])

    @staticmethod
    def backward(ctx, do):
        name, flops, metas = ctx.meta
        shard_ops.count_flops(name.replace("fwd", "bwd"), 2 * flops)
        return (None, None) + tuple(
            None if m is None else do.new_empty(m[0], dtype=m[1])
            for m in metas)


def _fake_attention(name, fwd, hc):
    def fake(q, k, v, gamma):
        B, H, n, d = q.shape
        flops = B * H * n * _row_flops(fwd, d, hc.chunk)
        return _ShapeOnly.apply(name, flops, q, k, v, gamma)

    return fake


def _fake_prefill(name, fwd, init, hc):
    def fake(q, k, v, gamma, state):
        B, H, n, d = q.shape
        dv = v.shape[-1]
        shard_ops.count_flops(name, B * H * n * _row_flops(fwd, d, hc.chunk))
        st = init((B, H), d, dv, torch.float32, q.device)
        return v.new_empty((B, H, n, dv)), st

    return fake


def _fake_step(name, dec):
    def fake(state, q1, k1, v1, gamma):
        B, H, d = q1.shape
        dv = v1.shape[-1]
        shard_ops.count_flops(name, B * H * dec(
            types.SimpleNamespace(n_heads=1, head_dim=d), None))
        return state, v1.new_empty((B, H, dv))

    return fake


def _hla2_fwd(q, k, v, gamma, hc, *, state, want_state):
    kw = dict(normalize=hc.normalize, eps=HLA_EPS, lam=hc.lam)
    if hc.impl == "scan":  # the paper's token-level associative scan
        return hla2_scan(q, k, v, gamma, state=state, **kw)
    if want_state:
        return shard_ops.call_sharded(
            lambda q_, k_, v_, g_, s_: kops.hla2_prefill(
                q_, k_, v_, g_, state=s_, **kw),
            q, k, v, gamma, state,
            fake=_fake_prefill("hla2_chunk_fwd", costs._fwd_hla2,
                               hla2_init_state, hc))
    return shard_ops.call_sharded(
        functools.partial(kops.hla2_attention, **kw), q, k, v, gamma,
        fake=_fake_attention("hla2_chunk_fwd", costs._fwd_hla2, hc)), None


def _hla2_step(state, q1, k1, v1, gamma, hc):
    return shard_ops.call_sharded(
        functools.partial(kops.hla2_decode_step, normalize=hc.normalize,
                          eps=HLA_EPS, lam=hc.lam),
        state, q1, k1, v1, gamma,
        fake=_fake_step("hla2_step", costs._dec_hla2))


def _ahla_fwd(q, k, v, gamma, hc, *, state, want_state):
    kw = dict(normalize=hc.normalize, eps=HLA_EPS)
    if hc.impl == "scan":
        return ahla_scan(q, k, v, gamma, state=state, **kw)
    if want_state:
        return shard_ops.call_sharded(
            lambda q_, k_, v_, g_, s_: kops.ahla_prefill(
                q_, k_, v_, g_, state=s_, **kw),
            q, k, v, gamma, state,
            fake=_fake_prefill("ahla_chunk_fwd", costs._fwd_ahla,
                               ahla_init_state, hc))
    return shard_ops.call_sharded(
        functools.partial(kops.ahla_attention, **kw), q, k, v, gamma,
        fake=_fake_attention("ahla_chunk_fwd", costs._fwd_ahla, hc)), None


def _ahla_step(state, q1, k1, v1, gamma, hc):
    return shard_ops.call_sharded(
        functools.partial(kops.ahla_decode_step, normalize=hc.normalize,
                          eps=HLA_EPS),
        state, q1, k1, v1, gamma,
        fake=_fake_step("ahla_step", costs._dec_ahla))


# -- the plain records (no kernel) take the same row dispatch: their states
# and inputs are (batch, head) rows too, so under a mesh each rank runs
# its block and no DTensor rule meets the chunk loops


def _hla3_fwd(q, k, v, gamma, hc, *, state, want_state):
    return shard_ops.call_sharded(
        lambda q_, k_, v_, g_, s_: hla3_exact_chunkwise(
            q_, k_, v_, g_, chunk=hc.chunk, normalize=hc.normalize,
            eps=HLA_EPS, state=s_),
        q, k, v, gamma, state)


def _hla3_step(state, q1, k1, v1, gamma, hc):
    return shard_ops.call_sharded(
        functools.partial(hla3_exact_step, normalize=hc.normalize,
                          eps=HLA_EPS),
        state, q1, k1, v1, gamma)


def _hla3_paper_fwd(q, k, v, gamma, hc, *, state, want_state):
    return shard_ops.call_sharded(
        lambda q_, k_, v_, s_: hla3_paper_chunkwise(
            q_, k_, v_, chunk=hc.chunk, normalize=hc.normalize, eps=HLA_EPS,
            state=s_),
        q, k, v, state)


def _hla3_paper_step(state, q1, k1, v1, gamma, hc):
    # an n = 1 chunkwise call: the prefill's state layout and its gamma = 1
    return shard_ops.call_sharded(
        functools.partial(hla3_paper_chunk_step, normalize=hc.normalize,
                          eps=HLA_EPS),
        state, q1, k1, v1)


def _linattn_fwd(q, k, v, gamma, hc, *, state, want_state):
    return shard_ops.call_sharded(
        lambda q_, k_, v_, g_, s_: linattn_chunkwise(
            q_, k_, v_, g_, chunk=hc.chunk, normalize=hc.normalize,
            eps=HLA_EPS, state=s_),
        q, k, v, gamma, state)


def _linattn_step(state, q1, k1, v1, gamma, hc):
    return shard_ops.call_sharded(
        functools.partial(linattn_step, normalize=hc.normalize, eps=HLA_EPS),
        state, q1, k1, v1, gamma)


# Every HLA-family decode-state leaf is a (batch, heads, ...feature) row
# tensor, declared field by field (the reference's state axes): heads
# shard on "model" as the kernels' row grid does.
_ROW_MAT = Axes(("batch", "q_heads", None, None))
_ROW_VEC = Axes(("batch", "q_heads", None))
_HLA2_AXES = HLA2State(S=_ROW_MAT, C=_ROW_MAT, m=_ROW_VEC, G=_ROW_MAT,
                       h=_ROW_VEC)
_LINATTN_AXES = LinAttnState(P=_ROW_MAT, m=_ROW_VEC)
# the fused records' leaf ranks: (B, H, d, d) / (B, H, d, dv) and (B, H, d)
_HLA2_STATE_NDIMS = HLA2State(4, 4, 3, 4, 3)
_AHLA_STATE_NDIMS = AHLAState(4, 4, 3, 4, 3)


def _register(name, core_fwd, core_step, core_init, axes, ndims=None,
              fused=False):
    def init_state(cfg, B, device, max_len=0):
        del max_len  # a streaming state does not grow with the context
        dh = cfg.head_dim
        return core_init((B, cfg.n_heads), dh, dh, torch.float32, device)

    seq_op.register_op(seq_op.SequenceOp(
        name=name, specs=mixer_specs, forward=_sublayer_forward(core_fwd),
        step=_sublayer_step(core_step), init_state=init_state,
        state_axes=lambda cfg, _axes=axes: _axes,
        state_ndims=None if ndims is None else (lambda cfg, _n=ndims: _n),
        streaming=True, has_fused_kernels=fused, spec_decodable=True,
        param_key="mixer",
    ))


_register("hla2", _hla2_fwd, _hla2_step, hla2_init_state, _HLA2_AXES,
          ndims=_HLA2_STATE_NDIMS, fused=True)
_register("ahla", _ahla_fwd, _ahla_step, ahla_init_state,
          AHLAState(R=_ROW_MAT, P=_ROW_MAT, m=_ROW_VEC, E=_ROW_MAT,
                    n=_ROW_VEC),
          ndims=_AHLA_STATE_NDIMS, fused=True)
_register("hla3", _hla3_fwd, _hla3_step, hla3_exact_init_state,
          HLA3ExactState(inner=_LINATTN_AXES, outer=_HLA2_AXES))
# the chunk-state layout: prefill (hla3_paper_chunkwise) and decode
# (hla3_paper_chunk_step) share it; Algorithm 3's 10-field state serves
# only the serial path
_register("hla3_paper", _hla3_paper_fwd, _hla3_paper_step,
          hla3_chunk_init_state,
          HLA3ChunkState(SK=_ROW_MAT, SQ=_ROW_MAT, P=_ROW_MAT, m=_ROW_VEC,
                         F=_ROW_MAT, eta=_ROW_VEC))
_register("linattn", _linattn_fwd, _linattn_step, linattn_init_state,
          _LINATTN_AXES)
