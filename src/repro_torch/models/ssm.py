"""Selective SSM (Mamba) block: chunked scan and decode state (twin of
``repro/models/ssm.py``).

The recurrence ``h_t = a_t * h_{t-1} + b_t`` (diagonal, data-dependent)
runs chunk-parallel as the HLA monoids do: an inclusive associative scan
inside a chunk (``core/_scan.py``, the port's stand-in for
``lax.associative_scan``) and a sequential carry across chunks (a Python
loop in place of ``lax.scan``).  The 4-D ``(B, w, d_inner, d_state)``
tensors exist one chunk at a time.  Under autograd each chunk is
recomputed in the backward pass (``torch.utils.checkpoint``), so what
stays alive for the backward is the chunk's inputs and its carry, not the
scan's ``log2 w`` rounds of 4-D tensors: at jamba's width (d_inner 16384)
one such tensor of a 128-token chunk is 268 MB a row pair.

Plain torch, as the reference is plain jnp: Mamba has no TPU kernel.  The
decode state's ``conv`` leaf is kept in the activation dtype
(``cfg.dtype``); the reference allocates it in bf16 and its first call
returns it in the activation dtype, so the values are the same (zeros,
then the activations).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core._scan import associative_scan
from . import seq_op
from .blocks import dense_apply, dense_specs
from .param import Axes, Spec

MAMBA_CHUNK = 128  # the reference's ``mamba_apply`` chunk


class _Affine(NamedTuple):
    a: torch.Tensor  # decay
    b: torch.Tensor  # input


def _first_order_op(x: _Affine, y: _Affine) -> _Affine:
    """``x`` then ``y``: ``h -> y.a * (x.a * h + x.b) + y.b``."""
    return _Affine(y.a * x.a, y.a * x.b + y.b)


def chunked_linear_recurrence(a, b, h0, chunk: int = 128):
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1; ``a``, ``b``: ``(B, n,
    ...)``, ``h0``: ``(B, ...)``.  Returns ``(h (B, n, ...), h_final)``.
    Exact up to the regrouping of the products; ``n`` must be a multiple
    of ``min(chunk, n)``, as in the reference."""
    n = a.shape[1]
    w = min(chunk, n)
    if n % w:
        raise ValueError(f"n={n} is not a multiple of the chunk {w}")
    h, hs = h0, []
    for c0 in range(0, n, w):
        acc = associative_scan(_first_order_op, _Affine(
            a[:, c0:c0 + w].movedim(1, 0), b[:, c0:c0 + w].movedim(1, 0)))
        h_t = acc.a * h[None] + acc.b  # (w, B, ...)
        h = h_t[-1]
        hs.append(h_t.movedim(0, 1))
    return torch.cat(hs, 1), h


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, d_inner) rolling conv inputs
    h: torch.Tensor  # (B, d_inner, d_state) fp32


def mamba_specs(cfg):
    d = cfg.d_model
    mc = cfg.mamba
    d_in = mc.expand * d
    dt_rank = mc.dt_rank or max(1, d // 16)
    return {
        "in_proj": dense_specs(d, 2 * d_in, axes=("embed", "inner")),
        "conv_w": Spec((mc.d_conv, d_in), ("conv", "inner"), init="normal"),
        "conv_b": Spec((d_in,), ("inner",), init="zeros"),
        "x_proj": dense_specs(d_in, dt_rank + 2 * mc.d_state,
                              axes=("inner", None)),
        "dt_proj": {
            "kernel": Spec((dt_rank, d_in), (None, "inner")),
            "bias": Spec((d_in,), ("inner",), init="constant", const=0.54),
        },
        "A_log": Spec((d_in, mc.d_state), ("inner", "state"),
                      init="constant", const=0.0),
        "D": Spec((d_in,), ("inner",), init="ones"),
        "out_proj": dense_specs(d_in, d, axes=("inner", "embed")),
    }


def _causal_depthwise_conv(x, w, b, prepend=None):
    """``x (B, n, D)``, ``w (K, D)`` depthwise, causal (left) padding by
    ``prepend (B, K - 1, D)`` (zeros when None).  Returns ``(out, the last
    K - 1 inputs)``, both in ``x``'s dtype."""
    K = w.shape[0]
    if prepend is None:
        prepend = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([prepend.to(x.dtype), x], 1)
    n = x.shape[1]
    out = xp[:, :n] * w[0].to(x.dtype)
    for i in range(1, K):  # K is tiny (4): unrolled taps
        out = out + xp[:, i:i + n] * w[i].to(x.dtype)
    return out + b.to(x.dtype), xp[:, n:] if K > 1 else prepend


def _scan_chunk(h, dt, Bc, Cc, x, A):
    """One chunk of the selective scan, every input fp32: ``dt``, ``x``
    ``(B, w, d_in)``, ``Bc``, ``Cc`` ``(B, w, ds)``, ``A (d_in, ds)``, carry
    ``h (B, d_in, ds)``.  Returns ``(h at the chunk's end, y (B, w,
    d_in))``."""
    dtT = dt.transpose(0, 1)  # (w, B, d_in): the scan's axis leads
    decay = torch.exp(dtT[..., None] * A)
    bu = (dtT * x.transpose(0, 1))[..., None] * Bc.transpose(0, 1)[:, :, None]
    acc = associative_scan(_first_order_op, _Affine(decay, bu))
    hseq = acc.a * h[None] + acc.b  # (w, B, d_in, ds)
    y = torch.einsum("wbds,wbs->bwd", hseq, Cc.transpose(0, 1))
    return hseq[-1], y


def mamba_apply(p, x, cfg, state: Optional[MambaState] = None,
                chunk: int = MAMBA_CHUNK):
    """``x (B, n, d)``, resumed from ``state`` when given (only read).
    Returns ``(y (B, n, d), MambaState)``: ``conv`` in ``x``'s dtype, ``h``
    fp32.  A DTensor ``x`` runs ``_mamba_sharded`` on its mesh."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _mamba_sharded(p, x, cfg, state, chunk)
    d_in = cfg.mamba.expand * x.shape[-1]
    xz = dense_apply(p["in_proj"], x)
    y, st = _mamba_core(p, xz[..., :d_in], xz[..., d_in:], cfg, state,
                        chunk, lambda t: t)
    return dense_apply(p["out_proj"], y), st


def _mamba_core(p, xin, z, cfg, state, chunk, reduce):
    """Everything between the in and out projections, per channel: the
    causal conv, ``x_proj`` (whose product over the channels ``reduce``
    completes: the identity on one device, a sum over the channel split
    on a mesh), ``dt_proj``, the chunked scan, ``D`` and the gate.
    ``xin``, ``z`` ``(B, n, channels)``.  Returns ``(y (B, n, channels)``
    before ``out_proj``, ``MambaState)``."""
    B, n, d_in = xin.shape
    ds = cfg.mamba.d_state
    xc, conv_tail = _causal_depthwise_conv(
        xin, p["conv_w"], p["conv_b"],
        prepend=state.conv if state is not None else None)
    xc = F.silu(xc)

    proj = reduce(dense_apply(p["x_proj"], xc))
    dt_rank = p["dt_proj"]["kernel"].shape[0]
    Bc = proj[..., dt_rank:dt_rank + ds].float()
    Cc = proj[..., dt_rank + ds:].float()
    dt = F.softplus(dense_apply(p["dt_proj"], proj[..., :dt_rank]).float())
    A = -torch.exp(p["A_log"].float())  # (d_in, ds)
    xf = xc.float()

    w = min(chunk, n)
    pad = (w - n % w) % w
    if pad:  # dt = 0 in the tail: decay 1, input 0, so the carry is exact
        dt, Bc, Cc, xp = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bc, Cc, xf))
    else:
        xp = xf
    h = state.h.float() if state is not None else \
        xin.new_zeros((B, d_in, ds), dtype=torch.float32)
    ys = []
    for c0 in range(0, n + pad, w):
        args = (h,) + tuple(t[:, c0:c0 + w] for t in (dt, Bc, Cc, xp)) + (A,)
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            # recompute the chunk in backward instead of keeping its scan
            h, y = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            h, y = _scan_chunk(*args)
        ys.append(y)
    y = torch.cat(ys, 1)[:, :n]
    y = y + xf * p["D"].float()
    y = y.to(xin.dtype) * F.silu(z)
    return y, MambaState(conv=conv_tail.to(xin.dtype), h=h)


def _mamba_sharded(p, x, cfg, state, chunk):
    """``mamba_apply`` of a DTensor ``x``: the reference's constraints,
    "inner" (d_inner) over "model", as an explicit block.  Each rank takes
    its batch rows whole and its block of channels: the in projection's
    columns of those channels (of the gathered kernel), the conv taps,
    ``dt_proj``, ``A_log`` and ``D`` of them, the state's block; the conv
    and the scan are local per channel; ``x_proj`` and ``out_proj``
    contract over the channels, so their products are summed over the
    channel split (an all-reduce each).  Every ``to_local`` names its
    gradient's placements (``Partial()`` where the ranks of a mesh dim
    hold shares of a sum)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..distributed.sharding import contiguous_stride, mesh_axes

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    sizes = mesh_axes(mesh)
    nd = len(names)
    d_in = cfg.mamba.expand * cfg.d_model
    rows = tuple(pl if pl.is_shard(0) else Replicate()
                 for pl in x.placements)
    row_dims = {i for i, pl in enumerate(rows) if pl.is_shard(0)}
    ch = next((i for i, a in enumerate(names) if a == "model"
               and sizes[a] > 1 and d_in % sizes[a] == 0), None)
    Dl = d_in // sizes[names[ch]] if ch is not None else d_in
    c0 = mesh.get_local_rank(ch) * Dl if ch is not None else 0

    def local(w, dim):
        """``w``'s block of the rank's channels (its dim ``dim``; None:
        the whole of ``w``, of which the rank reads its channels)."""
        want = tuple(Shard(dim) if i == ch and dim is not None
                     else Replicate() for i in range(nd))
        grads = tuple(want[i] if want[i].is_shard() else Partial()
                      if i in row_dims or i == ch else Replicate()
                      for i in range(nd))
        return w.redistribute(mesh, want).to_local(grad_placements=grads)

    def wrap(t, pl):
        shape = _global_shape(t.shape, pl, mesh)
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    part = tuple(Partial() if i == ch else rows[i] for i in range(nd))

    def reduce(t):
        """A product over the channel split, summed; each rank reads the
        sum for its own channels, so its gradient is a share too."""
        if ch is None:
            return t
        return wrap(t, part).redistribute(mesh, rows).to_local(
            grad_placements=part)

    xl = x.redistribute(mesh, rows).to_local(grad_placements=tuple(
        Partial() if i == ch else pl for i, pl in enumerate(rows)))
    w_in = local(p["in_proj"]["kernel"], None).to(xl.dtype)
    cols = torch.cat([torch.arange(c0, c0 + Dl, device=xl.device),
                      torch.arange(d_in + c0, d_in + c0 + Dl,
                                   device=xl.device)])
    xz = xl @ w_in.index_select(1, cols)
    pl_local = {
        "conv_w": local(p["conv_w"], 1), "conv_b": local(p["conv_b"], 0),
        "x_proj": {"kernel": local(p["x_proj"]["kernel"], 0)},
        "dt_proj": {"kernel": local(p["dt_proj"]["kernel"], 1),
                    "bias": local(p["dt_proj"]["bias"], 0)},
        "A_log": local(p["A_log"], 0), "D": local(p["D"], 0),
    }

    def state_pl(dim):
        return tuple(rows[i] if i in row_dims else Shard(dim) if i == ch
                     else Replicate() for i in range(nd))

    st = None
    if state is not None:
        st = MambaState(
            conv=state.conv.redistribute(mesh, state_pl(2)).to_local(),
            h=state.h.redistribute(mesh, state_pl(1)).to_local())
    y, new = _mamba_core(pl_local, xz[..., :Dl], xz[..., Dl:], cfg, st,
                         chunk, reduce)
    out = wrap(y @ local(p["out_proj"]["kernel"], 0).to(y.dtype),
               part).redistribute(mesh, rows)
    return out, MambaState(conv=wrap(new.conv, state_pl(2)),
                           h=wrap(new.h, state_pl(1)))


def _global_shape(shape, pl, mesh):
    """The global shape of a local block ``shape`` under placements
    ``pl`` (even shards)."""
    out = list(shape)
    for size, p in zip(mesh.shape, pl):
        if p.is_shard():
            out[p.dim] *= int(size)
    return tuple(out)


def mamba_init_state(cfg, B, device, dtype=torch.float32) -> MambaState:
    """Zero state: ``conv`` in the activation dtype ``cfg.dtype`` (see the
    module docstring), ``h`` in ``dtype``."""
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    return MambaState(
        conv=torch.zeros((B, mc.d_conv - 1, d_in),
                         dtype=getattr(torch, cfg.dtype), device=device),
        h=torch.zeros((B, d_in, mc.d_state), dtype=dtype, device=device),
    )


# --------------------------------------------------------------------------
# SequenceOp registration
# --------------------------------------------------------------------------


def _mamba_forward(p, x, cfg, *, state=None, want_state=True):
    """Train / prefill over ``x (B, n, d_model)``; ``state`` is only read.
    Returns ``(y, new MambaState)``."""
    del want_state  # the final state costs nothing beyond the last chunk
    return mamba_apply(p, x, cfg, state=state)


def _mamba_step(p, x_t, state, cfg):
    """One-token decode; ``state`` is updated in place.  Returns ``(y,
    state)``."""
    y, new = mamba_apply(p, x_t, cfg, state=state)
    state.conv.copy_(new.conv)
    state.h.copy_(new.h)
    return y, state


def mamba_state_axes() -> MambaState:
    """Logical axes of the state's leaves: d_inner shards by the "inner"
    rule."""
    return MambaState(conv=Axes(("batch", None, "inner")),
                      h=Axes(("batch", "inner", None)))


def _mamba_init_state(cfg, B, device, max_len=0):
    del max_len  # a streaming state does not grow with the context
    return mamba_init_state(cfg, B, device)


seq_op.register_op(seq_op.SequenceOp(
    name="mamba",
    specs=mamba_specs,
    forward=_mamba_forward,
    step=_mamba_step,
    init_state=_mamba_init_state,
    state_axes=lambda cfg: mamba_state_axes(),
    streaming=True,
    spec_decodable=True,
    prealloc_state=True,  # the reference's flag (its hybrid group scan
    #   needs a uniform carry); the port's prefill returns new states
))
