"""Elementary blocks: RMSNorm, LayerNorm, dense (with an optional bias),
embedding and its tied unembedding, RoPE, whisper's sinusoidal positions,
the MLPs — plain functions on parameter dicts (twin of
``repro/models/blocks.py``).  Under a mesh the embedding gather is
vocab-parallel and the MLP's hidden activations are constrained to their
logical axes, as in the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import constrain, contiguous_stride, mesh_axes
from .param import Spec


def rmsnorm_specs(d: int):
    return {"scale": Spec((d,), ("embed",), init="ones")}


def rmsnorm_apply(p, x, eps: float = 1e-5):
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_specs(d: int):
    return {"scale": Spec((d,), ("embed",), init="ones"),
            "bias": Spec((d,), ("embed",), init="zeros")}


def layernorm_apply(p, x, eps: float = 1e-5):
    """LayerNorm in fp32 (population variance), scale and bias applied in
    fp32; the result in ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def dense_specs(d_in: int, d_out: int, axes=("embed", "ff"),
                bias: bool = False):
    s = {"kernel": Spec((d_in, d_out), axes)}
    if bias:
        s["bias"] = Spec((d_out,), (axes[1],), init="zeros")
    return s


def gather_middle(x):
    """A DTensor ``x`` whose middle dims are sharded (the residual stream's
    "seq" over "model") gathered along them, as sequence parallelism does
    before a projection: batch rows and the contracted features keep their
    placements.  Anything else as it is."""
    if not isinstance(x, DTensor) or not any(
            pl.is_shard() and pl.dim not in (0, x.ndim - 1)
            for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if pl.is_shard() and pl.dim not in (0, x.ndim - 1)
        else pl for pl in x.placements))


def regather_grad(y):
    """``y`` (a projection's output) whose gradient comes back through
    ``gather_middle`` too: a gradient that arrives sharded along the
    sequence (from the residual stream) is gathered before the
    projection's backward flattens it with the batch rows."""
    if isinstance(y, DTensor) and y.requires_grad:
        y.register_hook(gather_middle)
    return y


def split_heads(y, heads: int, dh: int):
    """``y (..., heads * dh)`` as ``(..., heads, dh)``.  A DTensor whose
    last dim is split over more ranks than ``heads`` divides (8 KV heads on
    a 16-wide model axis) is gathered along it first, as GSPMD reshards
    such a reshape."""
    if isinstance(y, DTensor):
        sizes = list(mesh_axes(y.device_mesh).values())
        split = 1
        for size, pl in zip(sizes, y.placements):
            if pl.is_shard(y.ndim - 1):
                split *= size
        if heads % split:
            y = y.redistribute(y.device_mesh, tuple(
                Replicate() if pl.is_shard(y.ndim - 1) else pl
                for pl in y.placements))
    return y.reshape(y.shape[:-1] + (heads, dh))


def fsdp_gather(w):
    """A DTensor weight gathered over the data-parallel mesh dims ("pod",
    "data"; its "model" split kept) where a layer uses it: the FSDP
    all-gather of ``sharding.RULES``' "embed" -> data, explicit so that its
    backward reduce-scatters the weight's gradient back to its own
    placements, one layer at a time."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if a in ("pod", "data") else pl
                 for a, pl in zip(names, w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def dense_apply(p, x):
    y = gather_middle(x) @ fsdp_gather(p["kernel"].to(x.dtype))
    if "bias" in p:
        y = y + fsdp_gather(p["bias"].to(x.dtype))
    return regather_grad(y)


def embed_specs(vocab: int, d: int):
    return {"embedding": Spec((vocab, d), ("vocab", "embed"), init="embed",
                              scale=0.02)}


def embed_apply(p, ids):
    """The table's rows for ``ids``.  For a table on a mesh (a DTensor)
    whose "model" axis (of 2 ranks or more) divides a vocab over 8192
    rows, the gather is vocab-parallel, as the reference's ``shard_map``
    lookup: the table is held as vocab rows over
    "model" (its embed dim gathered), each rank takes the rows its block
    holds for its own batch rows, the ids outside its block masked to zero,
    and the result is a DTensor ``Partial`` over "model" that the next
    redistribution sums (the explicit masked gather, not DTensor's
    ``F.embedding`` rule, which here gathered the batch)."""
    table = p["embedding"]
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    sizes = mesh_axes(mesh)
    V = table.shape[0]
    if V <= 8192 or sizes.get("model", 1) == 1 or V % sizes["model"]:
        return table[ids]
    names = mesh.mesh_dim_names
    if isinstance(ids, DTensor):
        id_pl, ids = ids.placements, ids.to_local()
    else:
        from ..distributed.sharding import batch_sharding, local_block

        id_pl = batch_sharding(mesh, ids.shape)
        ids = local_block(ids, mesh, id_pl)
    held = tuple(Shard(0) if a == "model" else Replicate() for a in names)
    # a rank's gradient holds its own ids' rows: a sum over the batch split
    tbl = table.redistribute(mesh, held).to_local(grad_placements=tuple(
        pl if a == "model" else Partial() if id_pl[i].is_shard() else pl
        for i, (a, pl) in enumerate(zip(names, held))))
    vloc = tbl.shape[0]
    loc = ids - mesh.get_local_rank("model") * vloc
    ok = (loc >= 0) & (loc < vloc)
    out = F.embedding(loc.clamp(0, vloc - 1), tbl) * ok[..., None]
    pl = tuple(Partial() if a == "model" else id_pl[i]
               for i, a in enumerate(names))
    shape = tuple(out.shape)
    for i, a in enumerate(names):
        if id_pl[i].is_shard(0):
            shape = (shape[0] * sizes[a],) + shape[1:]
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def unembed_apply(p, x):
    """Logits through the embedding table (tied embeddings)."""
    return regather_grad(
        gather_middle(x) @ fsdp_gather(p["embedding"].to(x.dtype)).T)


def rope(x, positions, theta: float = 1e4):
    """Rotary embedding, NeoX style (each head split into halves).  ``x``:
    ``(..., n, h, dh)`` or ``(..., n, dh)``; ``positions``: ``(..., n)``.
    The angles are fp32; the result has ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freqs  # (..., n, half)
    if x.ndim == ang.ndim + 1:  # a heads dim
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def sinusoidal_pos(n: int, d: int, dtype=torch.float32, device=None):
    """``(n, d)`` fixed positions: angle ``pos / 10000 ** (2 * dim / d)``
    for ``dim < d // 2``, sines then cosines, computed in fp32 and cast to
    ``dtype``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def mlp_specs(d: int, d_ff: int, act: str):
    if act == "swiglu":
        return {
            "wi_gate": dense_specs(d, d_ff),
            "wi_up": dense_specs(d, d_ff),
            "wo": dense_specs(d_ff, d, axes=("ff", "embed")),
        }
    if act in ("squared_relu", "gelu", "relu"):
        return {"wi": dense_specs(d, d_ff),
                "wo": dense_specs(d_ff, d, axes=("ff", "embed"))}
    raise ValueError(act)


def mlp_apply(p, x, act: str):
    spec = ("batch", None, "ff")
    if act == "swiglu":
        g = constrain(dense_apply(p["wi_gate"], x), spec)
        u = constrain(dense_apply(p["wi_up"], x), spec)
        return dense_apply(p["wo"], F.silu(g) * u)
    h = constrain(dense_apply(p["wi"], x), spec)
    if act == "squared_relu":
        h = F.relu(h).square()
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    else:
        h = F.relu(h)
    return dense_apply(p["wo"], h)
