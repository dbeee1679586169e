"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch (twin
of ``repro/models/moe.py``).

No (T, E, C) one-hot tensors and no sort across rows: each batch row's
``n * K`` (token, expert) pairs are argsorted by expert id, positioned
inside their expert's segment by a ``searchsorted`` offset, and gathered
into a dense ``(B, E, C, d)`` buffer; the experts then run as batched
matmuls over ``E``, and a gather brings each pair's output back for the
gate-weighted combine.  The reference ``vmap``s the per-row dispatch; here
every step is batched over the rows (``torch.argsort(dim=-1)``,
``searchsorted`` on ``(B, nK)``, ``torch.gather``), with no Python loop
over rows and no value read back to the host.  Capacity is per row,
``C = ceil(K * n * capacity_factor / E)`` from static shapes (Switch
style): a pair past its expert's capacity is dropped.

The router runs in fp32 from fp32 weights (``lm.cast_params`` leaves its
kernel fp32); the experts run in the activations' dtype.  The Switch
load-balance loss is returned for the train loss.

Under a mesh (``x`` a DTensor) the layer is an explicit block
(``_moe_sharded``): the rows are gathered along everything but the batch
split, so each rank routes and dispatches its own rows whole (the same
code, so the expert ids and capacity drops are the single-device ones);
the ``(B, E, C, d)`` buffer is cut to the rank's experts, the reference's
``("batch", "experts", None, None)`` constraint with "experts" over
"model"; the expert weights are gathered over the data axes only (FSDP)
and stay split over "experts"; the experts' outputs are all-gathered over
"model", so the combine sees every expert's output; and the aux loss's
two means are summed over the batch split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .blocks import dense_specs, fsdp_gather
from .param import Spec

#: the expert leaves of an MoE layer (cast to ``cfg.dtype`` by
#: ``lm.cast_params``; the router is not among them)
EXPERT_LEAVES = ("wi_gate", "wi_up", "wi", "wo")


def moe_specs(cfg):
    d = cfg.d_model
    mc = cfg.moe
    E, ff = mc.n_experts, mc.d_ff
    if cfg.mlp == "swiglu":
        expert = {
            "wi_gate": Spec((E, d, ff), ("experts", "embed", "expert_ff")),
            "wi_up": Spec((E, d, ff), ("experts", "embed", "expert_ff")),
            "wo": Spec((E, ff, d), ("experts", "expert_ff", "embed")),
        }
    else:
        expert = {
            "wi": Spec((E, d, ff), ("experts", "embed", "expert_ff")),
            "wo": Spec((E, ff, d), ("experts", "expert_ff", "embed")),
        }
    return {"router": dense_specs(d, E, axes=("embed", "experts")),
            **expert}


def _expert_ffn(p, x, act):
    """``x (E, T, d) -> (E, T, d)``: expert ``e``'s FFN on its ``T`` rows,
    one batched matmul over ``E`` per weight."""
    if act == "swiglu":
        h = F.silu(x @ p["wi_gate"].to(x.dtype)) \
            * (x @ p["wi_up"].to(x.dtype))
    else:
        h = x @ p["wi"].to(x.dtype)
        if act == "squared_relu":
            h = F.relu(h).square()
        else:
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ p["wo"].to(x.dtype)


def route(p, x, cfg):
    """``(probs (B, n, E) fp32, gate_w (B, n, K) fp32, gate_e (B, n, K))``:
    the router's softmax in fp32, its top ``K`` experts (ties to the lower
    index, as ``lax.top_k``: a stable descending sort) and their weights
    renormalized over the ``K``."""
    K = cfg.moe.top_k
    logits = x.float() @ p["router"]["kernel"].float()
    probs = torch.softmax(logits, -1)
    gate_w, gate_e = torch.sort(probs, stable=True, dim=-1,
                                descending=True)
    gate_w, gate_e = gate_w[..., :K], gate_e[..., :K]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_e


def capacity(cfg, n: int) -> int:
    """Slots per expert and row for ``n`` tokens a row (a host integer,
    the reference's expression)."""
    mc = cfg.moe
    return max(1, int(-(-mc.top_k * n * mc.capacity_factor // mc.n_experts)))


def _dispatch(x, gate_e, E, C):
    """Gather-only dispatch, every row at once.  ``x (B, n, d)``, ``gate_e
    (B, n, K)``.  Returns ``(buf (B, E * C, d), dest (B, n * K))``: slot
    ``e * C + c`` holds the c-th token routed to expert ``e`` (zeros past
    its count); ``dest`` is each (token, k) pair's slot in the original
    order, ``E * C`` where it was dropped."""
    B, n, d = x.shape
    nK = gate_e.shape[1] * gate_e.shape[2]
    e_flat = gate_e.reshape(B, nK)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    se = torch.gather(e_flat, 1, order)
    stok = order // gate_e.shape[2]  # pair i belongs to token i // K
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    starts = torch.searchsorted(se, experts, side="left")  # (B, E)
    ends = torch.cat([starts[:, 1:], starts.new_full((B, 1), nK)], 1)
    # slot (e, c) <- sorted position starts[e] + c (valid while < ends[e])
    slot_pos = starts[:, :, None] + torch.arange(C, device=x.device)
    slot_valid = (slot_pos < ends[:, :, None]).reshape(B, E * C, 1)
    slot_tok = torch.gather(stok, 1, slot_pos.clamp(0, nK - 1)
                            .reshape(B, E * C))
    buf = torch.gather(x, 1, slot_tok[..., None].expand(B, E * C, d)) \
        * slot_valid.to(x.dtype)
    # each pair's slot id, in sorted then original order
    pos = torch.arange(nK, device=x.device) - torch.gather(starts, 1, se)
    dest_sorted = torch.where(pos < C, se * C + pos, E * C)
    inv = torch.argsort(order, dim=-1, stable=True)
    return buf, torch.gather(dest_sorted, 1, inv)


def _combine(y, dest, gate_w, dtype):
    """``y (B, E * C, d)``, ``dest (B, n * K)``, ``gate_w (B, n, K)`` ->
    ``(B, n, d)``: each token's ``K`` expert outputs (zero where dropped),
    weighted by its gates.  Gather-only."""
    B, EC, d = y.shape
    n, K = gate_w.shape[1:]
    valid = (dest < EC)[..., None]
    rows = torch.gather(y, 1, dest.clamp(max=EC - 1)[..., None]
                        .expand(B, n * K, d)) * valid.to(y.dtype)
    rows = rows.reshape(B, n, K, d)
    out = (gate_w.to(rows.dtype)[:, :, None, :] @ rows)[:, :, 0]
    return out.to(dtype)


def moe_apply(p, x, cfg):
    """``x (B, n, d)``.  Returns ``(y (B, n, d) in x.dtype, aux_loss fp32
    scalar)``."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _moe_sharded(p, x, cfg)
    out, probs, gate_e = _moe_rows(p, x, cfg)
    return out, _aux(probs.mean((0, 1)), _top1_share(gate_e, cfg), cfg)


def _top1_share(gate_e, cfg):
    """``(E,)``: the share of the tokens whose top-1 expert is ``e`` (the
    top-1 one-hot's mean as a count, no host sync)."""
    top1 = gate_e[..., 0].reshape(-1)
    return torch.zeros(cfg.moe.n_experts, device=gate_e.device).index_add_(
        0, top1, torch.ones(top1.shape, device=gate_e.device)) / top1.numel()


def _aux(me, ce, cfg):
    """The Switch load-balance loss over all tokens: the mean router
    probability times the share of tokens whose top-1 expert it is."""
    mc = cfg.moe
    return mc.aux_loss_coef * mc.n_experts * (me * ce).sum()


def _all_experts(p, buf, cfg):
    """``buf (B, E, C, d)`` -> every expert's output ``(B, E * C, d)``:
    experts lead, one batched matmul over E per weight."""
    B, E, C, d = buf.shape
    xe = buf.transpose(0, 1).reshape(E, B * C, d)
    y = _expert_ffn(p, xe, cfg.mlp)
    return y.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)


def _moe_rows(p, x, cfg, experts=_all_experts, x_disp=None):
    """Route, dispatch, run the experts and combine over the rows of a
    plain ``x (B, n, d)`` (``x_disp``, the same values, feeds the
    dispatch when given).  ``experts(p, buf, cfg)`` maps the dispatch
    buffer to every expert's output.  Returns ``(out, probs, gate_e)``."""
    B, n, d = x.shape
    E = cfg.moe.n_experts
    probs, gate_w, gate_e = route(p, x, cfg)
    C = capacity(cfg, n)
    buf, dest = _dispatch(x if x_disp is None else x_disp, gate_e, E, C)
    y = experts(p, buf.reshape(B, E, C, d), cfg)
    return _combine(y, dest, gate_w, x.dtype), probs, gate_e


def _moe_sharded(p, x, cfg):
    """``moe_apply`` of a DTensor ``x`` on its mesh, each rank on its own
    batch rows and its own experts (the module docstring); where "model"
    does not split the experts (one rank, or E not a multiple) each rank
    runs them all, the one-device code on its rows.  Every ``to_local`` of
    a tensor that the rank reads whole for its rows, or for its experts,
    names its gradient's placements: ``Partial()`` where the ranks of a
    mesh dim hold shares of a sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..distributed.sharding import contiguous_stride, mesh_axes

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    sizes = mesh_axes(mesh)
    B, n, d = x.shape
    E = cfg.moe.n_experts
    # rows: the batch split kept, everything else gathered
    rows = tuple(pl if pl.is_shard(0) else Replicate()
                 for pl in x.placements)
    row_dims = {i for i, pl in enumerate(rows) if pl.is_shard(0)}
    ex_dim = next((i for i, a in enumerate(names) if a == "model"
                   and sizes[a] > 1 and E % sizes[a] == 0), None)
    full = (Replicate(),) * len(names)

    def grads_of(pl_keep):
        """Gradient placements: ``pl_keep`` on the rows' and the experts'
        dims it names, Partial on a row dim it does not, Replicate
        elsewhere."""
        return tuple(
            pl_keep[i] if pl_keep[i].is_shard() else
            Partial() if i in row_dims else Replicate()
            for i in range(len(names)))

    local = {"router": {"kernel": p["router"]["kernel"].redistribute(
        mesh, full).to_local(grad_placements=grads_of(full))}}
    for key in EXPERT_LEAVES:
        if key in p:
            w = fsdp_gather(p[key])
            local[key] = w.to_local(grad_placements=grads_of(w.placements))
    xr = x.redistribute(mesh, rows)
    x_route = xr.to_local()  # routing: the same on every non-row rank
    if ex_dim is None:
        out, probs, gate_e = _moe_rows(local, x_route, cfg)
    else:
        El = E // sizes[names[ex_dim]]
        e0 = mesh.get_local_rank(ex_dim) * El
        # the dispatch feeds only the rank's experts: a share of the sum
        x_disp = xr.to_local(grad_placements=tuple(
            Partial() if i == ex_dim else pl for i, pl in enumerate(rows)))

        def experts(p_, buf, cfg_):
            Bl, _, C, _ = buf.shape
            # the reference's constrain(buf, ("batch", "experts", ...))
            xe = buf[:, e0:e0 + El].transpose(0, 1).reshape(El, Bl * C, d)
            y = _expert_ffn(p_, xe, cfg_.mlp)
            y = y.reshape(El, Bl, C, d).transpose(0, 1).contiguous()
            # every expert's output for the combine: an all-gather
            shape = (B, E, C, d)
            y_pl = tuple(Shard(1) if i == ex_dim else pl
                         for i, pl in enumerate(rows))
            return DTensor.from_local(
                y, mesh, y_pl, run_check=False, shape=torch.Size(shape),
                stride=contiguous_stride(shape)).redistribute(
                    mesh, rows).to_local().reshape(Bl, E * C, d)

        out, probs, gate_e = _moe_rows(local, x_route, cfg, experts,
                                       x_disp=x_disp)
    # the aux loss's two means over the global rows: each rank's share,
    # summed over the batch split (1.0 times the local mean without one)
    share = x_route.shape[0] / B
    part = tuple(Partial() if i in row_dims else Replicate()
                 for i in range(len(names)))

    def global_mean(t):
        return DTensor.from_local(t * share, mesh, part, run_check=False,
                                  shape=t.shape, stride=t.stride()) \
            .redistribute(mesh, full)

    aux = _aux(global_mean(probs.mean((0, 1))),
               global_mean(_top1_share(gate_e, cfg)), cfg)
    shape = (B, n, d)
    return DTensor.from_local(out, mesh, rows, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape)), aux


def moe_dense_oracle(p, x, cfg):
    """O(T * E) reference: every expert on every token, then the top-k
    combine (tests only; nothing dropped)."""
    B, n, d = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    _, gate_w, gate_e = route(p, x, cfg)
    xb = x.reshape(1, B * n, d).expand(E, B * n, d)
    all_out = _expert_ffn(p, xb, cfg.mlp).reshape(E, B, n, d)
    out = torch.zeros((B, n, d), dtype=torch.float32, device=x.device)
    for kk in range(K):
        idx = gate_e[..., kk]  # (B, n)
        sel = all_out[idx, torch.arange(B, device=x.device)[:, None],
                      torch.arange(n, device=x.device)]
        out = out + gate_w[..., kk:kk + 1] * sel.float()
    return out.to(x.dtype)
