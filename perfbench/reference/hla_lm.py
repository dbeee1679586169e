"""Plain PyTorch reference of a decoder-only LM of ``hla2`` layers with a
SwiGLU MLP or a top-k MoE FFN, in float32 with TF32 off.

It imports nothing of the program.  The masked second-order HLA core is
the chunkwise form (intra-chunk masked products, a carried state
``(S, C, m, G, h)``), a frozen copy of the plain per-chunk math of the
repo's operator; everything else (projections, GQA, decay, the per-head
output norm, RMSNorm, the MoE's routing, per-row capacity and combine, the
Switch load-balance loss, cross-entropy, global-norm clipping and AdamW)
is written out here from the configuration's description.

``Prec("fp32")`` is the reference.  ``Prec("fp8")`` is the control: the
same code with both operands of every matrix product, and q, k, v where
they enter the HLA core, rounded to float8 e4m3 with one scale a tensor
(its largest magnitude at 448), the step below the configuration's bf16
activations.  The rounding passes gradients straight through.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

OUT_NORM_EPS = 1e-6
FP8_MAX = 448.0


def exact_matmuls():
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q8(x):
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    r = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (r - x.detach()) if x.requires_grad else r


class Prec:
    """``fp32`` (the reference) or ``fp8`` (the control)."""

    def __init__(self, name="fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(name)
        self.name = name

    def act(self, x):
        return _q8(x) if self.name == "fp8" else x

    def mm(self, a, b):
        return self.act(a) @ self.act(b)


# -- the HLA2 core ------------------------------------------------------------


def _decay_mats(w, g):
    t = torch.arange(w, device=g.device)
    mask = t[:, None] >= t[None, :]
    diff = torch.where(mask, t[:, None] - t[None, :], 0).to(g.dtype)
    logg = torch.log(g)
    Lg = torch.where(mask, torch.exp(diff * logg[..., None, None]), 0.0)
    tv = t.to(g.dtype)
    pow_t = torch.exp((tv + 1.0) * logg[..., None])
    pow_rev = torch.exp((w - 1.0 - tv) * logg[..., None])
    return Lg, pow_t, pow_rev


def _chunk(Q, K, V, state, g):
    """One chunk of unnormalised masked HLA2 with decay ``g`` a row:
    outputs and the carried state, in the inputs' dtype."""
    w = Q.shape[-2]
    S0, C0, m0, G0, h0 = state
    Lg, pow_t, pow_rev = _decay_mats(w, g)
    t = torch.arange(w, device=Q.device)
    U = (t[:, None] <= t[None, :]).to(Q.dtype)
    Ls = (t[:, None] > t[None, :]).to(Q.dtype)
    pt = pow_t[..., None]
    KQ = K @ Q.mT
    A = KQ.mT * Lg
    M3 = (A @ (KQ * U)) * Lg
    QS0Q = (Q @ S0 @ Q.mT) * Lg
    D0 = S0 @ C0 - G0
    o = pt**2 * (Q @ D0) + pt * (QS0Q @ V) + M3 @ V
    rho = torch.exp(torch.log(g) * w)
    r, rv = rho[..., None, None], rho[..., None]
    pr = pow_rev[..., None]
    Kg = pr * K
    Sw = Kg.mT @ K
    Cw = (pr * Q).mT @ V
    mw = (pr * Q).sum(-2)
    N = KQ * Ls
    Gw = Kg.mT @ (N @ (pr * V))
    hw = Kg.mT @ (N @ pow_rev[..., None])
    S1 = r * S0 + Sw
    C1 = r * C0 + Cw
    m1 = rv * m0 + mw
    G1 = r**2 * G0 + Gw + r * (Sw @ C0)
    h1 = rv**2 * h0 + hw[..., 0] + rv * (Sw @ m0[..., None])[..., 0]
    return o, (S1, C1, m1, G1, h1)


def hla2(q, k, v, g, chunk=128):
    """``q, k (B, H, n, d)``, ``v (B, H, n, dv)``, ``g (B, H)``: the
    outputs ``(B, H, n, dv)`` from a zero state."""
    B, H, n, d = q.shape
    dv = v.shape[-1]

    def z(*s):
        return torch.zeros((B, H) + s, dtype=q.dtype, device=q.device)

    st = (z(d, d), z(d, dv), z(d), z(d, dv), z(d))
    outs = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        o, st = _chunk(q[..., sl, :], k[..., sl, :], v[..., sl, :], st, g)
        outs.append(o)
    return torch.cat(outs, -2)


# -- the layers ---------------------------------------------------------------


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def head_dim(c):
    return c.get("d_head") or c["d_model"] // c["n_heads"]


def mixer(p, x, c, prec):
    B, n, _ = x.shape
    H, Hk, dh = c["n_heads"], c["n_kv_heads"], head_dim(c)

    def proj(name, heads):
        y = prec.mm(x, p[name]["kernel"])
        if "bias" in p[name]:
            y = y + p[name]["bias"]
        return y.reshape(B, n, heads, dh).transpose(1, 2)

    q = proj("wq", H) * dh**-0.5
    k, v = proj("wk", Hk), proj("wv", Hk)
    if Hk != H:
        k = k.repeat_interleave(H // Hk, dim=1)
        v = v.repeat_interleave(H // Hk, dim=1)
    if c["hla"]["decay"] != "learned":
        raise ValueError("the reference runs the learned decay only")
    g = torch.sigmoid(p["decay_a"])[None].expand(B, H)
    o = hla2(prec.act(q), prec.act(k), prec.act(v), g)
    o = o * torch.rsqrt(o.square().mean(-1, keepdim=True) + OUT_NORM_EPS)
    o = o * p["out_scale"][None, :, None, :]
    o = o.transpose(1, 2).reshape(B, n, H * dh)
    return prec.mm(o, p["wo"]["kernel"])


def mlp(p, x, prec):
    h = F.silu(prec.mm(x, p["wi_gate"]["kernel"])) \
        * prec.mm(x, p["wi_up"]["kernel"])
    return prec.mm(h, p["wo"]["kernel"])


def moe(p, x, c, prec):
    """Top-k routing in fp32, each row's (token, k) pairs kept in token
    order while their expert has room (``ceil(K n cf / E)`` slots a row),
    the kept pairs through their expert's SwiGLU and summed with their
    renormalised gates.  Returns ``(y, aux)``."""
    m = c["moe"]
    B, n, d = x.shape
    E, K = m["n_experts"], m["top_k"]
    logits = prec.act(x) @ p["router"]["kernel"]
    probs = torch.softmax(logits, -1)
    gw, ge = torch.sort(probs, dim=-1, descending=True, stable=True)
    gw, ge = gw[..., :K], ge[..., :K]
    gw = gw / gw.sum(-1, keepdim=True).clamp_min(1e-9)
    C = max(1, math.ceil(K * n * m["capacity_factor"] / E))
    e_flat = ge.reshape(B, n * K)
    oh = F.one_hot(e_flat, E)
    pos = (oh.cumsum(1) * oh).sum(-1) - 1
    keep = pos < C
    rows, toks, outs = [], [], []
    w_gate, w_up, w_out = (p[k].unbind(0) for k in ("wi_gate", "wi_up", "wo"))
    for e in range(E):
        b_idx, j_idx = ((e_flat == e) & keep).nonzero(as_tuple=True)
        t_idx, k_idx = j_idx // K, j_idx % K
        xe = x[b_idx, t_idx]
        h = F.silu(prec.mm(xe, w_gate[e])) * prec.mm(xe, w_up[e])
        ye = prec.mm(h, w_out[e])
        rows.append(b_idx)
        toks.append(t_idx)
        outs.append(gw[b_idx, t_idx, k_idx][:, None] * ye)
    y = torch.zeros_like(x).index_put(
        (torch.cat(rows), torch.cat(toks)), torch.cat(outs), accumulate=True)
    top1 = torch.zeros(E, device=x.device).index_add_(
        0, ge[..., 0].reshape(-1),
        torch.ones(B * n, device=x.device)) / (B * n)
    aux = m["aux_loss_coef"] * E * (probs.mean((0, 1)) * top1).sum()
    return y, aux


def layer(lp, x, c, prec):
    eps = c["norm_eps"]
    x = x + mixer(lp["mixer"], rmsnorm(x, lp["ln1"]["scale"], eps), c, prec)
    h = rmsnorm(x, lp["ln2"]["scale"], eps)
    if c.get("moe"):
        y, aux = moe(lp["moe"], h, c, prec)
    else:
        y, aux = mlp(lp["mlp"], h, prec), x.new_zeros(())
    return x + y, aux


def _slice(tree, i):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(params):
    """``params`` with ``layers`` made a list of each layer's own tensors
    (copies), so that a layer's gradient lands in its own leaves rather
    than in a slice of a stacked one.  Each stacked leaf is dropped from
    ``params`` once it is copied."""
    L = next(x for _, x in leaves(params["layers"])).shape[0]
    layers = [{} for _ in range(L)]

    def walk(node, dsts):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], [d.setdefault(k, {}) for d in dsts])
            else:
                for i, d in enumerate(dsts):
                    d[k] = node[k][i].clone()
                node[k] = None

    walk(params["layers"], layers)
    return dict(params, layers=layers)


def stacked(params, path):
    """The leaf at a stacked ``path`` (``layers/...`` without an index)."""
    keys = path.split("/")
    if keys[0] != "layers" or not isinstance(params["layers"], list):
        node = params
        for k in keys:
            node = node[k]
        return node

    def get(node):
        for k in keys[1:]:
            node = node[k]
        return node

    return torch.stack([get(layer) for layer in params["layers"]])


def layer_params(params, i):
    layers = params["layers"]
    return layers[i] if isinstance(layers, list) else _slice(layers, i)


def hidden(params, tokens, c, prec, *, remat=False):
    """Final-norm hidden states ``(B, n, d_model)`` and the summed MoE
    loss; ``remat`` recomputes each layer in the backward pass."""
    x = params["embed"]["embedding"][tokens]
    aux = x.new_zeros(())
    for i in range(c["n_layers"]):
        def run(x, i=i):
            return layer(layer_params(params, i), x, c, prec)

        x, a = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        aux = aux + a
    return rmsnorm(x, params["final_norm"]["scale"], c["norm_eps"]), aux


def unembed(params, x, c, prec):
    if c.get("tie_embeddings"):
        return prec.mm(x, params["embed"]["embedding"].T)
    return prec.mm(x, params["unembed"]["kernel"])


def loss(params, tokens, labels, c, prec):
    """``(ce + aux, ce, aux)``: the mean next-token cross-entropy over the
    labels and the layers' summed load-balance loss."""
    x, aux = hidden(params, tokens, c, prec, remat=True)
    logits = unembed(params, x, c, prec)
    ce = F.cross_entropy(logits.flatten(0, 1), labels.flatten())
    return ce + aux, ce, aux


@torch.no_grad()
def logits_at(params, tokens, positions, c, prec):
    """The logits ``(len(positions), vocab)`` of one row ``tokens (n,)`` at
    ``positions``."""
    x, _ = hidden(params, tokens[None], c, prec)
    return unembed(params, x[0, positions], c, prec)


def leaves(tree, prefix=()):
    """``(path, tensor)`` of every leaf, a list's items under their
    index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def cosine_lr(step, o):
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = (step - o["warmup_steps"]) / max(
        o["total_steps"] - o["warmup_steps"], 1)
    prog = min(max(prog, 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return o["lr"] * warm * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * cos)


@torch.no_grad()
def adamw(params, moments, step, o):
    """One AdamW step on every leaf after clipping the gradients to a
    global norm of ``grad_clip``; weight decay on leaves of 2 or more dims
    as the layers' stacked tensors have them (the norm scales and decay
    logits of the layers included).  Returns the gradients' global norm
    before clipping."""
    named = list(leaves(params))
    norm = torch.sqrt(sum(p.grad.square().sum() for _, p in named))
    scale = torch.clamp(o["grad_clip"] / norm.clamp_min(1e-9), max=1.0)
    lr = cosine_lr(step, o)
    b1, b2 = o["betas"]
    bc1, bc2 = 1 - b1**step, 1 - b2**step
    for (path, p), (m, v) in zip(named, moments):
        keys = path.split("/")
        dims = p.dim() + (keys[0] == "layers" and keys[1].isdigit())
        g = p.grad.mul_(scale)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(o["eps"]))
        if o["weight_decay"] and dims >= 2:
            delta.add_(p, alpha=o["weight_decay"])
        p.sub_(delta.mul_(lr))
        p.grad = None
    return norm
