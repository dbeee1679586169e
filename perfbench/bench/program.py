"""What the benchmark takes from the program (``repro_torch``): the system
under test, built from a configuration file, and its counters."""

from __future__ import annotations

from . import weights

#: the source's scalar multipliers, which the program's LM does not apply:
#: a configuration may carry them only at 1
_UNAPPLIED = ("embedding_multiplier", "attention_multiplier",
              "residual_multiplier", "logits_scaling")


def model_config(c):
    """The program's ``ModelConfig`` for config dict ``c``."""
    from repro_torch.models.config import HLAConfig, ModelConfig, MoEConfig

    for key in _UNAPPLIED:
        if c.get(key, 1.0) != 1.0:
            raise ValueError(f"{key}={c[key]}: the program runs none")
    moe = c.get("moe")
    return ModelConfig(
        name=c["name"], n_layers=c["n_layers"], d_model=c["d_model"],
        n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"], d_ff=c["d_ff"],
        vocab=c["vocab"], d_head=c.get("d_head", 0), mixer=c["mixer"],
        mlp=c["mlp"],
        moe=None if moe is None else MoEConfig(
            n_experts=moe["n_experts"], top_k=moe["top_k"],
            d_ff=moe["d_ff"], capacity_factor=moe["capacity_factor"],
            aux_loss_coef=moe["aux_loss_coef"]),
        hla=HLAConfig(**c["hla"]), qkv_bias=c.get("qkv_bias", False),
        tie_embeddings=c.get("tie_embeddings", False),
        norm_eps=c["norm_eps"], dtype=c["dtype"],
        param_dtype=c["param_dtype"], moment_dtype=c["moment_dtype"],
        remat=c["remat"])


def check_layout(c, cfg):
    """Raise unless the benchmark's parameter tree is the program's: the
    same leaves with the same shapes."""
    from repro_torch.distributed.steps import model_specs
    from repro_torch.models.param import leaf_paths

    theirs = {"/".join(p): tuple(s.shape)
              for p, s in leaf_paths(model_specs(cfg))}
    ours = {p: tuple(shape) for p, shape, _ in weights.leaf_specs(c)}
    if theirs != ours:
        diff = sorted(set(theirs.items()) ^ set(ours.items()))
        raise ValueError(f"parameter layout differs from the program's: "
                         f"{diff[:8]}")


def served_leaf(path):
    """True for a leaf the program serves in the activation dtype (dense
    kernels, the embedding, the experts); norms, decay logits, output
    scales and the MoE router stay fp32."""
    if path.endswith("moe/router/kernel"):
        return False
    return path.endswith("/kernel") or path == "embed/embedding" or \
        path.split("/")[-1] in ("wi_gate", "wi_up", "wo")


def served_params(c, seed, device):
    """The weights in the types they are served in: each leaf made in fp32
    and the served ones rounded to ``c["dtype"]`` at once."""
    import torch

    dt = getattr(torch, c["dtype"])
    tree = {}
    for path, shape, init in weights.leaf_specs(c):
        x = weights.make_leaf(shape, init, seed, path, device)
        weights._set(tree, path, x.to(dt) if served_leaf(path) else x)
    return tree


def free():
    """Drops what the freed program state left in the allocator's cache,
    so that the reference after it starts from the card's memory."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
