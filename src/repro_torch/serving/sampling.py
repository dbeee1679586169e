"""Seeded device-side token sampling: greedy / temperature / top-k / top-p.

Twin of ``repro/serving/sampling.py`` with a ``torch.Generator`` in place of
a JAX key.  Draws use the Gumbel-max trick (argmax of the warped logits
plus Gumbel noise), which stays on the device and never syncs.  The two
packages draw different numbers from the same seed: only greedy decoding
matches token for token.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    method: str = "greedy"  # greedy | temperature | top_k | top_p
    temperature: float = 1.0
    top_k: int = 0  # only read when method == "top_k"
    top_p: float = 1.0  # only read when method == "top_p" (nucleus)


def warped_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Temperature/top-k/top-p warping in logit space (-inf = masked)."""
    lg = logits.float() / max(cfg.temperature, 1e-6)
    if cfg.method == "top_k":
        if cfg.top_k <= 0:
            raise ValueError("top_k sampling needs top_k > 0")
        kth = torch.topk(lg, cfg.top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, -torch.inf)
    elif cfg.method == "top_p":
        if not 0.0 < cfg.top_p <= 1.0:
            raise ValueError("top_p sampling needs 0 < top_p <= 1")
        # nucleus: keep the smallest prefix of the sorted distribution whose
        # mass reaches top_p (the token that crosses it is kept, so the set
        # is never empty)
        srt = torch.sort(lg, dim=-1, descending=True).values
        p = torch.softmax(srt, dim=-1)
        keep = torch.cumsum(p, dim=-1) - p < cfg.top_p
        thr = torch.where(keep, srt, torch.inf).amin(-1, keepdim=True)
        lg = lg.masked_fill(lg < thr, -torch.inf)
    elif cfg.method not in ("temperature", "greedy"):
        raise ValueError(f"unknown sampling method {cfg.method!r}")
    return lg


def sample(logits: torch.Tensor, generator: torch.Generator,
           cfg: SamplingConfig) -> torch.Tensor:
    """Sample next tokens from ``(..., vocab)`` logits -> ``(...,)`` int64.
    ``generator`` (on the logits' device) is unused for greedy."""
    if cfg.method == "greedy":
        return logits.argmax(-1)
    lg = warped_logits(logits, cfg)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    return (lg - torch.log(-torch.log(u))).argmax(-1)
