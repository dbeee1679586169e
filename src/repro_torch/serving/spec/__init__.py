"""Speculative decoding for the state-pool serving engine (twin of
``repro/serving/spec/``).

HLA's constant-size recurrent state suits speculative decoding:

* **verify is one prefill**: scoring k draft tokens is one chunk-parallel
  ``lm.lm_score_block`` pass (one chunk-kernel launch per layer, the pool's
  states as its carry), not k serial decode steps;
* **rollback is O(state)**: a rejected continuation costs per-slot state
  copies and a replay of the accepted prefix, never a KV-cache truncation.

Layering:

* ``drafters``: the ``Drafter`` interface, ``NGramDrafter`` (prompt lookup)
  and ``HLADrafter`` (a small HLA draft LM with its own weights and pool);
* ``verify``: chunk-parallel scoring, greedy and distribution-preserving
  acceptance, and the rollback over in-place decode state;
* ``SpecConfig``: the ``Engine(spec=...)`` knob.
"""

from __future__ import annotations

import dataclasses
from typing import Union

from .drafters import Drafter, HLADrafter, NGramDrafter, build_drafter
from .verify import make_replay, make_spec_round, make_verify


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding configuration for ``serving.engine.Engine``."""

    k: int = 4  # draft tokens per round (the literature's gamma)
    drafter: Union[str, Drafter] = "ngram"  # "ngram" | "lm" | instance
    # "lm" drafter: a configs registry entry with a streaming mixer
    draft_arch: str = "hla-1b"
    draft_reduced: bool = True
    draft_seed: int = 0
    # "ngram" drafter: trailing n-gram sizes tried, longest first
    ngram_max: int = 3
    ngram_min: int = 1
    # circuit breaker: a drafter exception, or ``breaker_zero_rounds``
    # consecutive rounds in which NO draft token was accepted, trips the
    # engine from speculative to plain block decode (greedy output is the
    # same either way).  After ``breaker_cooldown_blocks`` plain blocks it
    # goes half-open: the drafter is resynced with each live slot's
    # committed context and probed for one round; success closes it,
    # another failure opens it for a fresh cooldown.
    breaker_zero_rounds: int = 4
    breaker_cooldown_blocks: int = 8


__all__ = [
    "Drafter", "HLADrafter", "NGramDrafter", "SpecConfig",
    "build_drafter", "make_replay", "make_spec_round", "make_verify",
]
