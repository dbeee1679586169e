"""The one generator of every traffic mix: it reads a mix's data file
(``traffic/<name>.json``) and makes its inputs from the run's seed.

Kinds:

* ``train``: a fresh batch of ``batch`` rows of ``seq_len + 1`` token ids
  a step, uniform over the vocabulary, tokens and their next-token labels.
  Batch ``i`` comes from its own generator, so a check can make it again.
* ``closed_loop``: ``clients`` callers, each sending its next request as
  soon as its reply is complete.  The lengths do not depend on the run's
  seed, so every seed does the same work: round ``k`` (every client's
  ``k``-th request) takes the quantiles ``(j + f_k) / clients`` of the
  prompt and output distributions (``f_k`` a fixed low-discrepancy
  offset), dealt to the clients by permutations drawn from the mix's own
  ``schedule_seed``.  A closed loop's queueing follows the order in which
  long and short requests meet, so an order drawn from the run's seed
  would change the tails from seed to seed.  Round 0 is staggered: its
  output lengths are scaled by ``(j + 0.5) / clients``, so the first
  replies finish spread over the first output length and the engine
  starts near its steady mix.  Prompt ids are uniform over the
  vocabulary, from a generator per request and the run's seed.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

from . import seeds

_GOLDEN = (math.sqrt(5) - 1) / 2


def quantile(spec, u):
    """The ``u``-quantile of a length distribution, as a whole number
    within ``[min, max]``."""
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "lognormal":
        x = math.exp(math.log(spec["median"])
                     + spec["sigma"] * NormalDist().inv_cdf(u))
    elif spec["dist"] == "uniform":
        x = lo + u * (hi - lo + 1) - 0.5
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return int(min(hi, max(lo, round(x))))


def train_batch(t, vocab, seed, i, device):
    """Batch ``i`` of a ``train`` mix: ``{"tokens", "labels"}``, ``(batch,
    seq_len)`` int64 on ``device``."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, "batch", i))
    x = torch.randint(0, vocab, (t["batch"], t["seq_len"] + 1),
                      generator=gen, device=device)
    return {"tokens": x[:, :-1].contiguous(), "labels": x[:, 1:].contiguous()}


@dataclasses.dataclass
class Request:
    rid: int
    client: int
    round: int
    prompt: np.ndarray
    max_new: int


class ClosedLoop:
    """The requests of a ``closed_loop`` mix for one seed."""

    def __init__(self, t, vocab, seed):
        self.t, self.vocab, self.seed = t, vocab, seed
        self.clients = t["clients"]
        self._rounds = {}
        self._next_rid = 0

    def _round(self, k):
        if k not in self._rounds:
            n = self.clients
            f = 0.5 if k == 0 else (k * _GOLDEN) % 1.0
            us = [(j + f) / n for j in range(n)]
            prompts = [quantile(self.t["prompt"], u) for u in us]
            outs = [quantile(self.t["output"], u) for u in us]
            if k == 0:
                low = self.t["output"]["min"]
                outs = [max(1, math.ceil(low * (j + 0.5) / n))
                        for j in range(n)]
            rng = np.random.default_rng(
                seeds.derive(self.t["schedule_seed"], "round", k))
            self._rounds[k] = (np.asarray(prompts)[rng.permutation(n)],
                               np.asarray(outs)[rng.permutation(n)])
        return self._rounds[k]

    def lengths(self, client, k):
        prompts, outs = self._round(k)
        return int(prompts[client]), int(outs[client])

    def request(self, client, k):
        """Client ``client``'s ``k``-th request."""
        L, out = self.lengths(client, k)
        rng = np.random.default_rng(
            seeds.derive(self.seed, "prompt", client, k))
        rid = self._next_rid
        self._next_rid += 1
        return Request(rid, client, k, rng.integers(0, self.vocab, L),
                       out)
