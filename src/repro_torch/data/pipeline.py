"""Deterministic synthetic data pipeline (host-sharded, restart-safe).

The port's own copy of ``repro/data/pipeline.py`` (numpy only): the same
seed gives the same batches in both packages.

Every batch is a pure function of (seed, step, host_shard) — after a
restart the stream resumes exactly, and multi-host launches read disjoint
global-batch slices with no coordination (the production property that
matters; the token *distribution* is synthetic: Zipf-ish LM stream plus
task generators used by the examples/benchmarks).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "zipf"  # zipf | copy | recall


class SyntheticStream:
    """Iterator of {tokens, labels} for one host's slice of the batch."""

    def __init__(self, cfg: DataConfig, host_index: int = 0, host_count: int = 1):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count

    def batch(self, step: int):
        cfg = self.cfg
        seq = np.random.SeedSequence(
            entropy=(cfg.seed, step, self.host_index)
        )
        rng = np.random.Generator(np.random.Philox(seq))
        B, n, V = self.local_batch, cfg.seq_len, cfg.vocab
        if cfg.kind == "zipf":
            # zipf-distributed ids with short-range structure (bigram-ish
            # repeats) so a real model can actually reduce loss.
            base = rng.zipf(1.3, size=(B, n + 1)).astype(np.int64) % V
            rep = rng.random((B, n + 1)) < 0.3
            base[:, 1:][rep[:, 1:]] = base[:, :-1][rep[:, 1:]]
            tokens = base[:, :-1].astype(np.int32)
            labels = base[:, 1:].astype(np.int32)
        elif cfg.kind == "copy":
            half = n // 2
            pattern = rng.integers(2, V, size=(B, half), dtype=np.int32)
            tokens = np.concatenate(
                [pattern, np.full((B, n - half), 1, np.int32)], axis=1
            )
            labels = np.concatenate(
                [np.full((B, half), -1, np.int32),
                 pattern[:, : n - half]], axis=1
            )
        elif cfg.kind == "recall":
            # associative recall: k1 v1 k2 v2 ... query k_i -> predict v_i
            pairs = (n - 2) // 2
            keys = rng.integers(2, V // 2, size=(B, pairs), dtype=np.int32)
            vals = rng.integers(V // 2, V, size=(B, pairs), dtype=np.int32)
            inter = np.stack([keys, vals], axis=-1).reshape(B, -1)
            qidx = rng.integers(0, pairs, size=(B,))
            qk = keys[np.arange(B), qidx]
            qv = vals[np.arange(B), qidx]
            tokens = np.concatenate(
                [inter, qk[:, None],
                 np.full((B, n - inter.shape[1] - 1), 1, np.int32)], axis=1
            )[:, :n]
            labels = np.full((B, n), -1, np.int32)
            labels[:, inter.shape[1]] = qv  # predict value right after query
        else:
            raise ValueError(cfg.kind)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
