"""Content-addressed prefix/state cache (twin of ``repro/serving/cache.py``).

For the paper's streaming ops a whole prompt prefix is summarized by a
**constant-size sufficient statistic**: a cached prefix is ONE O(1) state
snapshot (five tensors per layer for hla-1b, whatever the prefix length),
so the cache is a dict of host tensors with a byte budget, not an
allocator.

* **Keying** — a polynomial rolling hash over the prompt token ids at
  chunk-granularity prefix lengths (``granularity`` tokens), seeded by the
  cache's ``namespace`` (model/params identity).  Every probe verifies the
  stored token ids before it hits, so a hash collision costs a miss, never
  a wrong token.
* **Lookup** — longest prefix first; the first verified entry wins.
  Resuming from the snapshot is exact by the chunkwise carry identity the
  prefill kernels keep (``lm.lm_prefill(states=...)``).
* **Insertion** — on prefill completion the engine inserts the state at
  the longest chunk-aligned prompt boundary, fetched to the host in the
  admission's one sync (``Engine.admit``).  Entries are CPU tensors (pinned
  when they came from the card): cached prefixes take host RAM, never
  device memory.
* **Eviction** — LRU under an explicit byte budget; ``state_bytes_for``
  gives one entry's size, so a budget is sized as "N cached prefixes".
* **Integrity** — every entry carries a crc32 over its leaf bytes,
  checked on every hit; a corrupt entry (the ``cache.corrupt`` fault
  point, or a real bit flip) is dropped and the lookup falls through to
  shorter prefixes or a cold prefill.  The crc32 runs over each leaf's own
  buffer (no byte copy) and equals the reference's for the same bytes in
  the same leaf order.
"""

from __future__ import annotations

import collections
import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.state_tree import flatten, leaves
from ..obs import Obs

# polynomial rolling hash over token ids: h_{i+1} = h_i * _BASE + tok + 1
# mod 2^61-1.  Deterministic across processes (unlike hash()), cheap to
# extend one token at a time, and collision-checked by token comparison.
_MOD = (1 << 61) - 1
_BASE = 1_000_003


def rolling_hashes(tokens: np.ndarray, lengths: List[int]) -> List[int]:
    """Hashes of ``tokens[:n]`` for each n in ``lengths`` (ascending),
    in one O(len) pass."""
    out, h, done = [], 0, 0
    for n in lengths:
        for t in tokens[done:n]:
            h = (h * _BASE + int(t) + 1) % _MOD
        done = n
        out.append(h)
    return out


def _leaf_bytes(leaf: torch.Tensor) -> np.ndarray:
    """The leaf's bytes as a flat uint8 view of its own (CPU) buffer."""
    # a host tensor: entries are CPU tensors, so this moves nothing
    return leaf.detach().contiguous().reshape(-1).view(  # noqa: RPR004
        torch.uint8).numpy()


def tree_bytes(tree) -> int:
    """Total bytes of a state snapshot's leaves."""
    return int(sum(x.numel() * x.element_size() for x in leaves(tree)))


def tree_checksum(tree) -> int:
    """crc32 over every leaf's raw bytes (order = tree leaf order), read
    in place from each contiguous leaf's buffer."""
    crc = 0
    for leaf in leaves(tree):
        crc = zlib.crc32(_leaf_bytes(leaf), crc)
    return crc


def state_bytes_for(cfg, *, max_len: int = 64) -> int:
    """One entry's bytes: the whole LM's decode state for one sequence,
    summed over the leaves of ``lm_init_states(cfg, 1)`` built on the meta
    device (no memory).  ``max_len`` is accepted for the reference's
    signature; a streaming state does not depend on it.  Sizing a budget as
    ``n_entries * state_bytes_for(cfg)`` caches about n_entries prefixes
    whatever their lengths."""
    from ..models import lm

    return tree_bytes(lm.lm_init_states(cfg, 1, torch.device("meta")))


@dataclasses.dataclass
class CacheEntry:
    key: Tuple[int, int]          # (prefix_len, rolling hash)
    tokens: np.ndarray            # the exact prefix ids (collision guard)
    state: Any                    # host state tree (CPU tensors)
    nbytes: int
    checksum: int
    hits: int = 0


class PrefixCache:
    """Longest-prefix -> state-snapshot cache with LRU byte budgeting.

    ``granularity`` is the chunk width prefixes are keyed at; cache
    boundaries are the chunkwise prefill's resume points.  ``budget_bytes``
    bounds HOST memory; inserting past it evicts least-recently-used
    entries first.  ``namespace`` scopes keys to one model+params identity.

    All mutation happens on the engine drive loop (the async server runs
    that loop one tick at a time), so no lock is needed.
    """

    def __init__(self, *, granularity: int = 256,
                 budget_bytes: int = 1 << 30, namespace: str = "",
                 obs: Optional[Obs] = None, faults=None):
        if granularity < 1:
            raise ValueError(f"granularity must be >= 1: {granularity}")
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0: {budget_bytes}")
        self.granularity = granularity
        self.budget_bytes = budget_bytes
        self.namespace = namespace
        self.faults = faults
        # key -> entry, ordered oldest-used first (OrderedDict LRU)
        self._entries: "collections.OrderedDict[Tuple[int, int], CacheEntry]" \
            = collections.OrderedDict()
        self._lengths: collections.Counter = collections.Counter()
        self.bytes = 0
        self._own_obs = obs is None
        self._declare_metrics(obs if obs is not None else Obs())

    def bind_obs(self, obs: Obs) -> None:
        """Re-home the cache's metric series into ``obs`` (the engine does
        this for a cache built without a bundle, so one snapshot carries
        engine, scheduler and cache counters together)."""
        self._own_obs = False
        self._declare_metrics(obs)

    def _declare_metrics(self, obs: Obs) -> None:
        self.obs = m = obs
        self._m_hits = m.counter(
            "cache_hits_total", "lookups that resumed from a snapshot")
        self._m_misses = m.counter(
            "cache_misses_total", "lookups with no usable prefix")
        self._m_inserts = m.counter(
            "cache_insertions_total", "entries inserted")
        self._m_evicted = m.counter(
            "cache_evicted_bytes_total", "bytes LRU-evicted over budget")
        self._m_corrupt = m.counter(
            "cache_corrupt_dropped_total",
            "entries dropped on checksum mismatch")
        self._m_entries = m.gauge("cache_entries", "live entries")
        self._m_bytes = m.gauge("cache_bytes", "live host bytes")
        self._m_hit_toks = m.histogram(
            "cache_hit_prefix_tokens", "prefix tokens served from cache",
            buckets=(16, 64, 256, 1024, 4096, 16384))

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every entry.  Counters are cumulative and unaffected; the
        entry/byte gauges go to zero."""
        self._entries.clear()
        self._lengths.clear()
        self.bytes = 0
        self._m_entries.set(0.0)
        self._m_bytes.set(0.0)

    # -- keying -------------------------------------------------------------

    def _ns_seed(self) -> int:
        return zlib.crc32(self.namespace.encode()) % _MOD

    def _candidate_lengths(self, n_tokens: int,
                           max_prefix: Optional[int]) -> List[int]:
        """Chunk-aligned prefix lengths to probe, ascending: only lengths
        present in the cache."""
        cap = n_tokens if max_prefix is None else min(n_tokens, max_prefix)
        return [n for n in sorted(self._lengths)
                if n <= cap and self._lengths[n] > 0]

    def aligned_len(self, n_tokens: int) -> int:
        """Longest chunk-aligned prefix length usable for a prompt of
        ``n_tokens`` (at least one token must remain to sample from)."""
        return ((n_tokens - 1) // self.granularity) * self.granularity

    # -- lookup / insert ----------------------------------------------------

    def _drop(self, entry: CacheEntry) -> None:
        self._entries.pop(entry.key, None)
        self._lengths[entry.key[0]] -= 1
        self.bytes -= entry.nbytes
        self._m_entries.set(float(len(self._entries)))
        self._m_bytes.set(float(self.bytes))

    def _corrupt_if_injected(self, entry: CacheEntry) -> None:
        """The ``cache.corrupt`` fault point: flip bytes in a copy of one
        leaf of the entry the lookup is about to return, and splice the
        copy into the entry."""
        if self.faults is None or self.faults.hit("cache.corrupt") is None:
            return
        flat, rebuild = flatten(entry.state)
        leaf = flat[0].clone()
        buf = leaf.reshape(-1).view(torch.uint8)
        buf[: max(1, buf.numel() // 16)] ^= 0xFF
        flat[0] = leaf
        entry.state = rebuild(flat)

    def lookup(self, tokens, *, max_prefix: Optional[int] = None
               ) -> Optional[Tuple[int, Any]]:
        """Longest verified cached prefix of ``tokens``: ``(prefix_len,
        host_state)`` or None.  ``max_prefix`` caps the usable length (the
        engine passes ``len(prompt) - 1``).  Corrupt or colliding entries
        are dropped or skipped and the next-shorter candidate is tried."""
        toks = np.asarray(tokens).reshape(-1)
        lengths = self._candidate_lengths(len(toks), max_prefix)
        if not lengths:
            self._m_misses.inc()
            return None
        hashes = rolling_hashes(toks, lengths)
        seed = self._ns_seed()
        for n, h in zip(reversed(lengths), reversed(hashes)):
            entry = self._entries.get((n, (h + seed) % _MOD))
            if entry is None:
                continue
            if not np.array_equal(entry.tokens, toks[:n]):
                continue  # hash collision: content mismatch, keep probing
            self._corrupt_if_injected(entry)
            if tree_checksum(entry.state) != entry.checksum:
                self._drop(entry)
                self._m_corrupt.inc()
                self.obs.event("cache.corrupt_dropped", prefix_len=n)
                continue
            self._entries.move_to_end(entry.key)  # LRU touch
            entry.hits += 1
            self._m_hits.inc()
            self._m_hit_toks.observe(float(n))
            self.obs.event("cache.hit", prefix_len=n, hits=entry.hits)
            return n, entry.state
        self._m_misses.inc()
        return None

    def insert(self, tokens, state) -> bool:
        """Insert a host state snapshot for the chunk-aligned prefix
        ``tokens``.  Refreshes LRU on re-insertion of a live key.  Returns
        False when rejected (misaligned length or larger than the whole
        budget)."""
        toks = np.asarray(tokens).reshape(-1).astype(np.int64)
        n = len(toks)
        if n == 0 or n % self.granularity != 0:
            return False
        nbytes = tree_bytes(state)
        if nbytes > self.budget_bytes:
            return False
        h = (rolling_hashes(toks, [n])[0] + self._ns_seed()) % _MOD
        key = (n, h)
        old = self._entries.get(key)
        if old is not None and np.array_equal(old.tokens, toks):
            self._entries.move_to_end(key)
            return True  # already cached: refresh recency, keep the entry
        if old is not None:
            self._drop(old)  # same key, different tokens: collision — replace
        entry = CacheEntry(key=key, tokens=toks, state=state, nbytes=nbytes,
                           checksum=tree_checksum(state))
        self._entries[key] = entry
        self._lengths[n] += 1
        self.bytes += nbytes
        self._m_inserts.inc()
        while self.bytes > self.budget_bytes and len(self._entries) > 1:
            _, lru = next(iter(self._entries.items()))
            if lru is entry:
                break
            self._drop(lru)
            self._m_evicted.inc(lru.nbytes)
            self.obs.event("cache.evicted", prefix_len=lru.key[0],
                           nbytes=lru.nbytes)
        self._m_entries.set(float(len(self._entries)))
        self._m_bytes.set(float(self.bytes))
        return True

    def stats(self) -> Dict[str, float]:
        hits = self._m_hits.total()
        misses = self._m_misses.total()
        return {
            "entries": float(len(self._entries)),
            "bytes": float(self.bytes),
            "hits": hits,
            "misses": misses,
            "hit_rate": hits / max(hits + misses, 1.0),
            "evicted_bytes": self._m_evicted.total(),
        }
