"""Dependency-free metrics registry: counters, gauges, histograms.

Own copy of ``repro/obs/registry.py`` (the port imports nothing of the
reference package).  The snapshot schema id ``repro.obs.metrics/v1`` names
the file format, not the package: the reference's validator reads the
port's artifacts and the other way round.

Design rules:

* **Bounded memory.**  Every instrument stores a fixed amount of state
  per labeled series: counters/gauges one float, histograms a fixed
  bucket-count vector plus count/sum/min/max and a bounded reservoir of
  recent samples.  Nothing grows with traffic — the unbounded
  ``stats["ttft_s"]`` list this replaces grew one float per request
  forever.
* **No device syncs.**  Instruments take plain Python numbers; callers
  observe values they already hold on the host (wall-clock deltas, token
  counts fetched at the engine's existing once-per-block sync).  Nothing
  in this module imports torch.
* **Thread-safe.**  The checkpoint manager observes save durations from
  its async thread; all mutation goes through one registry lock (the
  hot-path cost is one uncontended lock acquire per observation).

Naming convention: ``<subsystem>_<what>_<unit>`` with counters suffixed
``_total`` (``serving_ttft_seconds``, ``train_steps_total``,
``ckpt_save_seconds``).  Labels are sparse key=value pairs
(``status="timeout"``, ``point="engine.nan_state"``); a metric's series
are keyed by the sorted label tuple.

``Registry.snapshot()`` is the one export format — a plain-dict,
JSON-able view consumed by the JSONL/console/Prometheus sinks, the CLI
``--metrics-out`` dumps, and ``benchmarks/report.py``.  ``merge``
folds one snapshot into another (multi-process aggregation: counters and
histogram buckets add, gauges last-write-wins).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


#: default latency bucket edges (seconds): 100us .. ~105s, x2 per bucket.
LATENCY_BUCKETS = tuple(1e-4 * 2 ** i for i in range(21))


class Metric:
    """Base: one named instrument holding labeled series."""

    kind = "metric"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: Dict[LabelKey, object] = {}

    def labels(self) -> List[Dict[str, str]]:
        return [dict(k) for k in self._series]


class Counter(Metric):
    """Monotonic (float) accumulator, optionally labeled."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        """Sum over every labeled series."""
        with self._lock:
            return float(sum(self._series.values()))

    def _set(self, value: float, **labels) -> None:
        """Compat-shim backdoor (``Engine.stats`` writes); not public API."""
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot_series(self):
        with self._lock:
            return [
                {"labels": dict(k), "value": v}
                for k, v in sorted(self._series.items())
            ]

    def merge_series(self, series) -> None:
        for s in series:
            self.inc(s["value"], **s["labels"])


class Gauge(Metric):
    """Point-in-time value (queue depth, slot occupancy, last loss)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot_series(self):
        with self._lock:
            return [
                {"labels": dict(k), "value": v}
                for k, v in sorted(self._series.items())
            ]

    def merge_series(self, series) -> None:
        for s in series:  # last-write-wins
            self.set(s["value"], **s["labels"])


class _HistSeries:
    """Fixed-bucket histogram state: bucket counts + count/sum/min/max +
    a bounded ring of recent raw samples (for exact small-N quantiles and
    the ``stats["ttft_s"]`` compat view)."""

    __slots__ = ("counts", "count", "sum", "min", "max", "samples", "_cap",
                 "_next")

    def __init__(self, n_buckets: int, sample_cap: int):
        self.counts = [0] * (n_buckets + 1)  # +1 = overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._cap = sample_cap
        self._next = 0
        self.samples: List[float] = []


class Histogram(Metric):
    """Fixed-bucket-edge histogram with bounded sample reservoir.

    ``observe`` is O(log n_buckets).  Quantiles come from the raw sample
    ring while the series has seen <= ``sample_cap`` values (exact), and
    from linear interpolation inside the cumulative bucket counts after
    that (bounded error = bucket width).
    """

    kind = "histogram"

    def __init__(self, name, help, lock, buckets: Sequence[float],
                 sample_cap: int = 1024):
        super().__init__(name, help, lock)
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(
                f"histogram {name}: bucket edges must be non-empty, "
                f"sorted, unique; got {buckets}"
            )
        self.buckets = edges
        self.sample_cap = int(sample_cap)

    def _get(self, key: LabelKey) -> _HistSeries:
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(
                len(self.buckets), self.sample_cap
            )
        return s

    def observe(self, value: float, **labels) -> None:
        import bisect

        value = float(value)
        key = _label_key(labels)
        with self._lock:
            s = self._get(key)
            s.counts[bisect.bisect_left(self.buckets, value)] += 1
            s.count += 1
            s.sum += value
            s.min = value if s.min is None else min(s.min, value)
            s.max = value if s.max is None else max(s.max, value)
            if len(s.samples) < s._cap:
                s.samples.append(value)
            else:  # overwrite oldest: a ring, never growth
                s.samples[s._next] = value
                s._next = (s._next + 1) % s._cap

    def count(self, **labels) -> int:
        s = self._series.get(_label_key(labels))
        return 0 if s is None else s.count

    def sum(self, **labels) -> float:
        s = self._series.get(_label_key(labels))
        return 0.0 if s is None else s.sum

    def recent(self, **labels) -> List[float]:
        """The bounded reservoir of recent samples (compat view)."""
        s = self._series.get(_label_key(labels))
        return [] if s is None else list(s.samples)

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Estimate the q-quantile (q in [0, 1]) of one series."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        s = self._series.get(_label_key(labels))
        if s is None or s.count == 0:
            return None
        if s.count <= len(s.samples):  # reservoir still exact
            xs = sorted(s.samples)
            return xs[min(int(q * len(xs)), len(xs) - 1)]
        rank = q * s.count
        cum = 0
        for i, c in enumerate(s.counts):
            if cum + c >= rank and c > 0:
                lo = self.buckets[i - 1] if i > 0 else (
                    s.min if s.min is not None else 0.0
                )
                hi = self.buckets[i] if i < len(self.buckets) else s.max
                frac = (rank - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return s.max

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot_series(self):
        with self._lock:
            out = []
            for k, s in sorted(self._series.items()):
                out.append({
                    "labels": dict(k),
                    "count": s.count, "sum": round(s.sum, 9),
                    "min": s.min, "max": s.max,
                    "bucket_counts": list(s.counts),
                })
            return out

    def merge_series(self, series) -> None:
        with self._lock:
            for other in series:
                key = _label_key(other["labels"])
                s = self._get(key)
                bc = other["bucket_counts"]
                if len(bc) != len(s.counts):
                    raise ValueError(
                        f"histogram {self.name}: merging series with "
                        f"{len(bc)} buckets into {len(s.counts)}"
                    )
                s.counts = [a + b for a, b in zip(s.counts, bc)]
                s.count += other["count"]
                s.sum += other["sum"]
                for field, pick in (("min", min), ("max", max)):
                    ov = other.get(field)
                    if ov is not None:
                        cur = getattr(s, field)
                        setattr(s, field,
                                ov if cur is None else pick(cur, ov))


class Registry:
    """A named collection of instruments with one shared lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _declare(self, cls, name, help, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m
        m = cls(name, help, self._lock, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._declare(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._declare(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS,
                  sample_cap: int = 1024) -> Histogram:
        return self._declare(Histogram, name, help, buckets=tuple(buckets),
                             sample_cap=sample_cap)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def reset(self) -> None:
        """Zero every series (fresh traffic epoch, e.g. post-warmup);
        metric declarations survive."""
        for m in self._metrics.values():
            m.reset()

    def snapshot(self) -> dict:
        """Plain-dict JSON-able view of every metric — THE export schema
        (sinks, ``--metrics-out``, benchmarks, the CI validator)."""
        out = {"schema": "repro.obs.metrics/v1", "metrics": {}}
        for name, m in sorted(self._metrics.items()):
            entry = {"kind": m.kind, "help": m.help,
                     "series": m.snapshot_series()}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
            out["metrics"][name] = entry
        return out

    def merge(self, snapshot: dict) -> None:
        """Fold a ``snapshot()`` from another registry/process into this
        one: counters and histogram buckets add, gauges last-write-wins."""
        if snapshot.get("schema") != "repro.obs.metrics/v1":
            raise ValueError(
                f"unknown metrics schema {snapshot.get('schema')!r}"
            )
        kinds = {"counter": self.counter, "gauge": self.gauge}
        for name, entry in snapshot["metrics"].items():
            if entry["kind"] == "histogram":
                m = self.histogram(name, entry.get("help", ""),
                                   buckets=entry["buckets"])
            else:
                m = kinds[entry["kind"]](name, entry.get("help", ""))
            m.merge_series(entry["series"])
