"""Unified observability: metrics registry, span tracer, sinks, timelines.

Own copy of ``repro/obs`` (the port imports nothing of the reference
package); the artifact schemas are the reference's, so either package's
validator reads either package's files:

* ``registry``  — counters / gauges / fixed-bucket histograms with
  labeled series, bounded memory, one snapshot schema
  (``repro.obs.metrics/v1``);
* ``trace``     — wall-clock spans + point events into a bounded ring
  buffer (``repro.obs.events/v1``), optional
  ``torch.profiler.record_function`` forwarding when a card is present,
  never a device sync;
* ``sinks``     — JSONL event log, Prometheus text exposition, console
  summaries;
* ``timeline``  — per-request lifecycle reconstruction + completeness
  checks;
* ``validate``  — CLI schema validator for CI
  (``python -m repro_torch.obs.validate``);
* ``perf``      — roofline utilization against the device's peaks,
  ``torch.profiler`` capture and the bench history (writer and reader);
* ``perfcheck`` — the stdlib comparison of two bench histories;
* ``costs``     — the analytic per-op and whole-model cost model.

Nothing here imports torch at import time.  ``Obs`` bundles one
registry + one tracer, which is what components take
(``Engine(obs=...)``, ``PrefixCache(obs=...)``, ``Scheduler(obs=...)``);
each constructs a private ``Obs()`` when not given one, so tests never
share state accidentally and a CLI can thread one bundle through the
whole stack.
"""

from __future__ import annotations

from .registry import (  # noqa: F401
    LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from .sinks import (  # noqa: F401
    JsonlSink,
    console_summary,
    prometheus_text,
    read_jsonl,
    write_metrics,
    write_prometheus,
)
from .perf import BENCH_SCHEMA, profile_capture, read_bench  # noqa: F401
from .timeline import (  # noqa: F401
    check_timelines,
    render_timeline,
    request_timelines,
    terminal_events,
)
from .trace import SpanTimer, Tracer  # noqa: F401


class Obs:
    """One registry + one tracer: the bundle components program against.

    >>> obs = Obs()
    >>> ttft = obs.histogram("serving_ttft_seconds")
    >>> with obs.span("engine.prefill", rid=3):
    ...     pass
    """

    def __init__(self, *, ring: int = 4096, sinks=(), annotate="auto"):
        self.registry = Registry()
        self.tracer = Tracer(ring=ring, sinks=sinks, annotate=annotate)

    # metric declaration passes through to the registry
    def counter(self, name, help=""):
        return self.registry.counter(name, help)

    def gauge(self, name, help=""):
        return self.registry.gauge(name, help)

    def histogram(self, name, help="", buckets=LATENCY_BUCKETS,
                  sample_cap=1024):
        return self.registry.histogram(name, help, buckets=buckets,
                                       sample_cap=sample_cap)

    # tracing passes through to the tracer
    def span(self, name, **labels):
        return self.tracer.span(name, **labels)

    def event(self, name, **labels):
        self.tracer.event(name, **labels)

    def timer(self, name, **labels) -> SpanTimer:
        return SpanTimer(self.tracer, name, **labels)

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def events(self, name=None, kind=None):
        return self.tracer.events(name=name, kind=kind)

    def attach(self, sink) -> None:
        self.tracer.attach(sink)

    def reset(self) -> None:
        """Fresh epoch: zero every metric series and drop the event ring
        (post-warmup resets in CLIs/benches).  Attached sinks keep what
        they already wrote."""
        self.registry.reset()
        self.tracer.clear()

    def flush(self) -> None:
        self.tracer.flush()
