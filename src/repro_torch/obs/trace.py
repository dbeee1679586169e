"""Low-overhead span tracing into a bounded ring buffer.

Own copy of ``repro/obs/trace.py``; spans forward to
``torch.profiler.record_function`` where the reference forwards them to
``jax.profiler.TraceAnnotation``.

A ``Span`` is a named wall-clock interval with sparse labels; an
``Event`` is an instantaneous point (request lifecycle transitions,
fired fault injections).  Both become one plain-dict record in a
bounded ring buffer (``collections.deque(maxlen=...)`` — old records
fall off, memory never grows) and are optionally written through to
attached sinks as they complete.

Overhead rules:

* **No device syncs.**  Timestamps are ``time.perf_counter()`` only.
  Spans around kernel launches therefore measure *dispatch + whatever
  sync the caller already performs inside the span* — the engine opens
  its block span before dispatch and closes it after the block's one
  existing host transfer, so the span is accurate without adding a
  single transfer.  Nothing here imports torch eagerly.
* **Cheap when idle.**  A span enter/exit is two ``perf_counter`` calls,
  one dict build, one deque append — no locks on the hot path (deque
  appends are atomic under the GIL; sinks that need synchronization do
  it internally).
* **Optional profiler forwarding.**  ``annotate=True`` (or ``"auto"``,
  which enables it only while a CUDA device is present) additionally
  wraps each span in ``torch.profiler.record_function`` under the span's
  name, so engine spans show up beside the kernels in a
  ``torch.profiler`` trace (``obs.perf.profile_capture``).  The
  annotation only records while a profiler is active.

Record schema (``repro.obs.events/v1`` — shared with the JSONL sink and
the CI validator)::

    {"kind": "span",  "name": "engine.decode_block", "ts": <t0>,
     "dur_s": <wall>, "seq": <n>, "depth": <nesting>, ...labels}
    {"kind": "event", "name": "request.done", "ts": <t>, "seq": <n>,
     ...labels}

``ts`` is ``perf_counter``-relative (monotonic within a process, not an
epoch) — events are for *ordering and duration*.  One clock anchors them:
each ``Tracer`` takes its ``perf_counter`` -> wall-clock offset once, at
construction (``epoch_offset_ns``), and ``int(ts * 1e9) + epoch_offset_ns``
is nanoseconds since the epoch, the base of ``torch.profiler``'s event
times.  ``JsonlSink`` stamps the offset it is given in its header and
``obs.perf.profile_capture`` maps its ``wall_ns`` payloads through it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional


def _trace_annotation(enabled) -> Optional[type]:
    """Resolve ``torch.profiler.record_function`` lazily; None =
    disabled.  ``"auto"`` enables it only when CUDA is available."""
    if not enabled:
        return None
    try:
        import torch
        from torch.profiler import record_function
    except Exception:
        return None
    if enabled == "auto" and not torch.cuda.is_available():
        return None
    return record_function


def _epoch_offset_ns() -> int:
    """``time_ns() - perf_counter_ns()``, the wall clock read on both sides
    of the ``perf_counter`` read."""
    a = time.time_ns()
    p = time.perf_counter_ns()
    return (a + time.time_ns()) // 2 - p


class Tracer:
    """Bounded ring buffer of span/event records + write-through sinks.

    ``epoch_offset_ns``: the ``perf_counter`` -> wall-clock offset taken at
    construction; a record's ``ts`` is ``int(ts * 1e9) + epoch_offset_ns``
    nanoseconds since the epoch."""

    def __init__(self, ring: int = 4096, sinks=(), annotate="auto"):
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        self.ring_size = ring
        self.epoch_offset_ns = _epoch_offset_ns()
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._sinks: List = list(sinks)
        self._seq = itertools.count()  # next() is atomic: thread-safe seq
        self._annotation = _trace_annotation(annotate)
        # per-thread span stack: nesting depth without cross-thread races
        self._local = threading.local()

    # -- recording ----------------------------------------------------------

    def _record(self, rec: dict) -> None:
        rec["seq"] = next(self._seq)
        self._ring.append(rec)
        for sink in self._sinks:
            sink.emit(rec)

    def event(self, name: str, **labels) -> None:
        """Record an instantaneous point event."""
        rec = {"kind": "event", "name": name, "ts": time.perf_counter()}
        rec.update(labels)
        self._record(rec)

    @contextlib.contextmanager
    def span(self, name: str, **labels):
        """Record a wall-clock interval; nests (``depth`` = enclosing
        spans on this thread) and yields its start (``perf_counter``).
        Exceptions propagate — the span is still recorded, flagged
        ``error=True``."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        ann = self._annotation(name) if self._annotation else None
        stack.append(name)
        t0 = time.perf_counter()
        if ann is not None:
            ann.__enter__()
        try:
            yield t0
        except BaseException:
            self._close_span(name, t0, labels, len(stack) - 1, error=True)
            raise
        else:
            self._close_span(name, t0, labels, len(stack) - 1)
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            stack.pop()

    def _close_span(self, name, t0, labels, depth, error=False):
        rec = {"kind": "span", "name": name, "ts": t0,
               "dur_s": time.perf_counter() - t0, "depth": depth}
        if error:
            rec["error"] = True
        rec.update(labels)
        self._record(rec)

    def interval(self, name: str, t0: float, t1: float, **labels) -> None:
        """Record a span timed elsewhere, from ``t0`` to ``t1``
        (``perf_counter``): depth 0, no profiler range."""
        rec = {"kind": "span", "name": name, "ts": t0, "dur_s": t1 - t0,
               "depth": 0}
        rec.update(labels)
        self._record(rec)

    # -- consumption --------------------------------------------------------

    def events(self, name: Optional[str] = None,
               kind: Optional[str] = None) -> List[dict]:
        """Current ring contents (oldest first), optionally filtered."""
        out = list(self._ring)
        if name is not None:
            out = [e for e in out if e["name"] == name]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out

    def attach(self, sink) -> None:
        """Write-through every future record to ``sink`` (e.g. attach the
        JSONL sink after a warmup run so the log starts at the measured
        traffic)."""
        self._sinks.append(sink)

    def detach(self, sink) -> None:
        self._sinks.remove(sink)

    def clear(self) -> None:
        """Drop ring contents (fresh epoch); sinks keep what they wrote."""
        self._ring.clear()

    def flush(self) -> None:
        for sink in self._sinks:
            if hasattr(sink, "flush"):
                sink.flush()


class SpanTimer:
    """Manual open/close span for intervals that cross function
    boundaries (e.g. admission -> first token).  Prefer ``Tracer.span``
    when a ``with`` block fits."""

    def __init__(self, tracer: Tracer, name: str, **labels):
        self.tracer = tracer
        self.name = name
        self.labels = labels
        self.t0 = time.perf_counter()

    def close(self, **extra) -> float:
        t1 = time.perf_counter()
        self.tracer.interval(self.name, self.t0, t1,
                             **dict(self.labels, **extra))
        return t1 - self.t0


_NESTING_DOC: Dict[str, str] = {
    # every span and event name the port emits, with where it nests;
    # tests/test_torch_obs.py holds it to the names in the source
    "request.queued": "request entered the scheduler's queue (submit)",
    "request.admitted": "slot assigned, prefill done, first token sampled",
    "request.first_token": "first token of a request (after its admission)",
    "request.done": "terminal: status in ok|error|timeout|cancelled",
    "engine.queue_wait": "submit -> start of the request's engine.prefill "
                         "(span, recorded at admission; rid)",
    "engine.prefill": "chunk-parallel admission prefill (span)",
    "engine.prefill_dispatch": "engine.prefill's start through "
                               "pool.write_slot: ids to the card, "
                               "lm_prefill, sampling, flags (child span)",
    "engine.prefill_sync": "engine.prefill's one host transfer "
                           "(child span)",
    "engine.decode_block": "one step-locked decode block (span)",
    "engine.decode_step": "one step of a decode block: lm_apply(decode), "
                          "sampling, token select (child span)",
    "engine.block_sync": "after a block's last step: token copy, finite "
                         "mask, the block's one transfer (child span)",
    "engine.spec_round": "one draft->verify->accept round (span)",
    "breaker.tripped": "speculative decoding fell back to plain blocks",
    "stream.hook_error": "the streaming hook raised; streaming stops",
    "cache.hit": "prefix cache lookup found a snapshot",
    "cache.corrupt_dropped": "a cached snapshot failed its checksum",
    "cache.evicted": "LRU eviction of a cached snapshot",
    "sched.expired": "a queued request's deadline passed",
    "sched.stall": "a sched.stall fault held admissions",
    "sched.promote": "a queued request aged into a better class",
    "server.start": "AsyncServer's drive loop started",
    "server.drain": "AsyncServer stops taking requests and drains",
    "server.stop": "AsyncServer's drive loop ended",
    "train.step": "one optimizer step (span)",
    "train.resumed": "checkpoint auto-resume on loop entry",
    "ckpt.save": "one checkpoint save (span, async thread)",
    "ckpt.restore": "one checkpoint restore (span)",
    "fault.fired": "a runtime.faults injection point fired",
    "profile.start": "torch.profiler capture opened (perf.py; wall_ns is "
                     "the event's ts on the tracer's clock)",
    "profile.stop": "torch.profiler capture closed",
}
