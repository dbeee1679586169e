"""The traced run's reading of the profiler: device operations, host
spans, the device's busy time as the union of its operations' intervals,
and the idle gaps by what the host was doing.

The profiler (``torch.profiler``, CUPTI) runs over the measured window
only, tracing the device alone.  The host's spans are the program's
(``engine.prefill``, ``engine.decode_block``, from the engine's tracer)
and the harness's (``train.step``, ``perfbench.clients``), on the same
wall clock as the profiler's events.  Events are read raw from the
profiler's results, without building its per-event summaries.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

#: the device's activities that are work (CUPTI's kinds as the profiler
#: names them); synchronisation waits and range markers are not
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host spans' names (the device's copies of them are no work)
SPAN_PREFIXES = ("engine.", "train.", "perfbench.")


@contextlib.contextmanager
def profiling(on):
    """A CUDA-only profiler over the block when ``on``; yields it (or
    None).  Host ranges come from the harness's and the engine's own
    clocks, not from the profiler's CPU tracing, whose per-operation cost
    would slow the host-bound paths it measures."""
    if not on:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    # a CPU-only build traces nothing of a device: its host ops stand in
    kind = ProfilerActivity.CUDA if torch.cuda.is_available() \
        else ProfilerActivity.CPU
    with profile(activities=[kind]) as prof:
        yield prof


class Trace:
    """``ops``: device work ``(name, start_ns, end_ns)`` by start;
    ``spans``: host ranges ``(name, start_ns, end_ns)``; ``window``: the
    measured window ``(start_ns, end_ns)``; ``left_out``: seconds of the
    device activities that are not work, by kind.  Every time is wall
    clock in nanoseconds, the profiler's own base."""

    def __init__(self, prof, window, spans):
        from torch.autograd import DeviceType

        ops = []
        self.left_out = collections.Counter()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            kind = _kind(e)
            if kind in DEVICE_WORK:
                ops.append((e.name(), a, b))
            else:
                self.left_out[kind] += (b - a) / 1e9
        ops.sort(key=lambda x: x[1])
        self.ops = ops
        self.spans = sorted(spans, key=lambda s: s[1])
        self.window = tuple(window)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self):
        """Device operations that are kernels (no copies, no memsets)."""
        return [o for o in self.ops
                if not o[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        window."""
        w0, w1 = self.window
        out = []
        for _, a, b in self.ops:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_gaps(self):
        """``[(start_ns, end_ns)]``: the window less the busy union."""
        gaps, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = b
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def spans_named(self, name):
        return [s for s in self.spans if s[0] == name]

    def time_of(self, match):
        """``(seconds, count)`` of the kernels whose name holds one of the
        strings ``match``, inside the window."""
        w0, w1 = self.window
        hits = [(a, b) for n, a, b in self.kernels()
                if a >= w0 and b <= w1 and any(m in n for m in match)]
        return sum(b - a for a, b in hits) / 1e9, len(hits)

    def kernels_within(self, name):
        """Kernels that start inside a host span named ``name``."""
        starts = sorted(a for _, a, _ in self.kernels())
        total = 0
        for _, a, b in self.spans_named(name):
            total += bisect.bisect_right(starts, b) - bisect.bisect_left(
                starts, a)
        return total

    def breakdown(self):
        """The ten device operations with the most time, and the idle time
        by the innermost host span around each gap's middle."""
        by_op = collections.Counter()
        w0, w1 = self.window
        for n, a, b in self.ops:
            if a >= w0 and b <= w1:
                by_op[_short(n)] += (b - a) / 1e9
        # the host spans do not overlap one another: the last to start
        # before a moment is the one around it
        host = self.spans
        starts = [s[1] for s in host]
        by_host = collections.Counter()
        for a, b in self.idle_gaps():
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = host[i][0] if i >= 0 and mid <= host[i][2] else "harness"
            by_host[name] += (b - a) / 1e9
        return {"device_ops": [[n, s] for n, s in by_op.most_common(10)],
                "idle_gaps": [[n, s] for n, s in by_host.most_common(10)]}


def _kind(e):
    """The CUPTI activity kind of a device event; where the profiler does
    not give it, told from the name: range copies carry the host spans'
    names, synchronisation waits end in ``Sync`` or wait on an event."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if not name or name.startswith(SPAN_PREFIXES):
        return "gpu_user_annotation" if name else "unnamed"
    if name.endswith("Sync") or name == "Stream Wait Event":
        return "cuda_sync"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _short(name):
    """A kernel's name without its parameter list and return type."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:160]


class Spans:
    """Host spans on the wall clock in nanoseconds."""

    def __init__(self):
        self.spans = []
        # the engine's tracer times spans with perf_counter
        self.offset = time.time_ns() - time.perf_counter_ns()

    @contextlib.contextmanager
    def span(self, name):
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, a, time.time_ns()))

    def add_traced(self, records):
        """The engine tracer's span records (``ts``, ``dur_s`` on
        perf_counter)."""
        for r in records:
            a = int(r["ts"] * 1e9) + self.offset
            self.spans.append((r["name"], a, a + int(r["dur_s"] * 1e9)))

