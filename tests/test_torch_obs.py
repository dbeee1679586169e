"""The port's observability core (``repro_torch.obs``) against the
reference's (``repro.obs``): twins of ``tests/test_obs.py``'s registry,
tracer, sink, timeline and validator cases, and one serve trace driven
through both engines.

The trace parity cases run reduced hla-1b (2 layers, d_model 64, fp32) with
the reference's weights carried across by ``from_jax_params``, a prefix
cache, scheduler priorities and tenants, a cancelled and an expired
request, and injected faults; greedy, so everything compared is exact:
metric names and label sets (the port adds exactly two counters,
``serving_decode_steps_total`` and ``serving_spec_replay_steps_total``),
counter totals except wall-clock seconds, gauge values, histogram counts,
and the sequence of every event record's (kind, name, rid, status).  The
port's artifacts must pass both packages' validators.  What the port adds
is held apart: the child spans that tile an admission and a decode block,
each request's ``engine.queue_wait``, and ``serving_inter_token_seconds``
taken once a finished request (the reference takes it once a block).
"""

import collections
import io
import json
import re
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro.obs.validate import main as ref_validate_main
from repro.runtime.faults import FaultPlan as RefPlan
from repro.runtime.faults import FaultSpec as RefFaultSpec
from repro.serving import Engine as RefEngine
from repro.serving import GenRequest as RefRequest
from repro.serving import PrefixCache as RefCache
from repro.serving import SpecConfig as RefSpec
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params
from repro_torch.obs import (
    JsonlSink,
    Obs,
    Registry,
    Tracer,
    check_timelines,
    console_summary,
    profile_capture,
    prometheus_text,
    read_jsonl,
    render_timeline,
    request_timelines,
    terminal_events,
    write_metrics,
)
from repro_torch.obs.trace import _NESTING_DOC
from repro_torch.obs.validate import (
    check_requests,
    counter_total,
    main as validate_main,
    validate_events,
    validate_metrics,
)
from repro_torch.runtime.faults import FaultPlan, FaultSpec
from repro_torch.serving import Engine, GenRequest, PrefixCache, SpecConfig

#: the port's counters beside the reference's metric names
PORT_EXTRAS = {"serving_decode_steps_total",
               "serving_spec_replay_steps_total"}
#: the port's spans beside the reference's: the children of an admission
#: and of a decode block, and each admitted request's queue wait
PORT_SPANS = {"engine.prefill_dispatch", "engine.prefill_sync",
              "engine.decode_step", "engine.block_sync", "engine.queue_wait"}
#: histograms whose observations the port takes otherwise
PORT_OBSERVED = {"serving_inter_token_seconds"}


@pytest.fixture(scope="module")
def model():
    ref_cfg = ref_get_config("hla-1b", reduced=True)
    cfg = get_config("hla-1b", reduced=True)
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


# -- registry ---------------------------------------------------------------


class TestRegistry:
    def test_counter_labels_and_total(self):
        c = Registry().counter("reqs_total", "requests")
        c.inc(status="ok")
        c.inc(status="ok")
        c.inc(3, status="error")
        assert (c.value(status="ok"), c.value(status="error")) == (2, 3)
        assert c.value(status="timeout") == 0 and c.total() == 5
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_declaration_idempotent_but_kind_checked(self):
        reg = Registry()
        a = reg.counter("x_total")
        assert reg.counter("x_total") is a
        with pytest.raises(ValueError):
            reg.gauge("x_total")

    def test_gauge(self):
        g = Registry().gauge("depth")
        g.set(4.0)
        g.inc()
        assert g.value() == 5.0

    def test_histogram_bucket_edges(self):
        reg = Registry()
        h = reg.histogram("lat", buckets=(1.0, 2.0, 4.0))
        for v in (0.5, 1.0, 2.5, 5.0, 100.0):
            h.observe(v)
        (series,) = h.snapshot_series()
        assert series["bucket_counts"] == [2, 0, 1, 2]
        assert series["count"] == 5
        assert series["min"] == 0.5 and series["max"] == 100.0
        with pytest.raises(ValueError):
            reg.histogram("bad", buckets=(2.0, 1.0))

    def test_histogram_reservoir_bounded(self):
        h = Registry().histogram("lat", buckets=(1.0,), sample_cap=64)
        for i in range(5000):
            h.observe(float(i))
        assert len(h.recent()) == 64
        assert h.snapshot_series()[0]["count"] == 5000
        assert min(h.recent()) >= 5000 - 64  # the ring keeps the newest

    def test_quantiles(self):
        reg = Registry()
        h = reg.histogram("lat", buckets=(10.0,))
        for v in range(1, 11):
            h.observe(float(v))
        assert (h.quantile(0.0), h.quantile(0.5), h.quantile(1.0)) == \
            (1.0, 6.0, 10.0)
        assert reg.histogram("empty", buckets=(1.0,)).quantile(0.5) is None
        h2 = reg.histogram("lat2", buckets=tuple(float(i) for i in
                                                 range(1, 10)), sample_cap=8)
        for v in np.random.RandomState(0).uniform(0.0, 9.0, 500):
            h2.observe(float(v))
        q25, q50, q75 = (h2.quantile(q) for q in (0.25, 0.5, 0.75))
        assert 0.0 <= q25 <= q50 <= q75 <= 9.0 and abs(q50 - 4.5) < 1.5

    def test_snapshot_merge(self):
        a, b = Registry(), Registry()
        a.counter("c_total").inc(2, status="ok")
        a.gauge("g").set(1.0)
        a.histogram("h", buckets=(1.0, 2.0)).observe(0.5)
        b.counter("c_total").inc(3, status="ok")
        b.gauge("g").set(7.0)
        b.histogram("h", buckets=(1.0, 2.0)).observe(1.5)
        a.merge(b.snapshot())
        assert a.get("c_total").value(status="ok") == 5
        assert a.get("g").value() == 7.0
        (series,) = a.get("h").snapshot_series()
        assert series["count"] == 2 and series["bucket_counts"] == [1, 1, 0]
        with pytest.raises(ValueError):
            a.merge({"schema": "nope"})

    def test_snapshot_validates_and_renders(self):
        reg = Registry()
        reg.counter("c_total", "help text").inc(status="ok")
        reg.histogram("h_seconds", buckets=(0.1, 1.0)).observe(0.05)
        snap = reg.snapshot()
        validate_metrics(snap)
        assert json.loads(json.dumps(snap)) == snap
        text = prometheus_text(snap)
        assert '# TYPE c_total counter' in text
        assert 'c_total{status="ok"} 1.0' in text
        assert 'h_seconds_bucket{le="0.1"} 1' in text
        assert 'h_seconds_count 1' in text
        assert "c_total" in console_summary(snap)
        assert counter_total(snap, "c_total") == 1.0
        with pytest.raises(ValueError):
            counter_total(snap, "h_seconds")

    def test_reset_keeps_declarations(self):
        reg = Registry()
        c = reg.counter("c_total")
        c.inc(5)
        reg.reset()
        assert reg.get("c_total") is c and c.total() == 0


# -- tracer -----------------------------------------------------------------


class TestTracer:
    def test_span_nesting_depth(self):
        t = Tracer(annotate=False)
        with t.span("outer"):
            with t.span("inner", rid=1):
                pass
        inner, outer = t.events(kind="span")
        assert (inner["name"], inner["depth"], inner["rid"]) == ("inner", 1, 1)
        assert (outer["name"], outer["depth"]) == ("outer", 0)
        assert 0.0 <= inner["dur_s"] <= outer["dur_s"]
        assert inner["seq"] < outer["seq"]

    def test_ring_bounded(self):
        t = Tracer(ring=8, annotate=False)
        for i in range(50):
            t.event("tick", i=i)
        assert [e["i"] for e in t.events()] == list(range(42, 50))
        with pytest.raises(ValueError):
            Tracer(ring=0)

    def test_error_span_recorded_and_raises(self):
        t = Tracer(annotate=False)
        with pytest.raises(RuntimeError):
            with t.span("boom"):
                raise RuntimeError("x")
        (rec,) = t.events(kind="span")
        assert rec["error"] is True

    def test_jsonl_write_through_roundtrip(self, tmp_path):
        path = str(tmp_path / "e.jsonl")
        t = Tracer(annotate=False)
        sink = JsonlSink(path, epoch_offset_ns=t.epoch_offset_ns)
        t.attach(sink)
        t.event("before.close", rid=1)
        with t.span("work", rid=1):
            pass
        sink.close()
        evs = read_jsonl(path)
        assert [e["name"] for e in evs] == ["before.close", "work"]
        validate_events(evs)
        with open(path) as f:
            header = json.loads(f.readline())
        assert header["schema"] == "repro.obs.events/v1"
        assert header["epoch_offset_ns"] == t.epoch_offset_ns
        assert header["epoch_offset"] == t.epoch_offset_ns / 1e9

    def test_obs_reset_clears_both(self):
        obs = Obs(annotate=False)
        obs.counter("c_total").inc()
        obs.event("e")
        obs.reset()
        assert obs.registry.get("c_total").total() == 0
        assert obs.events() == []

    def test_profile_capture_sees_the_spans(self, tmp_path):
        """``annotate=True`` forwards spans to ``record_function``: inside
        ``profile_capture`` they appear in the profiler's table under their
        own names; the capture writes a Chrome trace and brackets itself
        with profile.start/stop events."""
        obs = Obs(annotate=True)
        with profile_capture(str(tmp_path), obs=obs) as prof:
            with obs.span("engine.decode_block", steps=1):
                torch.ones(8).add_(1)
        names = {e.key for e in prof.key_averages()}
        assert "engine.decode_block" in names
        assert (tmp_path / "trace.json").exists()
        assert [e["name"] for e in obs.events(kind="event")] == \
            ["profile.start", "profile.stop"]
        with profile_capture(None) as off:
            assert off is None


# -- the serve trace, port vs reference --------------------------------------


def _trace_requests(make, vocab):
    rng = np.random.RandomState(7)
    fams = [rng.randint(2, vocab, 12), rng.randint(2, vocab, 8)]
    # (family, suffix length, priority, tenant) per request
    spec = [(0, 3, 1, "a"), (0, 6, 0, "b"), (1, 9, 1, "a"), (0, 1, 2, "b"),
            (1, 4, 1, "a"), (0, 9, 1, "b"), (1, 2, 0, "a"), (0, 2, 1, "a"),
            (1, 8, 1, "b"), (0, 4, 1, "b"), (1, 1, 2, "a")]
    return [make(rid=i, prompt=np.concatenate(
        [fams[f], rng.randint(2, vocab, n)]), max_new=7, priority=p,
        tenant=t, deadline_s=0.0 if i == 5 else None)
        for i, (f, n, p, t) in enumerate(spec)]


TRACES = {
    "plain": dict(faults=[("engine.nan_state", 1, 1, 1), ("cache.corrupt", 1),
                          ("engine.prefill", 4)], spec=None),
    "spec": dict(faults=[("drafter.propose", 1), ("engine.nan_state", 3, 1,
                                                  0)],
                 spec=dict(k=3, drafter="ngram", breaker_cooldown_blocks=1)),
}


def _serve_trace(model, name, sink=None):
    """One trace through both engines: ``(port engine, ref engine, port
    results, ref results)``.  A cache of three entries' budget (so LRU
    evicts), request 6 cancelled before it is served."""
    ref_cfg, ref_params, cfg, params = model
    t = TRACES[name]
    kw = dict(slots=2, max_len=64, block=4)
    cache_kw = dict(granularity=4, budget_bytes=3 * 25_600 + 100)
    port = Engine(cfg, params, device="cpu", **kw,
                  cache=PrefixCache(**cache_kw),
                  faults=FaultPlan(*(FaultSpec(*f) for f in t["faults"])),
                  spec=None if t["spec"] is None else SpecConfig(**t["spec"]))
    ref = RefEngine(ref_cfg, ref_params, **kw, cache=RefCache(**cache_kw),
                    faults=RefPlan(*(RefFaultSpec(*f) for f in t["faults"])),
                    spec=None if t["spec"] is None else RefSpec(**t["spec"]))
    if sink is not None:
        port.obs.attach(sink)
    out = []
    for eng, make in ((port, GenRequest), (ref, RefRequest)):
        assert eng.cancel(6)
        out.append(eng.run(_trace_requests(make, cfg.vocab)))
    return port, ref, out[0], out[1]


@pytest.fixture(scope="module", params=sorted(TRACES))
def trace(request, model):
    return _serve_trace(model, request.param)


def test_trace_streams_and_statuses_match(trace):
    port, ref, got, want = trace
    assert [r.status for r in got] == [r.status for r in want]
    assert [r.tokens for r in got] == [r.tokens for r in want]
    statuses = collections.Counter(r.status for r in got)
    assert statuses["timeout"] == 1 and statuses["cancelled"] == 1
    assert statuses["error"] >= 1 and statuses["ok"] >= 3


def _metrics(eng):
    return eng.obs.snapshot()["metrics"]


def test_trace_metric_names_and_label_sets_match(trace):
    port, ref, _, _ = trace
    got, want = _metrics(port), _metrics(ref)
    assert set(got) - set(want) == PORT_EXTRAS
    assert set(want) <= set(got)
    for name in want:
        assert got[name]["kind"] == want[name]["kind"], name
        labels = sorted(json.dumps(s["labels"], sort_keys=True)
                        for s in got[name]["series"])
        assert labels == sorted(json.dumps(s["labels"], sort_keys=True)
                                for s in want[name]["series"]), name


def test_trace_counters_gauges_and_histogram_counts_match(trace):
    port, ref, results, _ = trace
    got, want = _metrics(port), _metrics(ref)
    compared = collections.Counter()
    for name, entry in want.items():
        if name.endswith("_seconds_total") or name in PORT_OBSERVED:
            continue  # wall clock; observed otherwise
        mine = {json.dumps(s["labels"], sort_keys=True): s
                for s in got[name]["series"]}
        for s in entry["series"]:
            g = mine[json.dumps(s["labels"], sort_keys=True)]
            field = "count" if entry["kind"] == "histogram" else "value"
            assert g[field] == s[field], (name, s["labels"])
            compared[entry["kind"]] += 1
        if name == "cache_hit_prefix_tokens":
            assert [s["bucket_counts"] for s in got[name]["series"]] == \
                [s["bucket_counts"] for s in entry["series"]]
    assert min(compared.values()) >= 3 and len(compared) == 3
    for key in ("serving_requests_total", "serving_prompt_tokens_total",
                "serving_generated_tokens_total", "serving_quarantined_total",
                "cache_hits_total", "cache_misses_total",
                "cache_insertions_total", "cache_evicted_bytes_total",
                "faults_fired_total"):
        assert counter_total(port.obs.snapshot(), key) == \
            counter_total(ref.obs.snapshot(), key) > 0, key
    spec_keys = ("spec_rounds", "spec_drafted", "spec_accepted",
                 "spec_replays", "breaker_trips")
    assert [port.stats[k] for k in spec_keys] == \
        [ref.stats[k] for k in spec_keys]
    # one inter-token observation a request that streamed two tokens or more
    itl = port.obs.registry.get("serving_inter_token_seconds")
    assert itl.count() == sum(len(r.tokens) > 1 for r in results) > 0


def test_trace_event_sequence_matches(trace):
    port, ref, got, _ = trace

    def seq(eng):
        return [(e["kind"], e["name"], e.get("rid"), e.get("status"))
                for e in eng.obs.events() if e["name"] not in PORT_SPANS]

    assert seq(port) == seq(ref)
    names = {e["name"] for e in port.obs.events()}
    assert {"request.queued", "request.admitted", "request.first_token",
            "request.done", "fault.fired", "engine.prefill"} <= names
    check_timelines(port.obs.events(), got)
    tls = request_timelines(port.obs.events())
    for r in got:
        kinds = [e["name"] for e in tls[r.rid]]
        assert kinds[0] == "request.queued" and kinds[-1] == "request.done"
        if r.status == "ok":
            assert "request.first_token" in kinds
    assert "request.done" in render_timeline(port.obs.events(), 0)


def test_trace_artifacts_pass_both_validators(model, tmp_path, capsys):
    sink = JsonlSink(str(tmp_path / "e.jsonl"))
    port, _, got, _ = _serve_trace(model, "plain", sink=sink)
    sink.close()
    write_metrics(port.obs.snapshot(), str(tmp_path / "m.json"))
    statuses = sorted({r.status for r in got})
    argv = ["--metrics", str(tmp_path / "m.json"),
            "--events", str(tmp_path / "e.jsonl"),
            "--expect-requests", str(len(got)),
            "--expect-terminal-statuses", ",".join(statuses),
            "--expect-counter", "serving_quarantined_total=1",
            "--expect-counter-min", "cache_hits_total=1"]
    assert validate_main(argv) == 0
    assert ref_validate_main(argv) == 0
    assert validate_main(argv[:4] + ["--expect-requests",
                                     str(len(got) + 1)]) == 1
    capsys.readouterr()


# -- engine integration -------------------------------------------------------


def _requests(cfg, lens=(5, 11, 7, 9), max_new=10):
    return [GenRequest(rid=i, prompt=np.random.RandomState(10 + i).randint(
        2, cfg.vocab, n), max_new=max_new) for i, n in enumerate(lens)]


def _engine(model, **kw):
    _, _, cfg, params = model
    return Engine(cfg, params, slots=2, max_len=96, block=4, device="cpu",
                  **kw)


def test_timeline_completeness_under_faults(model):
    eng = _engine(model, faults=FaultPlan(FaultSpec("engine.nan_state", at=1,
                                                    arg=0)))
    cfg = model[2]
    reqs = _requests(cfg, lens=(5, 11, 7))
    reqs.append(GenRequest(rid=9, prompt=np.asarray([cfg.vocab + 5]),
                           max_new=4))
    results = eng.run(reqs)
    evs = eng.obs.events()
    check_timelines(evs, results)
    m = eng.obs.registry.get("serving_requests_total")
    by_status = collections.Counter(r.status for r in results)
    for status, n in by_status.items():
        assert m.value(status=status) == n
    assert m.total() == len(results) and by_status["error"] == 2
    assert eng.obs.registry.get("serving_quarantined_total").total() == 1
    assert eng.obs.registry.get("faults_fired_total").value(
        point="engine.nan_state") == 1
    (fired,) = eng.obs.events(name="fault.fired")
    assert fired["point"] == "engine.nan_state"
    spans = eng.obs.events(name="engine.decode_block")
    assert spans and all(s["dur_s"] > 0 for s in spans)
    assert eng.obs.registry.get("serving_ttft_seconds").count() == 3


#: each parent span and the child spans that tile it
TILES = {"engine.prefill": ("engine.prefill_dispatch", "engine.prefill_sync"),
         "engine.decode_block": ("engine.decode_step", "engine.block_sync")}


@pytest.fixture(scope="module")
def served(model):
    """A served batch with a prefix cache (its admissions take the carry
    path too), submitted one by one with each submit's time bracketed:
    ``(engine, results, {rid: (before, after)})``."""
    eng = _engine(model, cache=PrefixCache(granularity=4))
    reqs = _requests(model[2], lens=(5, 11, 7, 9, 6))
    submitted = {}
    for r in reqs:
        a = time.perf_counter()
        eng.submit(r)
        submitted[r.rid] = (a, time.perf_counter())
    while len(eng.scheduler) or eng.active.any():
        eng._drive_tick()
    return eng, [eng.results[r.rid] for r in reqs], submitted


def test_serve_child_spans_tile_their_parents(served):
    """Every admission's and decode block's child spans lie inside it,
    one after another, and cover it to within 1% (or 0.2 ms); a block has
    one ``engine.decode_step`` a step."""
    eng, results, _ = served
    spans = eng.obs.events(kind="span")
    end = {id(s): s["ts"] + s["dur_s"] for s in spans}
    for parent, names in TILES.items():
        blocks = [s for s in spans if s["name"] == parent]
        assert blocks
        for p in blocks:
            kids = sorted((s for s in spans if s["name"] in names
                           and p["ts"] <= s["ts"] <= end[id(p)]),
                          key=lambda s: s["ts"])
            assert all(end[id(k)] <= end[id(p)] for k in kids)
            assert all(end[id(a)] <= b["ts"] for a, b in zip(kids, kids[1:]))
            assert all(k["depth"] == p["depth"] + 1 for k in kids)
            want = [names[0]] * (p.get("steps") or 1) + [names[1]]
            assert [k["name"] for k in kids] == want
            covered = sum(k["dur_s"] for k in kids)
            assert p["dur_s"] - covered <= max(0.01 * p["dur_s"], 2e-4), \
                (parent, p["dur_s"], covered)
            assert all(set(k) == {"kind", "name", "ts", "dur_s", "seq",
                                  "depth"} for k in kids)  # no labels
    assert len(eng.obs.events(name="engine.prefill")) == len(results)


def test_serve_queue_wait_runs_from_submit_to_admission(served):
    """One ``engine.queue_wait`` an admission, labelled with its rid alone,
    from the request's submit to its ``engine.prefill``'s start; the
    scheduler's queue wait and the registry's TTFT start at the same
    submit."""
    eng, results, submitted = served
    waits = {e["rid"]: e for e in eng.obs.events(name="engine.queue_wait")}
    prefills = {e["rid"]: e for e in eng.obs.events(name="engine.prefill")}
    assert sorted(waits) == sorted(prefills) == sorted(submitted)
    for rid, w in waits.items():
        a, b = submitted[rid]
        assert a <= w["ts"] <= b
        assert w["ts"] + w["dur_s"] == pytest.approx(prefills[rid]["ts"],
                                                     abs=1e-9)
        assert set(w) == {"kind", "name", "ts", "dur_s", "seq", "depth",
                          "rid"}
    reg = eng.obs.registry
    order = sorted(prefills, key=lambda rid: prefills[rid]["ts"])
    # the scheduler's wait ends at its pop, just before the admission
    sched = reg.get("sched_queue_wait_seconds").recent()
    assert len(sched) == len(order)
    assert all(0 <= q <= waits[rid]["dur_s"] for rid, q in zip(order, sched))
    # submission -> first token: the wait, then the admission's span
    for rid, ttft in zip(order, reg.get("serving_ttft_seconds").recent()):
        assert ttft >= waits[rid]["dur_s"] + prefills[rid]["dur_s"]
        assert ttft == pytest.approx(
            waits[rid]["dur_s"] + eng.results[rid].ttft_s, abs=1e-3)


def test_serve_inter_token_is_per_finished_request(served):
    """``serving_inter_token_seconds``: one (last - first) / (n - 1) a
    finished request, within its admission-to-done interval."""
    eng, results, _ = served
    itl = eng.obs.registry.get("serving_inter_token_seconds").recent()
    assert len(itl) == len(results) and all(len(r.tokens) == 10
                                            for r in results)
    done = {e["rid"]: e["ts"] for e in eng.obs.events(name="request.done")}
    prefill_end = {e["rid"]: e["ts"] + e["dur_s"]
                   for e in eng.obs.events(name="engine.prefill")}
    longest = max(done[r.rid] - prefill_end[r.rid] for r in results)
    assert all(0 < x <= longest / 9 for x in itl)


def test_span_catalog_lists_what_the_port_emits():
    """``_NESTING_DOC`` holds exactly the span and event names the port's
    source emits."""
    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    pat = re.compile(r"\.(?:event|span|timer|interval)\(\s*\"([a-z_.]+)\"")
    emitted = set()
    for f in src.rglob("*.py"):
        emitted |= set(pat.findall(f.read_text()))
    assert emitted == set(_NESTING_DOC)


def test_tracer_clock_maps_spans_onto_the_profiler(tmp_path):
    """One clock: a span around ``torch.mm``, mapped through the tracer's
    ``epoch_offset_ns``, encloses the profiler's ``aten::mm`` event to
    within 100 us; ``profile_capture``'s ``wall_ns`` is its event's
    ``ts`` on the same clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    obs = Obs(annotate=False)
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("mm"):
            torch.mm(a, a)
    (rec,) = obs.events(name="mm")
    t0 = int(rec["ts"] * 1e9) + obs.tracer.epoch_offset_ns
    t1 = t0 + int(rec["dur_s"] * 1e9)
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm" and e.device_type() == DeviceType.CPU]
    assert mm.start_ns() >= t0 - 100_000
    assert mm.start_ns() + mm.duration_ns() <= t1 + 100_000
    with profile_capture(str(tmp_path), obs=obs):
        pass
    marks = obs.events(kind="event")
    assert [e["name"] for e in marks] == ["profile.start", "profile.stop"]
    for e in marks:
        lag = int(e["ts"] * 1e9) + obs.tracer.epoch_offset_ns - e["wall_ns"]
        assert 0 <= lag < 1_000_000


def test_stats_shim_compat(model):
    eng = _engine(model)
    results = eng.run(_requests(model[2], lens=(5, 7)))
    st = eng.stats
    assert st["generated_tokens"] == sum(len(r.tokens) for r in results)
    assert isinstance(st["generated_tokens"], int)
    assert st["errors"] == 0 and st["decode_steps"] > 0
    assert len(st["ttft_s"]) == 2 and st["decode_s"] > 0
    assert dict(st)["prompt_tokens"] == 5 + 7
    eng.stats.update(prefill_s=0.0, decode_s=0.0, prompt_tokens=0,
                     generated_tokens=0, ttft_s=[])
    assert st["generated_tokens"] == 0 and st["ttft_s"] == []
    eng.obs.reset()
    assert st["decode_steps"] == 0
    with pytest.raises(TypeError):
        del st["errors"]


def test_engines_do_not_share_obs(model):
    a, b = _engine(model), _engine(model)
    assert a.obs is not b.obs
    a.obs.counter("serving_quarantined_total").inc()
    assert b.obs.registry.get("serving_quarantined_total").total() == 0


def test_sinks_add_zero_host_syncs(model, monkeypatch):
    """Observability never adds a device round trip: identical traffic
    makes as many host transfers with a write-through sink as without."""
    cfg = model[2]

    def run_once(sink):
        eng = _engine(model, cache=PrefixCache(granularity=4))
        if sink is not None:
            eng.obs.attach(sink)
        n = [0]
        with monkeypatch.context() as m:
            for name in ("cpu", "tolist", "item"):
                orig = getattr(torch.Tensor, name)

                def counted(self, *a, _o=orig, **k):
                    n[0] += 1
                    return _o(self, *a, **k)

                m.setattr(torch.Tensor, name, counted)
            results = eng.run(_requests(cfg))
        return n[0], [r.tokens for r in results]

    bare, bare_toks = run_once(None)
    with_sink, sink_toks = run_once(JsonlSink(io.StringIO()))
    assert bare > 0 and with_sink == bare
    assert sink_toks == bare_toks


# -- validator CLI ------------------------------------------------------------


class TestValidateCli:
    def _artifacts(self, tmp_path):
        obs = Obs(annotate=False)
        obs.counter("serving_quarantined_total").inc()
        for rid in (0, 1, 2):
            obs.event("request.queued", rid=rid)
            obs.event("request.done", rid=rid,
                      status="ok" if rid else "error")
        mpath, epath = str(tmp_path / "m.json"), str(tmp_path / "e.jsonl")
        with open(mpath, "w") as f:
            json.dump(obs.snapshot(), f)
        sink = JsonlSink(epath)
        for e in obs.events():
            sink.emit(e)
        sink.close()
        return mpath, epath

    def test_main_ok_and_fail(self, tmp_path, capsys):
        mpath, epath = self._artifacts(tmp_path)
        assert validate_main([
            "--metrics", mpath, "--events", epath,
            "--expect-counter", "serving_quarantined_total=1",
            "--expect-requests", "3",
            "--expect-terminal-statuses", "ok,error",
        ]) == 0
        assert validate_main([
            "--metrics", mpath,
            "--expect-counter", "serving_quarantined_total=7",
        ]) == 1
        assert validate_main(["--events", epath,
                              "--expect-requests", "4"]) == 1
        capsys.readouterr()

    def test_vanished_request_detected(self):
        events = [{"kind": "event", "name": "request.queued", "rid": 0,
                   "ts": 0.0, "seq": 0}]
        with pytest.raises(ValueError, match="vanished"):
            check_requests(events, 0)
        assert terminal_events(events) == {}


# -- the serve CLI --------------------------------------------------------------


def test_serve_cli_front_end_on_cpu(tmp_path, capsys):
    m, e = str(tmp_path / "m.json"), str(tmp_path / "e.jsonl")
    results = serve.main([
        "--reduced", "--device", "cpu", "--stream", "--cache-mb", "1",
        "--cache-chunk", "16", "--shared-prefix", "32", "--prompt-len", "48",
        "--inject", "engine.nan_state@1:0", "--metrics-out", m,
        "--events-out", e])
    out = capsys.readouterr().out
    assert "statuses: ok=7 error=1 | quarantined=1" in out
    hits = re.search(r"\[serve\] cache: 1 entries [\d.]+ MiB \| hit rate "
                     r"([\d.]+) \((\d+) hits, (\d+) misses", out)
    assert hits and (hits[2], hits[3]) == ("7", "1"), out
    assert len(results) == 8
    argv = ["--metrics", m, "--events", e, "--expect-requests", "8",
            "--expect-counter", "serving_quarantined_total=1",
            "--expect-terminal-statuses", "ok,error"]
    assert validate_main(argv) == 0
    assert ref_validate_main(argv) == 0
    capsys.readouterr()
