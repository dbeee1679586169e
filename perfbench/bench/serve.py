"""A ``closed_loop`` cell: clients that each wait for their reply, served
by the program's ``Engine`` (``submit``, then ``_drive_tick``), greedy.

Every client sends its first request at set-up, with an output length
staggered up to the mix's shortest (traffic.py); the engine admits them
all in its first tick, and once every client has had its first reply and
sent its second request, ``warm_ticks`` more ticks run and the window
opens, with every slot live.  In the window each client whose reply is complete
sends its next request before the next tick.  Times are the harness's,
taken when the engine hands tokens over (its streaming hook): a request's
first token after its admission's sync, the others after their block's.

* TTFT: from the client's submission to its first token, over the
  requests whose first token came in the window.
* Time per output token: ``(last - first) / (n - 1)`` over the requests
  finished in the window.
* Output tokens per second: every token handed over in the window, over
  the window.

Once the window has closed and the program's state is freed, the plain
reference reads a sample of the finished requests, drawn from the seed
with the longest among them: at each served token, the gap between the
reference's best logit and the served token's.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np

from . import program, seeds, spec, traffic
from .trace import Spans, profiling


class Clients:
    """The clients' requests and the times their tokens came."""

    def __init__(self, loop: traffic.ClosedLoop):
        self.loop = loop
        self.rounds = [0] * loop.clients
        self.live = {}  # rid -> record of a request not yet finished
        self.done = []  # records of finished requests
        self.handed = []  # (time, tokens handed over)

    def submit(self, engine, client):
        from repro_torch.serving.engine import GenRequest

        r = self.loop.request(client, self.rounds[client])
        self.rounds[client] += 1
        self.live[r.rid] = dict(rid=r.rid, client=client, prompt=r.prompt,
                                max_new=r.max_new, submit=time.perf_counter(),
                                first=None, last=None, n=0)
        engine.submit(GenRequest(rid=r.rid, prompt=r.prompt,
                                 max_new=r.max_new))

    def on_stream(self, rid, toks, result):
        now = time.perf_counter()
        rec = self.live[rid]
        if toks:
            rec["first"] = rec["first"] or now
            rec["last"] = now
            rec["n"] += len(toks)
            self.handed.append((now, len(toks)))
        if result is not None:
            rec.update(done=now, status=result.status,
                       tokens=list(result.tokens))
            self.done.append(self.live.pop(rid))

    def idle(self):
        busy = {r["client"] for r in self.live.values()}
        return [c for c in range(self.loop.clients) if c not in busy]


def build(c, t, seed, device):
    from repro_torch.obs import Obs
    from repro_torch.serving.engine import Engine

    cfg = program.model_config(c)
    program.check_layout(c, cfg)
    params = program.served_params(c, seed, device)
    return Engine(cfg, params, slots=t["slots"], max_len=t["max_len"],
                  block=t["block"], seed=seeds.derive(seed, "engine"),
                  device=device, obs=Obs(ring=1 << 18))


COUNTERS = ("serving_prefill_seconds_total", "serving_decode_seconds_total",
            "serving_decode_steps_total", "serving_prompt_tokens_total")


def _counters(engine):
    reg = engine.obs.registry
    return {k: reg.get(k).total() for k in COUNTERS}


def _p95(xs):
    return float(np.percentile(np.asarray(xs, float), 95)) if xs else None


def sample(done, seed, check):
    """Requests to check: the longest, then others drawn from the seed
    until there are ``min_requests`` and ``min_tokens`` served tokens."""
    ok = sorted((r for r in done if r["status"] == "ok"),
                key=lambda r: (-len(r["tokens"]), r["rid"]))
    if not ok:
        return []
    rng = np.random.default_rng(seeds.derive(seed, "check"))
    picked = [ok[0]]
    rest = [ok[i] for i in rng.permutation(len(ok) - 1) + 1]
    for r in rest:
        if len(picked) >= check["min_requests"] and sum(
                len(p["tokens"]) for p in picked) >= check["min_tokens"]:
            break
        picked.append(r)
    return picked


def gaps(c, reqs, seed, device, precs=("fp32",)):
    """For each precision, the gaps over ``reqs`` between the fp32
    reference's best logit and that of the token the side puts first at
    each served position: the served token for ``fp32`` (the program is
    judged), the lower precision's own best for the control.  Returns
    ``({prec: {"mean": ..., "widest": ..., "over_0.1": share}}, tokens
    compared)``."""
    import torch

    ref = spec.reference(c)
    ref.exact_matmuls()
    params = _fp32(program.served_params(c, seed, device))
    found = {p: [] for p in precs}
    for r in reqs:
        served = torch.as_tensor(r["tokens"], device=device)
        ids = torch.cat([torch.as_tensor(r["prompt"], device=device),
                         served[:-1]])
        L = len(r["prompt"])
        pos = torch.arange(L - 1, L - 1 + len(served), device=device)
        z = ref.logits_at(params, ids, pos, c, ref.Prec("fp32"))
        best = z.max(-1).values
        for p in precs:
            pick = served if p == "fp32" else ref.logits_at(
                params, ids, pos, c, ref.Prec(p)).argmax(-1)
            found[p].append(best - z.gather(1, pick[:, None])[:, 0])
    out = {}
    for p, gs in found.items():
        g = torch.cat(gs) if gs else torch.zeros(1, device=device)
        out[p] = {"mean": float(g.mean()), "widest": float(g.max()),
                  "over_0.1": float((g > 0.1).float().mean())}
    return out, sum(len(r["tokens"]) for r in reqs)


def _fp32(tree):
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    return tree.float()


def _tick(engine, clients, spans=None):
    """The idle clients send their next requests; the engine runs a
    tick."""
    with spans.span("perfbench.clients") if spans else nullcontext():
        for client in clients.idle():
            clients.submit(engine, client)
    engine._drive_tick()


def warm_admissions(engine, t, vocab, points=17):
    """One admission (a single token out) at each of ``points`` prompt
    lengths spread over the mix's range, so that the matrix products'
    kernels for those lengths are loaded before the window."""
    from repro_torch.serving.engine import GenRequest

    lo, hi = t["prompt"]["min"], t["prompt"]["max"]
    rng = np.random.default_rng(0)
    for i in range(points):
        n = lo + (hi - lo) * i // (points - 1)
        engine.submit(GenRequest(rid=-1 - i, prompt=rng.integers(0, vocab, n),
                                 max_new=1))
    while len(engine.scheduler) or engine.active.any():
        engine._drive_tick()


def run(ctx):
    c, t, seed, device = ctx.c, ctx.t, ctx.seed, ctx.device
    engine = build(c, t, seed, device)
    ctx.phase("built")
    warm_admissions(engine, t, c["vocab"])
    ctx.phase("admissions warm")
    if ctx.fault is not None:
        ctx.fault(engine)
    clients = Clients(traffic.ClosedLoop(t, c["vocab"], seed))
    engine.on_stream = clients.on_stream
    # set-up: every client's first, staggered request through, then the
    # warm ticks: the window opens on clients in their second round or later
    while min(clients.rounds) < 2:
        _tick(engine, clients)
    ctx.phase("first round")
    for _ in range(t["warm_ticks"]):
        _tick(engine, clients)
    spans = Spans()
    with profiling(ctx.trace) as prof:
        before = _counters(engine)
        w0 = ctx.window_opens()
        while True:
            _tick(engine, clients, spans)
            if time.perf_counter() - w0 >= ctx.seconds:
                break
        w1 = ctx.window_closes()
        after = _counters(engine)
    records = [e for e in engine.obs.tracer.events(kind="span")
               if w0 <= e["ts"] <= w1]
    spans.add_traced(records)
    del engine
    program.free()
    inside = [r for r in clients.done if w0 <= r["done"] <= w1]
    firsts = [r for r in clients.done + list(clients.live.values())
              if r["first"] is not None and w0 <= r["first"] <= w1]
    tokens = sum(n for when, n in clients.handed if w0 <= when <= w1)
    tpot = [(r["last"] - r["first"]) / (r["n"] - 1) for r in inside
            if r["n"] > 1]
    picked = sample(inside, seed, t["check"])
    widest, compared = gaps(c, picked, seed, device, ctx.precs)
    program.free()
    numbers = {"logit_gap_mean": widest["fp32"]["mean"] if picked else None,
               "logit_gap": widest["fp32"]["widest"] if picked else None}
    notes = {"compared_tokens": compared,
             "compared_requests": len(picked), "gaps": widest["fp32"],
             "control": {p: g for p, g in widest.items() if p != "fp32"}}
    return dict(
        attempted=len(inside),
        failed=sum(r["status"] != "ok" for r in inside),
        window_s=w1 - w0, prof=prof, spans=spans.spans, numbers=numbers,
        notes=notes,
        e2e={"serve_output_tokens_per_s": tokens / (w1 - w0),
             "ttft_p95_ms": 1e3 * _p95([r["first"] - r["submit"]
                                        for r in firsts]),
             "tpot_p95_ms": 1e3 * _p95(tpot)},
        work={"counters": {k: after[k] - before[k] for k in COUNTERS},
              "admissions": [e["prompt_len"] for e in records
                             if e["name"] == "engine.prefill"],
              "decode_blocks": [(e["steps"], e["slots_active"]) for e in records
                                if e["name"] == "engine.decode_block"],
              "slots": t["slots"]})
