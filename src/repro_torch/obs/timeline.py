"""Per-request lifecycle timelines derived from span/event records.

Own copy of ``repro/obs/timeline.py``.  The engine emits one event per
lifecycle transition::

    request.queued  ->  request.admitted  ->  request.first_token
        ->  (engine.decode_block / engine.spec_round spans, shared)
        ->  request.done {status: ok|error|timeout|cancelled}

``request_timelines`` groups the per-request events by ``rid`` (block
and round spans are engine-wide, not per-request, so they are not part
of a timeline); ``check_timelines`` asserts the completeness contract
the chaos tests and the CI validator rely on: every terminal
``GenResult`` has exactly one matching ``request.done`` event whose
``status`` label agrees.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

#: events that belong to one request (carry a ``rid`` label)
REQUEST_EVENTS = (
    "request.queued", "request.admitted", "request.first_token",
    "request.done",
)

TERMINAL_STATUSES = ("ok", "error", "timeout", "cancelled")


def request_timelines(events: Iterable[dict]) -> Dict[int, List[dict]]:
    """Group request lifecycle events by rid, each ordered by ``seq``."""
    out: Dict[int, List[dict]] = {}
    for e in events:
        if e.get("name") in REQUEST_EVENTS and "rid" in e:
            out.setdefault(int(e["rid"]), []).append(e)
    for tl in out.values():
        tl.sort(key=lambda e: e.get("seq", 0))
    return out


def terminal_events(events: Iterable[dict]) -> Dict[int, dict]:
    """rid -> its LAST ``request.done`` event (re-used rids — e.g. a
    warmup run sharing an engine — keep the latest terminal)."""
    out: Dict[int, dict] = {}
    for e in events:
        if e.get("name") == "request.done" and "rid" in e:
            out[int(e["rid"])] = e
    return out


def check_timelines(events: Iterable[dict], results) -> None:
    """Assert timeline completeness against engine results.

    ``results``: iterable of ``GenResult`` (or any object with ``rid``
    and ``status``).  Raises ``AssertionError`` naming the first broken
    contract:

    * every result has a ``request.done`` event;
    * the event's ``status`` label equals the result's status;
    * the status is one of the four terminal statuses.
    """
    events = list(events)
    done = terminal_events(events)
    for r in results:
        rid = int(r.rid)
        assert rid in done, (
            f"request {rid} (status={r.status}) has no request.done event"
        )
        got = done[rid].get("status")
        assert got == r.status, (
            f"request {rid}: terminal event status {got!r} != result "
            f"status {r.status!r}"
        )
        assert got in TERMINAL_STATUSES, (
            f"request {rid}: unknown terminal status {got!r}"
        )


def render_timeline(events: Iterable[dict], rid: int) -> str:
    """Human-readable one-request timeline (relative milliseconds)."""
    tl = request_timelines(events).get(rid, [])
    if not tl:
        return f"rid={rid}: no events"
    t0 = tl[0]["ts"]
    lines = [f"rid={rid}:"]
    for e in tl:
        extra = {k: v for k, v in e.items()
                 if k not in ("kind", "name", "ts", "seq", "rid", "depth")}
        detail = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        lines.append(
            f"  +{1e3 * (e['ts'] - t0):9.2f}ms  {e['name']}"
            + (f"  {detail}" if detail else "")
        )
    return "\n".join(lines)
