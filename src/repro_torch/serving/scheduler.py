"""Admission scheduler: priority classes, fair share, expiry, autoscaling.

Own copy of ``repro/serving/scheduler.py`` (framework-free).  Replaces
the engine's plain FIFO deque.  The queue can
hold thousands of requests; a slot admission is a chunk-parallel prefill
(expensive), so WHAT gets the next slot is policy, not arrival order:

* **Priority order** — requests are drained by ``(priority class,
  absolute deadline, arrival)``.  Lower ``priority`` numbers drain
  first; within a class, the request whose deadline expires soonest
  (deadline *slack* ordering: all slacks shrink at the same rate, so
  the absolute deadline is a stable heap key); no-deadline requests
  rank last in their class and fall back to arrival order.
* **Per-tenant fair share** — within the winning priority class, the
  tenant with the fewest slots currently held is served first, so one
  chatty tenant cannot starve the rest of its class.  The engine calls
  ``release(tenant)`` on every terminal result to return the share.
* **Queued-deadline expiry** — ``expire()`` returns every queued
  request whose deadline has already passed; the engine finalizes them
  as ``status="timeout"`` on EVERY drive-loop tick.  A slot is never
  spent prefilling an already-expired request (regression-tested) and
  an expired request never waits for a slot to free to learn its fate.
* **Slot autoscaling** — ``target_slots()`` moves the engine's usable
  slot count between ``min_slots`` and ``max_slots``: queue depth
  scales up immediately (latency is at stake), emptiness scales down
  one slot per ``scale_down_ticks`` consecutive idle ticks
  (hysteresis — a burst arriving right after a scale-down would pay
  recompile-sized latency), and quarantine pressure (poisoned-state
  resets since the last tick) caps the target to contain a poisoning
  workload while it is investigated.

``sched.stall`` (``runtime.faults``) suppresses every admission for the
tick it fires on (``stalled()``, hit once per engine drive tick) —
deterministic pressure for expiry/backlog tests.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time
from typing import Dict, List, Optional

from ..obs import Obs


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    min_slots: int = 1
    max_slots: int = 4
    # consecutive empty-queue ticks before the target shrinks by one
    scale_down_ticks: int = 4
    # quarantines within the last tick that cap the target at min_slots
    quarantine_cap: int = 2

    def __post_init__(self):
        if not 1 <= self.min_slots <= self.max_slots:
            raise ValueError(
                f"need 1 <= min_slots <= max_slots: {self}"
            )
        if self.scale_down_ticks < 1 or self.quarantine_cap < 1:
            raise ValueError(
                f"need scale_down_ticks >= 1 and quarantine_cap >= 1: {self}"
            )


class Scheduler:
    """Priority admission queue + slot-count autoscaler.

    Requests enter via ``submit`` (tenant/priority/deadline read off the
    ``GenRequest``); the engine drains with ``expire`` -> ``pop`` each
    tick.  Pure host-side data structure: no torch, no device syncs.
    """

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(), *,
                 obs: Optional[Obs] = None, faults=None,
                 clock=time.perf_counter):
        self.cfg = cfg
        self.faults = faults
        self._clock = clock
        self._seq = itertools.count()
        # (priority, deadline_abs, seq) heap per tenant, plus one global
        # deadline heap for O(log n) expiry sweeps.  Entries are lazily
        # invalidated (rid -> None) instead of re-heapified.
        self._q: Dict[str, List] = {}
        self._by_rid: Dict[int, object] = {}
        self._deadlines: List = []
        self._arrivals: List = []  # (seq, item): oldest-live-arrival peek
        self._inflight: Dict[str, int] = {}
        self._idle_ticks = 0
        self._quarantines_last_tick = 0
        self._target = cfg.min_slots
        self.obs = obs if obs is not None else Obs()
        m = self.obs
        self._m_wait = m.histogram(
            "sched_queue_wait_seconds", "submit -> admission wall-clock")
        self._m_expired = m.counter(
            "sched_expired_total", "queued requests expired by deadline")
        self._m_promoted = m.counter(
            "sched_promotions_total",
            "admissions that jumped at least one earlier arrival")
        self._m_stalled = m.counter(
            "sched_stall_ticks_total", "ticks the stall fault suppressed")
        self._m_depth = m.gauge("sched_queue_depth", "queued requests")
        self._m_target = m.gauge("sched_slots_target",
                                 "autoscaler slot target")
        self._m_target.set(float(self._target))

    def __len__(self) -> int:
        return len(self._by_rid)

    # -- queue --------------------------------------------------------------

    @staticmethod
    def _tenant(req) -> str:
        return getattr(req, "tenant", None) or "default"

    def submit(self, req, *, now: Optional[float] = None) -> None:
        """Enqueue; priority/deadline/tenant come off the request."""
        if req.rid in self._by_rid:
            raise ValueError(f"request {req.rid} is already queued")
        now = self._clock() if now is None else now
        deadline = (now + req.deadline_s if req.deadline_s is not None
                    else math.inf)
        seq = next(self._seq)
        item = [int(getattr(req, "priority", 1)), deadline, seq, now, req]
        self._by_rid[req.rid] = item
        heapq.heappush(self._q.setdefault(self._tenant(req), []), item)
        heapq.heappush(self._arrivals, (seq, item))
        if deadline != math.inf:
            heapq.heappush(self._deadlines, (deadline, seq, item))
        self._m_depth.set(float(len(self._by_rid)))

    def cancel(self, rid: int):
        """Drop a queued request; returns it (or None if not queued).
        Lazy removal: the heap entry is tombstoned in place."""
        item = self._by_rid.pop(rid, None)
        if item is None:
            return None
        req, item[4] = item[4], None
        self._m_depth.set(float(len(self._by_rid)))
        return req

    def expire(self, *, now: Optional[float] = None) -> List:
        """Pop every queued request whose deadline has passed.  The
        engine finalizes these as ``timeout`` on the SAME tick — before
        any admission — so an expired request never consumes a prefill
        and never waits for a free slot to be discovered."""
        now = self._clock() if now is None else now
        out = []
        while self._deadlines and self._deadlines[0][0] <= now:
            _, _, item = heapq.heappop(self._deadlines)
            req = item[4]
            if req is None or req.rid not in self._by_rid:
                continue  # tombstone: already admitted/cancelled
            del self._by_rid[req.rid]
            item[4] = None
            out.append(req)
            self._m_expired.inc()
            self.obs.event("sched.expired", rid=req.rid,
                           priority=item[0])
        if out:
            self._m_depth.set(float(len(self._by_rid)))
        return out

    def stalled(self) -> bool:
        """The ``sched.stall`` fault point: the engine hits it ONCE per
        drive-loop tick; a firing suppresses every admission that tick
        (expiry still runs — a stalled scheduler must not hide expired
        requests)."""
        if self.faults is not None and \
                self.faults.hit("sched.stall") is not None:
            self._m_stalled.inc()
            self.obs.event("sched.stall", depth=len(self._by_rid))
            return True
        return False

    def _peek(self, tenant: str):
        """Live head of a tenant heap (drops tombstones)."""
        heap = self._q.get(tenant)
        while heap:
            item = heap[0]
            if item[4] is None:
                heapq.heappop(heap)
                continue
            return item
        if heap is not None and not heap:
            del self._q[tenant]
        return None

    def pop(self, *, now: Optional[float] = None):
        """Next request to admit, or None.

        Picks the best (priority, deadline, arrival) head among tenants,
        breaking priority ties toward the tenant holding the fewest
        slots (fair share).  Emits ``sched.promote`` + a counter when
        the winner jumped an earlier arrival — the audit trail for
        "why did my request wait".
        """
        while self._arrivals and self._arrivals[0][1][4] is None:
            heapq.heappop(self._arrivals)  # tombstones
        oldest_seq = self._arrivals[0][0] if self._arrivals else None
        best = None
        for tenant in list(self._q):
            item = self._peek(tenant)
            if item is None:
                continue
            share = self._inflight.get(tenant, 0)
            # order: priority class, then fair share, then deadline
            # urgency, then arrival
            rank = (item[0], share, item[1], item[2])
            if best is None or rank < best[0]:
                best = (rank, tenant, item)
        if best is None:
            return None
        _, tenant, item = best
        heapq.heappop(self._q[tenant])
        priority, _, seq, t_submit, req = item
        del self._by_rid[req.rid]
        item[4] = None
        now = self._clock() if now is None else now
        self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        self._m_wait.observe(max(now - t_submit, 0.0))
        self._m_depth.set(float(len(self._by_rid)))
        if seq != oldest_seq:
            self._m_promoted.inc()
            self.obs.event("sched.promote", rid=req.rid, priority=priority,
                           tenant=tenant)
        return req

    def release(self, req) -> None:
        """A request admitted via ``pop`` reached a terminal result:
        return its tenant's fair-share slot."""
        tenant = self._tenant(req)
        held = self._inflight.get(tenant, 0)
        if held > 1:
            self._inflight[tenant] = held - 1
        else:
            self._inflight.pop(tenant, None)

    # -- autoscaler ---------------------------------------------------------

    def note_quarantine(self, n: int = 1) -> None:
        """The engine reports poisoned-state resets; heavy quarantine
        pressure caps the slot target until a clean tick passes."""
        self._quarantines_last_tick += n

    def target_slots(self) -> int:
        """One autoscaler tick -> the engine's usable slot count.

        Scale-up is immediate (queued work is waiting); scale-down needs
        ``scale_down_ticks`` consecutive idle ticks per step (hysteresis
        against burst arrival); ``quarantine_cap`` or more quarantines
        since the last tick clamp to ``min_slots``.
        """
        c = self.cfg
        depth = len(self._by_rid)
        if self._quarantines_last_tick >= c.quarantine_cap:
            self._target = c.min_slots
            self._idle_ticks = 0
        elif depth > 0:
            self._target = min(c.max_slots,
                               max(self._target, c.min_slots) + depth)
            self._idle_ticks = 0
        else:
            self._idle_ticks += 1
            if self._idle_ticks >= c.scale_down_ticks:
                self._idle_ticks = 0
                self._target = max(c.min_slots, self._target - 1)
        self._quarantines_last_tick = 0
        self._m_target.set(float(self._target))
        return self._target
