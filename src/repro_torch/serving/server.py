"""Async streaming front-end over the synchronous drive loop.

The engine is deliberately synchronous — one thread owns the device, and
every block is ONE host sync.  ``AsyncServer`` (own copy of
``repro/serving/server.py``) puts an
asyncio facade on that loop without changing its discipline:

* **Submission** — ``generate(req)`` queues the request with the
  engine's admission scheduler and returns an async iterator of token
  ids.  Arrival order is irrelevant; service order is the scheduler's
  policy (priority / deadline slack / tenant fair share).
* **Streaming** — the engine's ``on_stream`` hook fires on the drive
  thread after every commit (once per block/round, NEVER per token) and
  the server marshals the block's tokens onto the event loop with
  ``call_soon_threadsafe``; the async iterator then yields them one at a
  time.  Per-token latency to the consumer stays once-per-block — the
  async layer adds no device syncs.
* **Drive loop** — ``serve()`` (started by ``async with``) runs
  ``engine._drive_tick`` in a worker thread via ``asyncio.to_thread``,
  so the event loop keeps serving consumers during a device block.  One
  tick at a time: the single-owner engine contract is preserved.
* **Backpressure** — tokens buffered but not yet consumed are counted;
  past ``max_buffered_tokens`` the drive loop PAUSES (no admissions, no
  blocks) until consumers drain below the watermark.  Slow readers
  throttle generation instead of growing unbounded queues.
* **Graceful drain** — leaving the ``async with`` scope (or calling
  ``drain()``) stops new submissions, finishes every in-flight and
  queued request, flushes their streams, then stops the drive task.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Dict, List, Optional, Tuple

from .engine import Engine, GenRequest, GenResult


class AsyncServer:
    """Asyncio streaming facade over one ``Engine``.

    Usage::

        async with AsyncServer(engine) as srv:
            async for tok in srv.generate(req):
                ...
            result = srv.result(req.rid)

    Single event loop, single engine owner: ``generate`` may be called
    from many tasks concurrently, but all engine mutation happens on the
    drive task's worker thread, one tick at a time.
    """

    def __init__(self, engine: Engine, *, max_buffered_tokens: int = 4096):
        if max_buffered_tokens < 1:
            raise ValueError(
                f"max_buffered_tokens must be >= 1: {max_buffered_tokens}"
            )
        self.engine = engine
        self.max_buffered_tokens = max_buffered_tokens
        self._queues: Dict[int, asyncio.Queue] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        self._buffered = 0  # tokens pushed to consumers, not yet read
        self._draining = False
        self._wake: Optional[asyncio.Event] = None
        self._drained: Optional[asyncio.Event] = None
        m = engine.obs
        self._m_streams = m.counter(
            "server_streams_total", "streams opened via generate()")
        self._m_stream_toks = m.counter(
            "server_stream_tokens_total", "tokens yielded to consumers")
        self._m_bp = m.counter(
            "server_backpressure_waits_total",
            "drive-loop pauses waiting for slow consumers")
        self._m_open = m.gauge("server_open_streams", "live streams")

    # -- lifecycle ----------------------------------------------------------

    async def __aenter__(self) -> "AsyncServer":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.drain()

    def start(self) -> None:
        """Install the stream hook and start the drive task on the
        running event loop."""
        if self._task is not None:
            raise RuntimeError("server already started")
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._drained = asyncio.Event()
        self._drained.set()
        self.engine.on_stream = self._on_stream
        self._task = self._loop.create_task(self.serve())
        self.engine.obs.event("server.start")

    async def drain(self) -> None:
        """Graceful shutdown: refuse new submissions, serve everything
        queued or in flight to a terminal result, then stop the drive
        task.  Idempotent."""
        self._draining = True
        self.engine.obs.event(
            "server.drain",
            queued=len(self.engine.scheduler),
            live=int(self.engine.active.sum()),
        )
        if self._wake is not None:
            self._wake.set()
        if self._drained is not None:
            self._drained.set()  # drain must not hang on a gone consumer
        if self._task is not None:
            await self._task
            self._task = None

    # -- submission / consumption -------------------------------------------

    async def generate(self, req: GenRequest) -> AsyncIterator[int]:
        """Submit ``req`` and yield its generated token ids as the drive
        loop produces them.  The stream ends at the terminal result —
        inspect ``result(req.rid)`` for status/error; a failed request
        simply yields whatever partial stream it committed."""
        if self._draining:
            raise RuntimeError("server is draining: submission refused")
        if self._task is None:
            raise RuntimeError("server not started (use `async with`)")
        q: asyncio.Queue = asyncio.Queue()
        self._queues[req.rid] = q
        self._m_streams.inc()
        self._m_open.set(float(len(self._queues)))
        try:
            self.engine.submit(req)
            self._wake.set()
            while True:
                toks, result = await q.get()
                for t in toks:
                    self._buffered -= 1
                    if self._buffered <= self.max_buffered_tokens:
                        self._drained.set()
                    self._m_stream_toks.inc()
                    yield int(t)
                if result is not None:
                    return
        finally:
            self._queues.pop(req.rid, None)
            self._m_open.set(float(len(self._queues)))

    def result(self, rid: int) -> Optional[GenResult]:
        """Terminal result for a finished stream (None while running)."""
        return self.engine.results.get(rid)

    # -- engine-side hook (drive thread) ------------------------------------

    def _on_stream(self, rid: int, toks: List[int],
                   result: Optional[GenResult]) -> None:
        # called on the drive worker thread: marshal onto the event loop
        # (queues + the backpressure counter are loop-thread-only state)
        self._loop.call_soon_threadsafe(self._push, rid, list(toks), result)

    def _push(self, rid: int, toks: List[int],
              result: Optional[GenResult]) -> None:
        q = self._queues.get(rid)
        if q is None:
            return  # not a server-submitted request (e.g. direct admit)
        if toks or result is not None:
            self._buffered += len(toks)
            if self._buffered > self.max_buffered_tokens:
                self._drained.clear()
            q.put_nowait((toks, result))

    # -- drive task ---------------------------------------------------------

    def _idle(self) -> bool:
        return not (len(self.engine.scheduler) or self.engine.active.any())

    async def serve(self) -> None:
        """Drive the engine until drained: one ``_drive_tick`` per
        iteration in a worker thread, pausing while consumers lag."""
        while True:
            if self._idle():
                if self._draining:
                    break
                self._wake.clear()
                if self._idle():  # re-check: submit() may have raced
                    await self._wake.wait()
                continue
            if not self._draining and \
                    self._buffered > self.max_buffered_tokens:
                # backpressure: consumers are behind by more than the
                # watermark — generating more would just grow queues
                # (drain overrides: terminal results must still land)
                self._m_bp.inc()
                self._drained.clear()
                await self._drained.wait()
                continue
            await asyncio.to_thread(self.engine._drive_tick)
        self.engine.on_stream = None
        self.engine.obs.event("server.stop")


async def collect(server: AsyncServer, req: GenRequest
                  ) -> Tuple[List[int], Optional[GenResult]]:
    """Consume one stream to completion (tests / CLI convenience)."""
    toks = [t async for t in server.generate(req)]
    return toks, server.result(req.rid)
