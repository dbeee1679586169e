"""Serving: continuous batching over the streaming-state model (twin of
``repro/serving``).

* ``sampling``   — seeded device-side token sampling (greedy / temperature
                   / top-k / top-p);
* ``state_pool`` — per-slot decode-state ownership (in place on the card),
                   copies for rollback and host snapshots for the cache;
* ``engine``     — the continuous-batching loop: chunk-parallel admission
                   prefill, step-locked decode blocks with one host sync
                   per block, per-request statuses, fault points, metrics;
* ``spec``       — speculative decoding: drafters, chunk-parallel verify,
                   rollback over the in-place pool;
* ``cache``      — content-addressed prefix/state cache: a cached prompt
                   prefix is ONE O(1) state snapshot in host memory,
                   resumed exactly via the chunkwise carry identity;
* ``scheduler``  — priority admission queue (priority class / deadline
                   slack / tenant fair share), queued-deadline expiry,
                   slot-count autoscaling;
* ``server``     — asyncio streaming facade: per-token async generators
                   over the once-per-block sync, consumer backpressure,
                   graceful drain.

``launch.serve`` is a thin CLI over ``engine.Engine``.
"""

from .cache import PrefixCache, state_bytes_for  # noqa: F401
from .engine import Engine, GenRequest, GenResult  # noqa: F401
from .sampling import SamplingConfig, probs, sample  # noqa: F401
from .scheduler import Scheduler, SchedulerConfig  # noqa: F401
from .server import AsyncServer  # noqa: F401
from .spec import (  # noqa: F401
    Drafter,
    HLADrafter,
    NGramDrafter,
    SpecConfig,
)
from .state_pool import StatePool  # noqa: F401
