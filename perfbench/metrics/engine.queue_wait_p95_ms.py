"""The 95th percentile of the time requests wait for their admission: the
engine's ``engine.queue_wait`` spans (a request's ``submit`` to the start
of its ``engine.prefill``) of the requests submitted in the window."""

import numpy as np


def read(run):
    if run.trace is None:
        return None
    ns = [b - a for _, a, b in run.trace.spans_named("engine.queue_wait")]
    return 1e-6 * float(np.percentile(ns, 95)) if ns else None
