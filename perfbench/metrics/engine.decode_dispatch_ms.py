"""Host time a decode step takes to issue its work: the mean duration of
the engine's ``engine.decode_step`` spans in the window (each covers one
step's ``lm_apply(mode="decode")``, its sampling and token select; the
block's one sync is ``engine.block_sync``)."""


def read(run):
    if run.trace is None:
        return None
    ns = [b - a for _, a, b in run.trace.spans_named("engine.decode_step")]
    return 1e-6 * sum(ns) / len(ns) if ns else None
