"""Host time a decode block spends after its last step: the mean duration
of the engine's ``engine.block_sync`` spans in the window (the tokens'
copy, the finite mask and the block's one transfer, whose wait is the
card finishing the block's queued work)."""


def read(run):
    if run.trace is None:
        return None
    ns = [b - a for _, a, b in run.trace.spans_named("engine.block_sync")]
    return 1e-6 * sum(ns) / len(ns) if ns else None
