"""Kernels launched a decode step: the device trace's kernels that start
inside the engine's ``engine.decode_block`` spans, over the decode steps
of the window (the program's registry)."""


def read(run):
    c = run.work.get("counters")
    if run.trace is None or not c or not c["serving_decode_steps_total"]:
        return None
    return run.trace.kernels_within("engine.decode_block") \
        / c["serving_decode_steps_total"]
