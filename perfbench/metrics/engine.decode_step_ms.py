"""Host time a decode step in the engine's blocks: the change of
``serving_decode_seconds_total`` over that of ``serving_decode_steps_total``
across the window (the program's registry)."""


def read(run):
    c = run.work.get("counters")
    if not c or not c["serving_decode_steps_total"]:
        return None
    return 1e3 * c["serving_decode_seconds_total"] \
        / c["serving_decode_steps_total"]
