"""Host time of admissions spent issuing their work, per thousand prompt
tokens: the engine's ``engine.prefill_dispatch`` spans in the window (an
admission's ids to the card, ``lm_prefill``, sampling, flags and the
slot's copy, up to its one sync) over the prompt tokens of the window's
admissions."""


def read(run):
    adm = run.work.get("admissions")
    if run.trace is None or not adm:
        return None
    spans = run.trace.spans_named("engine.prefill_dispatch")
    if not spans:
        return None
    return 1e-6 * sum(b - a for _, a, b in spans) / (sum(adm) / 1e3)
