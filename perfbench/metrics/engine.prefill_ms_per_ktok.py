"""Host time of admissions per thousand prompt tokens: the change of
``serving_prefill_seconds_total`` over that of
``serving_prompt_tokens_total`` across the window (the program's
registry)."""


def read(run):
    c = run.work.get("counters")
    if not c or not c["serving_prompt_tokens_total"]:
        return None
    return 1e3 * c["serving_prefill_seconds_total"] \
        / (c["serving_prompt_tokens_total"] / 1e3)
