"""The admissions' share of the card's peaks: the least time the window's
admissions need (as ``mfu.serve`` counts it), over the host time the
engine spent in them (the change of ``serving_prefill_seconds_total``)."""

from perfbench.costs import model, peaks


def read(run):
    w = run.work
    c = w.get("counters")
    if not c or not c["serving_prefill_seconds_total"]:
        return None
    pre, _ = model.serve_least_seconds(
        run.c, w["admissions"], [],
        flop_s=peaks.BF16_FLOP_S, bytes_s=peaks.HBM_BYTES_S)
    return 100.0 * pre / c["serving_prefill_seconds_total"]
