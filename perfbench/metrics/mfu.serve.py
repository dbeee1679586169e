"""The serving window's share of the card's peaks: the least time the
window's admissions and decode steps need (each call's FLOPs at the bf16
peak or its bytes at the memory rate, whichever is longer, from
``costs.model`` with bf16 weights, at the call's prompt length or active
slots), over the window."""

from perfbench.costs import model, peaks


def read(run):
    w = run.work
    if not w.get("decode_blocks"):
        return None
    pre, dec = model.serve_least_seconds(
        run.c, w["admissions"], w["decode_blocks"],
        flop_s=peaks.BF16_FLOP_S, bytes_s=peaks.HBM_BYTES_S)
    return 100.0 * (pre + dec) / run.window_s
