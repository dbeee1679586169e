"""``hla2_step``'s share of its roofline in decode: the least time of its
calls (one a layer and step, at the pool's rows, slots times heads;
``costs.kernels.step_seconds``) over the kernel's device time in the
window."""

from perfbench.costs import kernels

NAME = "hla2_step_kernel"


def read(run):
    blocks = run.work.get("decode_blocks")
    if run.trace is None or not blocks:
        return None
    spent, calls = run.trace.time_of((NAME,))
    if not spent or not calls:
        return None
    c = run.c
    dh = c.get("d_head") or c["d_model"] // c["n_heads"]
    least, _ = kernels.step_seconds(run.work["slots"] * c["n_heads"], dh, dh)
    return 100.0 * calls * least / spent
