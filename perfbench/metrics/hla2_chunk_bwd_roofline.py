"""``hla2_chunk_bwd``'s share of its roofline in training: the least time
of its calls (``costs.kernels.chunk_bwd_seconds`` at the step's rows, batch
times heads, and sequence length) over its kernels' device time (the main
kernel and the reduction of its column tiles)."""

from perfbench.costs import kernels

MAIN, REDUCE = "hla2_chunk_bwd_kernel", "hla2_bwd_reduce_kernel"


def read(run):
    if run.trace is None or not run.work.get("train_steps"):
        return None
    _, calls = run.trace.time_of((MAIN,))
    spent, _ = run.trace.time_of((MAIN, REDUCE))
    if not calls or not spent:
        return None
    c, w = run.c, run.work
    dh = c.get("d_head") or c["d_model"] // c["n_heads"]
    least, _ = kernels.chunk_bwd_seconds(w["batch"] * c["n_heads"],
                                         w["seq_len"], dh, dh)
    return 100.0 * calls * least / spent
