"""``hla2_chunk_fwd``'s share of its roofline in admissions: the least time
of each admission's calls (one a layer, at the heads' rows and the prompt's
length, from a zero carry; ``costs.kernels.chunk_fwd_seconds``) over the
kernel's device time in the window."""

from perfbench.costs import kernels

NAME = "hla2_chunk_fwd_kernel"


def read(run):
    adm = run.work.get("admissions")
    if run.trace is None or not adm:
        return None
    spent, calls = run.trace.time_of((NAME,))
    c = run.c
    if not spent or calls != c["n_layers"] * len(adm):
        return None
    dh = c.get("d_head") or c["d_model"] // c["n_heads"]
    least = sum(kernels.chunk_fwd_seconds(c["n_heads"], n, dh, dh)[0]
                for n in adm)
    return 100.0 * c["n_layers"] * least / spent
