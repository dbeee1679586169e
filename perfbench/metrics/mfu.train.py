"""The train steps' share of the card's bf16 peak: the FLOPs the model
needs a token (``costs.model``, ``train_step``: three forward passes,
remat's recompute left out) times the tokens of the window's steps, over
the window, over 989 TFLOP/s."""

from perfbench.costs import model, peaks


def read(run):
    w = run.work
    if not w.get("train_steps"):
        return None
    cost = model.model_cost(run.c, mode="train_step", seq_len=w["seq_len"],
                            batch=w["batch"])
    tokens = w["train_steps"] * w["batch"] * w["seq_len"]
    return 100.0 * cost.flops_per_token * tokens / run.window_s \
        / peaks.BF16_FLOP_S
