"""A ``train`` cell: the program's train step on a fresh batch a step.

Set-up builds one object, the train step with its weights and AdamW
state, and drives it from the seed through the mix's ``checked_steps``
steps, reading the loss of each, the first gradient (from the first
moment after step 1) and each leaf's change; the same object then runs the
window.  Once the window has closed and the program's state is freed, the
plain reference follows the checked steps from the same weights and
batches.
"""

from __future__ import annotations

import math
import time

from . import checks, program, spec, traffic, weights
from .trace import Spans, profiling


def _opt(c):
    o = dict(c["optimizer"])
    o["betas"] = tuple(o["betas"])
    return o


def leaf_norms(c, tree, scale=1.0):
    return {path: float(weights.leaf(tree, path).float().norm()) * scale
            for path, _, _ in weights.leaf_specs(c)}


def changes(c, tree, seed, device, get=weights.leaf):
    """Each leaf's change from its initial value, made again leaf by
    leaf."""
    return {path: float((get(tree, path).detach() - p0).norm())
            for path, p0 in weights.regenerate(c, seed, device)}


def stacked_norms(pairs, scale=1.0):
    """``{path: norm}`` of ``(path, tensor)`` pairs whose ``layers/<i>/``
    paths are summed in squares over the layers."""
    sq = {}
    for path, x in pairs:
        keys = path.split("/")
        if keys[0] == "layers" and keys[1].isdigit():
            path = "/".join(keys[:1] + keys[2:])
        sq[path] = sq.get(path, 0.0) + float(x.float().square().sum())
    return {p: v ** 0.5 * scale for p, v in sq.items()}


def build(c, seed, device):
    """The program's train step, its weights and AdamW state."""
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.optim.adamw import OptConfig, init_opt_state

    cfg = program.model_config(c)
    program.check_layout(c, cfg)
    params = weights.make_params(c, seed, device)
    state = init_opt_state(params, cfg.moment_dtype)
    return make_train_step(cfg, OptConfig(**_opt(c))), params, state


def first_steps(step, params, state, c, t, seed, device):
    """The checked steps through ``step``; returns the object's new
    ``(params, state)`` and the readings."""
    b1 = c["optimizer"]["betas"][0]
    losses, grad = [], None
    for i in range(t["checked_steps"]):
        params, state, m = step(params, state, traffic.train_batch(
            t, c["vocab"], seed, i, device))
        losses.append(float(m["loss"]))
        if i == 0:
            grad = leaf_norms(c, state.mu, 1.0 / (1.0 - b1))
            gnorm = float(m["grad_norm"])
    return params, state, {"loss": losses, "grad": grad, "grad_norm": gnorm,
                           "update": changes(c, params, seed, device)}


def reference_readings(c, t, seed, device, prec="fp32", half=False):
    """The plain reference's readings over the checked steps, from the same
    weights and batches; ``prec="fp8"`` is the control, ``half`` the
    fault that leaves out half of each batch."""
    ref = spec.reference(c)
    ref.exact_matmuls()
    p = ref.Prec(prec)
    o = _opt(c)
    params = ref.unstack(weights.make_params(c, seed, device))
    for _, x in ref.leaves(params):
        x.requires_grad_(True)
    moments = [(x.detach().new_zeros(x.shape), x.detach().new_zeros(x.shape))
               for _, x in ref.leaves(params)]
    losses, grad = [], None
    for s in range(t["checked_steps"]):
        b = traffic.train_batch(t, c["vocab"], seed, s, device)
        if half:
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        total, _, _ = ref.loss(params, b["tokens"], b["labels"], c, p)
        total.backward()
        norm = ref.adamw(params, moments, s + 1, o)
        losses.append(float(total.detach()))
        if s == 0:
            gnorm = float(norm)
            grad = stacked_norms(
                [(path, m) for (path, _), (m, _) in zip(ref.leaves(params),
                                                        moments)],
                1.0 / (1.0 - o["betas"][0]))
    out = {"loss": losses, "grad": grad, "grad_norm": gnorm,
           "update": changes(c, params, seed, device, ref.stacked)}
    del params, moments
    return out


def run(ctx):
    """Set-up, the window and the check; returns the run's numbers."""
    c, t, seed, device = ctx.c, ctx.t, ctx.seed, ctx.device
    step, params, state = build(c, seed, device)
    ctx.phase("built")
    if ctx.fault is not None:
        step = ctx.fault(step)
    params, state, prog = first_steps(step, params, state, c, t, seed,
                                      device)
    ctx.phase("checked steps")
    i = t["checked_steps"]
    steps = failed = 0
    spans = Spans()
    with profiling(ctx.trace) as prof:
        w0 = ctx.window_opens()
        while True:
            # a step ends in the read of its loss, the loop's one sync
            with spans.span("train.step"):
                params, state, m = step(params, state, traffic.train_batch(
                    t, c["vocab"], seed, i, device))
                failed += not math.isfinite(float(m["loss"]))
            i += 1
            steps += 1
            if time.perf_counter() - w0 >= ctx.seconds:
                break
        w1 = ctx.window_closes()
    del step, params, state, m
    program.free()
    ref = reference_readings(c, t, seed, device)
    program.free()
    numbers, notes = checks.compare_train(prog, ref)
    tokens = steps * t["batch"] * t["seq_len"]
    return dict(
        attempted=steps, failed=failed, window_s=w1 - w0, prof=prof,
        spans=spans.spans,
        numbers=numbers, notes=notes,
        e2e={"train_tokens_per_s": tokens / (w1 - w0)},
        work={"train_steps": steps, "batch": t["batch"],
              "seq_len": t["seq_len"]})
