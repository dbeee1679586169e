"""The plain reference against the program's plain path (the kernels'
plain versions on the CPU) at reduced sizes of both configurations, in
float32: logits, loss, every gradient, one AdamW step, and the MoE's
capacity drops."""

import json

import _paths  # noqa: F401
import pytest
import torch

from perfbench.bench import program, spec, traffic, weights
from perfbench.reference import hla_lm

BENCH = spec.load_benchmark()


def small(name, **kw):
    ce = spec.by_name(BENCH["configs"], name, "configuration")
    c = json.loads((spec.ROOT / ce["file"]).read_text())
    c.update(n_layers=2, d_model=64, n_heads=4, d_ff=96, vocab=128,
             dtype="float32", remat="none")
    c["n_kv_heads"] = 2 if c.get("moe") else 4
    if c.get("moe"):
        c["moe"] = dict(c["moe"], n_experts=6, top_k=2, d_ff=32, **kw)
    return c


CASES = [("hla-1b.hla2", {}),
         ("granite-moe-3b-a800m.hla2", {}),
         ("granite-moe-3b-a800m.hla2", {"capacity_factor": 0.5})]


@pytest.mark.parametrize("name,kw", CASES)
def test_reference_matches_the_programs_plain_path(name, kw):
    from repro_torch.distributed.steps import accumulate_grads
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    torch.manual_seed(0)
    c = small(name, **kw)
    cfg = program.model_config(c)
    program.check_layout(c, cfg)
    t = {"batch": 2, "seq_len": 80}
    b = traffic.train_batch(t, c["vocab"], 5, 0, "cpu")
    hla_lm.exact_matmuls()
    prec = hla_lm.Prec("fp32")

    ours = weights.make_params(c, 3, "cpu")
    logits_p, _, aux_p = lm.lm_apply(ours, b["tokens"], cfg, mode="train")
    x, aux_r = hla_lm.hidden(ours, b["tokens"], c, prec)
    logits_r = hla_lm.unembed(ours, x, c, prec)
    torch.testing.assert_close(logits_p, logits_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux_p, aux_r, rtol=1e-5, atol=1e-6)

    loss_p, _, _, grads = accumulate_grads(ours, b, cfg)
    ref = weights.make_params(c, 3, "cpu")
    for _, leaf in hla_lm.leaves(ref):
        leaf.requires_grad_(True)
    loss_r, _, _ = hla_lm.loss(ref, b["tokens"], b["labels"], c, prec)
    loss_r.backward()
    torch.testing.assert_close(loss_p, loss_r.detach(), rtol=1e-5,
                               atol=1e-6)
    for path, leaf in hla_lm.leaves(ref):
        torch.testing.assert_close(weights.leaf(grads, path), leaf.grad,
                                   rtol=1e-3, atol=1e-6, msg=path)

    o = dict(c["optimizer"], betas=tuple(c["optimizer"]["betas"]))
    state = adamw.init_opt_state(ours)
    ours, _, _ = adamw.adamw_update(ours, grads, state, adamw.OptConfig(**o))
    moments = [(torch.zeros_like(x), torch.zeros_like(x))
               for _, x in hla_lm.leaves(ref)]
    hla_lm.adamw(ref, moments, 1, o)
    for path, leaf in hla_lm.leaves(ref):
        torch.testing.assert_close(weights.leaf(ours, path), leaf.detach(),
                                   rtol=1e-5, atol=1e-7, msg=path)


def test_capacity_drops_pairs_in_token_order():
    """At capacity 1 a row's second pair for an expert is dropped: the
    reference's output for that token leaves the expert out."""
    c = small("granite-moe-3b-a800m.hla2")
    m = dict(c["moe"], n_experts=2, top_k=1, capacity_factor=0.25)
    c["moe"] = m
    d = c["d_model"]
    p = {"router": {"kernel": torch.zeros(d, 2)},
         "wi_gate": torch.randn(2, d, 32), "wi_up": torch.randn(2, d, 32),
         "wo": torch.randn(2, 32, d)}
    p["router"]["kernel"][0, 0] = 1.0  # every token prefers expert 0
    x = torch.ones(1, 8, d)  # C = ceil(1 * 8 * 0.25 / 2) = 1
    y, _ = hla_lm.moe(p, x, c, hla_lm.Prec("fp32"))
    assert y[0, 0].abs().sum() > 0
    assert torch.equal(y[0, 1:], torch.zeros_like(y[0, 1:]))


def test_the_control_rounds_to_float8():
    x = torch.linspace(-3, 3, 101)
    r = hla_lm.Prec("fp8").act(x)
    assert not torch.equal(r, x)
    assert (r - x).abs().max() <= 3 * 2**-4
    assert torch.equal(hla_lm.Prec("fp32").act(x), x)
