"""The port's serving path vs the reference engine, reduced hla-1b, fp32,
with the reference's own weights (``from_jax_params``).

Greedy streams must match token for token.  Sampled streams cannot (torch
and JAX draw different numbers), so sampling is held to the reference's
warped distribution and checked in distribution only.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro.serving import Engine as RefEngine
from repro.serving import GenRequest as RefRequest
from repro.serving import SamplingConfig as RefSampling
from repro.serving.sampling import probs as ref_probs
from repro_torch.configs import get_config
from repro_torch.core.hla2 import HLA2State
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params
from repro_torch.serving.engine import Engine, GenRequest
from repro_torch.serving.sampling import SamplingConfig, sample, warped_logits
from repro_torch.serving.state_pool import StatePool


@pytest.fixture(scope="module")
def model():
    ref_cfg = ref_get_config("hla-1b", reduced=True)
    cfg = get_config("hla-1b", reduced=True)
    ref_params = ref_init_params(ref_lm.lm_specs(ref_cfg), jax.random.key(0))
    params = from_jax_params(jax.device_get(ref_params), lm.lm_specs(cfg),
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


def _engine(cfg, params, **kw):
    kw = {"slots": 2, "max_len": 64, "block": 4, **kw}
    return Engine(cfg, params, device="cpu", **kw)


@pytest.mark.parametrize("lens,max_new", [([3, 9, 9, 17], 6),
                                          ([1, 30, 5], 9)])
def test_greedy_streams_match_reference_engine(model, rng, lens, max_new):
    ref_cfg, ref_params, cfg, params = model
    prompts = [rng.randint(2, cfg.vocab, n) for n in lens]
    ref_res = RefEngine(ref_cfg, ref_params, slots=2, max_len=64,
                        block=4).run([
        RefRequest(rid=i, prompt=p, max_new=max_new)
        for i, p in enumerate(prompts)])
    res = _engine(cfg, params).run([
        GenRequest(rid=i, prompt=p, max_new=max_new)
        for i, p in enumerate(prompts)])
    assert [r.status for r in res] == ["ok"] * len(lens)
    assert [r.tokens for r in res] == [r.tokens for r in ref_res]
    assert [r.prompt_len for r in res] == lens


def test_eos_and_single_token_requests_match_reference_engine(model, rng):
    ref_cfg, ref_params, cfg, params = model
    prompts = [rng.randint(2, cfg.vocab, n) for n in (4, 11, 6)]
    (probe,) = _engine(cfg, params).run(
        [GenRequest(rid=0, prompt=prompts[0], max_new=8)])
    eos = probe.tokens[3]  # stops request 0 after at most 4 tokens
    specs = [(8, eos), (1, None), (8, eos)]
    ref_res = RefEngine(ref_cfg, ref_params, slots=2, max_len=64,
                        block=4).run([
        RefRequest(rid=i, prompt=p, max_new=m, eos_id=e)
        for i, (p, (m, e)) in enumerate(zip(prompts, specs))])
    res = _engine(cfg, params).run([
        GenRequest(rid=i, prompt=p, max_new=m, eos_id=e)
        for i, (p, (m, e)) in enumerate(zip(prompts, specs))])
    assert [r.tokens for r in res] == [r.tokens for r in ref_res]
    assert res[0].tokens[-1] == eos and len(res[0].tokens) <= 4
    assert len(res[1].tokens) == 1


def test_admission_never_perturbs_live_slots(model, rng):
    _, _, cfg, params = model
    prompt_a = rng.randint(2, cfg.vocab, 5)
    prompt_b = rng.randint(2, cfg.vocab, 5)
    (ra,) = _engine(cfg, params).run(
        [GenRequest(rid=0, prompt=prompt_a, max_new=12)])
    eng = _engine(cfg, params)
    eng.admit(0, GenRequest(rid=0, prompt=prompt_a, max_new=12))
    eng.step_block()
    eng.admit(1, GenRequest(rid=1, prompt=prompt_b, max_new=8))
    while eng.active.any():
        eng.step_block()
    assert eng.results[0].tokens == ra.tokens
    assert len(eng.results[1].tokens) == 8


def test_recycled_slot_reproduces(model, rng):
    _, _, cfg, params = model
    prompt = rng.randint(2, cfg.vocab, 5)
    r0, r1, r2 = _engine(cfg, params, slots=1).run([
        GenRequest(rid=0, prompt=prompt, max_new=6),
        GenRequest(rid=1, prompt=rng.randint(2, cfg.vocab, 7), max_new=6),
        GenRequest(rid=2, prompt=prompt, max_new=6)])
    assert len(r1.tokens) == 6 and r0.tokens == r2.tokens


def test_nan_slot_is_quarantined_and_neighbour_keeps_decoding(model, rng):
    _, _, cfg, params = model
    prompts = [rng.randint(2, cfg.vocab, 6) for _ in range(2)]
    (solo,) = _engine(cfg, params).run(
        [GenRequest(rid=1, prompt=prompts[1], max_new=10)])
    eng = _engine(cfg, params)
    eng.admit(0, GenRequest(rid=0, prompt=prompts[0], max_new=10))
    eng.admit(1, GenRequest(rid=1, prompt=prompts[1], max_new=10))
    eng.pool.states.S[:, 0] = float("nan")  # poison slot 0
    while eng.active.any():
        eng.step_block()
    assert eng.results[0].status == "error"
    assert "quarantined" in eng.results[0].error
    assert eng.results[1].status == "ok"
    assert eng.results[1].tokens == solo.tokens
    assert eng.stats["quarantined"] == 1
    assert bool(eng.pool.finite_mask().all())  # the slot was reset


def test_invalid_requests_fail_alone(model, rng):
    _, _, cfg, params = model
    good = GenRequest(rid=2, prompt=rng.randint(2, cfg.vocab, 4), max_new=3)
    res = _engine(cfg, params).run([
        GenRequest(rid=0, prompt=np.array([cfg.vocab]), max_new=3),
        GenRequest(rid=1, prompt=np.zeros(70, np.int64), max_new=3),
        good,
        GenRequest(rid=3, prompt=np.array([1.5]), max_new=3)])
    assert [r.status for r in res] == ["error", "error", "ok", "error"]
    assert len(res[2].tokens) == 3
    with pytest.raises(ValueError, match="unique"):
        _engine(cfg, params).run([good, good])


def test_one_host_transfer_per_block(model, rng, monkeypatch):
    """The block's tokens and finiteness flags come back in one ``.cpu()``
    and no per-token ``.item()`` / ``.tolist()`` runs in ``step_block``."""
    _, _, cfg, params = model
    eng = _engine(cfg, params)
    eng.admit(0, GenRequest(rid=0, prompt=rng.randint(2, cfg.vocab, 4),
                            max_new=20))
    calls = {"cpu": 0, "item": 0, "tolist": 0}
    for name in calls:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _n=name, _o=orig, **k):
            calls[_n] += 1
            return _o(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    eng.step_block()
    assert calls == {"cpu": 1, "item": 0, "tolist": 0}


def test_state_pool_slots_are_independent():
    def make(n):
        return HLA2State(*(torch.zeros(3, n, 2, *s) for s in
                           [(4, 4), (4, 5), (4,), (4, 5), (4,)]))

    pool = StatePool(make, 3)
    one = HLA2State(*(torch.ones(3, 1, *x.shape[2:]) for x in pool.states))
    pool.write_slot(1, one)
    for x in pool.states:
        assert (x[:, 1] == 1).all() and (x[:, [0, 2]] == 0).all()
    got = pool.read_slot(1)
    assert type(got) is HLA2State and got.S.shape == (3, 1, 2, 4, 4)
    got.S.zero_()  # a copy: the pool is untouched
    assert (pool.states.S[:, 1] == 1).all()
    pool.states.h[0, 2, 0, 0] = float("inf")
    assert pool.finite_mask().tolist() == [True, True, False]
    pool.reset_slot(2)
    pool.reset_slot(1)
    assert all((x == 0).all() for x in pool.states)


SAMPLERS = [
    SamplingConfig(method="temperature", temperature=0.7),
    SamplingConfig(method="top_k", top_k=3, temperature=1.3),
    SamplingConfig(method="top_p", top_p=0.6),
]


@pytest.mark.parametrize("scfg", SAMPLERS, ids=lambda c: c.method)
def test_warped_distribution_matches_reference(rng, scfg):
    logits = rng.randn(4, 32).astype(np.float32) * 2
    ref = ref_probs(jnp.asarray(logits), RefSampling(
        method=scfg.method, temperature=scfg.temperature, top_k=scfg.top_k,
        top_p=scfg.top_p))
    got = torch.softmax(warped_logits(torch.from_numpy(logits), scfg), -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("scfg", SAMPLERS, ids=lambda c: c.method)
def test_sampling_respects_masks_and_seeds(rng, scfg):
    logits = torch.from_numpy(rng.randn(1, 16).astype(np.float32) * 2)
    p = torch.softmax(warped_logits(logits, scfg), -1)[0]
    draws = 4000
    big = logits.expand(draws, -1)
    toks = sample(big, torch.Generator().manual_seed(7), scfg)
    again = sample(big, torch.Generator().manual_seed(7), scfg)
    other = sample(big, torch.Generator().manual_seed(8), scfg)
    assert torch.equal(toks, again) and not torch.equal(toks, other)
    assert (p[toks] > 0).all()  # never outside the top-k / nucleus set
    freq = torch.bincount(toks, minlength=16).double() / draws
    sigma = (p.double() * (1 - p.double()) / draws).sqrt()
    assert ((freq - p.double()).abs() <= 5 * sigma + 1e-12).all()


def test_sampling_rejects_bad_configs():
    logits = torch.zeros(2, 8)
    gen = torch.Generator()
    with pytest.raises(ValueError):
        sample(logits, gen, SamplingConfig(method="top_k", top_k=0))
    with pytest.raises(ValueError):
        sample(logits, gen, SamplingConfig(method="top_p", top_p=0.0))
    with pytest.raises(ValueError):
        sample(logits, gen, SamplingConfig(method="beam"))
    assert sample(torch.tensor([[0.0, 3.0, 1.0]]), gen,
                  SamplingConfig()).tolist() == [1]


@pytest.mark.parametrize("sampling", ["greedy", "top_p"])
def test_serve_cli_on_cpu(capsys, sampling):
    results = serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                          "--gen-len", "5", "--prompt-len", "9",
                          "--sampling", sampling])
    out = capsys.readouterr().out
    assert re.search(
        r"\[serve\] 3 requests, 15 generated tokens in [\d.]+s \| TTFT p50 "
        r"[\d.]+ms p99 [\d.]+ms \(queued p50 [\d.]+ms p99 [\d.]+ms\) \| "
        r"decode [\d.]+ tok/s \| prefill [\d.]+ tok/s", out), out
    assert "statuses: ok=3" in out
    assert all(len(r.tokens) == 5 for r in results)


def test_engine_on_cuda_without_a_card_raises(model):
    _, _, cfg, params = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, device="cuda")
