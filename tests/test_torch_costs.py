"""The port's analytic cost model (``repro_torch/obs/costs.py``) against the
reference's (``repro/obs/costs.py``).

* ``op_cost`` and ``model_cost`` of ``hla2`` and ``ahla`` equal the
  reference's in every mode, field by field, on reduced and full hla-1b
  (1e-12 relative: the same formulas over the same integers);
* the analytic forward FLOPs/token lie within a factor of 2 of what
  ``FlopCounterMode`` counts in the port's forward (the reference holds
  its own to XLA's dot FLOPs the same way);
* state bytes are constant in the sequence length (the paper's O(1)-state
  claim) and equal the reference's ``eval_shape`` account;
* the ``SequenceOp.cost_model`` hook replaces the state terms only;
* ``gla`` (its record's hook) equals the reference in every mode;
* an MoE config's ``model_cost`` is the reference's with the experts'
  share replaced (FLOPs at ``top_k / n_experts``, bytes at the expected
  share of experts a call touches), a closed form; at reduced
  qwen3-moe-30b-a3b (8 experts, top 2) it lies within 2x of what
  ``FlopCounterMode`` counts in the whole model's forward, and the
  reference's count, every expert on every token, does not;
* ``mamba`` (hla-1b's width with a ``MambaConfig``) and ``rwkv6`` (hla-1b
  and rwkv6-7b) equal the reference in every mode, ``op_cost`` and the
  uniform stack's ``model_cost``, at bf16 activations (the port keeps
  Mamba's conv state in the activation dtype, the reference in bf16);
* a hybrid stack's ``model_cost`` (jamba, its own ``attn`` and ``hla2``)
  is a closed form: the reference's projection term with the experts of
  the MoE positions at their share, plus each position's own op's state
  math, bytes and state (the reference's own ``op_cost`` of ``mamba`` and
  of the mixer), times the groups.
"""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_get_config
from repro.models import seq_op as ref_seq_op
from repro.obs import costs as ref_costs
from repro.models.config import MambaConfig as RefMambaConfig
from repro_torch.configs import get_config
from repro_torch.models import lm, seq_op
from repro_torch.models.config import MambaConfig
from repro_torch.models.param import init_params, param_bytes, param_count
from repro_torch.obs import costs
from repro_torch.serving.cache import state_bytes_for

MIXERS = ("hla2", "ahla")
REL = 1e-12


def _cfgs(mixer, reduced):
    return (ref_get_config("hla-1b", reduced=reduced).replace(mixer=mixer),
            get_config("hla-1b", reduced=reduced, mixer=mixer))


def _same(got, want):
    assert got.op == want.op and got.mode == want.mode
    assert got.state_bytes == want.state_bytes
    pairs = [(got.flops_per_token, want.flops_per_token),
             (got.bytes_per_token, want.bytes_per_token)]
    assert set(got.breakdown) == set(want.breakdown)
    pairs += [(got.breakdown[k], want.breakdown[k]) for k in want.breakdown]
    for a, b in pairs:
        assert abs(a - b) <= REL * abs(b), (got, want)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "hla-1b"])
@pytest.mark.parametrize("mode", costs.MODES)
@pytest.mark.parametrize("mixer", MIXERS)
def test_costs_match_reference(mixer, mode, reduced):
    ref_cfg, cfg = _cfgs(mixer, reduced)
    for seq_len, batch in ((1, 1), (64, 1), (300, 4), (2048, 2)):
        kw = dict(mode=mode, seq_len=seq_len, batch=batch)
        _same(costs.op_cost(mixer, cfg, **kw),
              ref_costs.op_cost(mixer, ref_cfg, **kw))
        _same(costs.model_cost(cfg, **kw), ref_costs.model_cost(ref_cfg, **kw))


def test_hla_1b_train_and_decode_costs():
    """The figures phase 10 of ``chip_smoke.py`` divides by: hla-1b's train
    step at 2 x 2048 and its decode step at 4 slots."""
    cfg = get_config("hla-1b")
    hla2 = costs.model_cost(cfg, mode="train_step", seq_len=2048, batch=2)
    ahla = costs.model_cost(cfg.replace(mixer="ahla"), mode="train_step",
                            seq_len=2048, batch=2)
    dec = costs.model_cost(cfg, mode="decode_step", seq_len=2048, batch=4)
    assert hla2.flops_per_token == 9_088_907_520
    assert ahla.flops_per_token == 8_824_666_368
    assert dec.bytes_per_token == pytest.approx(1.5746e9, rel=1e-4)


@pytest.mark.parametrize("mixer", MIXERS)
def test_analytic_flops_within_2x_of_counted(mixer):
    cfg = get_config("hla-1b", reduced=True, mixer=mixer)
    analytic = costs.op_cost(mixer, cfg, mode="train_fwd", seq_len=64)
    counted = costs.measured_op_flops(mixer, cfg, seq_len=64)["per_token"]
    assert counted > 0
    ratio = analytic.flops_per_token / counted
    assert 0.5 <= ratio <= 2.0, (analytic.flops_per_token, counted)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "hla-1b"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_state_bytes_constant_in_n_and_equal_reference(mixer, reduced):
    ref_cfg, cfg = _cfgs(mixer, reduced)
    op, ref_op = seq_op.get_op(mixer), ref_seq_op.get_op(mixer)
    sizes = {costs.record_state_bytes(op, cfg, max_len=n)
             for n in (16, 64, 256, 1024)}
    assert len(sizes) == 1 and min(sizes) > 0
    assert sizes == {ref_costs.record_state_bytes(ref_op, ref_cfg,
                                                  max_len=64)}
    # the whole LM's state is the layers' (the prefix cache's entry size)
    assert state_bytes_for(cfg) == cfg.n_layers * sizes.pop()


def test_hla_1b_state_bytes():
    for mixer in MIXERS:
        cfg = get_config("hla-1b", mixer=mixer)
        assert costs.op_cost(mixer, cfg).state_bytes * 24 == 75_890_688


@pytest.mark.parametrize("mixer", MIXERS)
def test_decode_flops_constant_in_context(mixer):
    cfg = get_config("hla-1b", reduced=True, mixer=mixer)
    short = costs.op_cost(mixer, cfg, mode="decode_step", seq_len=64)
    long = costs.op_cost(mixer, cfg, mode="decode_step", seq_len=4096)
    assert short.flops_per_token == long.flops_per_token


@pytest.mark.parametrize("mixer", MIXERS)
def test_backward_costs_twice_forward(mixer):
    cfg = get_config("hla-1b", reduced=True, mixer=mixer)
    fwd, bwd, stp = (costs.op_cost(mixer, cfg, mode=m, seq_len=64)
                     for m in ("train_fwd", "train_bwd", "train_step"))
    assert bwd.flops_per_token == pytest.approx(2 * fwd.flops_per_token)
    assert stp.flops_per_token == pytest.approx(3 * fwd.flops_per_token)
    assert stp.as_dict()["flops_per_token"] == stp.flops_per_token


def test_unknown_mode_or_op_raises():
    cfg = get_config("hla-1b", reduced=True)
    with pytest.raises(ValueError, match="mode"):
        costs.op_cost("hla2", cfg, mode="inference")
    op = dataclasses.replace(seq_op.get_op("hla2"), name="rwkv7")
    with pytest.raises(ValueError, match="no state-math formula"):
        costs.record_cost(op, cfg)


def test_cost_model_hook_overrides_state_terms():
    """A record's cost_model replaces the family state math (and state
    traffic); projections and state bytes stay record-derived."""
    cfg = get_config("hla-1b", reduced=True)
    base_op = seq_op.get_op("hla2")
    assert base_op.cost_model is None
    base = costs.record_cost(base_op, cfg, mode="train_fwd", seq_len=64)

    def hook(cfg, *, mode, seq_len, batch):
        return {"state_flops_per_token": 12345.0,
                "state_bytes_per_token": 777.0}

    hooked = costs.record_cost(dataclasses.replace(base_op, cost_model=hook),
                               cfg, mode="train_fwd", seq_len=64)
    assert hooked.breakdown["state_flops"] == 12345.0
    assert hooked.breakdown["state_traffic_bytes"] == 777.0
    assert hooked.breakdown["proj_flops"] == base.breakdown["proj_flops"]
    assert hooked.state_bytes == base.state_bytes


FAMILY = ("hla3", "hla3_paper", "linattn")


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "hla-1b"])
@pytest.mark.parametrize("mixer", FAMILY)
def test_family_costs_match_reference(mixer, reduced):
    """``op_cost`` and ``model_cost`` of the plain HLA records equal the
    reference's in every mode, field by field, and their state bytes are
    the reference's ``eval_shape`` account."""
    ref_cfg, cfg = _cfgs(mixer, reduced)
    for mode in costs.MODES:
        for seq_len, batch in ((1, 1), (64, 1), (300, 4), (2048, 2)):
            kw = dict(mode=mode, seq_len=seq_len, batch=batch)
            _same(costs.op_cost(mixer, cfg, **kw),
                  ref_costs.op_cost(mixer, ref_cfg, **kw))
            _same(costs.model_cost(cfg, **kw),
                  ref_costs.model_cost(ref_cfg, **kw))
    op, ref_op = seq_op.get_op(mixer), ref_seq_op.get_op(mixer)
    assert costs.record_state_bytes(op, cfg) == \
        ref_costs.record_state_bytes(ref_op, ref_cfg, max_len=64)
    assert state_bytes_for(cfg) == cfg.n_layers * costs.record_state_bytes(
        op, cfg)


def test_hla_1b_family_state_bytes():
    """The prefix cache's entry size per slot at full width, fp32 leaves."""
    want = {"hla3": 101_842_944, "hla3_paper": 101_056_512,
            "linattn": 25_362_432}
    for mixer, nbytes in want.items():
        assert state_bytes_for(get_config("hla-1b", mixer=mixer)) == nbytes


@pytest.mark.parametrize("mixer", FAMILY)
def test_family_analytic_flops_within_2x_of_counted(mixer):
    cfg = get_config("hla-1b", reduced=True, mixer=mixer)
    analytic = costs.op_cost(mixer, cfg, mode="train_fwd", seq_len=64)
    counted = costs.measured_op_flops(mixer, cfg, seq_len=64)["per_token"]
    ratio = analytic.flops_per_token / counted
    assert 0.5 <= ratio <= 2.0, (analytic.flops_per_token, counted)


ARCHS = ("codeqwen1.5-7b", "deepseek-67b", "internvl2-2b", "nemotron-4-15b",
         "qwen2-72b")


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_costs_match_reference(arch, reduced):
    """``op_cost("attn")`` and ``model_cost`` of each dense public config
    equal the reference's in every mode, field by field; the KV cache's
    bytes grow with the context and are the reference's ``eval_shape``
    account (bf16 K/V and an int32 length)."""
    ref_cfg = ref_get_config(arch, reduced=reduced)
    cfg = get_config(arch, reduced=reduced)
    for mode in costs.MODES:
        for seq_len, batch in ((1, 1), (64, 1), (300, 4), (2048, 2)):
            kw = dict(mode=mode, seq_len=seq_len, batch=batch)
            _same(costs.op_cost("attn", cfg, **kw),
                  ref_costs.op_cost("attn", ref_cfg, **kw))
            _same(costs.model_cost(cfg, **kw),
                  ref_costs.model_cost(ref_cfg, **kw))
    op, ref_op = seq_op.get_op("attn"), ref_seq_op.get_op("attn")
    sizes = [costs.record_state_bytes(op, cfg, max_len=n) for n in (16, 64)]
    assert sizes == [ref_costs.record_state_bytes(ref_op, ref_cfg, max_len=n)
                     for n in (16, 64)]
    assert sizes[1] - 4 == 4 * (sizes[0] - 4) == \
        4 * 2 * 2 * cfg.n_kv_heads * 16 * cfg.head_dim


@pytest.mark.parametrize("arch, mixer", [("codeqwen1.5-7b", "hla2"),
                                         ("codeqwen1.5-7b", "ahla"),
                                         ("qwen2-72b", "hla2")])
def test_dropin_costs_match_reference(arch, mixer):
    """An HLA mixer in a public config (qkv biases in its projections): the
    whole LM's cost equals the reference's in every mode."""
    ref_cfg = ref_get_config(arch, mixer=mixer)
    cfg = get_config(arch, mixer=mixer)
    for mode in costs.MODES:
        kw = dict(mode=mode, seq_len=2048, batch=2)
        _same(costs.model_cost(cfg, **kw), ref_costs.model_cost(ref_cfg, **kw))


def test_attn_analytic_flops_within_2x_of_counted_and_grow_with_context():
    cfg = get_config("codeqwen1.5-7b", reduced=True)
    analytic = costs.op_cost("attn", cfg, mode="train_fwd", seq_len=64)
    counted = costs.measured_op_flops("attn", cfg, seq_len=64)["per_token"]
    ratio = analytic.flops_per_token / counted
    assert 0.5 <= ratio <= 2.0, (analytic.flops_per_token, counted)
    short = costs.op_cost("attn", cfg, mode="decode_step", seq_len=64)
    long = costs.op_cost("attn", cfg, mode="decode_step", seq_len=4096)
    assert long.flops_per_token > short.flops_per_token
    assert long.state_bytes > short.state_bytes


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "hla-1b"])
def test_gla_costs_match_reference(reduced):
    """``gla``'s record hook (its fixed 32-token chunk) and ``model_cost``
    equal the reference's in every mode."""
    ref_cfg, cfg = _cfgs("gla", reduced)
    assert seq_op.get_op("gla").cost_model is not None
    for mode in costs.MODES:
        for seq_len, batch in ((1, 1), (20, 1), (300, 4), (2048, 2)):
            kw = dict(mode=mode, seq_len=seq_len, batch=batch)
            _same(costs.op_cost("gla", cfg, **kw),
                  ref_costs.op_cost("gla", ref_cfg, **kw))
            _same(costs.model_cost(cfg, **kw),
                  ref_costs.model_cost(ref_cfg, **kw))


MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("mixer", [None, "hla2"], ids=["attn", "hla2"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_cost_is_reference_with_expert_share(arch, reduced,
                                                       mixer):
    """The reference's ``model_cost`` minus the experts' weights it counts
    beyond the share a token runs (FLOPs) and a call reads (bytes)."""
    ref_cfg = ref_get_config(arch, reduced=reduced, mixer=mixer)
    cfg = get_config(arch, reduced=reduced, mixer=mixer)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    experts = {k: v for k, v in lm.lm_specs(cfg)["layers"]["moe"].items()
               if k != "router"}
    n_exp, b_exp = param_count(experts), param_bytes(experts)
    assert n_exp == cfg.n_layers * E * 3 * cfg.d_model * cfg.moe.d_ff
    for mode in costs.MODES:
        scale = costs._SCALE[mode]
        for seq_len, batch in ((1, 1), (64, 1), (300, 4), (2048, 2)):
            kw = dict(mode=mode, seq_len=seq_len, batch=batch)
            got = costs.model_cost(cfg, **kw)
            want = ref_costs.model_cost(ref_cfg, **kw)
            T = batch * (1 if mode == "decode_step" else seq_len)
            touched = E * (1 - (1 - K / E) ** T)
            flops = want.flops_per_token - scale * 2 * n_exp * (1 - K / E)
            nbytes = want.bytes_per_token \
                - scale * b_exp * (1 - touched / E) / T
            assert got.flops_per_token == pytest.approx(flops, rel=REL)
            assert got.bytes_per_token == pytest.approx(nbytes, rel=REL)
            assert got.state_bytes == want.state_bytes
            assert got.breakdown["state_flops"] == pytest.approx(
                want.breakdown["state_flops"], rel=REL)
    # decode at 4 slots touches ~24 of granite's 40 experts, not 40
    if arch == "granite-moe-3b-a800m" and not reduced:
        assert costs.moe_weight_shares(cfg, 4)[1] * E == pytest.approx(
            23.616)


def test_moe_model_flops_within_2x_of_counted():
    """Reduced qwen3-moe-30b-a3b (8 experts, top 2): the port's analytic
    forward FLOPs/token against ``FlopCounterMode`` over the whole model's
    forward (capacity slots included), and the reference's."""
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    assert cfg.moe.n_experts / cfg.moe.top_k >= 4
    params = init_params(lm.lm_specs(cfg), 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 64),
                           generator=torch.Generator().manual_seed(0))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        lm.lm_apply(params, tokens, cfg)
    counted = counter.get_total_flops() / 64
    ours = costs.model_cost(cfg, mode="train_fwd", seq_len=64)
    ref = ref_costs.model_cost(
        ref_get_config("qwen3-moe-30b-a3b", reduced=True), mode="train_fwd",
        seq_len=64)
    assert 0.5 <= ours.flops_per_token / counted <= 2.0, (
        ours.flops_per_token, counted)
    assert ref.flops_per_token / counted > 2.0, (ref.flops_per_token,
                                                 counted)


def _ssm_cfgs(arch, mixer, reduced):
    """Reference and port configs at bf16 activations, with the default
    ``MambaConfig`` where the arch has none."""
    ref_cfg = ref_get_config(arch, reduced=reduced).replace(
        mixer=mixer, dtype="bfloat16")
    cfg = get_config(arch, reduced=reduced).replace(mixer=mixer,
                                                    dtype="bfloat16")
    if cfg.mamba is None and mixer == "mamba":
        ref_cfg = ref_cfg.replace(mamba=RefMambaConfig())
        cfg = cfg.replace(mamba=MambaConfig())
    return ref_cfg, cfg


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch, mixer", [("hla-1b", "mamba"),
                                         ("hla-1b", "rwkv6"),
                                         ("rwkv6-7b", "rwkv6")])
def test_mamba_and_rwkv6_costs_match_reference(arch, mixer, reduced):
    ref_cfg, cfg = _ssm_cfgs(arch, mixer, reduced)
    for mode in costs.MODES:
        for seq_len, batch in ((1, 1), (20, 1), (300, 4), (2048, 2)):
            kw = dict(mode=mode, seq_len=seq_len, batch=batch)
            _same(costs.op_cost(mixer, cfg, **kw),
                  ref_costs.op_cost(mixer, ref_cfg, **kw))
            _same(costs.model_cost(cfg, **kw),
                  ref_costs.model_cost(ref_cfg, **kw))


@pytest.mark.parametrize("mixer", [None, "hla2"], ids=["attn", "hla2"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_hybrid_model_cost_closed_form(reduced, mixer):
    arch = "jamba-1.5-large-398b"
    ref_cfg = ref_get_config(arch, reduced=reduced, mixer=mixer).replace(
        dtype="bfloat16")
    cfg = get_config(arch, reduced=reduced, mixer=mixer).replace(
        dtype="bfloat16")
    G = cfg.n_layers // cfg.group_size
    mix = "attn" if cfg.mixer == "softmax" else cfg.mixer
    ops = [mix if i == cfg.attn_index else "mamba"
           for i in range(cfg.group_size)]
    assert ops.count("mamba") == 7
    groups = lm.lm_specs(cfg)["groups"]
    moe_pos = [f"pos{i}" for i in range(cfg.group_size)
               if i % cfg.moe.every == cfg.moe.every - 1]
    assert moe_pos == ["pos1", "pos3", "pos5", "pos7"]
    assert all(("moe" in groups[k]) == (k in moe_pos) for k in groups)
    experts = [{k: v for k, v in groups[p]["moe"].items() if k != "router"}
               for p in moe_pos]
    n_exp = sum(map(param_count, experts))
    b_exp = sum(map(param_bytes, experts))
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    assert n_exp == G * len(moe_pos) * E * 3 * cfg.d_model * cfg.moe.d_ff
    for mode in costs.MODES:
        scale = costs._SCALE[mode]
        for seq_len, batch in ((1, 1), (64, 1), (300, 4), (2048, 2)):
            kw = dict(mode=mode, seq_len=seq_len, batch=batch)
            got = costs.model_cost(cfg, **kw)
            want = ref_costs.model_cost(ref_cfg, **kw)
            per = [ref_costs.op_cost(o, ref_cfg, **kw) for o in ops]
            T = batch * (1 if mode == "decode_step" else seq_len)
            touched = E * (1 - (1 - K / E) ** T)
            proj = want.breakdown["proj_flops"] \
                - scale * 2 * n_exp * (1 - K / E)
            state = G * sum(c.breakdown["state_flops"] for c in per)
            traffic = G * sum(c.breakdown["state_traffic_bytes"]
                              for c in per)
            weights = want.breakdown["weight_bytes"] \
                - scale * b_exp * (1 - touched / E) / T
            assert got.breakdown["proj_flops"] == pytest.approx(proj,
                                                                rel=REL)
            assert got.breakdown["state_flops"] == pytest.approx(state,
                                                                 rel=REL)
            assert got.flops_per_token == pytest.approx(proj + state,
                                                        rel=REL)
            assert got.bytes_per_token == pytest.approx(
                weights + want.breakdown["act_bytes"] + traffic, rel=REL)
            assert got.state_bytes == G * sum(c.state_bytes for c in per)
            assert got.op == want.op
    # the reference counts softmax attention's state math in all 72 layers
    if mixer is None and not reduced:
        full = dict(mode="train_fwd", seq_len=2048, batch=1)
        assert ref_costs.model_cost(ref_cfg, **full).breakdown[
            "state_flops"] == 72 * ref_costs.op_cost(
                "attn", ref_cfg, **full).breakdown["state_flops"]
