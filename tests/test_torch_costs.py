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
* the ``SequenceOp.cost_model`` hook replaces the state terms only.
"""

import dataclasses

import pytest

from repro.configs import get_config as ref_get_config
from repro.models import seq_op as ref_seq_op
from repro.obs import costs as ref_costs
from repro_torch.configs import get_config
from repro_torch.models import seq_op
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
    op = dataclasses.replace(seq_op.get_op("hla2"), name="gla")
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
