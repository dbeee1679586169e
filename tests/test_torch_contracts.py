"""The run-time contracts of the port's four hot entry points
(``repro_torch/analysis/contracts.py``), the counterpart of the reference's
``tests/test_contracts.py``: on reduced hla-1b (chunk 16), on the CPU, with
either mixer, every entry point holds every contract; each planted fault
(an fp64 op, an out-of-place update, an extra ``.item()``, an op sequence
that depends on the prompt length) is caught, and the CLI exits 1 on it."""

import contextlib
import io
import json

import pytest
import torch

from repro_torch.analysis import contracts
from repro_torch.models import lm
from repro_torch.models.param import tree_map
from repro_torch.optim import adamw
from repro_torch.serving import engine as engine_mod

NAMES = ["prefill", "decode_block", "spec_round/accept", "spec_round/reject",
         "train_step"]


@pytest.mark.parametrize("mixer", ["hla2", "ahla"])
def test_entry_points_hold_every_contract(mixer):
    reports = contracts.check_entry_points(contracts.default_config(mixer),
                                           device="cpu")
    assert [r.name for r in reports] == NAMES
    assert {r.name.split("/")[0] for r in reports} == \
        set(contracts.ENTRY_POINTS)
    by = {r.name: r for r in reports}
    for r in reports:
        assert r.ok, (r.name, r.violations)
        assert r.syncs == r.expected_syncs and r.sync_warnings is None
        assert r.f64_ops == 0 and r.collectives == 0
        assert r.kept == r.donated and r.launches == {}  # plain versions
        assert r.aten_ops > 0
    assert [by[n].expected_syncs for n in NAMES] == [1, 1, 1, 2, 0]
    # pool leaves + tokens; params + mu + nu (14 leaves each)
    assert [by[n].donated for n in NAMES] == [0, 6, 6, 6, 42]


def _violations():
    """The CLI's exit code on the CPU and its violated reports, by name."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = contracts.main(["--device", "cpu", "--json"])
    out = json.loads(buf.getvalue())
    assert out["schema"] == "repro_torch.contracts/v1"
    return rc, {r["name"]: r["violations"] for r in out["reports"]
                if not r["ok"]}


def test_cli_passes_clean():
    rc, bad = _violations()
    assert rc == 0 and bad == {}


def test_planted_f64_op_is_caught(monkeypatch):
    orig = lm.rmsnorm_apply
    monkeypatch.setattr(lm, "rmsnorm_apply",
                        lambda p, x, eps: orig(p, x.double(), eps).to(x.dtype))
    rc, bad = _violations()
    assert rc == 1 and set(bad) == set(NAMES)
    assert all(any("f64 ops" in v for v in vs) for vs in bad.values())


def test_planted_out_of_place_update_is_caught(monkeypatch):
    def out_of_place(params, grads, state, cfg):
        params, mu, nu = (tree_map(torch.clone, t)
                          for t in (params, state.mu, state.nu))
        return orig(params, grads, adamw.OptState(state.step, mu, nu), cfg)

    orig = adamw.adamw_update
    monkeypatch.setattr(adamw, "adamw_update", out_of_place)
    rc, bad = _violations()
    assert rc == 1 and set(bad) == {"train_step"}
    assert any("donation contract: 42 buffer(s) donated but 0 kept" in v
               for v in bad["train_step"])


def test_planted_item_is_caught(monkeypatch):
    orig = engine_mod.sample

    def sample(logits, gen, cfg):
        logits.sum().item()  # a stray per-step sync
        return orig(logits, gen, cfg)

    monkeypatch.setattr(engine_mod, "sample", sample)
    rc, bad = _violations()
    assert rc == 1 and set(bad) == {"prefill", "decode_block"}
    assert any("host transfers: 5 ({'item': 4, 'cpu': 1})" in v
               for v in bad["decode_block"]), bad["decode_block"]


def test_planted_length_dependent_ops_are_caught(monkeypatch):
    orig = lm.lm_prefill

    def prefill(params, tokens, cfg, **kw):
        if tokens.shape[1] % 2:  # odd lengths take one more op
            tokens = tokens.clone()
        return orig(params, tokens, cfg, **kw)

    monkeypatch.setattr(lm, "lm_prefill", prefill)
    rc, bad = _violations()
    assert rc == 1 and set(bad) == {"prefill"}
    assert bad["prefill"] == [
        "unstable dispatch: prompt lengths [5, 11, 16] all pad to bucket 16 "
        "but run 2 distinct op sequences or launch counts"]


def test_pad_to_bucket_matches_reference():
    from repro.analysis.contracts import pad_to_bucket as ref

    for n in (1, 5, 15, 16, 17, 127, 128, 129, 700):
        for chunk in (16, 64, 128):
            assert contracts.pad_to_bucket(n, chunk) == ref(n, chunk)
