"""Property tests (hypothesis) of the port's scan operators
(``repro_torch/core/monoid.py``), twin of ``tests/test_monoid_properties.py``:
associativity and identity of the corrected operators, the two documented
errata (the paper's printed decay-aware concatenations are NOT
associative), the port's associative scan (``core/_scan.py``) against a
left fold, and each operator against the reference's on the same inputs.

Tolerance: fp64, 1e-9 absolute and relative (1e-8 where the reference's
test uses it).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis (CI installs it)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core._scan import associative_scan  # noqa: E402
from repro_torch.core.monoid import (  # noqa: E402
    AHLADecayState,
    AHLAState,
    HLA2DecayState,
    HLA2State,
    HLA3ScanState,
    ahla_op,
    ahla_op_decay,
    ahla_op_decay_paper,
    hla3_op,
    masked_op,
    masked_op_decay,
    masked_op_decay_paper,
)

R = importlib.import_module("repro.core.monoid")

D, DV = 3, 2
SETTINGS = dict(max_examples=25, deadline=None)


def _rand(kind, rs, lead=()):
    shapes = {
        "S": (D, D), "C": (D, DV), "m": (D,), "G": (D, DV), "h": (D,),
        "R": (D, D), "P": (D, DV), "E": (D, DV), "n": (D,), "SK": (D, D),
        "SQ": (D, D), "F": (D, DV), "eta": (D,), "RQP": (D, DV),
        "rQm": (D,), "UKQ": (D, D), "W4": (D, D, D, DV), "W3": (D, D, D),
    }
    return kind(*(torch.from_numpy(rs.uniform(0.5, 0.99, lead)) if f == "rho"
                  else torch.from_numpy(rs.randn(*lead, *shapes[f]))
                  for f in kind._fields))


def _close(a, b, tol=1e-9):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=tol,
                                   rtol=tol)


def _differs(a, b, min_diff=1e-6):
    assert max(float((x - y).abs().max()) for x, y in zip(a, b)) > min_diff


@given(st.integers(0, 2**31 - 1))
@settings(**SETTINGS)
def test_hla2_masked_decay_op_associative(seed):
    rs = np.random.RandomState(seed)
    x, y, z = (_rand(HLA2DecayState, rs) for _ in range(3))
    _close(masked_op_decay(masked_op_decay(x, y), z),
           masked_op_decay(x, masked_op_decay(y, z)))


@given(st.integers(0, 2**31 - 1))
@settings(**SETTINGS)
def test_hla2_masked_decay_identity(seed):
    x = _rand(HLA2DecayState, np.random.RandomState(seed))
    e = HLA2DecayState(*(torch.zeros_like(f) for f in x[:-1]),
                       rho=torch.ones((), dtype=torch.float64))
    _close(masked_op_decay(e, x), x)
    _close(masked_op_decay(x, e), x)


@given(st.integers(0, 2**31 - 1))
@settings(**SETTINGS)
def test_erratum_paper_hla2_decay_op_not_associative(seed):
    """The paper's printed decayed masked concatenation (Section 4.2)."""
    rs = np.random.RandomState(seed)
    x, y, z = (_rand(HLA2DecayState, rs) for _ in range(3))
    _differs(masked_op_decay_paper(masked_op_decay_paper(x, y), z),
             masked_op_decay_paper(x, masked_op_decay_paper(y, z)))


@given(st.integers(0, 2**31 - 1))
@settings(**SETTINGS)
def test_ahla_decay_op_associative(seed):
    rs = np.random.RandomState(seed)
    x, y, z = (_rand(AHLADecayState, rs) for _ in range(3))
    _close(ahla_op_decay(ahla_op_decay(x, y), z),
           ahla_op_decay(x, ahla_op_decay(y, z)))


@given(st.integers(0, 2**31 - 1))
@settings(**SETTINGS)
def test_erratum_paper_ahla_decay_op_not_associative(seed):
    rs = np.random.RandomState(seed)
    x, y, z = (_rand(AHLADecayState, rs) for _ in range(3))
    _differs(ahla_op_decay_paper(ahla_op_decay_paper(x, y), z),
             ahla_op_decay_paper(x, ahla_op_decay_paper(y, z)))


@given(st.integers(0, 2**31 - 1))
@settings(**SETTINGS)
def test_hla3_op_associative(seed):
    """(x)3 (Theorem 7.2) is associative, with materialized segment maps."""
    rs = np.random.RandomState(seed)
    x, y, z = (_rand(HLA3ScanState, rs) for _ in range(3))
    _close(hla3_op(hla3_op(x, y), z), hla3_op(x, hla3_op(y, z)), tol=1e-8)


@given(st.integers(0, 2**31 - 1), st.integers(2, 12))
@settings(**SETTINGS)
def test_scan_prefix_equals_serial_fold(seed, n):
    """The port's associative scan: every inclusive prefix equals the left
    fold (Theorem 4.1 / Remark 4.2)."""
    elems = _rand(HLA2DecayState, np.random.RandomState(seed), lead=(n,))
    inc = associative_scan(masked_op_decay, elems)
    acc = HLA2DecayState(*(f[0] for f in elems))
    _close(HLA2DecayState(*(f[0] for f in inc)), acc)
    for t in range(1, n):
        acc = masked_op_decay(acc, HLA2DecayState(*(f[t] for f in elems)))
        _close(HLA2DecayState(*(f[t] for f in inc)), acc, tol=1e-8)


OPS = {
    "masked_op": (masked_op, HLA2State),
    "masked_op_decay": (masked_op_decay, HLA2DecayState),
    "masked_op_decay_paper": (masked_op_decay_paper, HLA2DecayState),
    "ahla_op": (ahla_op, AHLAState),
    "ahla_op_decay": (ahla_op_decay, AHLADecayState),
    "ahla_op_decay_paper": (ahla_op_decay_paper, AHLADecayState),
    "hla3_op": (hla3_op, HLA3ScanState),
}


@pytest.mark.parametrize("name", sorted(OPS))
@given(seed=st.integers(0, 2**31 - 1))
@settings(max_examples=5, deadline=None)
def test_operator_matches_reference(name, seed):
    """Each port operator equals the reference's on the same states (a
    leading batch of 2, as the scans apply them)."""
    op, kind = OPS[name]
    rs = np.random.RandomState(seed)
    a, b = _rand(kind, rs, lead=(2,)), _rand(kind, rs, lead=(2,))
    ref_kind = getattr(R, kind.__name__)
    want = getattr(R, name)(
        ref_kind(*(jnp.asarray(x.numpy()) for x in a)),
        ref_kind(*(jnp.asarray(x.numpy()) for x in b)))
    got = op(a, b)
    assert type(got)._fields == type(want)._fields
    _close(got, want)
