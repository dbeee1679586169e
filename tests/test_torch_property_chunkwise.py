"""Hypothesis sweep, twin of ``tests/test_property_chunkwise.py``: the
port's chunkwise forms (and its scans) equal its serial recurrence, outputs
and states, for random shapes, chunk widths, ragged tails and per-head
decay; and the port's serial recurrences equal the reference's on seeded
draws of the same space (one JAX compile per shape, so a few draws, not
the whole sweep).

Tolerance: fp64, atol 1e-8 and rtol 1e-7 (the reference test's).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis (CI installs it)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core.ahla import (  # noqa: E402
    ahla_chunkwise,
    ahla_scan,
    ahla_serial,
)
from repro_torch.core.hla2 import (  # noqa: E402
    hla2_chunkwise,
    hla2_scan,
    hla2_serial,
)
from repro_torch.core.hla3 import (  # noqa: E402
    hla3_exact_chunkwise,
    hla3_exact_serial,
)
from repro_torch.models.state_tree import leaves  # noqa: E402

R2, RA, R3 = (importlib.import_module(f"repro.core.{m}")
              for m in ("hla2", "ahla", "hla3"))

SETTINGS = dict(max_examples=12, deadline=None)
TOL = dict(atol=1e-8, rtol=1e-7)


def _mk(seed, n, d, dv, decay):
    rs = np.random.RandomState(seed)
    q = rs.randn(1, 2, n, d) * 0.5
    k = rs.randn(1, 2, n, d) * 0.5
    v = rs.randn(1, 2, n, dv) * 0.5
    g = rs.uniform(0.7, 0.999, (1, 2)) if decay else None
    port = [torch.from_numpy(x) for x in (q, k, v)] + [
        None if g is None else torch.from_numpy(g)]
    return (q, k, v, g), port


def _same(got, want):
    """``(o, state)`` pairs, the second the port's or the reference's."""
    o, st = got
    o_w, st_w = want
    np.testing.assert_allclose(o.numpy(), np.asarray(o_w), **TOL)
    ref = jax.tree.leaves(st_w) if not isinstance(o_w, torch.Tensor) \
        else leaves(st_w)
    assert len(leaves(st)) == len(ref)
    for a, b in zip(leaves(st), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@given(
    st.integers(0, 2**31 - 1),
    st.integers(1, 33),  # n
    st.sampled_from([1, 2, 3, 5, 8, 16]),  # chunk
    st.sampled_from([2, 5, 8]),  # d
    st.sampled_from([1, 3, 8]),  # dv
    st.booleans(),  # decay
    st.booleans(),  # normalize
)
@settings(**SETTINGS)
def test_hla2_chunkwise_and_scan_equal_serial(seed, n, chunk, d, dv, decay,
                                              norm):
    _, port = _mk(seed, n, d, dv, decay)
    want = hla2_serial(*port, normalize=norm)
    _same(hla2_chunkwise(*port, chunk=chunk, normalize=norm), want)
    _same(hla2_scan(*port, normalize=norm), want)


@given(
    st.integers(0, 2**31 - 1),
    st.integers(1, 25),
    st.sampled_from([1, 3, 8]),
    st.booleans(),
)
@settings(**SETTINGS)
def test_ahla_chunkwise_and_scan_equal_serial(seed, n, chunk, decay):
    _, port = _mk(seed, n, 5, 4, decay)
    want = ahla_serial(*port)
    _same(ahla_chunkwise(*port, chunk=chunk), want)
    _same(ahla_scan(*port), want)


@given(
    st.integers(0, 2**31 - 1),
    st.integers(1, 20),
    st.sampled_from([1, 4, 7]),
    st.booleans(),
)
@settings(**SETTINGS)
def test_hla3_exact_chunkwise_equals_serial(seed, n, chunk, decay):
    _, port = _mk(seed, n, 4, 3, decay)
    _same(hla3_exact_chunkwise(*port, chunk=chunk), hla3_exact_serial(*port))


@pytest.mark.parametrize("seed,n,d,dv,decay,norm", [
    (0, 1, 2, 1, False, False), (1, 17, 5, 3, True, True),
    (2, 33, 8, 8, True, False)])
def test_serial_recurrences_equal_reference(seed, n, d, dv, decay, norm):
    ref, port = _mk(seed, n, d, dv, decay)
    _same(hla2_serial(*port, normalize=norm),
          R2.hla2_serial(*ref, normalize=norm))
    _same(ahla_serial(*port, normalize=norm),
          RA.ahla_serial(*ref, normalize=norm))
    _same(hla3_exact_serial(*port, normalize=norm),
          R3.hla3_exact_serial(*ref, normalize=norm))
