"""Third order in the port (``repro_torch/core/hla3.py``) against the
reference, twin of ``tests/test_hla3.py``: Algorithm 3/4 self-consistency,
the paper chunk path's carry, the exact operator's views and its decode
step, the stated ``((W W^T) . L)(W V)`` target, and the Theorem 7.1
erratum (``docs/DESIGN.md`` section 7.3).

Tolerance: fp64 on both sides, 1e-9 relative to max|want|.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from conftest import make_qkv
from repro_torch.core import hla3 as P
from repro_torch.models.state_tree import leaves

R = importlib.import_module("repro.core.hla3")

REL = 1e-9


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


def _wwtw_oracle(q, k, v):
    """The paper's *stated* target: ((W W^T) . L)(W V), W = L . (Q K^T)."""
    n = q.shape[-2]
    L = np.tril(np.ones((n, n)))
    W = np.einsum("...td,...jd->...tj", q, k) * L
    WWT = np.einsum("...ti,...ji->...tj", W, W) * L
    return WWT @ (W @ v)


@pytest.mark.parametrize("normalize", [False, True])
def test_paper_alg3_internal_consistency(rng, normalize):
    """Alg 3 == Alg 4 (scan, materialized maps) == chunkwise == the region
    oracle, and each equals the reference's region oracle."""
    q, k, v, _ = make_qkv(rng, n=20, d=5, dv=4)
    want = R.hla3_paper_naive(q, k, v, normalize=normalize)
    tq, tk, tv = (_t(x) for x in (q, k, v))
    kw = dict(form="paper", normalize=normalize)
    outs = [P.hla3(tq, tk, tv, impl=impl, chunk=5, **kw)[0]
            for impl in ("naive", "serial", "scan", "chunkwise")]
    outs.append(P.hla3(tq, tk, tv, impl="chunkwise", chunk=6, **kw)[0])
    for o in outs:
        _close(o, want)


def test_paper_chunk_carry(rng):
    q, k, v, _ = make_qkv(rng, n=20, d=5, dv=4)
    want, want_st = R.hla3_paper_chunkwise(q, k, v, chunk=5)
    tq, tk, tv = (_t(x) for x in (q, k, v))
    o_a, st = P.hla3_paper_chunkwise(tq[..., :8, :], tk[..., :8, :],
                                     tv[..., :8, :], chunk=4)
    o_b, st_b = P.hla3_paper_chunkwise(tq[..., 8:, :], tk[..., 8:, :],
                                       tv[..., 8:, :], chunk=6, state=st)
    _close(torch.cat([o_a, o_b], -2), want)
    assert st_b._fields == want_st._fields
    for a, b in zip(st_b, want_st):
        _close(a, b)
    # the decode step is an n = 1 chunk in the same state space
    st = P.hla3_chunk_init_state(q.shape[:-2], 5, 4, torch.float64)
    for t in range(20):
        st, o_t = P.hla3_paper_chunk_step(st, tq[..., t, :], tk[..., t, :],
                                          tv[..., t, :])
        _close(o_t, want[..., t, :])
    for a, b in zip(st, want_st):
        _close(a, b)


def test_paper_serial_state_matches_reference(rng):
    """Algorithm 3's own 10-field state, decay as printed."""
    q, k, v, gam = make_qkv(rng, n=12, d=5, dv=4)
    want, want_st = R.hla3_paper_serial(q, k, v, gam, normalize=True)
    got, st = P.hla3_paper_serial(*(_t(x) for x in (q, k, v, gam)),
                                  normalize=True)
    _close(got, want)
    assert st._fields == want_st._fields
    for a, b in zip(st, want_st):
        _close(a, b)


@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_exact_views_agree(rng, use_gamma, normalize):
    """naive, serial and chunkwise (ragged chunks) against the reference's
    naive output; the nested states leaf for leaf against its serial."""
    q, k, v, gam = make_qkv(rng, n=20, d=5, dv=4)
    g = gam if use_gamma else None
    want = R.hla3_exact_naive(q, k, v, g, normalize=normalize)
    _, want_st = R.hla3_exact_serial(q, k, v, g, normalize=normalize)
    args = [_t(x) for x in (q, k, v)] + [None if g is None else _t(g)]
    for impl, chunk in (("naive", 5), ("serial", 5), ("chunkwise", 5),
                        ("chunkwise", 7)):
        o, st = P.hla3(*args, impl=impl, chunk=chunk, normalize=normalize)
        _close(o, want)
        if st is not None:
            assert isinstance(st, P.HLA3ExactState)
            ref_leaves = jax.tree.leaves(want_st)
            assert len(leaves(st)) == len(ref_leaves) == 7
            for a, b in zip(leaves(st), ref_leaves):
                _close(a, b)


def test_exact_matches_wwtw_target(rng):
    """hla3_exact computes the paper's *stated* Theorem 7.1 target."""
    q, k, v, _ = (np.asarray(x) for x in make_qkv(rng, B=1, H=1, n=14, d=4,
                                                  dv=3))
    o, _ = P.hla3_exact_serial(_t(q), _t(k), _t(v))
    _close(o, _wwtw_oracle(q, k, v))


def test_erratum_paper_operator_differs_from_stated_target(rng):
    """Erratum: Alg 3's output != ((W W^T) . L)(W V).  If a fix ever makes
    them equal, this test must be revisited."""
    q, k, v, _ = (np.asarray(x) for x in make_qkv(rng, B=1, H=1, n=14, d=4,
                                                  dv=3))
    o, _ = P.hla3_paper_serial(_t(q), _t(k), _t(v), None)
    assert float(np.abs(o.numpy() - _wwtw_oracle(q, k, v)).max()) > 1e-3


def test_exact_decode_step(rng):
    q, k, v, gam = make_qkv(rng, n=10, d=5, dv=4)
    want, want_st = R.hla3_exact_serial(q, k, v, gam, normalize=True)
    tq, tk, tv, tg = (_t(x) for x in (q, k, v, gam))
    st = P.hla3_exact_init_state(q.shape[:-2], 5, 4, torch.float64)
    for t in range(10):
        new, o_t = P.hla3_exact_step(st, tq[..., t, :], tk[..., t, :],
                                     tv[..., t, :], tg, normalize=True)
        assert not any(a is b for a, b in zip(leaves(new), leaves(st)))
        st = new
        _close(o_t, want[..., t, :])
    for a, b in zip(leaves(st), jax.tree.leaves(want_st)):
        _close(a, b)


def test_front_end_rejects_what_the_reference_rejects(rng):
    tq, tk, tv, tg = (_t(x) for x in make_qkv(rng, n=6, d=3, dv=2))
    with pytest.raises(NotImplementedError, match="gamma = 1"):
        P.hla3(tq, tk, tv, tg, form="paper")
    with pytest.raises(ValueError):
        P.hla3(tq, tk, tv, impl="scan")  # the exact form has no scan
    with pytest.raises(ValueError):
        P.hla3(tq, tk, tv, form="bogus")


def test_state_tree_walks_the_nested_state():
    """``models/state_tree.py`` over ``HLA3ExactState``: the leaves in the
    reference's tree order, a rebuild of the same nested NamedTuples, and a
    structure mismatch refused."""
    from repro_torch.models.state_tree import flatten, tree_map

    st = P.hla3_exact_init_state((2,), 3, 2, torch.float64)
    flat, rebuild = flatten(st)
    ref = jax.tree.leaves(R.hla3_exact_init_state((2,), 3, 2))
    assert [tuple(x.shape) for x in flat] == [tuple(x.shape) for x in ref]
    twice = tree_map(lambda a, b: a + b + 1, st, st)
    assert isinstance(twice.outer, P.HLA2State) and \
        twice.inner._fields == ("P", "m")
    assert all(bool((x == 1).all()) for x in leaves(twice))
    assert rebuild(flat) == st
    mixed = tree_map(lambda x: x, {"b": torch.ones(1), "a": (torch.zeros(2),)})
    assert list(mixed) == ["a", "b"] and isinstance(mixed["a"], tuple)
    with pytest.raises(ValueError, match="structure"):
        tree_map(lambda a, b: a, st, st.inner)
    with pytest.raises(TypeError, match="leaf"):
        flatten((torch.ones(1), "not a tensor"))
