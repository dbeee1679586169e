"""Port kernel wrappers (their plain versions, on CPU tensors) vs the
reference Pallas kernels run in interpret mode, on the same numpy inputs.

Tolerance: 1e-5 of max|reference| in fp32 — both sides sum in fp32, in
other orders and (for the chunk kernel) with other chunk widths.
Normalized cases use positive inputs so the denominators stay away from 0.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_step import hla2_step_pallas
from repro.kernels.hla2_chunk import hla2_chunk_pallas
from repro_torch.kernels import _build, ops
from repro_torch.kernels.decode_step import hla2_step
from repro_torch.kernels.hla2_chunk import W, hla2_chunk_bwd, hla2_chunk_fwd

jax_hla2 = importlib.import_module("repro.core.hla2")

TOL = 1e-5
BH, D, DV = 3, 8, 6


def _mk(rng, n, positive=False):
    def r(*s):
        x = rng.randn(*s) * 0.5
        return (np.abs(x) if positive else x).astype(np.float32)

    g = rng.uniform(0.85, 0.99, BH).astype(np.float32)
    return r(BH, n, D), r(BH, n, D), r(BH, n, DV), g


def _prior_state(rng, gamma, positive):
    """A carry from a previous 20-token prefill (reference chunkwise)."""
    q, k, v, _ = _mk(rng, 20, positive)
    _, st = jax_hla2.hla2_chunkwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if gamma is None else jnp.asarray(gamma), chunk=8)
    return tuple(np.asarray(x, np.float32) for x in st)


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), f"{name}: {err}"


@pytest.mark.parametrize("n", [1, W, W + 13])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize,lam", [(False, 0.0), (True, 0.0),
                                           (False, 0.3), (True, 0.3)])
@pytest.mark.parametrize("resume", [False, True])
def test_chunk_matches_pallas(rng, n, use_gamma, normalize, lam, resume):
    q, k, v, g = _mk(rng, n, positive=normalize)
    gamma = g if use_gamma else None
    init = _prior_state(rng, gamma, normalize) if resume else None
    o_ref, st_ref = hla2_chunk_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if gamma is None else jnp.asarray(gamma), chunk=W,
        normalize=normalize, lam=lam, interpret=True,
        initial_state=None if init is None else tuple(map(jnp.asarray, init)),
    )
    o, st = hla2_chunk_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if gamma is None else torch.from_numpy(gamma),
        initial_state=None if init is None else tuple(
            torch.from_numpy(x.copy()) for x in init),
        normalize=normalize, lam=lam,
    )
    _close(o, o_ref, "o")
    for got, want, name in zip(st, st_ref, "SCmGh"):
        _close(got, want, name)


@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize,lam", [(False, 0.0), (True, 0.3)])
def test_step_matches_pallas_in_place(rng, use_gamma, normalize, lam):
    g = rng.uniform(0.85, 0.99, BH).astype(np.float32)
    gamma = g if use_gamma else None
    st0 = _prior_state(rng, gamma, normalize)
    q, k, v, _ = _mk(rng, 1, positive=normalize)
    st_ref, o_ref = hla2_step_pallas(
        tuple(map(jnp.asarray, st0)), jnp.asarray(q[:, 0]),
        jnp.asarray(k[:, 0]), jnp.asarray(v[:, 0]),
        None if gamma is None else jnp.asarray(gamma),
        normalize=normalize, lam=lam, interpret=True,
    )
    state = tuple(torch.from_numpy(x.copy()) for x in st0)
    o = hla2_step(state, torch.from_numpy(q[:, 0]), torch.from_numpy(k[:, 0]),
                  torch.from_numpy(v[:, 0]),
                  None if gamma is None else torch.from_numpy(gamma),
                  normalize=normalize, lam=lam)
    _close(o, o_ref, "o")
    for got, want, name in zip(state, st_ref, "SCmGh"):  # mutated in place
        _close(got, want, name)


@pytest.mark.parametrize("n", [5, W - 1, W, 2 * W + 3])
@pytest.mark.parametrize("use_gamma", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_prefill_then_step_equals_longer_prefill(rng, n, use_gamma,
                                                 normalize):
    """The carry identity inside the port: prefill(n) + step == prefill(n+1)
    on the last output and on the state."""
    q, k, v, g = (torch.from_numpy(x) for x in
                  _mk(rng, n + 1, positive=normalize))
    gamma = g if use_gamma else None
    o_full, st_full = ops.hla2_prefill(
        q[None], k[None], v[None], gamma, normalize=normalize)
    _, st = ops.hla2_prefill(q[None, :, :n], k[None, :, :n], v[None, :, :n],
                             gamma, normalize=normalize)
    st, o_t = ops.hla2_decode_step(st, q[None, :, n], k[None, :, n],
                                   v[None, :, n], gamma, normalize=normalize)
    _close(o_t, o_full[:, :, n], "o")
    for got, want, name in zip(st, st_full, "SCmGh"):
        _close(got, want, name)


def test_launch_counters_stay_zero_on_cpu(rng):
    ops.LAUNCHES.clear()
    q, k, v, g = (torch.from_numpy(x) for x in _mk(rng, 9))
    _, st = hla2_chunk_fwd(q, k, v, g)
    hla2_step(st, q[:, 0], k[:, 0], v[:, 0], g)
    assert sum(ops.LAUNCHES.values()) == 0


def test_wrappers_reject_bad_inputs(rng):
    q, k, v, g = (torch.from_numpy(x) for x in _mk(rng, 9))
    with pytest.raises(TypeError):
        hla2_chunk_fwd(q.double(), k.double(), v.double(), g)
    with pytest.raises(ValueError):
        hla2_chunk_fwd(q, k, v[:, :4], g)
    with pytest.raises(ValueError):
        hla2_chunk_fwd(q, k, v, g.double())
    _, st = hla2_chunk_fwd(q, k, v, g)
    with pytest.raises(ValueError):
        hla2_step(st[:4], q[:, 0], k[:, 0], v[:, 0], g)
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        hla2_chunk_fwd(*(x.to("meta") for x in (q, k, v, g)))


def test_refuse_grad_where_autograd_would_record():
    x = torch.zeros(3)
    w = torch.zeros(3, requires_grad=True)
    _build.refuse_grad("k", [x])  # nothing needs a gradient
    with torch.no_grad():
        _build.refuse_grad("k", [x, w])
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("k", [x, w])


@pytest.mark.parametrize("wrapper", [hla2_chunk_fwd, hla2_chunk_bwd,
                                     hla2_step])
def test_cuda_branch_refuses_grad_before_launch(wrapper):
    # a CUDA tensor cannot be made here, so read the CUDA branch: the guard
    # runs on every tensor the kernel reads, before the library is loaded
    src = inspect.getsource(wrapper)
    cuda = src[src.index('if q.device.type != "cuda"'):]
    assert 0 < cuda.index(f'_build.refuse_grad("{wrapper.__name__}", '
                          "tensors)") < cuda.index("_build.load(")


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    # a kernel source includes csrc/*.cuh: an edit to a header must give a
    # new build directory, or the old library would be loaded again
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = _build._lib_path("k")
    assert first.name == "libk.so" and first.parent.parent == _build.BUILD_ROOT
    assert _build._lib_path("k") == first  # the key is stable
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build._lib_path("k") not in (first, second)
    (tmp_path / "other.cuh").unlink()
    assert _build._lib_path("k") == second
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._lib_path("k") != second
