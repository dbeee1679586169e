"""How the stacked layer leaves' gradients are put together
(``models/param.py::unstack``), on the CPU at reduced sizes:

* the work does not grow with the number of layers: during one
  ``accumulate_grads`` under ``remat="full"``, the ops that write a tensor
  of a stacked leaf's whole shape number at most 2 a leaf (one ``stack``
  of the layers' gradients; a view writes nothing), at 4 and 8 layers of
  hla-1b and 2 and 4 of granite-moe-3b-a800m (MoE expert stacks).
  Indexing each layer (``select``) zero-fills the whole stack once a layer
  and adds it, L + (L - 1) such ops a leaf.  A whole shape that is also a
  layer's shape (granite's ``(4, 64, 64)`` at 4 layers of 4 experts) is
  left out, since a layer's own work writes it too;
* the gradients are bit for bit those of the per-layer ``select`` path,
  kept here as the oracle: hla-1b under ``remat`` ``"full"``, ``"dots"``
  and ``"none"`` and with 2 microbatches, granite-moe and whisper-small.
  The oracle adds zeros to disjoint slices, so the sums are exact;
* ``unstack`` takes each leaf apart once, with grad (training) and
  without (serving) alike.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.distributed import steps
from repro_torch.models import lm, whisper
from repro_torch.models.param import init_params, leaf_paths, unstack

STACKS = ("layers", "groups", "enc_layers", "dec_layers")


def _select_layers(tree):
    """The oracle: layer ``l``'s tree by indexing every leaf (``tree[l]``),
    as the stack was read before ``unstack``."""
    def one(t, l):
        if isinstance(t, dict):
            return {k: one(v, l) for k, v in t.items()}
        return t[l]
    n = next(leaf_paths(tree))[1].shape[0]
    return [one(tree, l) for l in range(n)]


def _setup(arch, n_layers=None, **kw):
    mixer = None if arch == "hla-1b" else "hla2"
    cfg = get_config(arch, reduced=True, mixer=mixer).replace(**kw)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    params = init_params(steps.model_specs(cfg), 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    B, n = 6, 20
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, n), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (B, n), generator=gen)}
    batch["labels"][0, :5] = -1
    if cfg.enc_layers:
        batch["frames"] = 0.1 * torch.randn(B, cfg.enc_frames, cfg.d_model,
                                            generator=gen)
    return cfg, params, batch


class _FullShapeOps(TorchDispatchMode):
    """Counts the ops other than views whose output has one of
    ``shapes``."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.n = shapes, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.n += sum(isinstance(o, torch.Tensor) and
                      tuple(o.shape) in self.shapes for o in outs)
        return out


@pytest.mark.parametrize("arch,n_layers", [
    ("hla-1b", 4), ("hla-1b", 8),
    ("granite-moe-3b-a800m", 2), ("granite-moe-3b-a800m", 4)])
def test_stack_sized_ops_do_not_grow_with_layers(arch, n_layers):
    cfg, params, batch = _setup(arch, n_layers, remat="full")
    stacked = [x for path, x in leaf_paths(params) if path[0] in STACKS]
    assert all(x.shape[0] == n_layers for x in stacked)
    whole = {tuple(x.shape) for x in stacked} - {
        tuple(x.shape[1:]) for x in stacked}
    counted = [x for x in stacked if tuple(x.shape) in whole]
    assert any(x.dim() == 4 for x in counted) or arch == "hla-1b"
    with _FullShapeOps(whole) as mode:
        steps.accumulate_grads(params, batch, cfg)
    assert 0 < mode.n <= 2 * len(counted), (mode.n, len(counted))


@pytest.mark.parametrize("arch,remat,microbatches", [
    ("hla-1b", "full", 1), ("hla-1b", "dots", 1), ("hla-1b", "none", 1),
    ("hla-1b", "full", 2), ("granite-moe-3b-a800m", "full", 1),
    ("whisper-small", "full", 1)])
def test_grads_equal_the_per_layer_select_path(arch, remat, microbatches,
                                               monkeypatch):
    cfg, params, batch = _setup(arch, remat=remat)
    got = steps.accumulate_grads(params, batch, cfg, microbatches)
    for mod in (lm, whisper):
        monkeypatch.setattr(mod, "unstack", _select_layers)
    want = steps.accumulate_grads(params, batch, cfg, microbatches)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    want = dict(leaf_paths(want[3]))
    for path, g in leaf_paths(got[3]):
        assert torch.equal(g, want[path]), "/".join(path)


class _Ops(TorchDispatchMode):
    """Records the name of every op."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("grad", [True, False])
def test_unstack_splits_each_leaf_once_where_autograd_records(grad):
    tree = {"a": torch.randn(3, 4, requires_grad=True),
            "b": {"c": torch.randn(3, 2, 5, requires_grad=True)}}
    with torch.set_grad_enabled(grad), _Ops() as mode:
        layers = unstack(tree)
    assert mode.names == ["unbind"] * 2
    assert len(layers) == 3
    for l, p in enumerate(layers):
        for got, leaf in ((p["a"], tree["a"]), (p["b"]["c"], tree["b"]["c"])):
            assert got._base is leaf
            assert torch.equal(got, leaf[l])
