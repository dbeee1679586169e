"""Checkpointing: atomic, async, checksummed, rotated.

Twin of ``repro/checkpoint/manager.py``, in the reference's
on-disk format, so a checkpoint written by either package restores in the
other: a directory ``step_<8 digits>`` per step holding one ``.npy`` per
tree leaf and a ``manifest.json`` (step, leaf paths, shapes, dtypes, the
crc32 of each leaf's raw bytes, user metadata).  A save writes
``<dir>.tmp`` and publishes it with one atomic ``os.rename``, so a crash
mid-save never damages the latest checkpoint.

Leaf names are the reference's ``_flatten`` paths: a ``(params,
opt_state)`` tuple gives ``0/<param path>``, ``1/step``, ``1/mu/...`` and
``1/nu/...``.  Leaves are torch tensors (any device), numpy arrays, Python
ints or None.  A Python int is saved as a 0-d int32 array, the layout of
the reference's ``OptState.step``, and comes back as an int wherever the
template holds an int; a tensor comes back as a tensor on the template
leaf's device.  A bfloat16 leaf, whose dtype numpy lacks, is written as
the reference writes it (its ``ml_dtypes`` array under ``np.save``): the
raw 2-byte values in a ``<V2`` ``.npy``, ``"dtype": "bfloat16"`` in the
manifest, the crc32 over those bytes; its bits travel through
``torch.int16``, so nothing is cast, and a restore views them back as
``torch.bfloat16`` bit for bit.  Another dtype numpy lacks raises
``CheckpointError`` naming the leaf.

Under a mesh the leaves are DTensors: a save gathers each into its full
logical array on every rank (the format stays the reference's) and rank
0 of the process group writes it.  ``restore_checkpoint(...,
shardings=, mesh=)`` re-places the restored leaves on the current mesh,
whatever mesh wrote them: the elastic restore.

Failure domains, as in the reference:

* restore verifies every leaf's crc32 (a manifest without them, written
  before checksums, still loads) and raises ``CheckpointError`` naming a
  damaged leaf;
* an exception in the async save thread is captured and re-raised as
  ``CheckpointError`` from the next ``wait()`` or ``save()``;
* ``CheckpointManager(faults=...)`` consumes the ``ckpt.save`` and
  ``ckpt.corrupt`` points of ``runtime.faults``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from ..obs import Obs


class CheckpointError(RuntimeError):
    """A checkpoint operation failed: an async save raised (surfaced on
    the next ``wait()``/``save()``), a leaf's dtype has no file form, or
    a restore hit a checksum mismatch."""


#: a bfloat16 leaf on the host: its raw 2-byte values (the ``.npy`` form
#: of the reference's ``ml_dtypes.bfloat16`` arrays)
BF16_BITS = np.dtype("V2")


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, f"{prefix}{k}/")
                for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten_into(getattr(template, k), flat, f"{prefix}{k}/")
            for k in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, f"{prefix}{i}/")
            for i, v in enumerate(template))
    return _like(template, flat[prefix.rstrip("/")])


def _like(template, arr):
    """The restored array ``arr`` in the template leaf's kind."""
    if arr is None:
        return None
    if isinstance(template, torch.Tensor):
        if arr.dtype == BF16_BITS:
            return torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).to(template.device)
        return torch.from_numpy(arr).to(template.device)
    if isinstance(template, int) and not isinstance(template, bool):
        return int(arr)
    return arr


def _to_host(name: str, leaf):
    """A leaf as a numpy array that no later step can change."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):  # the full logical array, on every rank
            leaf = leaf.full_tensor()
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(BF16_BITS)
        try:
            return host.numpy()
        except TypeError as e:  # other dtypes numpy lacks
            raise CheckpointError(
                f"leaf {name!r} has dtype {leaf.dtype}, which numpy cannot "
                "hold; checkpoints store floating (bf16 included) and "
                "integer leaves only"
            ) from e
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)  # the reference's OptState.step
    return np.array(leaf)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _writer() -> bool:
    """True on the one rank that writes a save (rank 0 of an initialised
    process group; the only process otherwise)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement

    return isinstance(x, tuple) and bool(x) and all(
        isinstance(p, Placement) for p in x)


def _place(tree, shardings, mesh):
    """``tree``'s tensor leaves distributed on ``mesh`` with the placements
    of ``shardings`` (a tree of the same structure; a None or non-tuple
    leaf keeps its value)."""
    from ..distributed.sharding import distribute_leaf

    if _is_placements(shardings):
        return distribute_leaf(tree, mesh, shardings)
    if isinstance(tree, dict):
        return {k: _place(tree[k], shardings[k], mesh) for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_place(getattr(tree, k), getattr(shardings, k),
                                   mesh) for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(t, s, mesh) for t, s in zip(tree,
                                                              shardings))
    return tree


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's raw bytes, read in place (no copy)."""
    return zlib.crc32(np.ascontiguousarray(arr))


def _host_tree(tree) -> dict:
    return {name: _to_host(name, leaf) for name, leaf in _flatten(tree).items()}


def _save_flat(directory: str, step: int, flat: dict,
               metadata: Optional[dict] = None) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "time": time.time(), "metadata": metadata or {},
                "leaves": {}}
    for i, (name, arr) in enumerate(flat.items()):
        if arr is None:
            manifest["leaves"][name] = {"file": None}
            continue
        fn = f"leaf_{i:05d}.npy"
        bf16 = arr.dtype == BF16_BITS
        if bf16:  # the header np.save gives an ml_dtypes bfloat16 array
            with open(os.path.join(tmp, fn), "wb") as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
                f.write(np.ascontiguousarray(arr).tobytes())
        else:
            np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][name] = {
            "file": fn, "shape": list(arr.shape),
            "dtype": "bfloat16" if bf16 else str(arr.dtype),
            "crc32": _crc32(arr),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # atomic publish
    return path


def save_checkpoint(directory: str, step: int, tree,
                    metadata: Optional[dict] = None) -> str:
    """Atomic save of a tree (dicts, NamedTuples, lists, tuples) of leaves.
    Returns the published directory."""
    return _save_flat(directory, step, _host_tree(tree), metadata)


def list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, template, step: Optional[int] = None,
                       shardings=None, mesh=None):
    """Restore the checkpoint of ``step`` (default: the latest) into
    ``template``'s structure.  Returns ``(tree, manifest)``.  With
    ``shardings`` (a placements tree matching ``template``, e.g.
    ``steps.make_shardings``' for params and moments) and ``mesh``, the
    tensor leaves come back as DTensors on ``mesh``: each rank keeps its
    own block of the full array (the elastic restore)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for name, info in manifest["leaves"].items():
        if info["file"] is None:
            flat[name] = None
            continue
        arr = np.load(os.path.join(path, info["file"]))
        want = info.get("crc32")  # absent on pre-checksum checkpoints
        if want is not None:
            got = _crc32(arr)
            if got != want:
                raise CheckpointError(
                    f"checksum mismatch for leaf {name!r} in {path} "
                    f"(manifest crc32={want}, file crc32={got}): "
                    "checkpoint is corrupt")
        flat[name] = arr
    tree = _unflatten_into(template, flat)
    if shardings is not None:
        tree = _place(tree, shardings, mesh)
    return tree, manifest


def _corrupt_leaf(path: str) -> None:
    """Flip trailing data bytes of the first leaf file under ``path`` (the
    ``ckpt.corrupt`` fault point): the ``.npy`` header survives, so only
    the checksum can find the damage."""
    leaves = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
    if not leaves:
        return
    fn = os.path.join(path, leaves[0])
    size = os.path.getsize(fn)
    n = min(8, max(size - 80, 1))
    with open(fn, "r+b") as f:
        f.seek(size - n)
        tail = f.read(n)
        f.seek(size - n)
        f.write(bytes(b ^ 0xFF for b in tail))


class CheckpointManager:
    """keep-N rotation + an optional async save thread.

    ``save`` copies every leaf to the host in the caller's thread (device
    tensors with ``.cpu()``), then writes in the background.  An exception
    in the save thread is re-raised as ``CheckpointError`` from the next
    ``wait()`` (and so from the next ``save()``, which waits first).
    """

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 faults=None, obs: Optional[Obs] = None):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.faults = faults  # runtime.faults.FaultPlan (ckpt.* points)
        self.obs = obs if obs is not None else Obs()
        if faults is not None and getattr(faults, "obs", None) is None:
            faults.obs = self.obs
        self._m_save_s = self.obs.histogram(
            "ckpt_save_seconds", "wall-clock per checkpoint save")
        self._m_restore_s = self.obs.histogram(
            "ckpt_restore_seconds", "wall-clock per checkpoint restore")
        self._m_saves = self.obs.counter(
            "ckpt_saves_total", "published checkpoints")
        self._m_save_fail = self.obs.counter(
            "ckpt_save_failures_total", "saves that raised")
        self._m_restores = self.obs.counter(
            "ckpt_restores_total", "successful restores")
        self._m_crc_fail = self.obs.counter(
            "ckpt_checksum_failures_total",
            "restores rejected on a leaf crc32 mismatch")
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[tuple] = None  # (step, exception)
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            step, exc = self._error
            self._error = None  # raise-and-clear: the manager stays usable
            raise CheckpointError(
                f"async checkpoint save for step {step} failed: {exc!r}"
            ) from exc

    def save(self, step: int, tree, metadata=None):
        self.wait()  # one in-flight save at a time; surfaces prior failure
        flat = _host_tree(tree)  # on a mesh: every rank gathers
        if not _writer():
            return

        def _work():
            try:
                with self.obs.span("ckpt.save", step=step):
                    t0 = time.perf_counter()
                    if self.faults is not None:
                        self.faults.raise_if("ckpt.save")
                    path = _save_flat(self.directory, step, flat, metadata)
                    self._rotate()
                    if self.faults is not None and \
                            self.faults.hit("ckpt.corrupt") is not None:
                        _corrupt_leaf(path)
            except Exception:
                self._m_save_fail.inc()
                raise
            self._m_saves.inc()
            self._m_save_s.observe(time.perf_counter() - t0)

        if self.async_save:

            def _work_async():
                try:
                    _work()
                except Exception as e:  # surfaced by the next wait()
                    self._error = (step, e)

            self._thread = threading.Thread(target=_work_async, daemon=False)
            self._thread.start()
        else:
            _work()

    def _rotate(self):
        steps = list_steps(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore(self, template, step=None, shardings=None, mesh=None):
        t0 = time.perf_counter()
        try:
            with self.obs.span("ckpt.restore", step=step):
                out = restore_checkpoint(self.directory, template, step=step,
                                         shardings=shardings, mesh=mesh)
        except CheckpointError as e:
            if "checksum mismatch" in str(e):
                self._m_crc_fail.inc()
            raise
        self._m_restores.inc()
        self._m_restore_s.observe(time.perf_counter() - t0)
        return out

    def latest_step(self):
        return latest_step(self.directory)
