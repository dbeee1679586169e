"""Build and load the hand-written CUDA kernels in ``src/repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into
``build/repro_torch/<hash>/lib<name>.so`` at the root of the checkout (the
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edited kernel or header rebuilds), then
loaded with ``ctypes``.  Nothing here runs at import: the CPU tests import
every module on a machine with no ``nvcc``.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one right
after its kernel launched, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_libs: dict = {}
# one lock per kernel: two kernels may build at once from two threads
_locks: collections.defaultdict = collections.defaultdict(threading.Lock)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, every shared
    header ``csrc/*.cuh`` (any of them may be included) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _compile(name: str, lib: Path) -> None:
    """Run ``nvcc`` for ``csrc/<name>.cu`` into ``lib``, keeping its output
    (the ptxas register/shared-memory report) beside it."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    out = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (lib.parent / f"{name}.log").write_text(out.stdout)
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) for ``name``."""
    log = _lib_path(name).parent / f"{name}.log"
    return log.read_text() if log.exists() else ""


def load(name: str, signature) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built if needed), with
    ``signature`` = ``(argtypes, restype)`` set on its function ``name``."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                _compile(name, path)
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = signature
            _libs[name] = lib
        return lib


def refuse_grad(name: str, tensors) -> None:
    """Raise where autograd would record a raw kernel call: the kernels
    write through raw pointers, so their outputs would carry no graph and
    the leaves behind them would silently get no gradient.  The message
    names the differentiable entry point of the kernel's operator.  A
    DTensor is refused too: its pointer is not its data."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(x, DTensor) for x in tensors):
        raise TypeError(
            f"{name}: a DTensor holds no one pointer to launch on; call the "
            "kernel through distributed.shard_ops.call_sharded, which hands "
            "it each rank's local block")
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        op = "ahla_attention" if name.startswith("ahla") else "hla2_attention"
        raise RuntimeError(
            f"{name}: the raw CUDA kernel records no backward; differentiate "
            f"through repro_torch.kernels.ops.{op}, or call it under "
            "torch.no_grad() or on tensors that do not require grad")


def check(err: int, name: str) -> None:
    """Raise on a nonzero CUDA error returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
