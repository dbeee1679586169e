"""Device-mesh construction (twin of ``repro/launch/mesh.py``).  Functions
only: importing this module starts no process group and touches no
device.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group the caller initialised (``torchrun``: NCCL on the
cards, gloo on the CPU; the dry run: the ``fake`` backend), with the
reference's axis names.  The reference's ``TPU_XLA_FLAGS`` (collective
and compute overlap flags for XLA on TPUs) have no twin: they are TPU
compiler flags, and nothing here compiles a program.
"""

from __future__ import annotations

import os


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The reference's target deployment mesh: 16 x 16 ranks per pod as
    ``("data", "model")``, or 2 x 16 x 16 as ``("pod", "data", "model")``
    with ``multi_pod``.  Needs a process group of 256 (512) ranks: real
    cards, or the dry run's fake process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape=None, axes=None, device_type="cuda"):
    """A mesh over every rank of the initialised process group.  Default:
    ``("data", "model")`` with the model axis as large as possible up to 4
    (the reference's, recomputed from whatever ranks exist at launch).
    The mesh is on the cards unless ``device_type="cpu"`` asks for the
    CPU (gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if shape is None:
        n = dist.get_world_size()
        model = next(c for c in (4, 2, 1) if n % c == 0)
        shape, axes = (n // model, model), ("data", "model")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_summary(mesh) -> str:
    from ..distributed.sharding import mesh_axes

    return f"mesh{mesh_axes(mesh)}"


def mesh_from_env(device):
    """``(mesh, device)`` of a run started by ``torchrun`` (``WORLD_SIZE``
    and ``RANK`` in the environment): a process group over its ranks (NCCL
    for a card, each rank on ``cuda:LOCAL_RANK``; gloo on the CPU) and the
    default ``make_mesh`` over them.  Without ``WORLD_SIZE``: ``(None,
    device)``, one device as before."""
    import torch
    import torch.distributed as dist

    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return None, device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo")
    return make_mesh(device_type=device.type), device
