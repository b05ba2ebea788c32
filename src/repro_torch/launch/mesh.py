"""Production mesh construction (the port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process-group or device state.

A JAX mesh is a grid of devices driven by one controller.  In PyTorch a
:class:`~torch.distributed.device_mesh.DeviceMesh` is a grid of *ranks*
of a process group that must already be running, one process per rank.
The production meshes need 256 or 512 ranks, so the dry run builds them
over a fake process group (:func:`start_fake_group`): every collective
is a no-op, and each process traces rank 0's program on fake tensors.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["production_shape", "make_production_mesh", "make_mesh",
           "data_axes", "mesh_sizes", "start_fake_group", "stop_group"]


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)`` of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group
    that is already initialised; raises if its world size differs."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError(
            f"no process group: a {shape} mesh needs one of world size "
            f"{math.prod(shape)} (start_fake_group for a dry run)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise RuntimeError(
            f"a {shape} mesh needs world size {math.prod(shape)}, the "
            f"process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with
    ``"pod"``, over the running process group."""
    return make_mesh(*production_shape(multi_pod), device_type=device_type)


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, a JAX mesh, or any
    stand-in with ``.shape`` (a mapping) and ``.axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    shape = mesh.shape
    return {a: shape[a] for a in mesh.axis_names}


def data_axes(mesh) -> tuple:
    """The data-parallel axes of a production mesh."""
    return tuple(a for a in mesh_sizes(mesh) if a in ("pod", "data"))


def start_fake_group(world_size: int, rank: int = 0) -> None:
    """Initialise a fake process group of ``world_size`` ranks in this
    process, as rank ``rank``: collectives return without moving data,
    so one process can trace one rank's program on a production mesh.
    Raises if a process group is already running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def stop_group(group: Optional[object] = None) -> None:
    """Destroy the default process group, if one is running."""
    if dist.is_initialized():
        dist.destroy_process_group(group)
