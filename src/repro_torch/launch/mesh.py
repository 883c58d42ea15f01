"""Meshes (PyTorch twin of ``src/repro/launch/mesh.py``).

NOTE: functions, not module-level constants: importing this module must
never touch a process group.  A ``DeviceMesh`` stands on the default
process group, so each function sets one up first:

* ``make_production_mesh`` / ``make_debug_mesh``: the dry run's meshes,
  on torch's fake process-group backend (one process plays rank 0 of the
  whole world; collectives return without communicating), which exists
  nowhere but in the dry run and its tests;
* ``make_local_mesh``: a one-rank mesh of a real device, on a one-rank
  ``gloo`` (CPU) or ``nccl`` (CUDA) group, where a placement runs for
  real.

A process holds one default group at a time: ``release()`` ends it, and
each function refuses to replace a group of another kind.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _fake_store():
    # the one place that names the private module behind the fake backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


def _world(backend: str, world_size: int, store_fn) -> None:
    """Make the default process group ``backend`` over ``world_size``
    ranks, this process rank 0, unless it is that already."""
    if dist.is_initialized():
        if dist.get_backend() == backend \
                and dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake" or backend != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group of "
                f"{dist.get_world_size()} ranks is initialized; release() "
                f"it before asking for {backend!r} over {world_size}")
        dist.destroy_process_group()
    dist.init_process_group(backend, store=store_fn(), rank=0,
                            world_size=world_size)


def release() -> None:
    """End the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 devices per pod; 2 pods for multi-pod (fake)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _fake_mesh(shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """Small ("data", "model") mesh for CPU tests (fake)."""
    return _fake_mesh((data, model), ("data", "model"))


def _fake_mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` on the fake backend."""
    n = 1
    for s in shape:
        n *= s
    _world("fake", n, _fake_store)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_local_mesh(device: Union[str, torch.device],
                    axes: Sequence[str] = ("model",)) -> DeviceMesh:
    """A one-device mesh of ``device`` named ``axes`` (each of size 1), on
    a one-rank ``nccl`` group for a CUDA device, ``gloo`` for the CPU."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    _world(backend, 1, dist.HashStore)
    return init_device_mesh(dev.type, (1,) * len(axes),
                            mesh_dim_names=tuple(axes))
