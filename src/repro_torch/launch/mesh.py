"""Production meshes: 16x16 single pod, 2x16x16 multi-pod, as
``torch.distributed`` ``DeviceMesh``\\ es over a fake process group.

Port of ``repro.launch.mesh``.  The reference lowers its steps against
meshes of 256 and 512 devices that it does not have (host devices forced
by ``XLA_FLAGS``); the port traces them in one process over a *fake*
process group of that many ranks (``torch.testing``'s ``FakeStore``: every
collective returns at once and moves nothing), as rank 0.  The mesh
functions are FUNCTIONS and start that group only when no process group
exists, so importing this module never touches ``torch.distributed``.
A mesh of n ranks is built over ranks ``0 .. n - 1`` of the group, so one
group of 512 serves both production meshes and the small test meshes.
"""

from __future__ import annotations

import math


def fake_world(ranks: int) -> None:
    """Start a fake process group of ``ranks`` ranks (this process is rank
    0) unless a process group exists; an existing one must have at least
    ``ranks`` ranks."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() < ranks:
            raise ValueError(f"the process group has {dist.get_world_size()} ranks, "
                             f"a mesh of {ranks} needs more")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    fake_world(math.prod(shape))
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """Small (data, model) mesh (a fake group unless one exists)."""
    return _mesh((data, model), ("data", "model"), device_type)


def chips(mesh) -> int:
    return math.prod(tuple(mesh.shape))
