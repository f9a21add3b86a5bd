"""Mesh construction over the ranks of a ``torch.distributed`` world.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model") — the
pod axis is the outer data-parallel axis (the gradient all-reduce crosses
pods).

Functions, not module constants: importing touches no process group.  The
caller initialises the world (``torch.distributed.init_process_group``)
first, with the address, world size and rank it chooses.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("init_process_group() first: a mesh spans the "
                           "ranks of the torch.distributed world")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world()
    if n != 16 * 16 * (2 if multi_pod else 1):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{16 * 16 * (2 if multi_pod else 1)} ranks; the "
                         f"world has {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(*, model: int = 1, device_type: str = "cuda"
                   ) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the world, data =
    world // model (tests, one-host runs; ``device_type="cpu"`` for gloo
    ranks on the CPU)."""
    n = _world()
    data = max(1, n // model)
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
