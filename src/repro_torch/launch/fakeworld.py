"""A fake ``torch.distributed`` world of the production mesh's size, in one
process: the counterpart of the reference dry-run's 512 forced host
devices.

:func:`fake_world` starts the ``fake`` backend (collectives complete at
once and move no data) at 256 ranks (one pod, ``(16, 16)``) or 512 (two
pods, ``(2, 16, 16)``), yields :func:`~repro_torch.launch.mesh.
make_production_mesh`'s mesh with this process as rank 0, and destroys the
process group on exit, whatever happened inside: no default group outlives
the block.  DTensor programs run on it as rank 0 of the production mesh
would run them, on rank 0's local shards: shape-only tensors on the
``meta`` device, or real tensors on the card, whose collective outputs
are then uninitialised.  The mesh's device type is ``"cuda"`` on any host
(the fake backend needs no card): DTensor picks some collectives by it (a
``"cpu"`` mesh turns an all-to-all into an all-gather), and the trace is
of the program a card runs.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch.distributed as dist

from .mesh import make_production_mesh


def production_world_size(multi_pod: bool) -> int:
    return 16 * 16 * (2 if multi_pod else 1)


@contextmanager
def fake_world(*, multi_pod: bool = False):
    """Yields the production ``DeviceMesh`` on a fake world of 256 (or
    512) ranks; this process is rank 0.  Refuses to start inside another
    world."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "fake world needs the process to itself")
    # registers the "fake" backend and provides its store
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=production_world_size(multi_pod))
    try:
        yield make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    finally:
        dist.destroy_process_group()
