"""Production mesh construction over a fake process group.

The dry-run traces each cell on the production meshes without the
cards: ``torch.distributed``'s ``fake`` backend (``FakeStore``) gives a
world of 256 or 512 ranks in one process, in which this process is rank
0 and every collective returns at once without moving data.  The meshes
are built by functions, never at import, as the reference's are.

Port of ``repro/launch/mesh.py``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks (this process is rank 0),
    re-initialised when the size changes."""
    if dist.is_initialized():
        if dist.get_world_size() == size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def destroy() -> None:
    """Tear down the process group a mesh of this module started."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape, axes) -> DeviceMesh:
    """A mesh of device type ``cuda`` (the port's cards; DTensor then
    moves a shard between tensor dims with an all-to-all, where on a
    ``cpu`` mesh it gathers the whole tensor) over the fake world.  No
    card is touched: the tensors it places are on ``meta``."""
    size = 1
    for s in shape:
        size *= s
    _fake_world(size)
    return DeviceMesh("cuda", torch.arange(size).view(*shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh of the reference's deployment: 16x16 = 256
    chips per pod, optionally 2 pods = 512 chips with a leading "pod"
    axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_local_mesh() -> DeviceMesh:
    """1x1 mesh ("data", "model") over a one-rank world."""
    return _mesh((1, 1), ("data", "model"))
