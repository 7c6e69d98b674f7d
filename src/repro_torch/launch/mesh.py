"""Meshes, port of ``repro.launch.mesh``: the reference's axis names and
degree rules over a ``torch.distributed`` process group.

Each ``make_*`` function returns a ``torch.distributed.device_mesh.
DeviceMesh`` over the current process group (one rank a device), and keeps
no module-level state. The mesh's *layout* -- its axis names and shape --
comes from a pure function of the device count (``*_layout``), so the
placement rules (``launch.sharding``) and their tests can use the 256- and
512-chip production shapes on one CPU, with no process group.

:func:`init_process_group` starts the group a ``torchrun`` launch
describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL for the card by default (one card a rank,
``cuda:{LOCAL_RANK}``), gloo for the CPU with ``device="cpu"``, with a
timeout, so a hung collective fails the run instead of hanging it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch

#: how long a collective may wait before the process group gives up
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes, without devices: what the placement
    rules read (the reference's rules read only ``mesh.axis_names`` and
    ``mesh.shape``). ``shape`` maps an axis name to its size."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def layout_of(mesh) -> MeshLayout:
    """The layout of a :class:`MeshLayout`, a ``DeviceMesh`` or any object
    with ``axis_names`` and a ``shape`` mapping (the reference's mesh)."""
    if isinstance(mesh, MeshLayout):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh
        return MeshLayout(tuple(names), tuple(int(s) for s in mesh.shape))
    names = tuple(mesh.axis_names)
    return MeshLayout(names, tuple(int(mesh.shape[a]) for a in names))


def production_layout(*, multi_pod: bool = False) -> MeshLayout:
    """16x16 = 256 chips per pod; 2 pods = 512 chips with a leading pod
    axis. ``data`` carries batch and FSDP sharding, ``model`` tensor and
    expert parallelism, ``pod`` extends data parallelism across pods."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def host_layout(n: int, model: int = 2) -> MeshLayout:
    """``make_host_mesh``'s layout over ``n`` devices."""
    model = min(model, n)
    return MeshLayout(("data", "model"), (n // model, model))


def serving_layout(n: int, model: Optional[int] = None) -> MeshLayout:
    """``make_serving_mesh``'s layout over ``n`` devices: ``model`` is the
    tensor-parallel degree (default: all of them); a degree that does not
    divide ``n`` rounds down to one that does (8 devices, 3 -> 2)."""
    model = n if model is None else max(1, min(model, n))
    while n % model:
        model -= 1
    return MeshLayout(("data", "model"), (n // model, model))


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh is built over a torch.distributed process group: start "
            "one rank per device (torchrun --nproc-per-node N ...) and call "
            "launch.mesh.init_process_group() first (NCCL on the card; "
            "init_process_group('cpu') for gloo on the CPU)"
        )
    return dist.get_world_size()


def _device_mesh(layout: MeshLayout):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev, layout.sizes, mesh_dim_names=layout.axis_names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh (``production_layout``) over a 256- or
    512-rank process group."""
    layout = production_layout(multi_pod=multi_pod)
    if _world() != layout.size:
        raise ValueError(
            f"the production mesh needs {layout.size} ranks, the process group "
            f"has {_world()}"
        )
    return _device_mesh(layout)


def make_host_mesh(model: int = 2):
    """A small (data, model) mesh over every rank (tests)."""
    return _device_mesh(host_layout(_world(), model))


def make_serving_mesh(model: Optional[int] = None):
    """Mesh over every rank for sharded serving and chip programming
    (``serving_layout``): weights and the PCM state are sharded over
    ``model``, the slot batch rides ``data``."""
    return _device_mesh(serving_layout(_world(), model))


def init_process_group(device="cuda", *, timeout_s: float = DEFAULT_TIMEOUT_S,
                       store=None, rank: Optional[int] = None,
                       world_size: Optional[int] = None) -> torch.device:
    """Join the process group (once) and return this rank's device.

    Without ``store``, the group is the one ``torchrun`` describes in the
    environment; ``store`` (a ``FileStore`` or ``TCPStore``) with ``rank``
    and ``world_size`` names it explicitly. NCCL on a card (the default),
    each rank on ``cuda:{LOCAL_RANK}``; gloo on the CPU (``device="cpu"``).

    A CPU group pins this process to one intra-op thread
    (``torch.set_num_threads(1)``): at more threads torch's fp32 product
    of a column slice ``x @ w[:, cols]`` is not bitwise the whole product's
    columns (measured at K = 1024 and 2048, N = 2048, M = 2-8 over 4
    slices, 8 threads), at one thread it is, and the tensor-parallel
    forward rests on that. The host result a sharded one is held against
    is computed at one thread as well (``core.analog``'s note).
    """
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if dev.type == "cpu":
            torch.set_num_threads(1)
        kw = {}
        if store is not None:
            kw = dict(store=store, rank=rank, world_size=world_size)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            timeout=datetime.timedelta(seconds=timeout_s),
            **({"device_id": dev} if dev.type == "cuda" else {}), **kw,
        )
    return dev

