"""Device meshes for the port: the counterpart of
``repro.sharding.compat``.

``make_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` over real
devices: one process per device, each in the default process group. A
one-device mesh needs no launcher, so a group of size 1 is started here
when none exists; a larger mesh needs its processes' group first (one
``start_group`` per rank, each with its rank's device from
``rank_devices``; ``train.mesh_group`` starts them from one controller).

``planning_mesh`` builds a mesh of any size in one process, for tracing
only: its process group is ``torch.distributed``'s fake backend, which
completes every collective at once without moving data. Its device type
is "cuda" wherever PyTorch is built for CUDA (a card need not be
present); a CPU-only build cannot index a fake CUDA tensor ("PyTorch is
not linked with support for cuda devices"), so there the mesh is of
"cpu" devices, and the planning code asks for the kernels' route itself
(``impl="flash"``) rather than reading it off the device. It never runs
real work; this module is the only one that imports the fake backend.

``shard_map`` has no counterpart: the port's ``collective_matmul`` runs
on each rank's local shards and talks over one axis's process group
(``axis_group``).
"""

from __future__ import annotations

import datetime
import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_FAKE = "fake"


def _group_backend() -> str:
    return str(dist.get_backend()).lower()


def _drop_fake_group() -> None:
    """A planning mesh's fake group makes way for any other group."""
    if dist.is_initialized() and _group_backend() == _FAKE:
        dist.destroy_process_group()


def rank_devices(axis_shapes: Sequence[int], device) -> list:
    """Each rank's device, rank 0 first, for a mesh of ``axis_shapes``
    on ``device``: every rank on the CPU, or on "cuda" rank r on card r
    (``RuntimeError`` when fewer cards are visible). Two ranks never
    share a card: NCCL refuses two ranks on one device, and gloo's
    functional collectives, which DTensor calls, crash on CUDA tensors
    (``scripts/torch_probe_gloo_cuda.py``)."""
    device = torch.device(device)
    n_need = math.prod(axis_shapes)
    if device.type != "cuda":
        return [device] * n_need
    n_have = torch.cuda.device_count()
    if n_have < n_need:
        raise RuntimeError(
            f"mesh {tuple(axis_shapes)} needs {n_need} cuda devices, "
            f"{n_have} visible (one rank a card)")
    return [torch.device("cuda", r) for r in range(n_need)]


def start_group(store, rank: int, devices: Sequence[torch.device],
                timeout_s: float) -> torch.device:
    """Join the default process group as ``rank`` of ``len(devices)``
    ranks that meet at ``store``: gloo on the CPU; on cards nccl, with
    gloo for CPU tensors (the command channel). Returns this rank's
    device, made the current card on "cuda"."""
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _drop_fake_group()
    dist.init_process_group(
        "gloo" if device.type == "cpu" else "cuda:nccl,cpu:gloo",
        store=store, rank=rank,
        world_size=len(devices),
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def _check_group(axis_shapes: Sequence[int]) -> None:
    """Raise ``RuntimeError`` when a real mesh of ``axis_shapes`` needs
    more devices than this process's group spans: the running group's
    world size, else 1 (``make_mesh`` starts a group of one)."""
    n_need = math.prod(axis_shapes)
    n_have = (dist.get_world_size()
              if dist.is_initialized() and _group_backend() != _FAKE else 1)
    if n_have < n_need:
        raise RuntimeError(
            f"mesh {tuple(axis_shapes)} needs {n_need} devices, the process "
            f"group has {n_have} (start one process per device, each in the "
            "group with its rank and world size, or shrink the mesh)")


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over real devices of ``device_type``. Starts a process
    group of size 1 (nccl on "cuda", gloo on "cpu") when the mesh has one
    device and no group exists; its rendezvous is an in-memory store, so
    it takes no port. A mesh larger than the group raises."""
    _drop_fake_group()
    _check_group(axis_shapes)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), world_size=1, rank=0)
    return init_device_mesh(device_type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def planning_mesh(axis_shapes: Sequence[int],
                  axis_names: Sequence[str]) -> DeviceMesh:
    """A mesh of ``prod(axis_shapes)`` devices on the fake backend
    in this one process, as rank 0: for tracing under ``FakeTensorMode``
    only. Replaces an earlier planning group of another size; refuses to
    replace a real group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    size = math.prod(axis_shapes)
    if dist.is_initialized():
        if _group_backend() != _FAKE:
            raise RuntimeError(
                "a real process group is running: a planning mesh needs "
                "the fake backend in a process of its own")
        if dist.get_world_size() != size:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group(_FAKE, store=FakeStore(), rank=0,
                                world_size=size)
    return init_device_mesh(planning_device(), tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def planning_device() -> str:
    """The device type of planning meshes and their fake tensors."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_group(mesh, axis: str) -> tuple:
    """(process group, size, this rank's index) of one mesh axis."""
    return (mesh.get_group(axis), mesh_sizes(mesh)[axis],
            mesh.get_local_rank(axis))
