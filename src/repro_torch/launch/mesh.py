"""Production and local meshes: the port of ``repro.launch.mesh``.

Functions, not module-level constants, so importing this module starts
no process group.
"""

from __future__ import annotations

import torch

from repro_torch.sharding.compat import make_mesh, planning_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's production meshes as planning meshes of H100s
    (``sharding.compat.planning_mesh``): 16x16 = 256 GPUs, or 2x16x16 =
    512 over two pods; for tracing only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return planning_mesh(shape, axes)


def make_local_mesh(shape=None, axes=("data", "model"), device="cuda"):
    """A mesh over the visible devices of ``device``'s type: the CUDA
    devices (one process each; one on a one-card machine), or the CPU
    when asked for. Defaults to all of them on the first axis."""
    if shape is None:
        n = torch.cuda.device_count() if device == "cuda" else 1
        if n == 0:
            raise RuntimeError("no CUDA device is available: pass "
                               "device='cpu' for a CPU mesh")
        shape = (n, 1) if len(axes) == 2 else (n,)
    return make_mesh(shape, axes, device)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
