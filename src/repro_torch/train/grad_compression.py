"""Gradient compression for the training fabric's wire — the port of
``repro.train.grad_compression``'s host/wire half.

The training fabric's chief-driven aggregation ships per-learner
gradients over courier RPC: each learner quantizes its contribution with
its *own* error-feedback residual, the chief dequantizes and averages.
The residual is real training state — the chief's copy rides in
published checkpoints (see ``ckpt/elastic.py``).

  * ``dense``: fp32 passes through.
  * ``int8_ef``: per-tensor int8 with error feedback, 4x fewer bytes; the
    quantization residual is added back into the next step's gradient
    (Seide et al.'s 1-bit-SGD trick generalized), so the bias does not
    accumulate.

Quantization runs where the gradient lives (the learner's device) and is
bit-equal to the JAX package's numpy version: the scale is
``max|g+e| / 127`` taken in Python floats and rounded to fp32, each
division is a true fp32 division (a 0-dim tensor divisor on the same
device: PyTorch divides by a Python scalar as a multiply by its
reciprocal), ``torch.round`` rounds half to even as ``np.rint`` does,
and the residual is ``(g+e) - q*scale`` in fp32. The payload leaves are
CPU numpy (courier refuses CUDA tensors); the residual stays on the
device.

``compress_reduce_pod`` is the mesh half: the cross-pod (DCN) reduction
over the ``pod`` axis of a ``DeviceMesh``, compressed to bf16 or to int8
with error feedback, an all-reduce over that axis's process group where
the JAX package runs a psum inside ``shard_map``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.sharding.compat import axis_group
from repro_torch.sharding.rules import full
from repro_torch.train import tree


def _quantize_int8(x: torch.Tensor):
    """The JAX package's fp32 formula: ``max(max|x|, 1e-12) / 127`` with
    fp32 tensor arithmetic (true divisions), round half to even."""
    scale = torch.div(
        torch.maximum(torch.max(torch.abs(x)), _f32(1e-12, x.device)),
        _f32(127.0, x.device))
    q = torch.clamp(torch.round(torch.div(x, scale)), -127, 127).to(
        torch.int8)
    return q, scale


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


@torch.no_grad()
def compress_reduce_pod(grads, error_state, mesh, method: str = "int8_ef",
                        pod_axis: str = "pod"):
    """All-reduce ``grads`` over the pod axis of ``mesh`` with compression.

    grads: tree of per-pod-averaged fp32 gradients, each a DTensor
    replicated over the pod axis (its full value is the JAX ``P()``
    view), or this rank's own tensor. error_state: a tree like grads
    (int8_ef) or None. Returns (reduced_grads, new_error_state), each
    leaf in its gradient's form and placements. Without a pod axis, or
    with one pod, both come back as they are.

      * ``bf16``: cast, all-reduce (sum) over the pod group, cast back,
        divide by the number of pods;
      * ``int8_ef``: add the residual, quantize, keep ``corrected - deq``
        as the new residual and all-reduce the fp32 dequantized values
        (an int8 sum would overflow; the wire cost is the int8 payload
        and one scalar), divided by the number of pods.
    """
    if (pod_axis not in mesh.mesh_dim_names
            or axis_group(mesh, pod_axis)[1] == 1):
        return grads, error_state
    if method not in ("bf16", "int8_ef"):
        raise ValueError(f"unknown cross-pod method {method!r}")
    group, npod, _ = axis_group(mesh, pod_axis)

    def like(ref, value):
        if not isinstance(ref, DTensor):
            return value
        whole = DTensor.from_local(value, ref.device_mesh,
                                   [Replicate()] * ref.device_mesh.ndim,
                                   run_check=False)
        return whole.redistribute(ref.device_mesh, ref.placements)

    def one(g, e):
        gf = full(g).float()
        if method == "bf16":
            r = gf.to(torch.bfloat16)
            dist.all_reduce(r, group=group)
            return like(g, torch.div(r.float(), _f32(npod, r.device))), e
        corrected = gf + full(e).float()
        q, scale = _quantize_int8(corrected)
        deq = q.float() * scale
        new_err = corrected - deq          # what compression dropped
        dist.all_reduce(deq, group=group)
        return (like(g, torch.div(deq, _f32(npod, deq.device))),
                like(e, new_err))

    if error_state is None:
        error_state = tree.tree_map(torch.zeros_like, grads)
    out = {}

    def record(path, g, e):
        out[path] = one(g, e)

    tree.map_with_path(record, grads, error_state)
    pick = lambda i: tree.map_with_path(  # noqa: E731
        lambda path, _: out[path][i], grads)
    return pick(0), pick(1)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


def wire_bytes_saved(grads, method: str = "int8_ef") -> float:
    """Analytic savings vs an fp32 all-reduce (for the records)."""
    total = sum(_numel(x) * 4 for x in tree.leaves(grads))
    factor = {"bf16": 2.0, "int8_ef": 4.0}[method]
    return total * (1 - 1 / factor)


def select_strategy(t, threshold_bytes: int = 1 << 22) -> str:
    """Pick the wire strategy by gradient size: below the threshold the
    dense fp32 payload is effectively free on a same-host courier, above it
    int8+EF buys 4x on the slow link."""
    return "int8_ef" if grad_bytes(t) >= threshold_bytes else "dense"


def grad_bytes(t) -> int:
    return sum(_nbytes(x) for x in tree.leaves(t))


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _int8_ef(g: torch.Tensor, e: torch.Tensor):
    corrected = g + e.to(g.device)
    scale = np.float32(
        max(float(torch.max(torch.abs(corrected))), 1e-12) / 127.0)
    s = torch.tensor(scale, dtype=torch.float32, device=g.device)
    q = torch.clamp(torch.round(corrected / s), -127, 127).to(torch.int8)
    residual = corrected - q.float() * s
    return q, scale, residual


@torch.no_grad()
def compress_tree(grads, error_state=None, method: str = "int8_ef"):
    """Compress a gradient tree into a picklable wire payload.

    Returns ``(payload, new_error_state)``. ``method="dense"`` passes fp32
    through untouched (error_state is returned as-is); ``"int8_ef"`` applies
    per-tensor int8 quantization with error feedback, so the residual of
    what compression dropped is added back into the next step's gradient.
    Leaves may be tensors on any device or numpy arrays; the payload is
    numpy, the new error state fp32 tensors where the gradient lives.
    """
    if method == "dense":
        return ({"method": "dense",
                 "tree": tree.tree_map(lambda x: _host(_as_tensor(x)),
                                       grads)}, error_state)
    if method != "int8_ef":
        raise ValueError(f"unknown wire compression method {method!r}")
    g = tree.tree_map(_as_tensor, grads)
    if error_state is None:
        error_state = tree.tree_map(torch.zeros_like, g)
    out = {}

    def one(path, gi, ei):
        out[path] = _int8_ef(gi, _as_tensor(ei))

    tree.map_with_path(one, g, error_state)
    pick = lambda i, f: tree.map_with_path(  # noqa: E731
        lambda path, _: f(out[path][i]), g)
    payload = {"method": "int8_ef", "q": pick(0, _host),
               "scale": pick(1, lambda s: s)}
    return payload, pick(2, lambda r: r)


def decompress_tree(payload, device: Optional[torch.device] = None):
    """Inverse of ``compress_tree``: payload -> fp32 numpy gradient tree,
    or fp32 tensors on ``device`` when one is given (the product runs
    there, in fp32: the same numbers)."""
    if device is None:
        if payload["method"] == "dense":
            return payload["tree"]
        return tree.tree_map(lambda q, s: q.astype(np.float32) * s,
                             payload["q"], payload["scale"])
    if payload["method"] == "dense":
        return tree.tree_map(
            lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device),
            payload["tree"])
    return tree.tree_map(
        lambda q, s: torch.from_numpy(q).to(device).float()
        * torch.tensor(s, dtype=torch.float32, device=device),
        payload["q"], payload["scale"])
