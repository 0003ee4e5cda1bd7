"""Collective matmul: the port of ``repro.sharding.collective_matmul``.

A column-parallel matmul whose input is sharded on its contraction dim
would first all-gather that input, serializing communication before
compute. The ring formulation (Wang et al., "Overlap communication with
dependent computation") decomposes

    Y = X @ W,   X sharded over the TP axis on its contraction dim

into TP steps: each step multiplies the X shard this rank now holds by
the matching rows of its W column shard while the next X shard travels
one step round the ring (``batch_isend_irecv`` on the TP axis's process
group), so the transfer of step i+1 overlaps the product of step i. With
one device on the TP axis no message is sent.

The JAX package runs the ring inside ``shard_map``; here every rank of
the mesh calls ``collective_matmul`` and runs the ring on its local
shards. The product is a plain ``torch.matmul``: the JAX package
computes it outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.sharding.compat import axis_group
from repro_torch.sharding.rules import Spec, placements


def _local(t: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec``: a DTensor is
    redistributed to it, a plain tensor (the same full value on every
    rank) is split without sending anything."""
    want = placements(mesh, spec)
    if isinstance(t, DTensor):
        if tuple(t.placements) != want:
            t = t.redistribute(mesh, want)
        return t.to_local()
    return distribute_tensor(t, mesh, want, src_data_rank=None).to_local()


def _shift(x: torch.Tensor, group, ranks: list, idx: int) -> torch.Tensor:
    """Start sending ``x`` to the previous rank of the ring and receiving
    the next rank's shard; returns the receive buffer and the requests."""
    tp = len(ranks)
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(idx - 1) % tp], group),
           dist.P2POp(dist.irecv, buf, ranks[(idx + 1) % tp], group)]
    return buf, dist.batch_isend_irecv(ops)


def ring_matmul(x_shard: torch.Tensor, w: torch.Tensor, group, ranks: list,
                idx: int) -> torch.Tensor:
    """x_shard: [B, S, D/tp], this rank's contraction shard; w: [D, F/tp],
    this rank's column shard with all D rows. Step s multiplies the shard
    that rank ``idx + s`` started with by its rows of ``w``, accumulating
    in ``promote_types(x, bf16)`` as the JAX package does."""
    tp = len(ranks)
    d = x_shard.shape[-1]
    acc = torch.zeros(x_shard.shape[:-1] + (w.shape[-1],),
                      dtype=torch.promote_types(x_shard.dtype,
                                                torch.bfloat16),
                      device=x_shard.device)
    x_cur = x_shard.contiguous()
    for s in range(tp):
        pending = None
        if s + 1 < tp:
            pending = _shift(x_cur, group, ranks, idx)
        src = (idx + s) % tp             # owner of the shard we now hold
        acc = acc + torch.matmul(x_cur, w[src * d:(src + 1) * d].to(
            x_cur.dtype))
        if pending is not None:
            x_cur, reqs = pending
            for r in reqs:
                r.wait()
    return acc.to(x_shard.dtype)


def collective_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                      tp_axis: str = "model",
                      dp_axes=("data",)) -> DTensor:
    """Y[B,S,F] = X[B,S,D] @ W[D,F], X feature-sharded over ``tp_axis``
    (and batch-sharded over ``dp_axes``), W column-sharded — without a
    blocking X all-gather. ``x`` and ``w`` are DTensors on ``mesh`` (or
    the same full tensor on every rank); Y is a DTensor sharded as
    ``(dp, None, tp_axis)``."""
    dp = tuple(a for a in dp_axes if a in mesh.mesh_dim_names)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    x_spec, w_spec = Spec(dp_spec, None, tp_axis), Spec(None, tp_axis)
    x_local, w_local = _local(x, mesh, x_spec), _local(w, mesh, w_spec)
    group, tp, idx = axis_group(mesh, tp_axis)
    ranks = dist.get_process_group_ranks(group)
    if len(ranks) != tp or ranks[idx] != dist.get_rank():
        raise RuntimeError(f"the {tp_axis!r} group's ranks {ranks} do not "
                           f"follow the mesh's {tp_axis!r} axis")
    y = ring_matmul(x_local, w_local, group, ranks, idx)
    return DTensor.from_local(y, mesh, placements(mesh, x_spec),
                              run_check=False)
