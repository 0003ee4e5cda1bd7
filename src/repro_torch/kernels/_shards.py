"""Kernel wrappers on DTensors: each kernel runs on this rank's shards.

A kernel wrapper handed a DTensor (a model traced or run under
``sharding.use_sharding``) calls ``on_shards``: the inputs are
redistributed to the placements the kernel can work on locally — batch,
head or channel sharded, never the sequence, the key length or the head
dim — and the kernel's custom op runs on the local tensors through
``torch.distributed.tensor.experimental.local_map``. A plain tensor among
the inputs counts as replicated.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)


def is_dtensor(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def mesh_of(*xs):
    return next(x.device_mesh for x in xs if isinstance(x, DTensor))


def moved(placements: Sequence, dims: dict) -> tuple:
    """``placements`` with ``Shard(d)`` renamed to ``Shard(dims[d])``;
    a shard of a dim missing from ``dims`` becomes ``Replicate()``."""
    out = []
    for p in placements:
        if isinstance(p, Shard) and p.dim in dims:
            out.append(Shard(dims[p.dim]))
        else:
            out.append(Replicate())
    return tuple(out)


def grad_placements(in_placements: Sequence, out_placements) -> tuple:
    """The placements of each input's gradient out of a local_map: an
    input whole on a mesh axis over which the outputs are split (sharded
    or partial sums) gets a partial gradient there (each device's share
    of the work adds to it); otherwise its own placement."""
    outs = ([out_placements] if all(isinstance(p, Placement)
                                    for p in out_placements)
            else list(out_placements))
    split = [any(not o[i].is_replicate() for o in outs)
             for i in range(len(outs[0]))]
    return tuple(
        None if pl is None else tuple(
            Partial() if p.is_replicate() and split[i] else p
            for i, p in enumerate(pl))
        for pl in in_placements)


def on_shards(op: Callable, args: Sequence, in_placements: Sequence,
              out_placements) -> object:
    """``op(*args)`` on local shards: tensor arguments are placed as
    ``in_placements`` says (``None`` for a non-tensor argument), outputs
    come back as DTensors placed as ``out_placements``."""
    from torch.distributed.tensor.experimental import local_map
    mesh = mesh_of(*args)
    placed = []
    for a, pl in zip(args, in_placements):
        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        placed.append(a)
    single = all(isinstance(p, Placement) for p in out_placements)
    fn = local_map(op, out_placements=(out_placements,) if single
                   else out_placements,
                   in_placements=tuple(in_placements),
                   in_grad_placements=grad_placements(in_placements,
                                                      out_placements),
                   device_mesh=mesh, redistribute_inputs=True)
    out = fn(*placed)
    return out[0] if single and isinstance(out, (tuple, list)) else out


def pad(x, widths: tuple):
    """``F.pad(x, widths)`` with zeros; on a DTensor, on its local
    shards, the padded dims whole (some PyTorch releases cannot
    redistribute for ``pad``'s own DTensor strategy on a 2-D mesh)."""
    import torch.nn.functional as F
    if not isinstance(x, DTensor):
        return F.pad(x, widths)
    padded = {x.dim() - 1 - i // 2 for i, w in enumerate(widths) if w}
    pl = moved(x.placements, {d: d for d in range(x.dim())
                              if d not in padded})
    return on_shards(lambda t: F.pad(t, widths), (x,), (pl,), pl)
