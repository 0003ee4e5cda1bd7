"""Activation-sharding context: the port of ``repro.sharding.ctx``.

Model code calls ``shard(x, 'dp', None, 'tp')`` at layer boundaries; the
logical axes are resolved against the active mesh (``'dp'`` expands to
the data-parallel axes — ``('pod', 'data')`` on the multi-pod mesh — and
``'tp'`` to the tensor-parallel axis), fitted to the tensor's shape, and
a DTensor is redistributed to those placements (the counterpart of
``with_sharding_constraint``). On a plain tensor, or outside any context,
it returns its argument: every path that runs without a mesh computes
exactly what it did.

Inside ``use_sharding`` with a context, DTensor's implicit replication
is on, so the plain tensors that model code makes (positions, masks,
zero states) combine with DTensors as replicated values.

The context is the process's, not a thread's: a backward pass on CUDA
(and the recomputation of a rematerialized block in it) runs in
autograd's device threads, which see no thread-local of the caller.
DTensor's implicit replication is process-wide too. Do not trace or run
a sharded step while another thread of the process runs plain model
code.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

from torch.distributed.tensor import DTensor, Replicate

from repro_torch.sharding.compat import mesh_sizes
from repro_torch.sharding.rules import Spec, fit_spec, placements

_active: list = [None]      # the process's current context


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: object                        # a torch DeviceMesh
    # Logical -> physical axis names.
    dp: tuple = ("data",)               # batch / fsdp axes
    tp: tuple = ("model",)              # tensor-parallel axes

    def resolve(self, logical) -> Optional[tuple]:
        if logical is None:
            return None
        names = self.mesh.mesh_dim_names
        if logical == "dp":
            out = tuple(a for a in self.dp if a in names)
        elif logical == "tp":
            out = tuple(a for a in self.tp if a in names)
        else:
            raise ValueError(f"unknown logical axis {logical!r}")
        return out or None

    def pspec(self, *logical) -> Spec:
        return Spec(*[self.resolve(lg) for lg in logical])

    def sharding(self, *logical) -> tuple:
        """(mesh, placements): the counterpart of a ``NamedSharding``."""
        return self.mesh, placements(self.mesh, self.pspec(*logical))

    def size(self, logical) -> int:
        """The number of devices a logical axis spans."""
        sizes = mesh_sizes(self.mesh)
        n = 1
        for a in self.resolve(logical) or ():
            n *= sizes[a]
        return n


def current_ctx() -> Optional[ShardingCtx]:
    return _active[0]


def get_mesh():
    ctx = current_ctx()
    return ctx.mesh if ctx else None


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingCtx]):
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _active[0]
    _active[0] = ctx
    try:
        with (implicit_replication() if ctx is not None
              else contextlib.nullcontext()):
            yield
    finally:
        _active[0] = prev


def shard(x, *logical):
    """Redistribute a DTensor to the fitted placements of ``logical``
    against the active mesh; no-op on a plain tensor or without a
    context.

    Axes that don't divide the corresponding dim are dropped (right to
    left) so the same model code serves every cell — e.g. batch=1
    long-context decode simply stays replicated on the DP axes.
    """
    ctx = current_ctx()
    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = fit_spec(ctx.mesh, x.shape, [ctx.resolve(lg) for lg in logical])
    want = placements(ctx.mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(ctx.mesh, want)


def gather_fsdp(w):
    """A weight as a layer uses it: whole over the data-parallel axes
    (FSDP's all-gather at use), still sharded over TP as it is stored.
    XLA's partitioner chooses this itself; DTensor, left to pick a
    strategy op by op, may instead gather activations or the whole
    weight. No-op on a plain tensor or without a context."""
    ctx = current_ctx()
    if ctx is None or not isinstance(w, DTensor):
        return w
    dp = ctx.resolve("dp") or ()
    names = ctx.mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in dp else pl
                 for i, pl in enumerate(w.placements))
    if tuple(w.placements) == want:
        return w
    return w.redistribute(ctx.mesh, want)
