"""Roofline terms from a traced step: the port's counterpart of
``repro.roofline.analysis``.

Three terms per (arch x shape x mesh), all in seconds a step:

    compute    = FLOPs_per_device / PEAK_FLOPS_BF16
    memory     = bytes_per_device / HBM_BW
    collective = collective_wire_bytes_per_device / LINK_BW

The JAX package reads them from the compiled program (XLA's
``cost_analysis`` and the collectives of the optimized HLO). Here
``cost_of`` runs the step once under a dispatch mode that sees the ops
each device runs: on DTensors (a mesh), DTensor lowers every op to the
local op on this rank's shards and the collectives that move them, and
the mode counts those, not the global op (``FlopCounterMode`` over a
DTensor counts the global product, every device's share at once). The
step runs under ``FakeTensorMode`` for planning, so nothing is allocated,
or on real tensors to check a plan.

  * FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention) and those the kernels' custom ops register
    (``kernels/*.py``), over the local ops' shapes. Elementwise ops count
    no FLOPs, as in PyTorch's counter.
  * Bytes: each local op's operand and result bytes, counted once an op:
    the unfused counterpart of XLA's "bytes accessed" (an eager step
    reads and writes every intermediate; a fused program does not).
  * Collectives: each ``_c10d_functional`` collective's result bytes, and
    its ring wire bytes per device (``wire_bytes``).
  * Breakdowns, for the planning scripts (``scripts/torch_profile_*.py``,
    ``torch_kernel_adjusted.py``): the bytes by (op, result shapes) and
    the wire bytes by (collective, result shape, group size); each sums
    to its total.
  * Memory: the bytes of the arguments' local shards, and the peak of
    live storage the step allocates on top (tracked by weak references,
    each allocation rounded up to the caching allocator's 512 bytes).

The trace unrolls every layer and microbatch, so it counts the full
configuration directly. ``extrapolate`` (the JAX package's depth probe)
is kept to check that method against the full count.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import weakref
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline import hw

COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")

# _c10d_functional op name -> (kind, index of its group-size argument or
# None to read the group's size from its name).
_COLLECTIVES = {
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", None),
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_into_tensor_out": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "all_to_all_single": ("all-to-all", None),
}
# Ops that move no data: metadata, allocation without a write, waits.
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "device", "wait_tensor", "lift_fresh",
             "detach", "alias", "_local_scalar_dense", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset", "dim",
             "is_contiguous", "is_same_size"}
_MIN_ALLOC = 512            # the CUDA caching allocator's rounding


def wire_bytes(kind: str, size: float, group: int) -> float:
    """Ring-algorithm wire bytes a device sends for one collective whose
    per-device result is ``size`` bytes over ``group`` devices (the JAX
    package's ``parse_collectives`` arithmetic)."""
    if group <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * size * (group - 1) / group
    if kind == "all-gather":
        return size * (group - 1) / group          # size = gathered result
    if kind == "reduce-scatter":
        return size * (group - 1)                  # size = scattered shard
    if kind == "all-to-all":
        return size * (group - 1) / group
    if kind == "collective-permute":
        return size
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class CellCost:
    """Per-device cost of one step."""
    flops: float
    bytes_accessed: float
    wire_bytes: float
    collective_counts: dict

    def __sub__(self, other: "CellCost") -> "CellCost":
        return CellCost(
            self.flops - other.flops,
            self.bytes_accessed - other.bytes_accessed,
            self.wire_bytes - other.wire_bytes,
            {k: self.collective_counts.get(k, 0)
             - other.collective_counts.get(k, 0)
             for k in set(self.collective_counts)
             | set(other.collective_counts)})

    def scaled(self, f: float) -> "CellCost":
        return CellCost(self.flops * f, self.bytes_accessed * f,
                        self.wire_bytes * f,
                        {k: v * f for k, v in self.collective_counts.items()})

    def __add__(self, other: "CellCost") -> "CellCost":
        return CellCost(
            self.flops + other.flops,
            self.bytes_accessed + other.bytes_accessed,
            self.wire_bytes + other.wire_bytes,
            {k: self.collective_counts.get(k, 0)
             + other.collective_counts.get(k, 0)
             for k in set(self.collective_counts)
             | set(other.collective_counts)})


def extrapolate(probe1: CellCost, probe2: CellCost, num_superblocks: float,
                micro_scale: float = 1.0) -> CellCost:
    """Depth extrapolation: per-superblock = probe2 - probe1 (probes with
    1 and 2 superblocks); total = base + num_superblocks * per_sb, with
    everything scaled by ``micro_scale`` (exact for 1)."""
    per_sb = probe2 - probe1
    base = probe1 - per_sb
    return base.scaled(micro_scale) + per_sb.scaled(num_superblocks
                                                    * micro_scale)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float           # the counted FLOPs (JAX: the HLO's)

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu(self) -> float:
        """MODEL_FLOPS / (peak x step time): roofline-model MFU."""
        if self.step_s <= 0:
            return 0.0
        return (self.model_flops / hw.PEAK_FLOPS_BF16) / self.step_s


def roofline_from_cost(cost: CellCost,
                       model_flops_per_device: float) -> Roofline:
    return Roofline(
        compute_s=cost.flops / hw.PEAK_FLOPS_BF16,
        memory_s=cost.bytes_accessed / hw.HBM_BW,
        collective_s=cost.wire_bytes / hw.LINK_BW,
        model_flops=model_flops_per_device,
        hlo_flops=cost.flops)


# ---------------------------------------------------------------------------
# Counting a step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceRecord:
    """What ``cost_of`` measured: the cost, and the memory of the step in
    bytes on one device."""
    cost: CellCost
    argument_bytes: int
    output_bytes: int
    peak_bytes: int            # arguments + the peak of what the step allocates
    temp_bytes: int            # peak - arguments - outputs
    collective_result_bytes: dict
    ops: int                   # local ops run
    # bytes by (op, ((dtype, shape), ...) of its results)
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    # wire bytes by (kind, ((dtype, shape),) of its result, group size)
    wire_by_collective: dict = dataclasses.field(default_factory=dict)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shapes(out) -> tuple:
    """((dtype, shape), ...) of the tensors in ``out``."""
    return tuple((str(t.dtype).replace("torch.", ""), tuple(t.shape))
                 for t in _tensors(out))


def _alloc(n: int) -> int:
    return math.ceil(n / _MIN_ALLOC) * _MIN_ALLOC


def _storages_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += _alloc(st.nbytes())
    return total


class _Counter(TorchDispatchMode):
    """Counts the local ops a step runs (see the module docstring).

    DTensor-level ops are handed back (``NotImplemented``) so DTensor
    lowers them to local ops and collectives, which reach this mode. The
    ops DTensor's sharding propagation runs on global shapes to infer an
    output's metadata are not counted (``_shadow``)."""

    def __init__(self, known_storages):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.wire = {k: 0.0 for k in COLL_KINDS}
        self.result = {k: 0.0 for k in COLL_KINDS}
        self.counts = {k: 0 for k in COLL_KINDS}
        self.bytes_by_op: collections.Counter = collections.Counter()
        self.wire_by: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0
        self._known = known_storages     # ids of storages alive before
        self._refs: dict[int, Any] = {}
        self._local = threading.local()

    # DTensor's sharding propagation runs each new op once on global
    # shapes; those runs are not this device's work.
    def shadow(self):
        return _Shadow(self._local)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._known or key in self._refs:
                continue
            n = _alloc(st.nbytes())
            self.live += n
            self.peak = max(self.peak, self.live)
            self._refs[key] = weakref.ref(st, self._freed(key, n))

    def _freed(self, key: int, n: int) -> Callable:
        def cb(_):
            self.live -= n
            self._refs.pop(key, None)
        return cb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if getattr(self._local, "depth", 0):
            return out
        self.ops += 1
        packet = func._overloadpacket
        name = packet.__name__
        ns = packet._qualified_op_name.split("::")[0]
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if ns == "_c10d_functional" and name in _COLLECTIVES:
            kind, gi = _COLLECTIVES[name]
            if gi is not None:
                group = int(args[gi])
            else:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                group = _resolve_process_group(args[-1]).size()
            size = float(_nbytes(out if isinstance(out, torch.Tensor)
                                 else _tensors(out)[0]))
            if group > 1:
                wire = wire_bytes(kind, size, group)
                self.counts[kind] += 1
                self.result[kind] += size
                self.wire[kind] += wire
                self.wire_by[(kind, _shapes(out), group)] += wire
        elif not func.is_view and name not in _NO_BYTES:
            n = sum(_nbytes(t) for t in _tensors(args)
                    + _tensors(kwargs) + _tensors(out))
            self.bytes += n
            self.bytes_by_op[(f"{ns}.{name}", _shapes(out))] += n
        if not func.is_view:
            self._track(out)
        return out


class _Shadow:
    def __init__(self, local):
        self._l = local

    def __enter__(self):
        self._l.depth = getattr(self._l, "depth", 0) + 1

    def __exit__(self, *exc):
        self._l.depth -= 1


def cost_of(fn: Callable, args: tuple, mesh=None) -> tuple[Any, TraceRecord]:
    """Run ``fn(*args)`` once and count, per device, what it runs (see
    the module docstring). ``args`` hold plain tensors or DTensors (fake
    or real); ``mesh`` is only recorded. Returns (fn's result, record)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    arg_tensors = _tensors(args)
    known = {id(_local(t).untyped_storage()) for t in arg_tensors}
    counter = _Counter(known)
    meta = ShardingPropagator._propagate_tensor_meta_non_cached

    def shadowed(self, *a, **k):
        with counter.shadow():
            return meta(self, *a, **k)

    ShardingPropagator._propagate_tensor_meta_non_cached = shadowed
    try:
        with counter:
            out = fn(*args)
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = meta
    arg_bytes = _storages_bytes(arg_tensors)
    out_bytes = _storages_bytes(
        [t for t in _tensors(out)
         if id(_local(t).untyped_storage()) not in known])
    peak = arg_bytes + counter.peak
    cost = CellCost(flops=counter.flops, bytes_accessed=counter.bytes,
                    wire_bytes=sum(counter.wire.values()),
                    collective_counts=dict(counter.counts))
    return out, TraceRecord(
        cost=cost, argument_bytes=arg_bytes, output_bytes=out_bytes,
        peak_bytes=peak, temp_bytes=max(peak - arg_bytes - out_bytes, 0),
        collective_result_bytes=dict(counter.result), ops=counter.ops,
        bytes_by_op=dict(counter.bytes_by_op),
        wire_by_collective=dict(counter.wire_by))

