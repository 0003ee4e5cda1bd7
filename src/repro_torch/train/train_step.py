"""Training step factory: remat + microbatch accumulation + AdamW — the
port of ``repro.train.train_step``.

``make_train_step`` builds a ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` for a given model/optimizer config. Microbatches
run one after another in a Python loop, accumulating fp32 gradients, so
arbitrary global batches fit; the remat policy trades activation memory
for a second forward pass.

The loss runs attention on the gradient pass's route
(``impl="train"``): on a card, bf16 self- and cross-attention go through
the flash kernel and its backward kernels (the JAX package's Pallas
kernel has no backward, and its loss runs XLA's attention, whose logits
are the same bf16 products in fp32); anything else the flash backward
does not take (a DTensor, fp32, a softcap, another head dim, the CPU)
runs the dense attention. The scans take their plain route, as the JAX
loss runs associative scans. Master weights are ``cfg.param_dtype`` (fp32) and compute is
``cfg.compute_dtype``: the layers cast each weight as they read it, and
the gradient comes back through that cast in fp32.

``Replayed`` wraps a gradient function for a caller that updates its
parameter tensors in place (the learner's task, ``launch.train.LMTask``,
beside ``optimizer.apply_updates_``): on a CUDA device it captures the
pass once into a ``torch.cuda.CUDAGraph`` and replays it on later calls
whose input allows it. Every microbatch's forward and remat backward,
the fp32 accumulation and the mean are then issued as one graph launch
instead of one kernel launch at a time from Python. The kernels and
their arithmetic are the eager pass's. ``make_grad_fn`` and
``make_train_step`` stay eager.

Under a sampled trace context (``core.telemetry``) each microbatch of an
eager pass records ``train.forward``, ``train.backward`` and, with
several microbatches, ``train.accumulate``, each with its index ``mb``;
a replayed pass records one ``train.replay`` in their place, and the
call that captures the graph ``train.capture`` before it; without a
context each span is a context-variable read. The process's counters
``train.graph.captures``, ``train.graph.replays`` and
``train.graph.eager`` count the calls of each kind (a capturing call
counts as a replay too).
"""

from __future__ import annotations

import dataclasses
import threading
import weakref

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core import telemetry
from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import resolve_device
from repro_torch.sharding import current_ctx
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt_lib.OptimizerConfig = opt_lib.OptimizerConfig()
    num_microbatches: int = 1
    remat: str = "full"            # none | full | dots ("dots" = "full")
    grad_accum_dtype: str = "float32"
    resid_tp: bool = False         # feature-shard saved residuals over TP
    # The JAX package's switch between lax.scan and a Python loop over
    # microbatches; the port always loops in Python. Kept so that one
    # config reads in both packages.
    unroll_micro: bool = False


def _remat_flag(policy: str) -> bool:
    return policy != "none"


def to_device(batch, device) -> dict:
    """A tree of numpy arrays (or tensors) as tensors on ``device``, each
    of its own shape (a 0-d array stays 0-d)."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            a = np.asarray(x)
            x = torch.from_numpy(a if a.flags.c_contiguous
                                 else np.ascontiguousarray(a))
        return x.to(device, non_blocking=True)
    return tree.tree_map(one, batch)


def split_batch(batch: dict, num_micro: int) -> dict:
    """[B, ...] -> [num_micro, B/num_micro, ...]: microbatch i is rows
    i*B/num_micro onward, as in the JAX package. A batch sharded over
    its rows (a DTensor) splits strided instead, microbatch i being rows
    i, i + num_micro, ...: each device then takes 1/num_micro of its own
    rows, where a contiguous split would move rows between devices. The
    step averages the same rows either way; only the order of the sums
    differs."""
    def f(x):
        B = x.shape[0]
        if B % num_micro:
            raise ValueError(f"batch {B} does not split into {num_micro} "
                             "microbatches")
        if isinstance(x, DTensor) and any(
                isinstance(p, Shard) and p.dim == 0 for p in x.placements):
            return x.reshape(B // num_micro, num_micro,
                             *x.shape[1:]).transpose(0, 1)
        return x.reshape(num_micro, B // num_micro, *x.shape[1:])
    return tree.tree_map(f, batch)


def make_loss_fn(model_cfg: ModelConfig, remat: str, resid_tp: bool = False):
    """``resid_tp`` feature-shards the residual stream under a sharding
    context (``transformer.forward``); without one it changes nothing."""
    use_remat = _remat_flag(remat)

    def loss_fn(params, micro_batch):
        return transformer.loss_fn(model_cfg, params, micro_batch,
                                   remat=use_remat, impl="train",
                                   resid_tp=resid_tp)
    return loss_fn


def _value_and_grad(loss_fn):
    """``(params, batch, mb=0) -> (loss, aux, grads)``, all detached; a
    leaf the loss does not reach gets a zero gradient, as in JAX. ``mb``
    names the microbatch in the spans."""
    def fn(params, batch, mb: int = 0):
        with telemetry.span("train.forward", mb=mb):
            live = tree.tree_map(lambda p: p.detach().requires_grad_(),
                                 params)
            with torch.enable_grad():
                loss, aux = loss_fn(live, batch)
        with telemetry.span("train.backward", mb=mb):
            paths, leaves = zip(*tree.leaves_with_path(live))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            by_path = {path: torch.zeros_like(p) if g is None else g
                       for path, p, g in zip(paths, leaves, grads)}
            grads = tree.map_with_path(lambda path, _: by_path[path], live)
        aux = {k: v.detach() for k, v in aux.items()}
        return loss.detach(), aux, grads
    return fn


def make_grad_fn(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """``(params, batch) -> (loss, aux, grads)`` with microbatch
    accumulation — the gradient half of ``make_train_step``, exposed so
    the training fabric can aggregate gradients across learners before
    applying the update. With several microbatches the metrics are
    ``{"ce": loss, "aux": 0}``, as the JAX package reports them
    (ROADMAP.md C16), and, for a stack of dropless expert layers,
    ``moe_rows`` [layers, H]: the rows each held expert computed, summed
    over the microbatches on the device."""
    grad_fn = _value_and_grad(
        make_loss_fn(model_cfg, train_cfg.remat, train_cfg.resid_tp))
    nm = train_cfg.num_microbatches
    acc_dt = layers.to_dtype(train_cfg.grad_accum_dtype)

    def compute_grads(params, batch):
        if nm == 1:
            return grad_fn(params, batch)
        micro = split_batch(batch, nm)
        loss_sum, g_acc, rows = None, None, None
        for i in range(nm):
            loss, aux, g = grad_fn(params, tree.tree_map(lambda x: x[i],
                                                         micro), mb=i)
            with telemetry.span("train.accumulate", mb=i):
                if g_acc is None:           # 0 + loss and 0 + g: exact
                    loss_sum = loss.float()
                    g_acc = tree.tree_map(lambda b: b.to(acc_dt), g)
                    rows = aux.get("moe_rows")
                else:
                    loss_sum = loss_sum + loss
                    tree.tree_map(lambda a, b: a.add_(b.to(acc_dt)), g_acc,
                                  g)
                    if rows is not None:
                        rows = rows + aux["moe_rows"]
                del g
                if i == nm - 1:     # the mean, in the last one's span
                    # A fill on the device: a CUDA graph can hold it,
                    # where a tensor made from a host value is a copy
                    # from pageable memory that capture refuses.
                    n = torch.full((), float(nm), dtype=torch.float32,
                                   device=loss_sum.device)
                    grads = tree.tree_map(
                        lambda g: g.div_(n).to(torch.float32), g_acc)
                    loss = loss_sum / n
        metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        if rows is not None:
            metrics["moe_rows"] = rows
        return loss, metrics, grads

    return compute_grads


def _graph_inputs(params, batch):
    """(parameter leaves, batch leaves with their paths) when a CUDA
    graph can take the call: every leaf a plain tensor (not a DTensor)
    on one CUDA device, and no sharding context active (under one the
    layers place their tensors on its mesh, and ``resid_tp`` acts).
    Else None."""
    if current_ctx() is not None:
        return None
    leaves = tree.leaves(params)
    inputs = tree.leaves_with_path(batch)
    if not leaves or leaves[0].device.type != "cuda":
        return None
    dev = leaves[0].device
    if all(type(x) is torch.Tensor and x.device == dev
           for x in leaves + [x for _, x in inputs]):
        return leaves, inputs
    return None


class Replayed:
    """``compute(params, batch)``, replayed from one CUDA graph where the
    input lets it be, else run eagerly.

    A call can be replayed when ``_graph_inputs`` admits it, its
    parameter leaves are the tensors of the previous call (the same
    objects at the same addresses: the graph reads them where they
    live, so an optimizer that updates them in place keeps the graph
    valid) and its batch has the previous call's paths, shapes and
    dtypes. The first such call, the second of a run, captures the pass
    and replays it; later ones copy the batch into the graph's own and
    replay. Any other call runs eagerly and drops the graph, freeing its
    memory pool, so that a new run of such calls captures anew. Only
    weak references to the previous call's parameters are kept.

    Capture follows ``torch.cuda.graphs``' rules: one warm-up pass on
    the stream captured on (the graph's entry then synchronises and
    empties the allocator's cache, so the eager step's cached blocks do
    not sit beside the new pool), and ``thread_local`` capture, since
    the heartbeat, courier and data threads share the learner's
    process. Callers sharing one instance take turns.

    A replayed call returns the graph's outputs: the next call
    overwrites them, and dropping the graph leaves them to the caller.
    """

    def __init__(self, compute, num_micro: int):
        self._compute = compute
        self._num_micro = num_micro
        self._lock = threading.Lock()
        self._seen = None    # the previous call's parameters and batch
        self._graph = None   # (CUDAGraph, its batch, its outputs)
        self._stream = None  # captured on; kept, with its cuBLAS workspaces
        reg = telemetry.metrics()
        self._captures = reg.counter("train.graph.captures")
        self._replays = reg.counter("train.graph.replays")
        self._eager = reg.counter("train.graph.eager")

    def __call__(self, params, batch):
        inputs = _graph_inputs(params, batch)
        with self._lock:
            if inputs is not None and self._same_as_seen(*inputs):
                if self._graph is None:
                    self._capture(params, batch)
                return self._replay(batch)
            self._drop()
            self._seen = None if inputs is None else (
                [(weakref.ref(x), x.data_ptr()) for x in inputs[0]],
                _layout(inputs[1]))
        self._eager.inc()
        return self._compute(params, batch)

    def _same_as_seen(self, leaves, batch_leaves) -> bool:
        if self._seen is None:
            return False
        refs, layout = self._seen
        return (len(refs) == len(leaves)
                and all(ref() is x and ptr == x.data_ptr()
                        for (ref, ptr), x in zip(refs, leaves))
                and layout == _layout(batch_leaves))

    def _capture(self, params, batch) -> None:
        dev = tree.leaves(params)[0].device
        with telemetry.span("train.capture", microbatches=self._num_micro), \
                telemetry.activate(None):
            static = tree.tree_map(torch.clone, batch)
            if self._stream is None or self._stream.device != dev:
                self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                self._compute(params, static)            # warm-up
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = self._compute(params, static)
        self._graph = (graph, static, out)
        self._captures.inc()

    def _replay(self, batch):
        graph, static, out = self._graph
        with telemetry.span("train.replay", microbatches=self._num_micro):
            tree.tree_map(lambda dst, src: dst.copy_(src), static, batch)
            graph.replay()
        self._replays.inc()
        return out

    def _drop(self) -> None:
        if self._graph is not None:
            self._graph = None
            torch.cuda.empty_cache()


def _layout(batch_leaves) -> list:
    return [(path, x.shape, x.dtype) for path, x in batch_leaves]


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    compute_grads = make_grad_fn(model_cfg, train_cfg)

    def train_step(params, opt_state, batch):
        loss, aux, grads = compute_grads(params, batch)
        params, opt_state, om = opt_lib.apply_updates(
            train_cfg.optimizer, params, grads, opt_state)
        metrics = {"loss": loss, **aux, **om}
        return params, opt_state, metrics

    return train_step


def make_train_state(model_cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Seeded master weights in ``cfg.param_dtype`` on ``device`` (a CUDA
    device must exist unless ``device="cpu"``) and a zero AdamW state."""
    params = transformer.init_params(model_cfg, seed,
                                     device=resolve_device(device),
                                     dtype=model_cfg.param_dtype)
    return params, opt_lib.init_opt_state(params)


def train_state_shapes(model_cfg: ModelConfig):
    """(params, opt_state) as meta tensors (no allocation): the JAX
    package's ``train_state_shapes`` for the dry run. ``step`` is the
    CPU int32 scalar ``init_opt_state`` makes."""
    params = transformer.param_shapes(model_cfg)
    return params, opt_lib.init_opt_state(params)
