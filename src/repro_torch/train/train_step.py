"""Training step factory: remat + microbatch accumulation + AdamW — the
port of ``repro.train.train_step``.

``make_train_step`` builds a ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` for a given model/optimizer config. Microbatches
run one after another in a Python loop, accumulating fp32 gradients, so
arbitrary global batches fit; the remat policy trades activation memory
for a second forward pass.

The loss runs the dense attention and plain scans (``impl="dense"``),
as the JAX loss runs XLA's attention and associative scans: the CUDA
kernels have no backward pass, because the JAX package's kernels have
none. Master weights are ``cfg.param_dtype`` (fp32) and compute is
``cfg.compute_dtype``: the layers cast each weight as they read it, and
the gradient comes back through that cast in fp32.

Under a sampled trace context (``core.telemetry``) each microbatch
records ``train.forward``, ``train.backward`` and, with several
microbatches, ``train.accumulate``, each with its index ``mb``; without
one each span is a context-variable read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core import telemetry
from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import resolve_device
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
                                   remat=use_remat, impl="dense",
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
    (ROADMAP.md C16)."""
    grad_fn = _value_and_grad(
        make_loss_fn(model_cfg, train_cfg.remat, train_cfg.resid_tp))
    nm = train_cfg.num_microbatches
    acc_dt = layers.to_dtype(train_cfg.grad_accum_dtype)

    def compute_grads(params, batch):
        if nm == 1:
            return grad_fn(params, batch)
        micro = split_batch(batch, nm)
        loss_sum, g_acc = None, None
        for i in range(nm):
            loss, _aux, g = grad_fn(params, tree.tree_map(lambda x: x[i],
                                                          micro), mb=i)
            with telemetry.span("train.accumulate", mb=i):
                if g_acc is None:           # 0 + loss and 0 + g: exact
                    loss_sum = loss.float()
                    g_acc = tree.tree_map(lambda b: b.to(acc_dt), g)
                else:
                    loss_sum = loss_sum + loss
                    tree.tree_map(lambda a, b: a.add_(b.to(acc_dt)), g_acc,
                                  g)
                del g
                if i == nm - 1:     # the mean, in the last one's span
                    n = torch.tensor(float(nm), dtype=torch.float32,
                                     device=loss_sum.device)
                    grads = tree.tree_map(
                        lambda g: g.div_(n).to(torch.float32), g_acc)
                    loss = loss_sum / n
        return loss, {"ce": loss, "aux": torch.zeros_like(loss)}, grads

    return compute_grads


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
