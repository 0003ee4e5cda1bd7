"""Dry-run cell construction: the port of ``repro.launch.cells``.

Per (arch x shape): the step function, its inputs as meta tensors (no
allocation), their shardings on a ``DeviceMesh``, and the napkin-math
cell plan (microbatching / remat / residual sharding) that makes a cell
fit a card's memory. ``trace_cell`` runs the step once under
``FakeTensorMode`` on DTensor arguments, inside the mesh's sharding
context, and returns ``roofline.analysis.cost_of``'s record: per-device
FLOPs, bytes, collectives and peak memory.

The step takes the card's route: attention through the flash kernels'
custom ops (prefill; decode where the cache is not split over TP), the
RG-LRU and selective scans through theirs, training on its own route
(``impl="train"``: the flash backward takes no DTensor, so a sharded
step's attention runs dense).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.models.config import ALL_SHAPES, ModelConfig, ShapeConfig
from repro_torch.launch.mesh import dp_axes
from repro_torch.roofline import analysis, hw
from repro_torch.serve import decode as serve_lib
from repro_torch.sharding import ShardingCtx, use_sharding
from repro_torch.sharding.compat import mesh_sizes
from repro_torch.sharding.rules import (batch_shardings, batch_spec,
                                        fit_spec, param_sharding,
                                        placements)
from repro_torch.train import tree
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                          train_state_shapes)

SHAPES = {s.name: s for s in ALL_SHAPES}

# The JAX package budgets 2.5e9 bytes of live activations a 16 GiB chip;
# the same share of an H100's memory.
JAX_BUDGET, JAX_HBM = 2.5e9, 16 * 1024 ** 3
DEFAULT_BUDGET = JAX_BUDGET * hw.HBM_BYTES / JAX_HBM

# The kernels' route, asked for by name: on a CPU-only build the planning
# mesh is of CPU devices (see ``sharding.compat``), where "auto" would
# pick the dense route.
ROUTE = "flash"


# ---------------------------------------------------------------------------
# Cell plan: napkin math -> microbatching / remat / residual sharding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CellPlan:
    num_microbatches: int = 1
    remat: str = "full"
    grad_accum_dtype: str = "float32"
    resid_tp: bool = False        # shard saved residuals over TP (FSDP+SP)
    unroll_micro: bool = False    # the JAX package's probes; a no-op here
    notes: str = ""


def _train_mem_estimate(cfg: ModelConfig, shape: ShapeConfig, mesh,
                        nm: int, resid_tp: bool) -> float:
    """Per-device live activation bytes at microbatch size b_local/nm."""
    sizes = mesh_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    tp = sizes.get("model", 1)
    bm = max(shape.global_batch // dp // nm, 1)
    S = shape.seq_len
    # remat=full saves superblock inputs [bm, S, D] bf16 per layer.
    width_factor = 2.0 if cfg.family == "ssm" else 1.0
    resid = bm * S * cfg.d_model * 2 * cfg.num_layers * width_factor
    if resid_tp:
        resid /= tp
    # Live attention logits (f32 + softmax copy), padded heads over TP.
    attn = 0.0
    if cfg.num_heads:
        hp = cfg.num_heads + ((-cfg.num_heads) % tp)
        span = min(S, cfg.window or S)
        attn = bm * (hp / tp) * min(S, 2048 * 2) * span * 4 * 2
    return resid + attn


def plan_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
              budget: float = DEFAULT_BUDGET) -> CellPlan:
    """Microbatches double until the activation estimate fits ``budget``
    bytes; a microbatch of one row that still does not fit shards the
    saved residuals over TP."""
    if shape.kind != "train":
        return CellPlan(notes="forward-only: no activation accumulation")
    sizes = mesh_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    b_local = max(shape.global_batch // dp, 1)
    nm, resid_tp = 1, False
    while nm < b_local and _train_mem_estimate(cfg, shape, mesh, nm,
                                               resid_tp) > budget:
        nm *= 2
    if _train_mem_estimate(cfg, shape, mesh, nm, resid_tp) > budget:
        resid_tp = True   # microbatch of 1 still too big: SP the residuals
    est = _train_mem_estimate(cfg, shape, mesh, nm, resid_tp)
    accum = "bfloat16" if cfg.param_count() > 5e10 else "float32"
    return CellPlan(num_microbatches=nm, remat="full",
                    grad_accum_dtype=accum, resid_tp=resid_tp,
                    notes=f"b_local={b_local} est_act={est/1e9:.2f}GB")


# ---------------------------------------------------------------------------
# Shardings: trees of (mesh, placements)
# ---------------------------------------------------------------------------

def _dp(mesh):
    axes = dp_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def state_shardings(mesh, state_tree):
    """Decode-state sharding: batch over DP; KV heads (or failing that the
    cache length), recurrent widths over TP. Leaves under ``blocks`` are
    stacked on a leading repeat axis, as in the JAX package."""
    dp = _dp(mesh)
    tp = mesh_sizes(mesh)["model"]

    def leaf(path, x):
        name = str(path[-1])
        stacked = "blocks" in path
        core = x.shape[1:] if stacked else x.shape
        if name in ("k", "v", "k_mem", "v_mem"):     # [B, L, KV, dh]
            spec = [dp, None, "model", None]
            if core[2] % tp:
                spec = [dp, "model", None, None]     # shard cache length
        elif name == "h" and len(core) == 3:          # mamba [B, Di, N]
            spec = [dp, "model", None]
        elif name == "h":                             # rg-lru [B, W]
            spec = [dp, "model"]
        elif name == "conv":                          # [B, K-1, W/Di]
            spec = [dp, None, "model"]
        else:
            spec = [None] * len(core)
        if stacked:
            spec = [None] + spec
        return mesh, placements(mesh, fit_spec(mesh, x.shape, spec))

    return tree.map_with_path(leaf, state_tree)


# ---------------------------------------------------------------------------
# Abstract inputs: meta tensors
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model-input batch for one step (the paper-shape cell)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((B, 1), torch.int32)}
    batch: dict[str, Any] = {}
    if cfg.family == "audio":
        batch["embeddings"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        if shape.kind == "train":
            batch["targets"] = _meta((B, S), torch.int32)
            batch["mask"] = _meta((B, S), torch.float32)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), torch.int32)
        if cfg.family == "vlm":
            batch["image_embeds"] = _meta((B, cfg.frontend_tokens,
                                           cfg.d_model), torch.bfloat16)
    return batch


def serve_param_shapes(cfg: ModelConfig):
    """Inference params are bf16."""
    return tree.tree_map(
        lambda t: _meta(t.shape, torch.bfloat16 if t.dtype == torch.float32
                        else t.dtype), transformer.param_shapes(cfg))


def input_specs(arch: str, shape_name: str) -> dict:
    """Meta-tensor stand-ins for every model input of the given cell."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    specs = {"batch": batch_specs(cfg, shape)}
    if shape.kind == "train":
        params, opt = train_state_shapes(cfg)
        specs["params"], specs["opt_state"] = params, opt
    else:
        specs["params"] = serve_param_shapes(cfg)
        if shape.kind == "decode":
            specs["state"] = transformer.decode_state_spec(
                cfg, shape.global_batch, shape.seq_len)
    return specs


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellStep:
    fn: Any
    args: tuple                  # meta tensors (and plain values)
    shardings: tuple             # (mesh, placements) trees, None: as is
    plan: CellPlan
    model_flops_per_device: float


def _model_flops(cfg: ModelConfig, shape: ShapeConfig, n_dev: int) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / n_dev
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / n_dev
    return 2.0 * n_active * shape.global_batch / n_dev  # decode: 1 tok/seq


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               plan: Optional[CellPlan] = None) -> CellStep:
    plan = plan or plan_cell(cfg, shape, mesh)
    mflops = _model_flops(cfg, shape, mesh.size())
    batch = batch_specs(cfg, shape)
    batch_sh = batch_shardings(mesh, batch)

    if shape.kind == "train":
        tc = TrainConfig(
            optimizer=OptimizerConfig(),
            num_microbatches=plan.num_microbatches,
            remat=plan.remat,
            grad_accum_dtype=plan.grad_accum_dtype,
            resid_tp=plan.resid_tp,
            unroll_micro=plan.unroll_micro)
        params, opt = train_state_shapes(cfg)
        return CellStep(
            fn=make_train_step(cfg, tc), args=(params, opt, batch),
            shardings=(param_sharding(params, mesh),
                       param_sharding(opt, mesh), batch_sh),
            plan=plan, model_flops_per_device=mflops)

    params = serve_param_shapes(cfg)
    p_sh = param_sharding(params, mesh)

    if shape.kind == "prefill":
        if cfg.decode_supported:
            fn = serve_lib.make_prefill(cfg, context_len=shape.seq_len,
                                        impl=ROUTE)

            def prefill_fn(params, batch):
                logits, state = fn(params, batch.get("tokens"),
                                   memory=batch.get("image_embeds"),
                                   embeddings=batch.get("embeddings"))
                return logits.to(torch.bfloat16), state
        else:
            def prefill_fn(params, batch):
                hidden, _ = transformer.forward(
                    cfg, params, tokens=batch.get("tokens"),
                    embeddings=batch.get("embeddings"),
                    memory=batch.get("image_embeds"), impl=ROUTE)
                logits = transformer.logits_from_hidden(cfg, params, hidden)
                return logits.to(torch.bfloat16)
        return CellStep(fn=prefill_fn, args=(params, batch),
                        shardings=(p_sh, batch_sh), plan=plan,
                        model_flops_per_device=mflops)

    # decode: one token at the last position of a full context
    state = transformer.decode_state_spec(cfg, shape.global_batch,
                                          shape.seq_len)
    serve_step = serve_lib.make_serve_step(cfg, attn_impl=ROUTE)

    def decode_fn(params, state, tokens, t):
        return serve_step(params, state, tokens, t)

    return CellStep(
        fn=decode_fn, args=(params, state, batch["tokens"],
                            shape.seq_len - 1),
        shardings=(p_sh, state_shardings(mesh, state), batch_sh["tokens"],
                   None),
        plan=plan, model_flops_per_device=mflops)


def _placed(meta: torch.Tensor, sharding, device) -> torch.Tensor:
    """A fake DTensor of ``meta``'s global shape and dtype, this rank's
    shard of it placed as ``sharding`` says (inside FakeTensorMode).
    A CPU scalar (the optimizer's step) stays a plain CPU tensor."""
    if meta.device.type != "meta":
        return torch.zeros(meta.shape, dtype=meta.dtype)
    mesh, pl = sharding
    full = torch.empty(meta.shape, dtype=meta.dtype, device=device)
    local = full
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            local = local.tensor_split(n, dim=p.dim)[0]
    return DTensor.from_local(torch.empty(local.shape, dtype=meta.dtype,
                                          device=device),
                              mesh, pl, run_check=False,
                              shape=meta.shape, stride=full.stride())


def sharding_ctx(mesh) -> ShardingCtx:
    return ShardingCtx(mesh, dp=dp_axes(mesh), tp=("model",))


def trace_cell(cell: CellStep, mesh) -> analysis.TraceRecord:
    """Run the cell's step once on fake DTensor arguments (nothing is
    allocated) under the mesh's sharding context, counting what each
    device runs: the counterpart of the JAX package's ``lower_cell``.
    The fake tensors lie on the mesh's device type."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    device = mesh.device_type
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        args = tuple(
            a if sh is None else tree.tree_map(
                lambda m, s: _placed(m, s, device), a, sh)
            for a, sh in zip(cell.args, cell.shardings))
        with use_sharding(sharding_ctx(mesh)):
            _, rec = analysis.cost_of(cell.fn, args, mesh)
    return rec
