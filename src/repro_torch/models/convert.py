"""Move parameter trees between the JAX package's layout and the port's.

The JAX tree stacks every ``blocks`` leaf along a leading repeat axis
(``repro/models/transformer.py:79-91``); the port keeps one superblock
dict per repeat, so that axis is unstacked here — RG-LRU leaves (``in_x``,
``in_gate``, ``conv1d`` [K,W], ``gate_a``/``gate_x`` [heads,blk,blk],
``bias_a``/``bias_x``, ``lam``, ``out``) and Mamba leaves (``in_proj``,
``conv1d`` [K,Di], ``conv_bias``, ``x_proj``, ``dt_proj``, ``A_log``
[Di,N], ``D``, ``out_proj``) like every other; a Mamba block has no MLP
leaves. Norm scales, the RG-LRU ``lam`` and the Mamba ``A_log`` and ``D``
stay fp32 (they are used in fp32: ``-exp(A_log)``, ``u * D``, so a bf16
copy would change the numbers); every other leaf is stored once in the
compute dtype, which the forward pass reads without a per-call cast.

``params_to_numpy`` is the inverse: it re-stacks the per-repeat blocks
onto the leading repeat axis and writes every leaf as fp32 numpy, the
layout the JAX package keeps (``param_dtype="float32"``) and restores
from a ``ModelStore``. A bf16 leaf exports as its exact fp32 widening.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


_FP32_LEAVES = ("lam", "A_log", "D")


def _keeps_fp32(path: tuple) -> bool:
    return (path[-1] in _FP32_LEAVES
            or any(str(k).endswith("norm") for k in path))


def _convert(tree: Any, path: tuple, device, dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, path + (k,), device, dtype)
                for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, dtype=np.float32))   # own copy
    return t.to(device=device,
                dtype=torch.float32 if _keeps_fp32(path) else dtype)


def _unstack(tree: Any, r: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> dict:
    """``tree``: the JAX ``init_params`` tree with numpy (or array-like)
    leaves. Returns the port's parameter dict on ``device``, matrices in
    ``dtype`` (default: the config's compute dtype)."""
    dtype = layers.to_dtype(dtype or cfg.compute_dtype)
    device = torch.device(device)
    out: dict[str, Any] = {}
    for key, sub in tree.items():
        if key == "blocks":
            out["blocks"] = [_convert(_unstack(sub, r), (key,), device, dtype)
                             for r in range(cfg.num_repeats)]
        else:
            out[key] = _convert(sub, (key,), device, dtype)
    return out


def _export(parts: list, stacked: bool) -> Any:
    """``parts``: the same subtree once per repeat (or once). Each leaf
    is copied, cast to fp32, into one fresh numpy array — stacked on a
    leading axis when ``stacked``."""
    if isinstance(parts[0], dict):
        return {k: _export([p[k] for p in parts], stacked) for k in parts[0]}
    out = np.empty((len(parts),) + tuple(parts[0].shape), np.float32)
    dst = torch.from_numpy(out)
    for r, leaf in enumerate(parts):
        dst[r].copy_(leaf.detach())
    return out if stacked else out[0]


def params_to_numpy(cfg: ModelConfig, params: dict) -> dict:
    """The port's parameter dict as the JAX ``init_params`` tree: fp32
    numpy leaves with the JAX tree's keys, ``blocks`` stacked on the
    repeat axis. Inverse of :func:`params_from_numpy`."""
    if len(params.get("blocks", [])) != cfg.num_repeats:
        raise ValueError(f"expected {cfg.num_repeats} block repeats, got "
                         f"{len(params.get('blocks', []))}")
    return {key: _export(sub if key == "blocks" else [sub], key == "blocks")
            for key, sub in params.items()}


def train_state_to_numpy(cfg: ModelConfig, state: dict) -> dict:
    """A training state ``{"params", "opt": {"m", "v", "step"}, "ef"}``
    (any of the three) as the JAX package's tree: every parameter-shaped
    tree through :func:`params_to_numpy`, ``step`` an int32 scalar. This
    is what a learner publishes to the ``ModelStore``."""
    out: dict[str, Any] = {}
    for key in ("params", "ef"):
        if key in state:
            out[key] = params_to_numpy(cfg, state[key])
    if "opt" in state:
        opt = state["opt"]
        out["opt"] = {"m": params_to_numpy(cfg, opt["m"]),
                      "v": params_to_numpy(cfg, opt["v"]),
                      "step": np.asarray(int(opt["step"]), np.int32)}
    return out


def train_state_from_numpy(cfg: ModelConfig, tree: dict,
                           device="cuda") -> dict:
    """Inverse of :func:`train_state_to_numpy`: parameters and moments in
    ``cfg.param_dtype`` (the master weights), the error-feedback residual
    in fp32, on ``device``; ``step`` a CPU int32 scalar."""
    param_dt = layers.to_dtype(cfg.param_dtype)
    out: dict[str, Any] = {}
    if "params" in tree:
        out["params"] = params_from_numpy(cfg, tree["params"], device,
                                          param_dt)
    if "opt" in tree:
        opt = tree["opt"]
        out["opt"] = {
            "m": params_from_numpy(cfg, opt["m"], device, param_dt),
            "v": params_from_numpy(cfg, opt["v"], device, param_dt),
            "step": torch.tensor(int(np.asarray(opt["step"])),
                                 dtype=torch.int32)}
    if "ef" in tree:
        out["ef"] = params_from_numpy(cfg, tree["ef"], device,
                                      torch.float32)
    return out
