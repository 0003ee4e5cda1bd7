"""Load a JAX parameter tree (numpy leaves) into the port's layout.

The JAX tree stacks every ``blocks`` leaf along a leading repeat axis
(``repro/models/transformer.py:79-91``); the port keeps one superblock
dict per repeat, so that axis is unstacked here. Norm scales stay fp32
(the norms compute in fp32); every other leaf is stored once in the
compute dtype, which the forward pass reads without a per-call cast.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def _is_norm(path: tuple) -> bool:
    return any(str(k).endswith("norm") for k in path)


def _convert(tree: Any, path: tuple, device, dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, path + (k,), device, dtype)
                for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, dtype=np.float32))   # own copy
    return t.to(device=device,
                dtype=torch.float32 if _is_norm(path) else dtype)


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
