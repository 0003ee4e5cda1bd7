"""Registry of assigned architectures. ``get(name)`` / ``--arch <id>``."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_ARCHS = {
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-1.5b": "qwen2_1_5b",
    "command-r-plus-104b": "command_r_plus_104b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-8b": "qwen3_8b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mixtral-8x7b": "mixtral_8x7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

ARCH_NAMES = tuple(_ARCHS)


def get(name: str) -> ModelConfig:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
    return mod.CONFIG


def get_reduced(name: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
    return mod.reduced()
