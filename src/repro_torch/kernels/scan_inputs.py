"""Seeded inputs for the two scan kernels at the models' scale, for
holding each kernel against its plain version and timing it
(``tests/test_torch_gpu.py``, ``scripts/torch_time_kernels.py``,
``scripts/torch_tune_scan.py``).

Each draws from ``gen`` in a fixed order, so a seed gives the same
tensors wherever it is used.
"""

from __future__ import annotations

import torch


def rglru(gen: torch.Generator, B: int, S: int, W: int, dtype: torch.dtype,
          device) -> tuple:
    """a/x [B,S,W] in ``dtype`` (a in [0.8, 0.999), as the RG-LRU gate
    gives it near 1), h0 [B,W] fp32 normal."""
    a = (0.8 + 0.199 * torch.rand((B, S, W), generator=gen,
                                  device=device)).to(dtype)
    x = torch.randn((B, S, W), generator=gen, device=device).to(dtype)
    h0 = torch.randn((B, W), generator=gen, device=device)
    return a, x, h0


def ssm(gen: torch.Generator, B: int, S: int, Di: int, N: int,
        dtype: torch.dtype, device) -> tuple:
    """u in ``dtype``, the rest fp32 as the model hands them over, at its
    scale: Δ a softplus, A = -(1..N) per channel (Falcon-Mamba's A_log),
    B, C and D normal, non-zero h0."""
    u = torch.randn((B, S, Di), generator=gen, device=device).to(dtype)
    delta = torch.nn.functional.softplus(
        torch.randn((B, S, Di), generator=gen, device=device))
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=device).repeat(Di, 1)
    Bc = torch.randn((B, S, N), generator=gen, device=device)
    Cc = torch.randn((B, S, N), generator=gen, device=device)
    D = torch.randn((Di,), generator=gen, device=device)
    h0 = torch.randn((B, Di, N), generator=gen, device=device)
    return u, delta, A, Bc, Cc, D, h0
