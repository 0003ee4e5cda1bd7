"""The port's CUDA kernels and engine on a card (``gpu`` marker).

Skipped where no CUDA device is present. This file imports neither JAX
nor the JAX package, so it also runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because the shared conftest resets the JAX package's
courier registry.)
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ref
from repro_torch.models import transformer
from repro_torch.serve.engine import ServeEngine

# Kernel and plain version both accumulate in fp32: a float32 output
# differs by summation order, a bf16 one by at most a rounding step, so
# its bound is 2 bf16 ulps at the largest |plain| value (as chip_smoke).
REL_L2_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _assert_matches_plain(out, expect):
    e = expect.float()
    scale = e.abs().max().item()
    atol = (2 * 2.0 ** (math.floor(math.log2(scale)) - 7)
            if out.dtype == torch.bfloat16 and scale > 0 else 2e-5)
    torch.testing.assert_close(out.float(), e, rtol=0, atol=atol)
    err = (out.float() - e).norm().item()
    assert err <= REL_L2_TOL[out.dtype] * e.norm().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
def test_cuda_kernels_match_plain(cuda, dtype, dh):
    gen = torch.Generator(device=cuda).manual_seed(dh)
    B, H, KV, L = 3, 12, 2, 777
    q = _randn(gen, (B, H, dh), dtype, cuda)
    k = _randn(gen, (B, L, KV, dh), dtype, cuda)
    v = _randn(gen, (B, L, KV, dh), dtype, cuda)
    valid = torch.rand((B, L), generator=gen, device=cuda) < 0.6
    valid[1] = False                                  # all-invalid row
    before = dec.launches["decode_attention"]
    out = dec.decode_attention(q, k, v, valid)
    assert dec.launches["decode_attention"] == before + 1
    _assert_matches_plain(out, ref.decode_attention(q, k, v, valid))
    assert torch.equal(out[1], torch.zeros_like(out[1]))

    P, n, ps = 13, 5, 16
    kp = _randn(gen, (P, ps, KV, dh), dtype, cuda)
    vp = _randn(gen, (P, ps, KV, dh), dtype, cuda)
    pages = torch.randint(0, P, (B, n), generator=gen, device=cuda,
                          dtype=torch.int32)
    pages[:, -1] = 0
    pages[2] = pages[0]
    pvalid = torch.rand((B, n * ps), generator=gen, device=cuda) < 0.6
    out = dec.paged_decode_attention(q, kp, vp, pages, pvalid)
    _assert_matches_plain(out,
                          ref.paged_decode_attention(q, kp, vp, pages, pvalid))


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 4, 48), device=cuda)          # dh 48: no instance
    k = torch.zeros((1, 64, 2, 48), device=cuda)
    valid = torch.ones((1, 64), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        dec.decode_attention(q, k, k, valid)
    q = torch.zeros((1, 4, 64), device=cuda)
    k = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="bool"):
        dec.decode_attention(q, k, k, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        dec.decode_attention(q, k.transpose(1, 2), k.transpose(1, 2),
                             valid)


@pytest.mark.gpu
@pytest.mark.parametrize("page_size", [None, 4])
def test_cuda_engine_flash_matches_dense(cuda, page_size):
    """The reduced config's engine on the card: greedy tokens through the
    flash-decode kernels equal the dense attention path's."""
    import dataclasses
    cfg = dataclasses.replace(configs.get_reduced("qwen2-1.5b"),
                              compute_dtype="float32")
    params = transformer.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 12, 7)]
    outs = []
    for impl in ("dense", "flash"):
        eng = ServeEngine(cfg, params, num_slots=2, context_len=24,
                          max_new=4, sync_every=1, decode_impl=impl,
                          page_size=page_size, num_pages=16, device=cuda)
        futs = [eng.submit(p) for p in prompts]
        while not all(f.done() for f in futs):
            eng.step()
        outs.append([f.result() for f in futs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
