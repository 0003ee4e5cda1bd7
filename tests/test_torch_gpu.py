"""The port's CUDA kernels and engine on a card (``gpu`` marker).

Skipped where no CUDA device is present. This file imports neither JAX
nor the JAX package, so it also runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because the shared conftest resets the JAX package's
courier registry.)
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import transformer
from repro_torch.serve.engine import ServeEngine

# Kernel and plain version both accumulate in fp32: a float32 output
# differs by summation order, a bf16 one by at most a rounding step, so
# its bound is 2 bf16 ulps at the largest |plain| value of its row (one
# head's output vector), as in chip_smoke.
REL_L2_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _assert_matches_plain(out, expect):
    e = expect.float()
    if out.dtype == torch.bfloat16:
        row_max = e.abs().amax(dim=-1, keepdim=True)
        atol = 2 * torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    else:
        atol = torch.full_like(e, 2e-5)
    err = (out.float() - e).abs()
    assert bool((err <= atol).all()), float((err - atol).max())
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
@pytest.mark.parametrize("H,KV", [(12, 2), (10, 1)])  # Qwen2, RecurrentGemma
def test_cuda_kernels_match_plain(cuda, dtype, dh, H, KV):
    gen = torch.Generator(device=cuda).manual_seed(dh)
    B, L = 3, 777
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("case", [
    # B, Sq, Sk, H, KV, causal, window
    (2, 200, 200, 4, 2, True, None),          # ragged S
    (1, 70, 333, 6, 1, True, 100),            # right-aligned, windowed
    (2, 65, 129, 4, 4, False, None),          # encoder
    (1, 300, 1000, 4, 2, True, 130),          # ragged, windowed, Sq < Sk
])
def test_cuda_flash_attention_matches_plain(cuda, dtype, dh, case):
    B, Sq, Sk, H, KV, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(dh + Sq)
    q = _randn(gen, (B, Sq, H, dh), dtype, cuda)
    k = _randn(gen, (B, Sk, KV, dh), dtype, cuda)
    v = _randn(gen, (B, Sk, KV, dh), dtype, cuda)
    before = fa.launches["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches["flash_attention"] == before + 1
    _assert_matches_plain(out, ref.flash_attention(q, k, v, causal, window))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # B, S, H, KV, dh, window: Qwen2-1.5B and RecurrentGemma-2B LOCAL
    (1, 1536, 12, 2, 128, None),
    (1, 3072, 10, 1, 256, 2048),
])
def test_cuda_flash_attention_full_prefill_shapes(cuda, case):
    """bf16 (the tensor-core kernel) at the serving path's prefill shapes."""
    B, S, H, KV, dh, window = case
    gen = torch.Generator(device=cuda).manual_seed(S)
    q = _randn(gen, (B, S, H, dh), torch.bfloat16, cuda)
    k = _randn(gen, (B, S, KV, dh), torch.bfloat16, cuda)
    v = _randn(gen, (B, S, KV, dh), torch.bfloat16, cuda)
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    _assert_matches_plain(out, ref.flash_attention(q, k, v, True, window))


@pytest.mark.gpu
def test_cuda_decode_attention_repeats_bit_identical(cuda):
    """Calls in a row give the same bits: the split kernel's counters go
    back to 0 after each call. RecurrentGemma's decode shape (B=8, 10/1
    heads, dh 256, L 2048) with an all-invalid row."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    B, H, KV, dh, L = 8, 10, 1, 256, 2048
    q = _randn(gen, (B, H, dh), torch.bfloat16, cuda)
    k = _randn(gen, (B, L, KV, dh), torch.bfloat16, cuda)
    v = _randn(gen, (B, L, KV, dh), torch.bfloat16, cuda)
    valid = torch.rand((B, L), generator=gen, device=cuda) < 0.7
    valid[3] = False
    _, n_splits = dec.split_plan(L, B * KV, H // KV, 2,
                                 dec._num_sms(q.device))
    assert n_splits > 1
    outs = [dec.decode_attention(q, k, v, valid) for _ in range(3)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    assert torch.equal(outs[0][3], torch.zeros_like(outs[0][3]))
    _assert_matches_plain(outs[0], ref.decode_attention(q, k, v, valid))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [(1, 3072, 2560), (3, 37, 100)])
def test_cuda_rglru_scan_matches_plain(cuda, dtype, B, S, W):
    """Multiply then add, each rounded, in both: bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    a = (0.8 + 0.199 * torch.rand((B, S, W), generator=gen,
                                  device=cuda)).to(dtype)
    x = _randn(gen, (B, S, W), dtype, cuda)
    h0 = torch.randn((B, W), generator=gen, device=cuda)
    before = rg.launches["rglru_scan"]
    y, h = rg.rglru_scan(a, x, h0)
    assert rg.launches["rglru_scan"] == before + 1
    ye, he = ref.rglru_scan(a, x, h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y, ye, rtol=0, atol=0)
    torch.testing.assert_close(h, he, rtol=0, atol=0)


def _ssm_inputs(gen, B, S, Di, N, dtype, device):
    """u in ``dtype``, the rest fp32, at the model's scale: Δ a softplus,
    A = -(1..N) per channel, non-zero h0."""
    u = _randn(gen, (B, S, Di), dtype, device)
    delta = torch.nn.functional.softplus(
        torch.randn((B, S, Di), generator=gen, device=device))
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=device).repeat(Di, 1)
    Bc = torch.randn((B, S, N), generator=gen, device=device)
    Cc = torch.randn((B, S, N), generator=gen, device=device)
    D = torch.randn((Di,), generator=gen, device=device)
    h0 = torch.randn((B, Di, N), generator=gen, device=device)
    return u, delta, A, Bc, Cc, D, h0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N", [(1, 2048, 8192, 16),  # Falcon-Mamba-7B
                                      (3, 1001, 333, 8), (2, 7, 100, 4),
                                      (1, 1, 64, 16)])
def test_cuda_ssm_scan_matches_plain(cuda, dtype, B, S, Di, N):
    """y to the plain loop's tolerance (the sum over N runs in another
    order); h_last multiplies then adds, each rounded, as the plain loop
    does, so it is held to the fp32 limit."""
    gen = torch.Generator(device=cuda).manual_seed(S + Di)
    args = _ssm_inputs(gen, B, S, Di, N, dtype, cuda)
    before = ss.launches["ssm_scan"]
    y, h = ss.ssm_scan(*args)
    assert ss.launches["ssm_scan"] == before + 1
    ye, he = ref.ssm_scan(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    _assert_matches_plain(y, ye)
    _assert_matches_plain(h, he)


@pytest.mark.gpu
def test_cuda_prefill_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)       # dh 48: no instance
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="more queries"):
        fa.flash_attention(q, q[:, :4].contiguous(), q[:, :4].contiguous())
    a = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(TypeError, match="h0"):
        rg.rglru_scan(a, a, torch.zeros((1, 16), device=cuda,
                                        dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        rg.rglru_scan(a.transpose(1, 2), a.transpose(1, 2),
                      torch.zeros((1, 8), device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = list(_ssm_inputs(gen, 1, 8, 16, 32, torch.float32, cuda))
    with pytest.raises(ValueError, match="state size"):
        ss.ssm_scan(*args)                            # N 32: not built
    args = list(_ssm_inputs(gen, 1, 8, 16, 16, torch.float32, cuda))
    with pytest.raises(TypeError, match="delta"):
        ss.ssm_scan(args[0], args[1].to(torch.bfloat16), *args[2:])
    bc = torch.zeros((1, 8, 32), device=cuda)         # B/C split views
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssm_scan(*args[:3], bc[..., :16], bc[..., 16:], *args[5:])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,page_size", [("qwen2-1.5b", None),
                                            ("qwen2-1.5b", 4),
                                            ("recurrentgemma-2b", None),
                                            ("falcon-mamba-7b", None)])
def test_cuda_engine_flash_matches_dense(cuda, arch, page_size):
    """The reduced config's engine on the card: greedy tokens through the
    kernels (prefill flash attention, the RG-LRU and selective scans,
    flash-decode) equal the plain PyTorch path's."""
    import dataclasses
    cfg = dataclasses.replace(configs.get_reduced(arch),
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
