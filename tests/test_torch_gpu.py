"""The port's CUDA kernels and engine on a card (``gpu`` marker).

Skipped where no CUDA device is present. This file imports neither JAX
nor the JAX package, so it also runs on a machine that has only the
port's dependencies, with the other card tests:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_gpu*.py tests/test_torch_train_trace.py

(``--noconftest`` because the shared conftest resets the JAX package's
courier registry.)
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_pairs as mp
from repro_torch.kernels import ref, scan_inputs
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import transformer
from repro_torch.serve.engine import ServeEngine

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from torch_time_kernels import by_kv_group  # noqa: E402

# Kernel and plain version both accumulate in fp32: a float32 output
# differs by summation order, a bf16 one by at most a rounding step, so
# its bound is 2 bf16 ulps at the largest |plain| value of its row (one
# head's output vector). On top, the relative L2 error stays below
# REL_L2_TOL. ``test_cuda_check_rejects_a_wrong_kernel`` shows the bound
# fails a wrong output.
REL_L2_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _over_tol(out, expect, grad=False):
    """By how many times ``out`` passes each bound of the plain
    ``expect``: (the worst element's |err| over its bound, the relative
    L2 error over REL_L2_TOL). A gradient (``grad``) may have rows that
    are a cancellation: dQ of the first causal query is 0 exactly (P = 1
    and dS = dout.v - delta = 0), and both sides compute it as a residue
    of fp32 rounding in dout.v - delta. Each row's bound is then the
    larger of 2 bf16 ulps at its largest |plain| value and the fp32 bound
    (2e-5) at the gradient's largest |plain| value."""
    e = expect.float()
    err = (out.float() - e).abs()
    if out.dtype == torch.bfloat16:
        row_max = e.abs().amax(dim=-1, keepdim=True)
        atol = 2 * torch.exp2(torch.floor(torch.log2(row_max)) - 7)
        if grad:
            atol = torch.maximum(atol, 2e-5 * e.abs().max())
    else:
        atol = torch.full_like(e, 2e-5)
    # An element whose bound is 0 (a row of zeros) must have no error.
    worst = torch.where(err == 0, torch.zeros_like(err), err / atol).max()
    norm, limit = err.norm().item(), REL_L2_TOL[out.dtype] * e.norm().item()
    rel = norm / limit if limit else (0.0 if norm == 0 else float("inf"))
    return worst.item(), rel


def _assert_matches_plain(out, expect, grad=False):
    worst, rel = _over_tol(out, expect, grad)
    assert worst <= 1 and rel <= 1, {"err_over_tol": worst,
                                     "rel_l2_over_tol": rel}


def _launches() -> dict:
    return {**dec.launches, **fa.launches, **rg.launches, **ss.launches,
            **mp.launches}


def _since(before: dict) -> dict:
    """Each kernel's launches since ``_launches()`` read ``before``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {k: n - before[k] for k, n in _launches().items()}


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
@pytest.mark.parametrize("H,KV", [(12, 2), (10, 1),     # Qwen2, RecurrentGemma
                                  (4, 4)])              # groups of one
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
    pvalid[1] = False                                 # all-invalid row
    out = dec.paged_decode_attention(q, kp, vp, pages, pvalid)
    _assert_matches_plain(out,
                          ref.paged_decode_attention(q, kp, vp, pages, pvalid))
    assert torch.equal(out[1], torch.zeros_like(out[1]))


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
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("case", [
    # B, Sq, Sk, H, KV, causal, window
    (2, 200, 200, 4, 2, True, None),          # ragged S
    (1, 70, 333, 6, 1, True, 100),            # right-aligned, windowed
    (2, 65, 129, 4, 4, False, None),          # encoder
    (1, 300, 1000, 4, 2, True, 130),          # ragged, windowed, Sq < Sk
    (2, 1000, 1000, 8, 2, True, None),        # ragged, 16 key tiles
    (2, 128, 640, 8, 1, True, 300),           # one KV head, windowed
    (3, 200, 200, 4, 2, True, 50),            # a window under one tile
    (1, 500, 777, 6, 3, True, None),          # right-aligned, groups of 2
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
    # B, S, H, KV, dh, window, dtype
    (1, 1536, 12, 2, 128, None, torch.bfloat16),  # Qwen2-1.5B
    (1, 3072, 10, 1, 256, 2048, torch.bfloat16),  # RecurrentGemma-2B LOCAL
    (1, 128, 32, 8, 128, 4096, torch.bfloat16),   # Mixtral-8x7B
    (2, 128, 32, 8, 128, None, torch.bfloat16),   # Llama-3.2-Vision self
    (8, 64, 12, 4, 64, None, torch.bfloat16),     # the training evaluator
    (8, 1024, 12, 2, 128, None, torch.float32),   # an fp32 Qwen2 evaluator
])
def test_cuda_flash_attention_full_prefill_shapes(cuda, case):
    """K3 at the prefill shapes of the served models and the training
    program's evaluator (bf16: the tensor-core kernel)."""
    B, S, H, KV, dh, window, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(S)
    q = _randn(gen, (B, S, H, dh), dtype, cuda)
    k = _randn(gen, (B, S, KV, dh), dtype, cuda)
    v = _randn(gen, (B, S, KV, dh), dtype, cuda)
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    _assert_matches_plain(out, ref.flash_attention(q, k, v, True, window))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # B, Sq, Sk, H, KV, dh
    (1, 1500, 1500, 16, 16, 80),      # HuBERT-XLarge: bidirectional, dh 80
    (2, 128, 1601, 32, 8, 128),       # Llama-3.2-Vision cross: Sq < Sk
    (1, 37, 1601, 4, 2, 80),          # ragged Sq and Sk, dh 80
])
def test_cuda_flash_attention_non_causal_new_shapes(cuda, dtype, case):
    """Non-causal K3 at the audio encoder's and the vision cross layers'
    shapes: with causal=False and no window the right alignment of the
    queries must not matter, and the unmasked fast path must hold for a
    ragged Sk of 1601 (25 tiles and one key)."""
    B, Sq, Sk, H, KV, dh = case
    gen = torch.Generator(device=cuda).manual_seed(Sk + dh)
    q = _randn(gen, (B, Sq, H, dh), dtype, cuda)
    k = _randn(gen, (B, Sk, KV, dh), dtype, cuda)
    v = _randn(gen, (B, Sk, KV, dh), dtype, cuda)
    out = fa.flash_attention(q, k, v, causal=False)
    _assert_matches_plain(out, ref.flash_attention(q, k, v, False, None))
    # Every query sees every key: the plain version over an all-true mask.
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=cuda)
    _assert_matches_plain(out, ref.masked_attention(q, k, v, ok))


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_all_valid_image_memory(cuda, q_dtype):
    """K1 over Llama-3.2-Vision's cross memory: L = 1601 slots, every one
    valid, bf16 K/V as the decode state stores them."""
    gen = torch.Generator(device=cuda).manual_seed(1601)
    B, H, KV, dh, L = 8, 32, 8, 128, 1601
    q = _randn(gen, (B, H, dh), q_dtype, cuda)
    k = _randn(gen, (B, L, KV, dh), torch.bfloat16, cuda)
    v = _randn(gen, (B, L, KV, dh), torch.bfloat16, cuda)
    valid = torch.ones((B, L), dtype=torch.bool, device=cuda)
    out = dec.decode_attention(q, k, v, valid)
    _assert_matches_plain(out, ref.decode_attention(q, k, v, valid))


_BF16, _FP32 = torch.bfloat16, torch.float32
_RG_FILLS = [2048, 1500, 77, 2048, 2000, 1024, 300, 2048]


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # B, H, KV, dh, slots, each row's valid slots, q dtype, page size
    (8, 12, 2, 128, 2048, [2048] * 8, _BF16, None),     # Qwen2-1.5B
    (1, 10, 1, 256, 2048, [2048], _BF16, None),         # RecurrentGemma-2B
    (3, 10, 1, 256, 2048, _RG_FILLS[:3], _FP32, None),  # LOCAL ring, fp32 q
    (8, 10, 1, 256, 2048, _RG_FILLS, _BF16, None),
    (3, 32, 8, 128, 160, [160, 145, 129], _BF16, None),  # Mixtral SWA ring
    (2, 32, 8, 128, 160, [137, 137], _BF16, None),      # Llama-Vision self
    (2, 12, 2, 128, 777, [777, 400], _FP32, None),      # fp32 q, bf16 K/V
    (8, 12, 2, 128, 2048, [2048] * 8, _BF16, 16),       # Qwen2-1.5B paged
    (3, 4, 2, 64, 40, [40, 25, 0], _FP32, 8),           # pages of 8
    (3, 4, 2, 64, 40, [40, 25, 0], _BF16, 8),
])
def test_cuda_decode_attention_serving_shapes(cuda, case):
    """K1 and K2 at the decode shapes the served models run: rows at
    different fills of a flat bf16 cache (an fp32 q over it as an fp32
    run has), and a page pool in q's dtype whose table shares a prefix
    between two rows and ends on the trash page; an empty row is
    exactly zero."""
    B, H, KV, dh, L, fills, q_dtype, ps = case
    gen = torch.Generator(device=cuda).manual_seed(L + B)
    q = _randn(gen, (B, H, dh), q_dtype, cuda)
    valid = (torch.arange(L, device=cuda)[None, :]
             < torch.tensor(fills, device=cuda)[:, None])
    if ps is None:
        k, v = (_randn(gen, (B, L, KV, dh), _BF16, cuda) for _ in range(2))
        before = dec.launches["decode_attention"]
        out = dec.decode_attention(q, k, v, valid)
        assert dec.launches["decode_attention"] == before + 1
        want = ref.decode_attention(q, k, v, valid)
    else:
        n = L // ps
        P = B * n + 1
        kp, vp = (_randn(gen, (P, ps, KV, dh), q_dtype, cuda)
                  for _ in range(2))
        pages = torch.randperm(P, generator=gen, device=cuda)
        pages = pages[:B * n].to(torch.int32).reshape(B, n).contiguous()
        pages[1, :n // 4] = pages[0, :n // 4]
        pages[:, -1] = 0
        before = dec.launches["paged_decode_attention"]
        out = dec.paged_decode_attention(q, kp, vp, pages, valid)
        assert dec.launches["paged_decode_attention"] == before + 1
        want = ref.paged_decode_attention(q, kp, vp, pages, valid)
    _assert_matches_plain(out, want)
    for b, fill in enumerate(fills):
        if not fill:
            assert torch.equal(out[b], torch.zeros_like(out[b]))


@pytest.mark.gpu
def test_cuda_flash_wrapper_takes_dh80_and_refuses_dh96(cuda):
    q = torch.zeros((1, 8, 2, 80), device=cuda)
    before = fa.launches["flash_attention"]
    out = fa.flash_attention(q, q, q, causal=False)
    assert fa.launches["flash_attention"] == before + 1
    assert bool((out == 0).all())
    q = torch.zeros((1, 8, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, causal=False)


BWD_CASES = [
    # B, Sq, Sk, H, KV, dh, causal, window
    (2, 200, 200, 4, 2, 16, True, None),      # ragged S, groups of 2
    (1, 70, 333, 8, 1, 64, True, 100),        # right-aligned, windowed, 8
    (2, 65, 129, 4, 4, 128, False, None),     # encoder, groups of 1
    (1, 300, 1000, 4, 2, 80, True, 130),      # dh 80, windowed, Sq < Sk
    (2, 128, 160, 8, 2, 32, False, None),     # cross-attention, Sq < Sk
    (4, 1024, 1024, 12, 2, 128, True, None),  # Qwen2-1.5B's cell
    (1, 8192, 8192, 32, 4, 128, True, 1024),  # Mellum2's sliding layers
    (1, 8192, 8192, 32, 4, 128, True, None),  # and its full ones
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES)
def test_cuda_flash_attention_bwd_matches_plain(cuda, case):
    """The differentiable entry on the card: its forward's output and
    log-sum-exp, and the gradient its backward kernels give, against the
    plain versions over the kernels' own output and log-sum-exp, within
    the bf16 bound of the forward's tests (the gradient's floored as
    ``_over_tol`` says; the log-sum-exp, fp32, within 1e-5). The two cells' shapes included: Qwen2's spreads each group's
    heads over six blocks, Mellum2's full layers over two."""
    B, Sq, Sk, H, KV, dh, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(Sq + dh)
    q, g = (_randn(gen, (B, Sq, H, dh), torch.bfloat16, cuda)
            for _ in range(2))
    k, v = (_randn(gen, (B, Sk, KV, dh), torch.bfloat16, cuda)
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_train(*leaves, causal=causal, window=window)
    before = dict(fa.launches)
    out.backward(g)
    assert fa.launches["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    _, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal,
                                                       window, None)
    want_out, want_lse = by_kv_group(
        lambda *a: ref.flash_attention_lse(*a, causal, window), q, k, v)
    _assert_matches_plain(out.detach(), want_out)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    want = by_kv_group(
        lambda q, k, v, o, lse, g: ref.flash_attention_bwd(
            q, k, v, o, lse, g, causal, window),
        q, k, v, out.detach(), g, lse=lse)
    for leaf, w in zip(leaves, want):
        _assert_matches_plain(leaf.grad, w, grad=True)
    # The last key tile's gradient (keys every case's last query sees)
    # dropped is rejected.
    wrong = want[1].clone()
    wrong[:, Sk - 64:] = 0
    with pytest.raises(AssertionError):
        _assert_matches_plain(wrong, want[1], grad=True)


@pytest.mark.gpu
@pytest.mark.parametrize("case,splits", [(BWD_CASES[5], 6),
                                         (BWD_CASES[6], 1),
                                         (BWD_CASES[7], 2)])
def test_cuda_flash_attention_bwd_repeats_bit_identical(cuda, case, splits):
    """Two backward calls on the same inputs give the same dQ, dK and dV
    to the bit at the cells' shapes, with a group's heads spread over
    blocks (the partial sums added in a fixed order) and without: no
    float atomics."""
    B, Sq, Sk, H, KV, dh, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, g = (_randn(gen, (B, Sq, H, dh), torch.bfloat16, cuda)
            for _ in range(2))
    k, v = (_randn(gen, (B, Sk, KV, dh), torch.bfloat16, cuda)
            for _ in range(2))
    out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal,
                                                         window, None)
    runs = [torch.ops.repro_torch.flash_attention_bwd(
        g, q, k, v, out, lse, causal, window, None) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert fa.bwd_splits(B, Sq, Sk, H, KV, causal, window,
                         fa._sm_count(q.device)) == splits


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
@pytest.mark.parametrize("B,S,W", [(1, 3072, 2560),   # RecurrentGemma-2B
                                   (3, 37, 100), (2, 777, 2560),
                                   (3, 1001, 2501)])
def test_cuda_rglru_scan_matches_plain(cuda, dtype, B, S, W):
    """Multiply then add, each rounded, in both: bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    a, x, h0 = scan_inputs.rglru(gen, B, S, W, dtype, cuda)
    before = rg.launches["rglru_scan"]
    y, h = rg.rglru_scan(a, x, h0)
    assert rg.launches["rglru_scan"] == before + 1
    ye, he = ref.rglru_scan(a, x, h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y, ye, rtol=0, atol=0)
    torch.testing.assert_close(h, he, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [(1, 0, 64),       # no step: h_last = h0
                                   (2, 1, 2560),     # one step
                                   (3, 5, 2560),     # S < one ring stage
                                   (3, 1001, 100),   # ragged S, W % 32 != 0
                                   (1, 1001, 2501),  # W % 8 != 0: plain loads
                                   (3, 800, 2560)])  # past the ring, B = 3
def test_cuda_rglru_scan_ring_edges(cuda, dtype, B, S, W):
    """The load ring's edges: S of 0 and 1, shorter than a stage, not a
    multiple of it and longer than the ring; W not a multiple of the
    block's 32 channels, or of a 16-byte vector; B = 3. Bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(S + W)
    a, x, h0 = scan_inputs.rglru(gen, B, S, W, dtype, cuda)
    y, h = rg.rglru_scan(a, x, h0)
    ye, he = ref.rglru_scan(a, x, h0)
    assert y.shape == (B, S, W) and y.dtype == dtype
    torch.testing.assert_close(y, ye, rtol=0, atol=0)
    torch.testing.assert_close(h, he, rtol=0, atol=0)
    if S == 0:
        assert torch.equal(h, h0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N", [(1, 2048, 8192, 16),  # Falcon-Mamba-7B
                                      (3, 257, 8192, 16), (1, 1, 8192, 16),
                                      (1, 7, 8190, 16), (2, 1001, 1000, 8),
                                      (3, 1001, 333, 8), (2, 7, 100, 4),
                                      (1, 1, 64, 16)])
def test_cuda_ssm_scan_matches_plain(cuda, dtype, B, S, Di, N):
    """Each step multiplies then adds, each rounded, as the plain loop
    does, and the sum over N runs in the plain loop's halving order, so
    y and h_last are bit-identical (and within the plain loop's
    tolerance)."""
    gen = torch.Generator(device=cuda).manual_seed(S + Di)
    args = scan_inputs.ssm(gen, B, S, Di, N, dtype, cuda)
    before = ss.launches["ssm_scan"]
    y, h = ss.ssm_scan(*args)
    assert ss.launches["ssm_scan"] == before + 1
    ye, he = ref.ssm_scan(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    _assert_matches_plain(y, ye)
    _assert_matches_plain(h, he)
    assert torch.equal(y, ye)
    assert torch.equal(h, he)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", ss.STATE_SIZES)
@pytest.mark.parametrize("B,S,Di", [(1, 1, 333),      # one step, ragged Di
                                    (3, 130, 1000),   # S % 64 != 0
                                    (2, 200, 8190)])  # Di % 8 != 0
def test_cuda_ssm_scan_staging_edges(cuda, dtype, N, B, S, Di):
    """The staging's edges, at every state size: S of 1 and not a
    multiple of the 64-step chunk, Di not a multiple of the block's 32
    channels or of a 16-byte vector (plain loads). y and h_last
    bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(S + Di + N)
    args = scan_inputs.ssm(gen, B, S, Di, N, dtype, cuda)
    before = ss.launches["ssm_scan"]
    y, h = ss.ssm_scan(*args)
    assert ss.launches["ssm_scan"] == before + 1
    ye, he = ref.ssm_scan(*args)
    assert y.shape == (B, S, Di) and y.dtype == dtype
    _assert_matches_plain(y, ye)
    assert torch.equal(y, ye)
    assert torch.equal(h, he)


@pytest.mark.gpu
def test_cuda_scan_launch_config(cuda):
    """The launch each scan reports is the one its wrapper makes at the
    models' prefill shapes: K4 one chain warp and two producer warps per
    32 channels, K5 4 lanes a channel over 32 channels, both chunks of
    its double buffer in the dynamic shared memory it asks for."""
    assert rg.launch_config(torch.float32, 1, 2560) == {
        "grid_x": 80, "grid_y": 1, "threads": 96, "smem_bytes": 98496,
        "stages": 12, "steps_per_stage": 32}
    assert ss.launch_config(torch.bfloat16, 16, 1, 8192) == {
        "grid_x": 256, "grid_y": 1, "threads": 128, "smem_bytes": 49152,
        "buffers": 2, "steps_per_chunk": 64, "lanes": 4, "group_steps": 8}
    assert ss.launch_config(torch.float32, 4, 3, 333)["grid_x"] == 11


# The dropless expert layer's pair kernels at Mellum2's widths: N tokens
# of K choices over E experts, of which experts 0 .. H-1 are held; model
# width D, expert width F.
PAIRS = {"N": 8192, "K": 8, "E": 64, "H": 8, "D": 2304, "F": 896}


def _pair_routing(seed, device):
    """(tok, pos, ends, held rows) of a routing at PAIRS on ``device``:
    held experts drawn 1/4 .. 2 times as often as one not held (uneven
    groups), held expert 3 never (an empty group), token 0's K choices
    all held (expert 0 twice: the kernels read rows and gates, not
    experts) and token 1's none."""
    N, K, E, H = (PAIRS[k] for k in "NKEH")
    w = torch.ones(E)
    w[:H] = torch.arange(1, H + 1) / 4
    w[3] = 0
    gen = torch.Generator().manual_seed(seed)
    idx = torch.multinomial(w.repeat(N, 1), K, generator=gen)
    idx[0] = torch.tensor([0, 1, 2, 4, 5, 6, 7, 0])
    idx[1] = torch.arange(H, H + K)
    from repro_torch.models import moe
    order, pos, ends = moe.sort_pairs(idx.to(device), 0, H)
    return (torch.div(order, K, rounding_mode="floor"), pos, ends,
            int(ends[-1]))


def _nan_past(t, n):
    """t with its rows from n on NaN: rows the kernels must not read."""
    t[n:] = float("nan")
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_pair_kernels_match_plain(cuda, dtype):
    """Each pair kernel through its differentiable entry at Mellum2's
    widths against its plain version: the gather (its rows exact) and its
    backward dx, SwiGLU and d[a | b], the combine, dye and dgate. Every
    [N*K, ..] input's rows past the held ones are NaN, and no output
    holds one; token 1, with no choice held, gets zeros."""
    N, K, D, F = (PAIRS[k] for k in "NKDF")
    tok, pos, ends, n = _pair_routing(21, cuda)
    gen = torch.Generator(device=cuda).manual_seed(21)
    before = _launches()

    x = _randn(gen, (N, D), dtype, cuda).requires_grad_()
    xs = mp.gather(x, tok, pos, ends)
    g = _nan_past(_randn(gen, (N * K, D), dtype, cuda), n)
    xs.backward(g)
    assert torch.equal(xs[:n], x.detach()[tok[:n]])
    _assert_matches_plain(x.grad, ref.moe_combine(g, None, pos, ends))

    ab = _nan_past(_randn(gen, (N * K, 2 * F), dtype, cuda) * 3, n)
    ab.requires_grad_()
    h = mp.swiglu(ab, ends)
    dh = _nan_past(_randn(gen, (N * K, F), dtype, cuda), n)
    h.backward(dh)
    a_b = ab.detach()[:n]
    _assert_matches_plain(h[:n], ref.moe_swiglu(a_b, ends))
    _assert_matches_plain(ab.grad[:n], ref.moe_swiglu_bwd(dh[:n], a_b, ends))

    ye = _nan_past(_randn(gen, (N * K, D), dtype, cuda), n).requires_grad_()
    gate = torch.rand((N, K), generator=gen, device=cuda).to(dtype)
    gate.requires_grad_()
    y = mp.combine(ye, gate, pos, ends)
    dy = _randn(gen, (N, D), dtype, cuda) * D ** -0.5
    y.backward(dy)
    _assert_matches_plain(y, ref.moe_combine(ye.detach(), gate.detach(), pos,
                                             ends))
    dye, dgate = ref.moe_combine_bwd(dy, ye.detach(), gate.detach(), pos,
                                     ends)
    _assert_matches_plain(ye.grad[:n], dye[:n])
    _assert_matches_plain(gate.grad, dgate, grad=True)

    for t in (x.grad, h[:n], ab.grad[:n], y, ye.grad[:n], gate.grad):
        assert bool(torch.isfinite(t).all())
    assert not (y[1].any() or x.grad[1].any() or gate.grad[1].any())
    run = _since(before)
    assert {k: run[k] for k in mp.launches} == {
        "moe_gather": 1, "moe_swiglu": 1, "moe_swiglu_bwd": 1,
        "moe_combine": 2, "moe_combine_bwd": 1}


@pytest.mark.gpu
def test_cuda_pair_kernels_repeat_bit_identical(cuda):
    """Every pair kernel (bf16, Mellum2's widths) twice, then a captured
    graph of them replayed twice: the held rows of every output equal the
    first call's bit for bit (no atomics, fixed sums)."""
    N, K, D, F = (PAIRS[k] for k in "NKDF")
    tok, pos, ends, n = _pair_routing(22, cuda)
    gen = torch.Generator(device=cuda).manual_seed(22)
    x, dy = (_randn(gen, (N, D), _BF16, cuda) for _ in range(2))
    ye, g = (_randn(gen, (N * K, D), _BF16, cuda) for _ in range(2))
    ab = _randn(gen, (N * K, 2 * F), _BF16, cuda)
    dh = _randn(gen, (N * K, F), _BF16, cuda)
    gate = torch.rand((N, K), generator=gen, device=cuda).to(_BF16)

    def run():
        dye, dgate = mp._combine_bwd(dy, ye, gate, pos, ends)
        return [mp._gather(x, tok, pos, ends)[:n], mp._swiglu(ab, ends)[:n],
                mp._swiglu_bwd(dh, ab, ends)[:n],
                mp._combine(ye, gate, pos, ends), dye[:n], dgate,
                mp._combine(g, None, pos, ends)]

    first = [t.clone() for t in run()]
    assert all(torch.equal(a, b) for a, b in zip(run(), first))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, first))


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
    args = list(scan_inputs.ssm(gen, 1, 8, 16, 32, torch.float32, cuda))
    with pytest.raises(ValueError, match="state size"):
        ss.ssm_scan(*args)                            # N 32: not built
    args = list(scan_inputs.ssm(gen, 1, 8, 16, 16, torch.float32, cuda))
    with pytest.raises(TypeError, match="delta"):
        ss.ssm_scan(args[0], args[1].to(torch.bfloat16), *args[2:])
    bc = torch.zeros((1, 8, 32), device=cuda)         # B/C split views
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssm_scan(*args[:3], bc[..., :16], bc[..., 16:], *args[5:])


# The wrong kernels, each the plain version with one fault, at a serving
# or training path's full-width shape. Each returns (the kernel's output,
# the plain version's, the wrong one's, whether it is a gradient).

def _wrong_decode(cuda, paged):
    """K1 (K2 through a page table) at Qwen2-1.5B's decode, 32 slots
    from the middle of the cache dropped."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    B, H, KV, dh, L, ps = 8, 12, 2, 128, 2048, 16
    q = _randn(gen, (B, H, dh), _BF16, cuda)
    valid = torch.ones((B, L), dtype=torch.bool, device=cuda)
    dropped = valid.clone()
    dropped[:, L // 2:L // 2 + 32] = False
    if not paged:
        k, v = (_randn(gen, (B, L, KV, dh), _BF16, cuda) for _ in range(2))
        return (dec.decode_attention(q, k, v, valid),
                ref.decode_attention(q, k, v, valid),
                ref.decode_attention(q, k, v, dropped), False)
    P = B * (L // ps) + 1
    kp, vp = (_randn(gen, (P, ps, KV, dh), _BF16, cuda) for _ in range(2))
    pages = torch.randperm(P, generator=gen, device=cuda)[:P - 1]
    pages = pages.to(torch.int32).reshape(B, L // ps).contiguous()
    return (dec.paged_decode_attention(q, kp, vp, pages, valid),
            ref.paged_decode_attention(q, kp, vp, pages, valid),
            ref.paged_decode_attention(q, kp, vp, pages, dropped), False)


def _wrong_prefill(cuda, causal):
    """K3 at RecurrentGemma-2B's LOCAL prefill (window 2048) or, not
    causal, at HuBERT-XLarge's encoder (dh 80): 64 keys from the middle
    dropped."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    B, S, H, KV, dh, window = ((1, 3072, 10, 1, 256, 2048) if causal
                               else (1, 1500, 16, 16, 80, None))
    q = _randn(gen, (B, S, H, dh), _BF16, cuda)
    k, v = (_randn(gen, (B, S, KV, dh), _BF16, cuda) for _ in range(2))
    dropped = ref.visible(S, S, causal, window, q.device).clone()
    dropped[:, S // 2:S // 2 + 64] = False
    return (fa.flash_attention(q, k, v, causal, window),
            ref.flash_attention(q, k, v, causal, window),
            ref.masked_attention(q, k, v, dropped), False)


def _wrong_backward(cuda):
    """K3b at Qwen2-1.5B's training attention (4 x 1024, 12/2 heads):
    the dK of 64 keys from the middle dropped."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    B, S, H, KV, dh = 4, 1024, 12, 2, 128
    q, g = (_randn(gen, (B, S, H, dh), _BF16, cuda) for _ in range(2))
    k, v = (_randn(gen, (B, S, KV, dh), _BF16, cuda) for _ in range(2))
    out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, True,
                                                         None, None)
    got = torch.ops.repro_torch.flash_attention_bwd(g, q, k, v, out, lse,
                                                    True, None, None)
    want = by_kv_group(lambda q, k, v, o, lse, g: ref.flash_attention_bwd(
        q, k, v, o, lse, g, True, None), q, k, v, out, g, lse=lse)
    wrong = want[1].clone()
    wrong[:, S // 2:S // 2 + 64] = 0
    return got[1], want[1], wrong, True


def _wrong_rglru(cuda):
    """K4 at RecurrentGemma-2B's prefill (fp32 a/x): h reset to 0 at
    S/2."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    S = 3072
    a, x, h0 = scan_inputs.rglru(gen, 1, S, 2560, _FP32, cuda)
    want, _ = ref.rglru_scan(a, x, h0)
    y1, _ = ref.rglru_scan(a[:, :S // 2], x[:, :S // 2], h0)
    y2, _ = ref.rglru_scan(a[:, S // 2:].contiguous(),
                           x[:, S // 2:].contiguous(), torch.zeros_like(h0))
    return rg.rglru_scan(a, x, h0)[0], want, torch.cat([y1, y2], 1), False


def _wrong_ssm(cuda, fault):
    """K5 at Falcon-Mamba-7B's prefill (bf16 u): h reset to 0 at S/2, or
    y_t read from h_{t-1}, the state before step t's update (the plain
    scan with D = 0 and C taken one step ahead gives z_t = h_t . C_{t+1},
    so that y_t is z_{t-1} + D u_t, and h0 . C_0 + D u_0 at t = 0)."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    S = 2048
    args = scan_inputs.ssm(gen, 1, S, 8192, 16, _BF16, cuda)
    u, delta, A, Bc, Cc, D, h0 = args
    want, _ = ref.ssm_scan(*args)
    if fault == "h reset":
        y1, _ = ref.ssm_scan(u[:, :S // 2], delta[:, :S // 2], A,
                             Bc[:, :S // 2], Cc[:, :S // 2], D, h0)
        y2, _ = ref.ssm_scan(*(t[:, S // 2:].contiguous() for t in (u, delta)),
                             A, *(t[:, S // 2:].contiguous() for t in (Bc, Cc)),
                             D, torch.zeros_like(h0))
        wrong = torch.cat([y1, y2], dim=1)
    else:
        c_next = torch.cat([Cc[:, 1:], Cc[:, :1]], dim=1).contiguous()
        z, _ = ref.ssm_scan(u.float(), delta, A, Bc, c_next,
                            torch.zeros_like(D), h0)
        first = torch.einsum("bdn,bn->bd", h0, Cc[:, 0])[:, None]
        wrong = (torch.cat([first, z[:, :-1]], dim=1)
                 + D * u.float()).to(u.dtype)
    return ss.ssm_scan(*args)[0], want, wrong, False


def _wrong_pairs(cuda, fault):
    """The pair kernels at Mellum2's widths (bf16): the combine without
    each token's last held choice, or SwiGLU stopped at ends[-2] (the
    last held expert's rows left 0)."""
    N, K, D, F = (PAIRS[k] for k in "NKDF")
    tok, pos, ends, n = _pair_routing(16, cuda)
    gen = torch.Generator(device=cuda).manual_seed(16)
    if fault == "combine":
        ye = _randn(gen, (N * K, D), _BF16, cuda)
        gate = torch.rand((N, K), generator=gen, device=cuda).to(_BF16)
        held = ref.moe_held(pos, ends)
        last = held & (held.long().flip(1).cumsum(1).flip(1) == 1)
        dropped = torch.where(last, torch.zeros_like(gate), gate)
        return (mp.combine(ye, gate, pos, ends),
                ref.moe_combine(ye, gate, pos, ends),
                ref.moe_combine(ye, dropped, pos, ends), False)
    ab = _randn(gen, (N * K, 2 * F), _BF16, cuda)
    want = ref.moe_swiglu(ab[:n], ends)
    wrong = want.clone()
    wrong[int(ends[-2]):] = 0
    return mp.swiglu(ab, ends)[:n], want, wrong, False


_WRONG_KERNELS = {
    "K1 key tile dropped": lambda c: _wrong_decode(c, paged=False),
    "K2 key tile dropped": lambda c: _wrong_decode(c, paged=True),
    "K3 key tile dropped": lambda c: _wrong_prefill(c, causal=True),
    "K3 non-causal key tile dropped": lambda c: _wrong_prefill(c, False),
    "K3b key tile's dK dropped": _wrong_backward,
    "K4 h reset at S/2": _wrong_rglru,
    "K5 h reset at S/2": lambda c: _wrong_ssm(c, "h reset"),
    "K5 y_t from h_{t-1}": lambda c: _wrong_ssm(c, "previous h"),
    "pair combine without each token's last held choice":
        lambda c: _wrong_pairs(c, "combine"),
    "pair SwiGLU stopped at ends[-2]": lambda c: _wrong_pairs(c, "swiglu"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", list(_WRONG_KERNELS))
def test_cuda_check_rejects_a_wrong_kernel(cuda, fault, record_property):
    """The bound every kernel test holds its kernel to passes the kernel
    and fails a wrong one: the plain version with one fault, at a
    serving or training path's full-width shape. By how many times the
    wrong output passes each bound is recorded (the junit XML's
    properties) and printed."""
    got, want, wrong, grad = _WRONG_KERNELS[fault](cuda)
    _assert_matches_plain(got, want, grad)
    worst, rel = _over_tol(wrong, want, grad)
    record_property("err_over_tol", worst)
    record_property("rel_l2_over_tol", rel)
    print(json.dumps({"fault": fault, "err_over_tol": worst,
                      "rel_l2_over_tol": rel}))
    with pytest.raises(AssertionError):
        _assert_matches_plain(wrong, want, grad)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,page_size,sync_every,kernels", [
    ("qwen2-1.5b", None, 1, ("decode_attention", "flash_attention")),
    ("qwen2-1.5b", None, 8, ("decode_attention", "flash_attention")),
    ("qwen2-1.5b", 4, 1, ("paged_decode_attention",)),
    ("qwen2-1.5b", 4, 8, ("paged_decode_attention",)),
    ("recurrentgemma-2b", None, 1,
     ("decode_attention", "flash_attention", "rglru_scan")),
    ("falcon-mamba-7b", None, 1, ("ssm_scan",)),
    ("mixtral-8x7b", None, 1, ("decode_attention", "flash_attention"))])
def test_cuda_engine_flash_matches_dense(cuda, arch, page_size, sync_every,
                                         kernels):
    """The reduced config's engine on the card: greedy tokens through the
    kernels (prefill flash attention, the RG-LRU and selective scans,
    flash-decode; Mixtral's MoE around them) equal the plain PyTorch
    path's, with a prompt longer than RecurrentGemma's window and two
    that share a prefix, which a paged engine serves from its prefix
    cache. The flash run launches each of ``kernels``, the selective
    scan once a layer a prompt."""
    import dataclasses
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              compute_dtype="float32")
    params = transformer.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 18, 7)]
    prompts += [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)]) for n in (3, 5)]
    outs = []
    for impl in ("dense", "flash"):
        eng = ServeEngine(cfg, params, num_slots=2, context_len=24,
                          max_new=4, sync_every=sync_every, decode_impl=impl,
                          page_size=page_size, num_pages=16, device=cuda)
        before = _launches()
        futs = [eng.submit(p) for p in prompts]
        while not all(f.done() for f in futs):
            eng.step()
        outs.append([f.result() for f in futs])
        hits = eng.stats().get("prefix_cache", {}).get("hits", 0)
        eng.stop()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    run = _since(before)
    assert all(run[k] for k in kernels), run
    if cfg.ssm_state:
        assert run["ssm_scan"] == cfg.num_layers * len(prompts)
    if page_size:
        assert hits


@pytest.mark.gpu
def test_cuda_vision_generate_flash_matches_dense(cuda):
    """Reduced Llama-3.2-Vision on the card: ``generate(memory=...)``
    through the kernels (K3 causal and non-causal over the memory, K1
    over the rings and over the all-valid memory) gives the plain path's
    greedy tokens, and launches both kernels."""
    import dataclasses
    from repro_torch.serve import decode as serve_lib
    cfg = dataclasses.replace(configs.get_reduced("llama-3.2-vision-11b"),
                              compute_dtype="float32")
    params = transformer.init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen,
                           device=cuda, dtype=torch.int32)
    memory = torch.randn((2, cfg.frontend_tokens, cfg.d_model),
                         generator=gen, device=cuda)
    outs = []
    for impl in ("dense", "flash"):
        before = (fa.launches["flash_attention"],
                  dec.launches["decode_attention"])
        outs.append(serve_lib.generate(cfg, params, prompt, 6,
                                       memory=memory, attn_impl=impl))
        after = (fa.launches["flash_attention"],
                 dec.launches["decode_attention"])
        assert (after != before) == (impl == "flash")
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
def test_cuda_hubert_forward_flash_matches_dense(cuda):
    """Reduced HuBERT on the card at fp32: hidden states through K3
    (non-causal, one launch a layer) within 1e-4 of the plain path's."""
    import dataclasses
    cfg = dataclasses.replace(configs.get_reduced("hubert-xlarge"),
                              compute_dtype="float32")
    params = transformer.init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 37, cfg.d_model), generator=gen, device=cuda)
    dense, _ = transformer.forward(cfg, params, embeddings=x, impl="dense")
    before = fa.launches["flash_attention"]
    flash, _ = transformer.forward(cfg, params, embeddings=x, impl="flash")
    assert fa.launches["flash_attention"] == before + cfg.num_layers
    torch.testing.assert_close(flash, dense, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_courier_refuses_cuda_bf16_tensor(cuda):
    """A device buffer never travels implicitly, bf16 included; its CPU
    copy does (as ``ml_dtypes.bfloat16`` where that is installed)."""
    from repro_torch.core.courier import serialization as ser
    t = torch.ones(3, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="cuda tensors"):
        ser.tensor_as_numpy(t)
    with pytest.raises(TypeError, match="cuda tensors"):
        ser.encode_call("f", (t,), {})


@pytest.mark.gpu
def test_cuda_engine_server_load_version_swaps_and_serves(cuda, tmp_path):
    """An EngineServer on the card restores v0 from a store in the JAX
    layout, hot-swaps to v1, and then serves v1's greedy tokens — those
    of a fresh engine over v1's weights."""
    from repro_torch.launch.serve import EngineServer, publish_demo_versions
    from repro_torch.models import convert
    cfg = configs.get_reduced("qwen2-1.5b")
    store = str(tmp_path / "store")
    publish_demo_versions(cfg, store, device=cuda)
    prompt = np.arange(1, 9, dtype=np.int32)
    server = EngineServer(cfg, max_new=6, num_slots=2, context_len=32,
                          store_dir=store, version=0, device=cuda)
    try:
        out0 = np.asarray(server.generate(prompt))
        server.load_version(1)
        assert server.load()["version"] == 1
        assert server.stats()["param_swaps"] == 1
        out1 = np.asarray(server.generate(prompt))
    finally:
        server.kill()
    p1 = convert.params_from_numpy(
        cfg, convert.params_to_numpy(
            cfg, transformer.init_params(cfg, seed=1, device=cuda)),
        device=cuda)
    with ServeEngine(cfg, p1, num_slots=2, context_len=32, max_new=6,
                     device=cuda) as eng:
        want = np.asarray(eng.submit(prompt).result(timeout=120))
    np.testing.assert_array_equal(out1, want)
    assert not np.array_equal(out0, out1)


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu(cuda):
    """Microbatched gradients of the reduced Qwen2 at fp32 (TF32 off) on
    the card and on the CPU from the same weights and batch: the loss
    within 1e-5 relative, each gradient leaf within 1e-4 relative L2
    (plus 1e-7 of the whole gradient's norm for a leaf whose true
    gradient is zero: the key bias, to which a softmax is blind). The
    AdamW update of the same gradients agrees within 1e-6 relative L2 on
    both devices; it is compared on one set of gradients because AdamW's
    first step is sign(g) elementwise, which turns a zero gradient's
    rounding residue into a full-size step. Then one ``make_train_step``
    on the card."""
    import dataclasses

    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import tree
    from repro_torch.train.train_step import (TrainConfig, make_grad_fn,
                                              make_train_step)
    cfg = dataclasses.replace(configs.get_reduced("qwen2-1.5b"),
                              compute_dtype="float32")
    tc = TrainConfig(optimizer=opt_lib.OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=10), num_microbatches=2)
    cpu = transformer.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    gpu = tree.tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))
    on = {"cpu": {"tokens": toks, "labels": toks},
          "gpu": {"tokens": toks.to(cuda), "labels": toks.to(cuda)}}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lc, _, gc = make_grad_fn(cfg, tc)(cpu, on["cpu"])
        lg, _, gg = make_grad_fn(cfg, tc)(gpu, on["gpu"])
        pc, sc, _ = opt_lib.apply_updates(tc.optimizer, cpu, gc,
                                          opt_lib.init_opt_state(cpu))
        pg, sg, _ = opt_lib.apply_updates(
            tc.optimizer, gpu, tree.tree_map(lambda t: t.to(cuda), gc),
            opt_lib.init_opt_state(gpu))
        p2, s2, m2 = make_train_step(cfg, tc)(
            gpu, opt_lib.init_opt_state(gpu), on["gpu"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    total = float(opt_lib.global_norm(gc))
    for a, b in zip(tree.leaves(gg), tree.leaves(gc)):
        err = float((a.cpu().double() - b.double()).norm())
        assert err <= 1e-4 * float(b.double().norm()) + 1e-7 * total
    for a, b in zip(tree.leaves((pg, sg["m"], sg["v"])),
                    tree.leaves((pc, sc["m"], sc["v"]))):
        err = float((a.cpu().double() - b.double()).norm())
        assert err <= 1e-6 * float(b.double().norm())
    assert bool(torch.isfinite(m2["loss"])) and int(s2["step"]) == 1
    assert all(leaf.device.type == "cuda" for leaf in tree.leaves(p2))


@pytest.mark.gpu
def test_cuda_plan_estimate_matches_the_card(cuda):
    """The planner against the card: the dry run's trace of a train step
    on the 1x1 CUDA mesh counts the FLOPs the step runs on the card with
    DTensor parameters (within 1%), estimates its peak within a factor
    of 2, and the sharded step's loss equals the unsharded step's."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.roofline.analysis import cost_of
    from repro_torch.sharding import use_sharding
    from repro_torch.sharding.rules import param_sharding
    from repro_torch.train import tree
    from repro_torch.train.train_step import (TrainConfig, make_train_state,
                                              make_train_step)
    import dataclasses
    # Full width, 2 layers: large enough that the card's own workspaces
    # (cuBLAS) are a small part of the peak.
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=2)
    B, S, nm = 4, 256, 2
    mesh = make_local_mesh()
    try:
        plan = cells.CellPlan(num_microbatches=nm)
        cell = cells.build_cell(cfg, ShapeConfig("t", "train", S, B), mesh,
                                plan=plan)
        est = cells.trace_cell(cell, mesh)
        step = make_train_step(cfg, TrainConfig(num_microbatches=nm))
        params, opt = make_train_state(cfg, 0, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
        batch = {"tokens": toks.int(), "labels": toks.int()}

        def place(t):
            return tree.tree_map(
                lambda x, sh: DTensor.from_local(x, mesh, sh[1],
                                                 run_check=False)
                if x.is_cuda else x, t, param_sharding(t, mesh))
        args = (place(params), place(opt), place(batch))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with use_sharding(cells.sharding_ctx(mesh)):
            out, rec = cost_of(step, args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        sharded = float(out[2]["loss"].full_tensor())
        del out
        # The DTensor step's attention runs dense; the plain step is held
        # to the same route, so that only the sharding differs.
        from repro_torch.models import attention
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(attention, "_flash_grad_eligible", lambda *a: False)
            plain = float(step(params, opt, batch)[2]["loss"])
        assert sharded == plain
        assert rec.cost.flops == pytest.approx(est.cost.flops, rel=1e-2)
        assert 0.5 <= est.peak_bytes / peak <= 2.0
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_cuda_grad_pass_replays_as_one_graph(cuda):
    """The gradient pass as the learner drives it on the card
    (``Replayed`` over ``make_grad_fn``, as ``launch.train.LMTask``
    builds it): the
    reduced Qwen2 (2 superblocks, bf16 compute over fp32 master weights),
    2 microbatches and full remat, four steps of gradient then in-place
    AdamW on the same tensors. The first call runs eagerly, the second
    captures the pass and every later one replays it; each step's loss
    and every gradient leaf equal, bit for bit, a fresh function's eager
    pass (the same kernels on the same inputs) over a copy of the state
    that takes the same updates. A traced replay records
    ``train.replay`` and no per-microbatch span; a batch of another
    shape, or a new parameter tree, runs eagerly and the next call
    captures again; dropping the graph gives its memory back."""
    import dataclasses

    from repro_torch.core import telemetry
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import tree
    from repro_torch.train.train_step import (Replayed, TrainConfig,
                                              make_grad_fn)
    cfg = configs.get_reduced("qwen2-1.5b")
    assert cfg.num_layers == 2 and cfg.compute_dtype == "bfloat16"
    tc = TrainConfig(optimizer=opt_lib.OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=10), num_microbatches=2,
        remat="full")
    rng = np.random.default_rng(0)

    def batch(B=4, S=64):
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)).to(cuda)
        return {"tokens": toks, "labels": toks}

    def eager(params, b):
        return make_grad_fn(cfg, tc)(params, b)

    def same(a, b):
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(x, y) for x, y in
                   zip(tree.leaves(a[2]), tree.leaves(b[2])))

    counters = {k: telemetry.metrics().counter(f"train.graph.{k}")
                for k in ("captures", "replays", "eager")}

    def counted(fn):
        before = {k: c.value for k, c in counters.items()}
        out = fn()
        return out, {k: c.value - before[k] for k, c in counters.items()}

    params = transformer.init_params(cfg, 0, device=cuda,
                                     dtype=torch.float32)
    ref = tree.tree_map(torch.clone, params)
    opt, ref_opt = opt_lib.init_opt_state(params), opt_lib.init_opt_state(ref)
    grad_fn = Replayed(make_grad_fn(cfg, tc), tc.num_microbatches)
    kinds = []
    for _ in range(4):
        b = batch()
        out, n = counted(lambda: grad_fn(params, b))
        kinds.append(n)
        want = eager(ref, b)
        same(out, want)
        opt_lib.apply_updates_(tc.optimizer, params, out[2], opt)
        opt_lib.apply_updates_(tc.optimizer, ref, want[2], ref_opt)
    del out, want
    assert kinds == [{"captures": 0, "replays": 0, "eager": 1},
                     {"captures": 1, "replays": 1, "eager": 0},
                     {"captures": 0, "replays": 1, "eager": 0},
                     {"captures": 0, "replays": 1, "eager": 0}]

    b = batch()
    telemetry.spans_buffer().drain()
    with telemetry.activate(telemetry.start_trace()):
        out = grad_fn(params, b)
    names = [s["name"] for s in telemetry.spans_buffer().drain()]
    assert names == ["train.replay"]
    same(out, eager(ref, b))
    del out

    # Another shape, then a new parameter tree: eager, then a capture.
    short = batch(S=32)
    for p in (params, tree.tree_map(torch.clone, params)):
        _, n = counted(lambda: grad_fn(p, short))
        assert n == {"captures": 0, "replays": 0, "eager": 1}
        out, n = counted(lambda: grad_fn(p, short))
        assert n == {"captures": 1, "replays": 1, "eager": 0}
        same(out, eager(p, short))
        del out

    # Dropped by a call the graph cannot take, the graph frees its pool.
    fresh = tree.tree_map(torch.clone, params)
    grad_fn(fresh, b)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    out, n = counted(lambda: grad_fn(fresh, b))
    assert n["captures"] == 1
    assert torch.cuda.memory_allocated(cuda) > before
    del out
    cpu = tree.tree_map(lambda t: t.cpu(), fresh)
    grad_fn(cpu, {k: v.cpu() for k, v in b.items()})
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) == before


def _train_batch(cfg, rng, device, B=4, S=32):
    """A seeded batch for the loss of ``cfg``'s family, on ``device``."""
    if cfg.family == "audio":
        batch = {"embeddings": rng.normal(size=(B, S, cfg.d_model))
                 .astype(np.float32),
                 "targets": rng.integers(0, cfg.vocab_size, (B, S))
                 .astype(np.int32),
                 "mask": (rng.random((B, S)) < 0.5).astype(np.float32)}
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        batch = {"tokens": toks, "labels": toks}
        if cfg.family == "vlm":
            batch["image_embeds"] = rng.normal(
                size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_cuda_grad_pass_replays_every_family(cuda, arch):
    """Every family's reduced config (its own compute dtype, fp32 master
    weights), 2 microbatches and full remat, driven as the learner drives
    ``Replayed``: three steps of gradient then in-place AdamW on the same
    tensors. The first call runs eagerly, the second captures the pass
    (the MoE dispatch, the recurrent scans, cross-attention and the
    audio loss included) and the third replays it; each step's loss and
    every gradient leaf equal, bit for bit, a fresh eager pass over a
    copy of the state that takes the same updates."""
    from repro_torch.core import telemetry
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import tree
    from repro_torch.train.train_step import (Replayed, TrainConfig,
                                              make_grad_fn)
    cfg = configs.get_reduced(arch)
    tc = TrainConfig(optimizer=opt_lib.OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=10), num_microbatches=2,
        remat="full")
    rng = np.random.default_rng(1)
    params = transformer.init_params(cfg, 0, device=cuda,
                                     dtype=torch.float32)
    ref = tree.tree_map(torch.clone, params)
    opt, ref_opt = opt_lib.init_opt_state(params), opt_lib.init_opt_state(ref)
    grad_fn = Replayed(make_grad_fn(cfg, tc), tc.num_microbatches)
    counters = {k: telemetry.metrics().counter(f"train.graph.{k}")
                for k in ("captures", "replays", "eager")}
    attn = {k: telemetry.metrics().counter(f"train.attn.{k}")
            for k in ("flash", "dense")}
    before = {k: c.value for k, c in counters.items()}
    attn_before = {k: c.value for k, c in attn.items()}
    for step in range(3):
        b = _train_batch(cfg, rng, cuda)
        loss, _, grads = grad_fn(params, b)
        want, _, want_grads = make_grad_fn(cfg, tc)(ref, b)
        assert torch.isfinite(want)
        assert torch.equal(loss, want), (step, float(loss), float(want))
        for (path, a), w in zip(tree.leaves_with_path(grads),
                                tree.leaves(want_grads)):
            assert torch.equal(a, w), (step, path)
        opt_lib.apply_updates_(tc.optimizer, params, grads, opt)
        opt_lib.apply_updates_(tc.optimizer, ref, want_grads, ref_opt)
    assert {k: c.value - before[k] for k, c in counters.items()} == {
        "captures": 1, "replays": 2, "eager": 1}
    # Attention blocks of an eligible config (bf16, no softcap, a head dim
    # the backward takes) trained through the flash kernels, in the
    # learner's eager passes, the capture and the fresh eager passes.
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS
    from repro_torch.models.config import MAMBA, RGLRU
    has_attn = any(kind not in (RGLRU, MAMBA)
                   for kind in cfg.pattern + cfg.remainder)
    eligible = (has_attn and cfg.compute_dtype == "bfloat16"
                and not cfg.logit_softcap
                and cfg.head_dim in BWD_HEAD_DIMS)
    flash = attn["flash"].value - attn_before["flash"]
    dense = attn["dense"].value - attn_before["dense"]
    assert (flash > 0, dense > 0) == (eligible, has_attn and not eligible)


@pytest.mark.gpu
def test_grouped_expert_products_match_the_plain_loop(cuda):
    """The dropless expert layer's grouped products on the card (CUTLASS's
    grouped GEMM through ``torch._grouped_mm``) against the plain loop
    over the groups in fp32, at Mellum2's expert widths with uneven
    groups, an empty one among them, and rows past the last group that
    the product leaves alone: the output and both gradients within the
    bf16 bound above, an empty group's weight gradient zero."""
    from repro_torch.models import moe
    gen = torch.Generator(device=cuda).manual_seed(3)
    D, F, M = 2304, 896, 16384
    counts = [700, 0, 1500, 1024, 1, 900, 2000, 1100]
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int32, device=cuda)
    n = int(ends[-1])
    a = _randn(gen, (M, D), torch.bfloat16, cuda).requires_grad_()
    b = (torch.randn((len(counts), D, F), generator=gen, device=cuda)
         * D ** -0.5).to(torch.bfloat16).requires_grad_()
    g = _randn(gen, (M, F), torch.bfloat16, cuda)
    y = moe.grouped_mm(a, b, ends)
    (y[:n].float() * g[:n].float()).sum().backward()
    a32 = a.detach().float().cpu().requires_grad_()
    b32 = b.detach().float().cpu().requires_grad_()
    want = moe.grouped_mm(a32, b32, ends.cpu())
    (want[:n] * g[:n].float().cpu()).sum().backward()
    _assert_matches_plain(y[:n], want[:n].to(cuda))
    _assert_matches_plain(a.grad[:n], a32.grad[:n].to(cuda))
    for grp in range(len(counts)):
        if counts[grp]:
            _assert_matches_plain(b.grad[grp], b32.grad[grp].to(cuda))
        else:
            assert not bool(b.grad[grp].any())


@pytest.mark.gpu
def test_a_mellum_pass_reads_nothing_back_to_the_host(cuda):
    """The reduced Mellum2's gradient pass (its sliding and full layers,
    the dropless layer over its held experts, two microbatches, remat)
    makes no synchronising call once warm, so the learner's graph holds
    it whole: the eager pass runs under the sync debug mode's "error",
    its held pairs through the pair kernels,
    and ``Replayed`` captures it, then replays the held experts' rows
    that the eager pass reports."""
    from repro_torch.train.train_step import (Replayed, TrainConfig,
                                              make_grad_fn)
    cfg = configs.get_reduced("mellum2-12b-a2.5b")
    tc = TrainConfig(num_microbatches=2, remat="full")
    params = transformer.init_params(cfg, 0, device=cuda,
                                     dtype=torch.float32)
    batch = _train_batch(cfg, np.random.default_rng(0), cuda)
    fn = make_grad_fn(cfg, tc)
    fn(params, batch)
    torch.cuda.synchronize()
    before = _launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, aux, _ = fn(params, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rows = aux["moe_rows"].clone()
    assert rows.shape == (cfg.num_layers, cfg.num_experts_held)
    # The held pairs went through the pair kernels, forward and backward.
    run = _since(before)
    assert all(run[k] for k in mp.launches), run
    replayed = Replayed(fn, tc.num_microbatches)
    for _ in range(3):
        r_loss, r_aux, _ = replayed(params, batch)
    assert replayed._graph is not None
    assert torch.equal(r_loss, loss)
    assert torch.equal(r_aux["moe_rows"], rows)
