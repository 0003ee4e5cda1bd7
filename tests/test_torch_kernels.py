"""The port's kernel contracts against the JAX package.

The plain PyTorch versions (``repro_torch.kernels.ref``) are held against
``repro.kernels.ref`` over the shape sweeps of ``tests/test_kernels.py``
and against the Pallas bodies in interpret mode (the CUDA kernels are held
against the plain versions on a card in ``test_torch_gpu.py``). Inputs
are made with numpy from a seed and handed to both frameworks.
"""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import attention

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

# As tests/test_kernels.py: bf16 inputs round at other places in the two
# frameworks, fp32 differ only in summation order.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

DECODE_CASES = [                 # B, H, KV, dh, L (tests/test_kernels.py)
    (2, 4, 2, 64, 512),
    (1, 8, 1, 128, 1024),
    (3, 4, 4, 32, 512),
    (1, 16, 8, 128, 2048),
]

FLASH_CASES = [                  # tests/test_kernels.py
    # B, Sq, Sk, H, KV, dh, causal, window
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 256, 256, 4, 4, 64, True, 64),
    (2, 128, 256, 4, 1, 64, True, None),      # Sq < Sk (right-aligned)
    (1, 128, 128, 2, 2, 32, False, None),     # encoder / bidirectional
    (1, 512, 512, 8, 2, 128, True, 128),      # GQA + window
    (3, 64, 64, 2, 1, 128, True, None),       # MQA
]

RGLRU_CASES = [(2, 512, 256), (1, 256, 128), (4, 128, 384)]   # B, S, W

SSM_CASES = [                    # B, S, Di, N (tests/test_kernels.py, then
    (2, 256, 256, 16),           # ragged S and S past the plain loop's
    (1, 128, 128, 8),            # chunk of steps)
    (2, 64, 384, 4),
    (3, 77, 96, 16),
    (1, 300, 64, 8),
]

PAGED_CASES = [                  # B, H, KV, dh, P, n_log, ps
    (2, 4, 2, 64, 16, 4, 16),
    (1, 8, 1, 128, 8, 8, 8),
    (3, 4, 4, 32, 12, 3, 32),
    (1, 16, 8, 128, 24, 2, 64),
]


def _flat_np(B, H, KV, dh, L, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dh), np.float32)
    k = rng.standard_normal((B, L, KV, dh), np.float32)
    v = rng.standard_normal((B, L, KV, dh), np.float32)
    valid = rng.random((B, L)) < 0.7
    valid[:, 0] = True
    return q, k, v, valid


def _paged_np(B, H, KV, dh, P, n, ps, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dh), np.float32)
    kp = rng.standard_normal((P, ps, KV, dh), np.float32)
    vp = rng.standard_normal((P, ps, KV, dh), np.float32)
    # Arbitrary tables are legal: repeats and the trash page 0 included.
    pages = rng.integers(0, P, (B, n)).astype(np.int32)
    pages[:, -1] = 0
    if n > 1:
        pages[:, 1] = pages[:, 0]
    valid = rng.random((B, n * ps)) < 0.7
    valid[:, 0] = True
    return q, kp, vp, pages, valid


def _to_torch(arrs, dtype, n_float):
    return [torch.from_numpy(a).to(dtype) if i < n_float
            else torch.from_numpy(a) for i, a in enumerate(arrs)]


def _to_jax(arrs, dtype, n_float):
    return [jnp.asarray(a, dtype) if i < n_float else jnp.asarray(a)
            for i, a in enumerate(arrs)]


def _close(out_t, out_j, name):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), **TOL[name])


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("name", DTYPES)
def test_decode_plain_matches_jax_ref(case, name):
    tdt, jdt = DTYPES[name]
    arrs = _flat_np(*case)
    out = ref.decode_attention(*_to_torch(arrs, tdt, 3))
    assert out.dtype == tdt and out.shape == (case[0], case[1], case[3])
    _close(out, jref.decode_attention(*_to_jax(arrs, jdt, 3)), name)


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("name", DTYPES)
def test_paged_plain_matches_jax_ref(case, name):
    tdt, jdt = DTYPES[name]
    arrs = _paged_np(*case)
    out = ref.paged_decode_attention(*_to_torch(arrs, tdt, 3))
    _close(out, jref.paged_decode_attention(*_to_jax(arrs, jdt, 3)), name)


@pytest.mark.parametrize("name", DTYPES)
def test_decode_plain_matches_pallas_interpret(name):
    tdt, jdt = DTYPES[name]
    arrs = _flat_np(2, 4, 2, 64, 512, seed=1)
    out = ref.decode_attention(*_to_torch(arrs, tdt, 3))
    pallas = jops.decode_attention(*_to_jax(arrs, jdt, 3), block_l=256,
                                   impl="pallas", interpret=True)
    _close(out, pallas, name)


@pytest.mark.parametrize("name", DTYPES)
def test_paged_plain_matches_pallas_interpret(name):
    tdt, jdt = DTYPES[name]
    arrs = _paged_np(3, 4, 4, 32, 12, 3, 32, seed=2)
    out = ref.paged_decode_attention(*_to_torch(arrs, tdt, 3))
    pallas = jops.paged_decode_attention(*_to_jax(arrs, jdt, 3),
                                         impl="pallas", interpret=True)
    _close(out, pallas, name)


def test_all_invalid_row_is_exact_zeros():
    """A row with no valid slot gives exact zeros (the kernels' finalize),
    not the uniform mean a plain softmax over NEG_INF logits gives —
    and agrees with the Pallas body on the other rows."""
    q, k, v, valid = _flat_np(3, 4, 2, 64, 256, seed=3)
    valid[0] = True
    valid[1] = False
    out = ref.decode_attention(*_to_torch([q, k, v, valid], torch.float32, 3))
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    pallas = jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(valid),
                                   block_l=64, impl="pallas", interpret=True)
    _close(out, pallas, "float32")

    qp, kp, vp, pages, pvalid = _paged_np(2, 4, 2, 32, 6, 3, 8, seed=4)
    pvalid[1] = False
    outp = ref.paged_decode_attention(
        *_to_torch([qp, kp, vp, pages, pvalid], torch.float32, 3))
    assert torch.equal(outp[1], torch.zeros_like(outp[1]))


def test_paged_repeats_and_trash_page_equal_flat_gather():
    """Repeated page ids and the trash page 0 are legal: only ``valid``
    decides. Walking the table equals gathering the rows' pages into a
    flat ring and running the flat version on it."""
    B, H, KV, dh, P, n, ps = 3, 4, 2, 64, 10, 4, 16
    q, kp, vp, pages, valid = _paged_np(B, H, KV, dh, P, n, ps, seed=5)
    pages[2] = pages[0]                       # a whole shared row
    tq, tkp, tvp, tpages, tvalid = _to_torch([q, kp, vp, pages, valid],
                                             torch.float32, 3)
    out = ref.paged_decode_attention(tq, tkp, tvp, tpages, tvalid)
    kf = tkp[tpages.long()].reshape(B, n * ps, KV, dh)
    vf = tvp[tpages.long()].reshape(B, n * ps, KV, dh)
    flat = ref.decode_attention(tq, kf, vf, tvalid)
    torch.testing.assert_close(out, flat, rtol=1e-6, atol=1e-6)


def test_mixed_precision_plain_equals_widened_cache():
    """q in fp32 over a bf16 cache (the engine under fp32 compute) equals
    widening the cache to fp32 first, which is what the JAX package
    does: the kernel reads the bf16 cache directly."""
    q, k, v, valid = _flat_np(2, 4, 2, 32, 96, seed=6)
    tq = torch.from_numpy(q)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    tvalid = torch.from_numpy(valid)
    torch.testing.assert_close(
        ref.decode_attention(tq, tk, tv, tvalid),
        ref.decode_attention(tq, tk.float(), tv.float(), tvalid),
        rtol=0, atol=0)


def test_dispatch_rules():
    """The tensor's device decides: on the CPU each kernel wrapper runs
    the plain version and counts no launch; a device with no kernel
    raises instead of falling back. The attention leaf switch picks
    ``dense`` for "auto" off the card and rejects unknown leaves."""
    q, k, v, valid = _to_torch(list(_flat_np(1, 4, 2, 16, 40, seed=7)),
                               torch.float32, 3)
    qp, kp, vp, pages, pvalid = _to_torch(
        list(_paged_np(1, 4, 2, 16, 5, 3, 8, seed=7)), torch.float32, 3)
    before = dict(dec.launches)
    torch.testing.assert_close(dec.decode_attention(q, k, v, valid),
                               ref.decode_attention(q, k, v, valid),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        dec.paged_decode_attention(qp, kp, vp, pages, pvalid),
        ref.paged_decode_attention(qp, kp, vp, pages, pvalid),
        rtol=0, atol=0)
    assert dec.launches == before
    meta = [t.to("meta") for t in (q, k, v, valid)]
    with pytest.raises(ValueError, match="no decode-attention kernel"):
        dec.decode_attention(*meta)
    meta = [t.to("meta") for t in (qp, kp, vp, pages, pvalid)]
    with pytest.raises(ValueError, match="no decode-attention kernel"):
        dec.paged_decode_attention(*meta)
    assert attention._resolve_impl("auto", q) == "dense"
    assert attention._resolve_impl("flash", q) == "flash"
    with pytest.raises(ValueError):
        attention._resolve_impl("pallas", q)


@pytest.mark.parametrize("L,rows,group,kv_bytes,sms", [
    (2048, 16, 6, 2, 132),       # Qwen2-1.5B decode, B=8
    (2048, 8, 10, 2, 132),       # RecurrentGemma-2B decode, B=8
    (2048, 1, 10, 2, 132),       # RecurrentGemma-2B decode, B=1
    (24, 8, 6, 2, 132), (1000, 3, 4, 4, 132), (5, 1, 1, 4, 4),
    (4096, 256, 32, 2, 132)])
def test_split_plan_covers_cache_in_whole_tiles(L, rows, group, kv_bytes,
                                                sms):
    split_len, n_splits = dec.split_plan(L, rows, group, kv_bytes, sms)
    assert split_len % dec.TILE == 0
    assert (n_splits - 1) * split_len < L <= n_splits * split_len
    blocks_per_sm = max(1, dec._WARPS_PER_SM // group)
    assert rows * n_splits <= blocks_per_sm * sms + rows
    tiles = math.ceil(L / dec.TILE)
    assert split_len // dec.TILE >= min(dec._MIN_TILES, tiles)
    # a split's K/V bytes against its fp32 partials (per head dim)
    assert (split_len * 2 * kv_bytes >= dec._PARTIAL_SHARE * group * 4
            or n_splits == 1)


def test_flash_attention_routes_by_dtype():
    """bf16 goes to the tensor-core entry, float32 to the FMA entry: the
    wrapper's table, and in the C source each entry point's launcher.
    The inference entries pass no log-sum-exp, so bf16 inference runs
    the tensor-core kernel's instance without it; the training forward's
    entry passes one."""
    assert fa.ENTRY == {torch.bfloat16: "repro_flash_attention_bf16",
                        torch.float32: "repro_flash_attention_f32"}
    src = (Path(fa.__file__).parent / "csrc" /
           "flash_attention.cu").read_text()
    for name, tc, lse in (("repro_flash_attention_bf16", "true", "nullptr"),
                          ("repro_flash_attention_f32", "false", "nullptr"),
                          ("repro_flash_attention_bf16_lse", "true",
                           "static_cast<float*>(lse)")):
        body = src[src.index(f"int {name}("):]
        body = body[:body.index("\n}\n")]
        assert f"launch_dh<{tc}>(dh, q, k, v, out, {lse}," in body
    tc = src.split("if constexpr (TC)")[1].split("} else {")[0]
    assert "lse ? tc::flash_tc_kernel<DH, true>" in tc
    assert ": tc::flash_tc_kernel<DH, false>" in tc


def _flash_np(B, Sq, Sk, H, KV, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh), np.float32),
            rng.standard_normal((B, Sk, KV, dh), np.float32),
            rng.standard_normal((B, Sk, KV, dh), np.float32))


def _rglru_np(B, S, W, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.8, 0.999, (B, S, W)).astype(np.float32),
            rng.standard_normal((B, S, W), np.float32),
            rng.standard_normal((B, W), np.float32))


def _ssm_np(B, S, Di, N, seed=0):
    """u, Δ, A, B, C, D, h0 as tests/test_kernels.py draws them, with a
    non-zero h0."""
    rng = np.random.default_rng(seed)
    delta = np.logaddexp(rng.standard_normal((B, S, Di)), 0)
    return (rng.standard_normal((B, S, Di), np.float32),
            delta.astype(np.float32),
            -np.exp(rng.standard_normal((Di, N)) * 0.5).astype(np.float32),
            rng.standard_normal((B, S, N), np.float32),
            rng.standard_normal((B, S, N), np.float32),
            rng.standard_normal((Di,), np.float32),
            rng.standard_normal((B, Di, N), np.float32))


def _ssm_args(arrs, tdt):
    """u in ``tdt``, the rest fp32, as the model hands them over."""
    return [torch.from_numpy(a).to(tdt) if i == 0 else torch.from_numpy(a)
            for i, a in enumerate(arrs)]


def _ssm_jax(arrs, jdt):
    return [jnp.asarray(a, jdt) if i == 0 else jnp.asarray(a)
            for i, a in enumerate(arrs)]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("name", DTYPES)
def test_flash_plain_matches_jax_ref(case, name):
    tdt, jdt = DTYPES[name]
    B, Sq, Sk, H, KV, dh, causal, window = case
    arrs = _flash_np(B, Sq, Sk, H, KV, dh)
    out = ref.flash_attention(*_to_torch(arrs, tdt, 3), causal=causal,
                              window=window)
    assert out.dtype == tdt and out.shape == (B, Sq, H, dh)
    _close(out, jref.flash_attention(*_to_jax(arrs, jdt, 3), causal=causal,
                                     window=window), name)


@pytest.mark.parametrize("case", RGLRU_CASES)
@pytest.mark.parametrize("name", DTYPES)
def test_rglru_plain_matches_jax_ref(case, name):
    """The sequential loop against the JAX package's ``lax.scan``: y in
    x's dtype with that file's tolerances, h_last fp32 (1e-5; 1e-2 where
    the inputs are bf16, as tests/test_kernels.py holds the kernel)."""
    tdt, jdt = DTYPES[name]
    arrs = _rglru_np(*case)
    y, h = ref.rglru_scan(*_to_torch(arrs, tdt, 2))
    jy, jh = jref.rglru_scan(*_to_jax(arrs, jdt, 2))
    assert y.dtype == tdt and h.dtype == torch.float32
    _close(y, jy, name)
    tol = 1e-2 if name == "bfloat16" else 1e-5
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", SSM_CASES)
@pytest.mark.parametrize("name", DTYPES)
def test_ssm_plain_matches_jax_ref(case, name):
    """The sequential loop against the JAX package's ``lax.scan``: y in
    u's dtype with this file's tolerances, h_last fp32 within 1e-5 (both
    compute in fp32 from the same inputs; exp and the sum over N differ
    in the last bits)."""
    tdt, jdt = DTYPES[name]
    arrs = _ssm_np(*case)
    y, h = ref.ssm_scan(*_ssm_args(arrs, tdt))
    jy, jh = jref.ssm_scan(*_ssm_jax(arrs, jdt))
    B, S, Di, N = case
    assert y.dtype == tdt and y.shape == (B, S, Di)
    assert h.dtype == torch.float32 and h.shape == (B, Di, N)
    assert h.is_contiguous()
    _close(y, jy, name)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", DTYPES)
def test_ssm_plain_matches_pallas_interpret(name):
    """Against the Pallas body at an S and Di its blocks divide (the
    kernel takes any)."""
    tdt, jdt = DTYPES[name]
    arrs = _ssm_np(2, 128, 128, 16, seed=12)
    y, h = ref.ssm_scan(*_ssm_args(arrs, tdt))
    jy, jh = jops.ssm_scan(*_ssm_jax(arrs, jdt), block_s=64, block_d=64,
                           interpret=True)
    _close(y, jy, name)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", DTYPES)
def test_flash_plain_matches_pallas_interpret(name):
    tdt, jdt = DTYPES[name]
    arrs = _flash_np(1, 128, 256, 4, 2, 32, seed=8)
    out = ref.flash_attention(*_to_torch(arrs, tdt, 3), window=96)
    pallas = jops.flash_attention(*_to_jax(arrs, jdt, 3), window=96,
                                  block_q=64, block_k=64, interpret=True)
    _close(out, pallas, name)


@pytest.mark.parametrize("name", DTYPES)
def test_rglru_plain_matches_pallas_interpret(name):
    tdt, jdt = DTYPES[name]
    arrs = _rglru_np(2, 256, 128, seed=9)
    y, h = ref.rglru_scan(*_to_torch(arrs, tdt, 2))
    jy, jh = jops.rglru_scan(*_to_jax(arrs, jdt, 2), block_s=128,
                             block_w=128, interpret=True)
    _close(y, jy, name)
    tol = 1e-2 if name == "bfloat16" else 1e-5
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=tol, atol=tol)


def test_prefill_kernel_dispatch_rules():
    """K3, K4 and K5 on the CPU run the plain version and count no launch;
    a device with no kernel raises instead of falling back; and none
    hands autograd an output whose gradient it does not compute."""
    q, k, v = (torch.from_numpy(a) for a in _flash_np(1, 40, 40, 4, 2, 16,
                                                      seed=10))
    a, x, h0 = (torch.from_numpy(t) for t in _rglru_np(2, 30, 24, seed=10))
    sargs = _ssm_args(_ssm_np(2, 30, 24, 8, seed=10), torch.float32)
    before = (dict(fa.launches), dict(rg.launches), dict(ss.launches))
    torch.testing.assert_close(fa.flash_attention(q, k, v, window=7),
                               ref.flash_attention(q, k, v, window=7),
                               rtol=0, atol=0)
    for got, want in zip(rg.rglru_scan(a, x, h0), ref.rglru_scan(a, x, h0)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(ss.ssm_scan(*sargs), ref.ssm_scan(*sargs)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (fa.launches, rg.launches, ss.launches) == before
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_attention(*(t.to("meta") for t in (q, k, v)))
    with pytest.raises(ValueError, match="no rglru-scan kernel"):
        rg.rglru_scan(*(t.to("meta") for t in (a, x, h0)))
    with pytest.raises(ValueError, match="no ssm-scan kernel"):
        ss.ssm_scan(*(t.to("meta") for t in sargs))
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        rg.rglru_scan(a, x.requires_grad_(), h0)
    with pytest.raises(RuntimeError, match="no backward"):
        ss.ssm_scan(sargs[0].requires_grad_(), *sargs[1:])
    with torch.no_grad():                 # no gradient asked for: fine
        fa.flash_attention(q, k, v)
        rg.rglru_scan(a, x, h0)
        ss.ssm_scan(*sargs)


@pytest.mark.parametrize("N,lanes", [(N, L) for N in ss.STATE_SIZES
                                     for L in (2, 4, 8) if L <= N])
def test_ssm_lane_layout_sums_in_halving_order(N, lanes):
    """The CUDA selective scan's sum over N, emulated here: lane j of a
    channel holds states n = j + L*k (k < K = N/L), folds them in
    registers (k with k + K/2, then k + K/4, ...) and then adds lane
    j ^ L/2, ..., j ^ 1 (a butterfly of shuffles). Every lane ends with
    ref._halving_sum's value, bit for bit, for the 4 lanes the kernel
    uses and the 2 and 8 of its sweep; a left-to-right sum of the same
    numbers does not."""
    rng = np.random.default_rng(10 * N + lanes)
    mag = 10.0 ** rng.uniform(-4, 4, (256, N))
    t = torch.from_numpy((rng.standard_normal((256, N)) * mag)
                         .astype(np.float32))
    K = N // lanes
    p = t.reshape(-1, K, lanes).transpose(1, 2)     # p[:, j, k] = t[:, j+L*k]
    w = K // 2
    while w >= 1:                                   # in-thread folds
        p = p[..., :w] + p[..., w:2 * w]
        w //= 2
    s = p[..., 0]                                   # [rows, L]
    o = lanes // 2
    while o >= 1:                                   # shuffles at xor o
        s = s + s[:, torch.arange(lanes) ^ o]
        o //= 2
    want = ref._halving_sum(t)
    for j in range(lanes):
        assert torch.equal(s[:, j], want)
    seq = t[:, 0].clone()
    for n in range(1, N):
        seq = seq + t[:, n]
    assert not torch.equal(seq, want)


def test_flash_plain_right_aligns_and_windows():
    """Queries right-aligned over a longer key sequence equal the last Sq
    rows of the square problem, with or without a window."""
    q, k, v = (torch.from_numpy(t) for t in _flash_np(2, 48, 48, 4, 1, 16,
                                                      seed=11))
    for window in (None, 10):
        full = ref.flash_attention(q, k, v, window=window)
        tail = ref.flash_attention(q[:, -20:].contiguous(), k, v,
                                   window=window)
        torch.testing.assert_close(tail, full[:, -20:], rtol=1e-6,
                                   atol=1e-6)
