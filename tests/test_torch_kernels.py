"""The port's decode-attention kernels against the JAX package.

The plain PyTorch versions (``repro_torch.kernels.ref``) are held against
``repro.kernels.ref`` over the shape sweeps of ``tests/test_kernels.py``
and against the Pallas bodies in interpret mode (the CUDA kernels are held
against the plain versions on a card in ``test_torch_gpu.py``). Inputs
are made with numpy from a seed and handed to both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ref
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


@pytest.mark.parametrize("L,rows,sms", [(2048, 16, 132), (24, 8, 132),
                                        (1000, 3, 132), (5, 1, 4),
                                        (4096, 256, 132)])
def test_split_plan_covers_cache_in_whole_tiles(L, rows, sms):
    split_len, n_splits = dec.split_plan(L, rows, sms)
    assert split_len % dec.TILE == 0
    assert (n_splits - 1) * split_len < L <= n_splits * split_len
    assert rows * n_splits <= dec._BLOCKS_PER_SM * sms + rows
