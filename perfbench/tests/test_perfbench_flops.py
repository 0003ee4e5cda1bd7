"""The transformer architecture's FLOP and byte counts on shapes checked by
hand."""

import pytest

from perfbench import spec

ARCH = spec.arch("transformer")
QWEN = ARCH.sizes(spec.load_json(f"{spec.HERE}/configs/qwen2-1.5b.json"))
MIXTRAL = ARCH.sizes(spec.load_json(
    f"{spec.HERE}/configs/mixtral-8x7b.json"))


def test_parameter_counts_match_the_published_sizes():
    # Qwen2-1.5B: 1,543,714,304 parameters (embedding tied).
    assert ARCH.param_count(QWEN) == 1_543_714_304
    # Mixtral-8x7B, 16 of 32 layers: half the 46.7 B less the shared
    # embedding and head.
    per_layer = (4096 * 4096 * 2 + 4096 * 1024 * 2
                 + 8 * 3 * 4096 * 14336 + 4096 * 8 + 2 * 4096)
    assert ARCH.param_count(MIXTRAL) == (16 * per_layer
                                          + 2 * 32000 * 4096 + 4096)


def test_active_matmul_weights():
    # Mixtral's top-2: two experts' three matrices and the router.
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    mlp = 2 * 3 * 4096 * 14336 + 4096 * 8
    assert ARCH.matmul_params(MIXTRAL) == 16 * (attn + mlp) + 4096 * 32000
    assert ARCH.matmul_params(MIXTRAL, active=False) > \
        ARCH.matmul_params(MIXTRAL)


def test_attention_pairs_flops_and_kv_bytes():
    assert ARCH.attn_pairs_prefill(0, 4) == 1 + 2 + 3 + 4
    assert ARCH.attn_pairs_prefill(10, 2) == 11 + 12
    assert ARCH.attn_pairs_prefill(0, 6, window=2) == 1 + 2 * 5
    # 4 FLOPs a pair, head and dimension: q.k and p.v, 2 each.
    assert ARCH.attn_flops(QWEN, 1) == 4 * 12 * 128 * 28
    # Qwen2: 28 layers x K and V x 2 heads x 128 x 2 bytes.
    assert ARCH.kv_bytes_per_token(QWEN) == 28 * 2 * 2 * 128 * 2 == 28672
    assert ARCH.decode_kv_bytes(QWEN, [0, 9]) == 11 * 28672
    assert ARCH.decode_kv_bytes(MIXTRAL, [5000]) == 4096 * \
        ARCH.kv_bytes_per_token(MIXTRAL)


def test_train_and_token_flops():
    f = ARCH.train_flops(QWEN, 8, 1024)
    n = ARCH.matmul_params(QWEN)
    assert f == pytest.approx(6 * n * 8192 + 3 * 4 * 8 * 1024 * 1024
                              * 12 * 128 * 28)
    assert ARCH.token_flops(QWEN, 3, 0) == 6 * n
