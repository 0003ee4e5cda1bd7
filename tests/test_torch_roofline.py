"""The port's roofline (``repro_torch.roofline``) against the JAX
package's: the same arithmetic on the same numbers (the terms scaled by
the ratio of the two packages' hardware figures), the same ring wire
bytes for every collective, and per-device counting on a planning mesh
(the product's local FLOPs, not the global product's; an all-gather's
ring bytes)."""

from __future__ import annotations

import json

import pytest

from repro.roofline import analysis as jan
from repro.roofline import hw as jhw
from repro_torch.roofline import analysis, hw
from tests.test_torch_sharding import run_py

COST = dict(flops=3.8e13, bytes_accessed=2.1e11, wire_bytes=4.4e9,
            collective_counts={"all-reduce": 3, "all-gather": 5})


def _fields(c) -> tuple:
    return (c.flops, c.bytes_accessed, c.wire_bytes,
            dict(c.collective_counts))


def test_cell_cost_arithmetic_matches_jax():
    a, b = analysis.CellCost(**COST), jan.CellCost(**COST)
    a2 = analysis.CellCost(1e12, 1e9, 1e8, {"all-reduce": 1})
    b2 = jan.CellCost(1e12, 1e9, 1e8, {"all-reduce": 1})
    assert _fields(a - a2) == _fields(b - b2)
    assert _fields(a + a2) == _fields(b + b2)
    assert _fields(a.scaled(2.5)) == _fields(b.scaled(2.5))
    for n in (1.0, 14.0, 28.0):
        for micro in (1.0, 4.0):
            assert _fields(analysis.extrapolate(a2, a, n, micro)) == \
                _fields(jan.extrapolate(b2, b, n, micro))


def test_roofline_terms_match_jax_scaled_by_the_hardware():
    mf = 2.9e13
    mine = analysis.roofline_from_cost(analysis.CellCost(**COST), mf)
    ref = jan.roofline_from_cost(jan.CellCost(**COST), mf)
    assert mine.compute_s == pytest.approx(
        ref.compute_s * jhw.PEAK_FLOPS_BF16 / hw.PEAK_FLOPS_BF16, rel=1e-12)
    assert mine.memory_s == pytest.approx(
        ref.memory_s * jhw.HBM_BW / hw.HBM_BW, rel=1e-12)
    assert mine.collective_s == pytest.approx(
        ref.collective_s * jhw.ICI_LINK_BW / hw.LINK_BW, rel=1e-12)
    assert (mine.model_flops, mine.hlo_flops) == (ref.model_flops,
                                                  ref.hlo_flops)
    assert mine.useful_flops_ratio == ref.useful_flops_ratio
    # bound / step / MFU follow the terms exactly as in the JAX package
    terms = {"compute": mine.compute_s, "memory": mine.memory_s,
             "collective": mine.collective_s}
    assert mine.bound == max(terms, key=terms.get)
    assert mine.step_s == max(terms.values())
    assert mine.mfu == pytest.approx(
        mf / hw.PEAK_FLOPS_BF16 / mine.step_s, rel=1e-12)


def test_hw_is_the_h100_not_a_tpu():
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.HBM_BW == 3.35e12
    assert hw.LINK_BW == 50e9
    assert 80e9 < hw.HBM_BYTES < 86e9
    assert not any(hasattr(hw, n) for n in ("ICI_LINK_BW", "CHIPS_PER_POD"))


_HLO = {
    "all-reduce": "%ar = bf16[16,4096,512]{2,1,0} all-reduce(%x), "
                  "replica_groups=[N,G]<=[256], to_apply=%add",
    "all-gather": "%ag = bf16[16,4096,512]{2,1,0} all-gather(%x), "
                  "replica_groups=[N,G]<=[256], dimensions={2}",
    "reduce-scatter": "%rs = f32[96,560]{1,0} reduce-scatter(%x), "
                      "replica_groups=[N,G]<=[256], dimensions={0}",
    "all-to-all": "%aa = bf16[8,128,64]{2,1,0} all-to-all(%x), "
                  "replica_groups=[N,G]<=[256], dimensions={0}",
}


@pytest.mark.parametrize("group", [2, 4, 16])
@pytest.mark.parametrize("kind", list(_HLO))
def test_wire_bytes_match_jax_parse_collectives(kind, group):
    line = _HLO[kind].replace("[N,G]", f"[{256 // group},{group}]")
    stats = jan.parse_collectives(line, 256)
    size = stats.result_bytes[kind]
    assert stats.counts[kind] == 1 and size > 0
    assert analysis.wire_bytes(kind, size, group) == stats.wire_bytes[kind]


def test_permute_and_single_device_wire_bytes():
    line = ("%cp = bf16[4,64]{1,0} collective-permute(%x), "
            "source_target_pairs={{0,1},{1,0}}")
    stats = jan.parse_collectives(line, 2)
    assert analysis.wire_bytes("collective-permute", 512, 2) == \
        stats.wire_bytes["collective-permute"] == 512
    assert analysis.wire_bytes("all-reduce", 1e6, 1) == 0.0
    with pytest.raises(ValueError):
        analysis.wire_bytes("broadcast", 1.0, 2)


def test_per_device_flops_and_ring_bytes_on_a_planning_mesh():
    """[B,S,D] @ [D,F] with x batch-sharded over 'data' and the weight
    column-sharded over 'model' on a 2x4 mesh: each device multiplies its
    own [B/2,S,D] by [D,F/4], 2*B*S*D*F/8 FLOPs; gathering the result's
    features over 'model' is one all-gather of the [B/2,S,F] result."""
    out = run_py("""
    import json, torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding import ShardingCtx, shard, use_sharding
    from repro_torch.sharding.compat import planning_mesh
    from repro_torch.sharding.rules import Spec, placements
    from repro_torch.roofline.analysis import cost_of
    B, S, D, F = 8, 64, 32, 48
    mesh = planning_mesh((2, 4), ("data", "model"))
    dev = mesh.device_type
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(B // 2, S, D, device=dev), mesh,
                               placements(mesh, Spec("data", None, None)),
                               run_check=False)
        w = DTensor.from_local(torch.empty(D, F // 4, device=dev), mesh,
                               placements(mesh, Spec(None, "model")),
                               run_check=False)
        with use_sharding(ShardingCtx(mesh)):
            out, rec = cost_of(lambda x, w: shard(x @ w, "dp", None, None),
                               (x, w))
        local = list(out.to_local().shape)
    print(json.dumps({"flops": rec.cost.flops, "wire": rec.cost.wire_bytes,
                      "counts": rec.cost.collective_counts,
                      "result": rec.collective_result_bytes,
                      "arg": rec.argument_bytes, "local": local}))
    """)
    res = json.loads(out.strip().splitlines()[-1])
    B, S, D, F = 8, 64, 32, 48
    assert res["flops"] == 2 * B * S * D * F / 8
    assert res["local"] == [B // 2, S, F]
    gathered = (B // 2) * S * F * 4
    assert res["counts"]["all-gather"] == 1
    assert res["result"]["all-gather"] == gathered
    assert res["wire"] == pytest.approx(gathered * 3 / 4)
    assert res["arg"] == (B // 2) * S * D * 4 + D * (F // 4) * 4


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None), (False, 7)])
@pytest.mark.parametrize("Sq,Sk", [(16, 16), (8, 24), (1, 9)])
def test_flash_flops_count_the_visible_pairs(Sq, Sk, causal, window):
    """K3's FLOP formula: q.k and p.v over the pairs ``ref.visible`` keeps
    (a causal query right-aligned on more keys than queries), 4 dh a pair
    and head, as PyTorch's counter sees the custom op."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ref
    B, H, KV, dh = 2, 4, 2, 16
    q = torch.randn(B, Sq, H, dh)
    k = torch.randn(B, Sk, KV, dh)
    pairs = int(ref.visible(Sq, Sk, causal, window).sum())
    assert k3.visible_pairs(Sq, Sk, causal, window) == pairs
    with FlopCounterMode(display=False) as fc:
        k3.flash_attention(q, k, k, causal=causal, window=window)
    assert fc.get_total_flops() == 4 * B * H * dh * pairs


def test_kernel_ops_trace_as_one_op_with_their_shapes():
    """Under ``FakeTensorMode`` each kernel wrapper's custom op answers
    with its outputs' shapes and dtypes (nothing runs), and a counter sees
    one op a call with its formula's FLOPs."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import decode_attention as k12
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import rglru_scan as k4
    from repro_torch.kernels import ssm_scan as k5
    B, S, H, KV, dh, L, W, Di, N = 2, 64, 4, 2, 32, 48, 24, 16, 8
    with FakeTensorMode():
        q1 = torch.empty(B, H, dh, dtype=torch.bfloat16)
        kv = torch.empty(B, L, KV, dh, dtype=torch.bfloat16)
        valid = torch.empty(B, L, dtype=torch.bool)
        q3 = torch.empty(B, S, H, dh, dtype=torch.bfloat16)
        k3_ = torch.empty(B, S, KV, dh, dtype=torch.bfloat16)
        a = torch.empty(B, S, W)
        u = torch.empty(B, S, Di, dtype=torch.bfloat16)
        d, A = torch.empty(B, S, Di), torch.empty(Di, N)
        bc, D, h0 = torch.empty(B, S, N), torch.empty(Di), \
            torch.empty(B, Di, N)
        with FlopCounterMode(display=False) as fc:
            out1 = k12.decode_attention(q1, kv, kv, valid)
            out3 = k3.flash_attention(q3, k3_, k3_)
            y4, h4 = k4.rglru_scan(a, a, torch.empty(B, W))
            y5, h5 = k5.ssm_scan(u, d, A, bc, bc, D, h0)
    assert (out1.shape, out1.dtype) == (q1.shape, torch.bfloat16)
    assert (out3.shape, out3.dtype) == (q3.shape, torch.bfloat16)
    assert (y4.shape, h4.shape, h4.dtype) == (a.shape, (B, W),
                                              torch.float32)
    assert (y5.shape, y5.dtype, h5.shape) == (u.shape, torch.bfloat16,
                                              (B, Di, N))
    want = (4 * B * H * dh * L
            + 4 * B * H * dh * k3.visible_pairs(S, S, True, None)
            + 2 * B * S * W + 8 * B * S * Di * N + 2 * B * S * Di)
    assert fc.get_total_flops() == want
    assert sum(k.launches[n] for k, n in (
        (k12, "decode_attention"), (k3, "flash_attention"),
        (k4, "rglru_scan"), (k5, "ssm_scan"))) == 0
