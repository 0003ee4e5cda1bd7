"""The dropless expert layer's pair kernels on the CPU: their plain
versions (``kernels/ref.py``) against the layer's former pair-wide tensor
code, which gathered, activated and combined all N*K (token, choice)
pairs; the wrappers' dispatch and refusals; and the learner's count of
the pairs a step routes. The kernels themselves are held to the plain
versions on the card (``tests/test_torch_gpu.py``).

Tolerances, all fp32: the same sums in another order, within 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.kernels import moe_pairs, ref
from repro_torch.models import layers, moe

torch.set_num_threads(1)

ARCH = "mellum2-12b-a2.5b"
TOL = {"rtol": 1e-6, "atol": 1e-6}


def _cfg():
    return dataclasses.replace(configs.get_reduced(ARCH),
                               compute_dtype="float32")


# -- the layer's former code, pair-wide -----------------------------------------

class _PairRows(torch.autograd.Function):
    """x[tok]; the gradient of token t sums its held pairs' rows."""

    @staticmethod
    def forward(ctx, x, tok, pos, held):
        ctx.save_for_backward(pos, held)
        return x[tok]

    @staticmethod
    def backward(ctx, g):
        pos, held = ctx.saved_tensors
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return torch.where(held[..., None], g[pos], zero).sum(1), None, \
            None, None


def _pair_wide_combine(ye, k_gate, pos, held):
    zero = torch.zeros((), dtype=ye.dtype, device=ye.device)
    got = torch.where(held[..., None], ye[pos], zero)
    return (k_gate.float()[..., None] * got.float()).sum(dim=1).to(ye.dtype)


def _pair_wide_dropless(cfg, p, x):
    B, S, D = x.shape
    K = cfg.experts_per_token
    lo, hi = cfg.held_range
    N = B * S
    xf = x.reshape(N, D)
    probs = torch.softmax(layers.apply_linear(p["router"], xf).float(), -1)
    idx, mask = moe.topk_mask(probs, K)
    gates = probs * mask
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    k_gate = torch.gather(gates, -1, idx).to(x.dtype)
    held = (idx >= lo) & (idx < hi)
    order, pos, ends = moe.sort_pairs(idx, lo, hi)
    xs = _PairRows.apply(xf, torch.div(order, K, rounding_mode="floor"),
                         pos, held)
    h = (F.silu(moe.grouped_mm(xs, p["w_gate"].to(x.dtype), ends))
         * moe.grouped_mm(xs, p["w_up"].to(x.dtype), ends))
    ye = moe.grouped_mm(h, p["w_down"].to(x.dtype), ends)
    y = _pair_wide_combine(ye, k_gate, pos, held)
    rows = torch.diff(ends, prepend=ends.new_zeros(1)).float()
    return y.view(B, S, D), moe._aux_loss(cfg, mask.mean(0), probs.mean(0)), \
        rows


def _leaves(seed, cfg, B, S):
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_moe(cfg, gen, "cpu", torch.float32)
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    w = torch.randn(B, S, cfg.d_model, generator=gen)
    return p, x, w


def _run(fn, cfg, p, x, w):
    p = {k: ({"kernel": v["kernel"].clone().requires_grad_()}
             if k == "router" else v.clone().requires_grad_())
         for k, v in p.items()}
    x = x.clone().requires_grad_()
    y, aux, rows = fn(cfg, p, x)
    ((y * w).sum() + aux).backward()
    grads = [x.grad, p["router"]["kernel"].grad,
             *(p[k].grad for k in ("w_gate", "w_up", "w_down"))]
    return y, aux, rows, grads


@pytest.mark.parametrize("seed,B,S", [(0, 1, 32), (1, 2, 24), (2, 3, 7)])
def test_the_layer_equals_its_pair_wide_code(seed, B, S):
    """The reduced Mellum2's dropless layer through the pair kernels'
    plain versions (the wrappers' CPU route), output and every gradient,
    equals the former pair-wide tensor code."""
    cfg = _cfg()
    p, x, w = _leaves(seed, cfg, B, S)
    got = _run(moe.apply_dropless, cfg, p, x, w)
    want = _run(_pair_wide_dropless, cfg, p, x, w)
    torch.testing.assert_close(got[0], want[0], **TOL)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for g, wg in zip(got[3], want[3]):
        torch.testing.assert_close(g, wg, **TOL)


def _routing(seed, N=48, K=4, E=16, lo=4, hi=12):
    """A routing of N tokens' K choices over E experts, lo..hi-1 held,
    with token 0's choices all held and token 1's none; (order, pos,
    ends) sorted as the layer sorts them."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(E, K, replace=False) for _ in range(N)])
    idx[0] = np.arange(lo, lo + K)
    idx[1] = np.arange(hi, hi + K) % E
    return moe.sort_pairs(torch.as_tensor(idx), lo, hi)


@pytest.mark.parametrize("seed", [0, 1])
def test_the_combine_twin_is_the_pair_wide_combine(seed):
    _, pos, ends = _routing(seed)
    N, K = pos.shape
    gen = torch.Generator().manual_seed(seed)
    ye = torch.randn(N * K, 64, generator=gen).requires_grad_()
    gate = torch.rand(N, K, generator=gen).requires_grad_()
    dy = torch.randn(N, 64, generator=gen)
    held = ref.moe_held(pos, ends)
    want = _pair_wide_combine(ye, gate, pos, held)
    want.backward(dy)
    got = ref.moe_combine(ye.detach(), gate.detach(), pos, ends)
    assert torch.equal(got, want)
    assert bool((got[1] == 0).all())              # token 1 holds none
    dye, dgate = ref.moe_combine_bwd(dy, ye.detach(), gate.detach(), pos,
                                     ends)
    n = int(ends[-1])
    torch.testing.assert_close(dye[:n], ye.grad[:n], **TOL)
    torch.testing.assert_close(dgate, gate.grad, **TOL)
    assert bool((dgate[~held] == 0).all())


def test_the_gather_twins_backward_is_the_ordered_pair_sum():
    order, pos, ends = _routing(2)
    N, K = pos.shape
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(N, 64, generator=gen).requires_grad_()
    tok = torch.div(order, K, rounding_mode="floor")
    held = ref.moe_held(pos, ends)
    g = torch.randn(N * K, 64, generator=gen)
    _PairRows.apply(x, tok, pos, held).backward(g)
    assert torch.equal(ref.moe_gather(x.detach(), tok, ends), x.detach()[tok])
    torch.testing.assert_close(ref.moe_combine(g, None, pos, ends), x.grad,
                               **TOL)
    xg = x.detach().clone().requires_grad_()
    moe_pairs.gather(xg, tok, pos, ends).backward(g)
    torch.testing.assert_close(xg.grad, x.grad, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_swiglu_twin_is_silu_times_up(dtype):
    """silu(a) * b in fp32, rounded once; its gradient is autograd's of
    the same fp32 product, rounded once (bf16: to within a rounding)."""
    gen = torch.Generator().manual_seed(3)
    ab = (torch.randn(40, 64, generator=gen) * 3).to(dtype)
    dh = torch.randn(40, 32, generator=gen).to(dtype)
    ends = torch.tensor([10, 30], dtype=torch.int32)
    ab32 = ab.float().requires_grad_()
    want = F.silu(ab32[:, :32]) * ab32[:, 32:]
    want.backward(dh.float())
    got = ref.moe_swiglu(ab, ends)
    assert got.dtype == dtype and torch.equal(got, want.to(dtype))
    tol = TOL if dtype == torch.float32 else {"rtol": 1e-2, "atol": 1e-2}
    torch.testing.assert_close(ref.moe_swiglu_bwd(dh, ab, ends).float(),
                               ab32.grad.to(dtype).float(), **tol)


def test_the_reduced_configs_own_dtype_takes_the_wrappers():
    """The reduced Mellum2 in its own bf16 (top-4: a token's 4 gates are
    8 bytes, read an element at a time) runs the layer forward and
    backward through the wrappers."""
    cfg = configs.get_reduced(ARCH)
    gen = torch.Generator().manual_seed(6)
    p = moe.init_moe(cfg, gen, "cpu", torch.float32)
    x = torch.randn(2, 16, cfg.d_model, generator=gen).to(torch.bfloat16)
    x.requires_grad_()
    y, aux, _ = moe.apply_dropless(cfg, p, x)
    (y.float().square().sum() + aux).backward()
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(x.grad).all())


def test_a_cpu_tensor_goes_to_the_plain_versions():
    _, pos, ends = _routing(4)
    N, K = pos.shape
    gen = torch.Generator().manual_seed(4)
    ab = torch.randn(N * K, 64, generator=gen)
    ye = torch.randn(N * K, 64, generator=gen)
    gate = torch.rand(N, K, generator=gen)
    before = dict(moe_pairs.launches)
    assert torch.equal(moe_pairs.swiglu(ab, ends), ref.moe_swiglu(ab, ends))
    assert torch.equal(moe_pairs.combine(ye, gate, pos, ends),
                       ref.moe_combine(ye, gate, pos, ends))
    assert moe_pairs.launches == before


@pytest.mark.parametrize("case", ["dtype", "row bytes", "odd width",
                                  "too many choices", "pos shape",
                                  "index dtype", "ends dtype",
                                  "not contiguous", "gate shape"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(case):
    order, pos, ends = _routing(5)
    N, K = pos.shape
    tok = torch.div(order, K, rounding_mode="floor")
    x = torch.zeros(N, 64)
    ye = torch.zeros(N * K, 64)
    gate = torch.zeros(N, K)
    call, err = {
        "dtype": (lambda: moe_pairs.gather(x.half(), tok, pos, ends),
                  TypeError),
        "row bytes": (lambda: moe_pairs.combine(ye[:, :6].contiguous(), gate,
                                                pos, ends), ValueError),
        "odd width": (lambda: moe_pairs.swiglu(ye[:, :63].contiguous(), ends),
                      ValueError),
        "too many choices": (lambda: moe_pairs.combine(
            ye, gate.reshape(N // 4, 16), pos.reshape(N // 4, 16), ends),
            ValueError),
        "pos shape": (lambda: moe_pairs.gather(x, tok, pos[:-1], ends),
                      ValueError),
        "index dtype": (lambda: moe_pairs.gather(x, tok.int(), pos, ends),
                        TypeError),
        "ends dtype": (lambda: moe_pairs.swiglu(ye, ends.long()), ValueError),
        "not contiguous": (lambda: moe_pairs.gather(x.t().contiguous().t(),
                                                    tok, pos, ends),
                           ValueError),
        "gate shape": (lambda: moe_pairs.combine(ye, gate[:, :2].contiguous(),
                                                 pos, ends), ValueError),
    }[case]
    with pytest.raises(err):
        call()


def test_read_step_counts_the_pairs_a_step_routes():
    """``LMTask.read_step`` reports ``moe.pairs``, layers x tokens x top-k
    counted on the host, beside the held rows."""
    from repro_torch.launch.train import LMTask
    from repro_torch.train.train_step import TrainConfig
    cfg = _cfg()
    task = LMTask(cfg, TrainConfig(num_microbatches=2), device="cpu")
    params = task.init_params(0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)), dtype=torch.int32)
    loss, _ = task.grad_fn(params, {"tokens": toks, "labels": toks})
    _, got = task.read_step(loss)
    pairs = cfg.num_layers * 4 * 32 * cfg.experts_per_token
    assert got["moe.pairs"] == pairs
    assert 0 < got["moe.rows_held"] < pairs
    # The held experts (8 of 16, top-4) take about half the pairs.
    assert 0.25 < got["moe.rows_held"] / pairs < 0.75


def test_a_dense_task_reports_no_pairs():
    from repro_torch.launch.train import LMTask
    from repro_torch.train.train_step import TrainConfig
    cfg = configs.get_reduced("qwen2-1.5b")
    task = LMTask(cfg, TrainConfig(), device="cpu")
    toks = torch.zeros((2, 16), dtype=torch.int32)
    loss, _ = task.grad_fn(task.init_params(0),
                           {"tokens": toks, "labels": toks})
    assert task.read_step(loss)[1] == {}

