"""The learner's attention through the flash kernel's differentiable entry,
on the CPU: the plain backward (``kernels/ref.py``, the backward kernels'
contract) against autograd through the fp32 dense attention, the entry
(``flash_attention.flash_attention_train``, a custom op with its own
backward) against the plain versions, the gradient pass's route and its
``train.attn.*`` counters, and how the backward spreads a group's heads.

A CPU tensor never takes the kernels; the route tests stand in for a card
by patching ``attention._on_card``, and the entry then runs its plain
versions.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.core import telemetry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention, transformer
from repro_torch.train import tree
from repro_torch.train.train_step import make_loss_fn

CASES = [
    # B, Sq, Sk, H, KV, dh, causal, window
    (2, 70, 70, 2, 2, 16, True, None),       # groups of 1, Sq not 64k
    (1, 100, 100, 4, 2, 16, True, 30),       # groups of 2, a window
    (2, 65, 65, 8, 1, 128, False, None),     # groups of 8, bidirectional
    (1, 40, 90, 8, 1, 16, True, 25),         # right-aligned queries
    (1, 33, 77, 4, 2, 128, False, None),     # cross-attention, Sq < Sk
    (1, 129, 129, 2, 1, 128, True, 64),      # dh 128, a window
]


def _inputs(case, dtype, seed=0):
    B, Sq, Sk, H, KV, dh, _, _ = case
    gen = torch.Generator().manual_seed(seed)
    q, g = (torch.randn((B, Sq, H, dh), generator=gen).to(dtype)
            for _ in range(2))
    k, v = (torch.randn((B, Sk, KV, dh), generator=gen).to(dtype)
            for _ in range(2))
    return q, k, v, g


def _dense_grads(q, k, v, g, causal, window):
    """Output and (dq, dk, dv) by autograd through the model's fp32 dense
    attention (``attention._sdpa``, the masks from right-aligned query
    positions)."""
    cfg = configs.get_reduced("qwen2-1.5b")
    Sq, Sk = q.shape[1], k.shape[1]
    bias = attention._mask_bias(cfg, torch.arange(Sq) + (Sk - Sq),
                                torch.arange(Sk), causal, window)[None, None]
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    out = attention._sdpa(cfg, *leaves, bias)
    out.backward(g.float())
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_through_dense(case):
    """At fp32 the plain forward's output and log-sum-exp and the plain
    backward equal what autograd gives through the dense path, to fp32
    rounding; with bf16 inputs (P and dS rounded to bf16 before their
    products, as the kernels round them) within 1% relative L2."""
    causal, window = case[6], case[7]
    q, k, v, g = _inputs(case, torch.float32)
    want_out, want = _dense_grads(q, k, v, g, causal, window)
    out, lse = ref.flash_attention_lse(q, k, v, causal, window)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    ok = ref.visible(q.shape[1], k.shape[1], causal, window)
    logits = torch.einsum("bqhd,bshd->bhqs", q,
                          k.repeat_interleave(q.shape[2] // k.shape[2], 2))
    logits = (logits * q.shape[3] ** -0.5).masked_fill(~ok, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=1e-5,
                               atol=1e-5)
    got = ref.flash_attention_bwd(q, k, v, out, lse, g, causal, window)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)

    q, k, v, g = _inputs(case, torch.bfloat16)
    _, want = _dense_grads(q, k, v, g, causal, window)
    out, lse = ref.flash_attention_lse(q, k, v, causal, window)
    got = ref.flash_attention_bwd(q, k, v, out, lse, g, causal, window)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b).norm()) <= 1e-2 * float(b.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_entry_on_cpu_tensors_equals_the_plain_versions(case, dtype):
    """The differentiable entry on CPU tensors: its output is the plain
    forward's and the gradient autograd takes from it is the plain
    backward's, to the bit; nothing launches."""
    causal, window = case[6], case[7]
    q, k, v, g = _inputs(case, dtype, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fa.launches)
    out = fa.flash_attention_train(*leaves, causal=causal, window=window)
    out.backward(g)
    assert fa.launches == before
    want_out, lse = ref.flash_attention_lse(q, k, v, causal, window)
    assert torch.equal(out.detach(), want_out)
    for leaf, w in zip(leaves, ref.flash_attention_bwd(
            q, k, v, want_out, lse, g, causal, window)):
        assert torch.equal(leaf.grad, w)


def test_entry_counts_the_visible_pairs_forward_and_backward():
    """A FLOP counter over the entry's forward and backward sees q.k and
    p.v over the visible pairs forward (4 dh a pair and head) and five
    products over them backward (10 dh), not the dense square."""
    B, Sq, Sk, H, KV, dh, causal, window = CASES[1]
    q, k, v, g = _inputs(CASES[1], torch.float32)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    with FlopCounterMode(display=False) as fc:
        fa.flash_attention_train(*leaves, causal=causal,
                                 window=window).backward(g)
    pairs = fa.visible_pairs(Sq, Sk, causal, window)
    assert pairs < Sq * Sk
    assert fc.get_total_flops() == 14 * B * H * dh * pairs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inference_entry_still_refuses_a_gradient(dtype):
    q, k, v, _ = _inputs(CASES[0], dtype)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        fa.flash_attention(q, k, v)


def _counts():
    reg = telemetry.metrics()
    return {k: reg.counter(f"train.attn.{k}").value
            for k in ("flash", "dense")}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


@pytest.fixture
def on_card(monkeypatch):
    """CPU tensors stand for tensors on a card in the route."""
    monkeypatch.setattr(attention, "_on_card", lambda q: True)


def _bf16_q(dh=128, H=4):
    return torch.zeros((1, 8, H, dh), dtype=torch.bfloat16)


def test_route_takes_the_flash_entry_only_where_the_input_allows(on_card):
    """The gradient pass's route: bf16 q on a card with a head dim the
    backward takes runs the differentiable flash entry; fp32 q, a
    softcap, a head dim it does not take (256, 48) and an inference or
    dense call keep their routes. Each "train" call bumps one counter."""
    cfg = configs.get_reduced("qwen2-1.5b")
    x = torch.zeros((1, 8, cfg.d_model))
    train, infer = fa.flash_attention_train, fa.flash_attention
    cases = [
        (cfg, _bf16_q(), "train", train),
        (cfg, _bf16_q(16), "train", train),
        (cfg, _bf16_q(80), "train", train),
        (cfg, _bf16_q().float(), "train", None),
        (dataclasses.replace(cfg, logit_softcap=30.0), _bf16_q(), "train",
         None),
        (cfg, _bf16_q(256), "train", None),
        (cfg, _bf16_q(48), "train", None),
        (cfg, _bf16_q(), "dense", None),
        (cfg, _bf16_q(), "flash", infer),
    ]
    for c, q, impl, want in cases:
        before = _counts()
        assert attention._prefill_kernel(impl, c, x, q) is want, \
            (q.shape, impl)
        counted = {"flash": 0, "dense": 0}
        if impl == "train":
            counted["flash" if want is train else "dense"] = 1
        assert _delta(before) == counted


@pytest.fixture
def cpu_mesh():
    from repro_torch.launch.mesh import make_local_mesh
    yield make_local_mesh((1, 1), device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_route_keeps_a_dtensor_dense(on_card, cpu_mesh):
    """A DTensor (a learner's state on a mesh) keeps the dense path."""
    from torch.distributed.tensor import DTensor, Replicate
    cfg = configs.get_reduced("qwen2-1.5b")
    q = DTensor.from_local(_bf16_q(), cpu_mesh, [Replicate(), Replicate()],
                           run_check=False)
    before = _counts()
    assert attention._prefill_kernel("train", cfg, q, q) is None
    assert _delta(before) == {"flash": 0, "dense": 1}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama-3.2-vision-11b"])
def test_gradient_pass_trains_through_the_entry(on_card, arch):
    """``make_loss_fn``'s loss of a bf16 config, on the simulated card:
    every self- and cross-attention call of the pass (remat recomputes
    each block once more) takes the flash entry, whose plain versions
    give a loss and gradients within bf16 rounding of the dense route's;
    the same config at fp32 compute runs dense throughout."""
    cfg = configs.get_reduced(arch)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48))
                            .astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    params = transformer.init_params(cfg, 0, device="cpu",
                                     dtype=torch.float32)
    n_attn = cfg.num_layers      # every block of these stacks attends

    def grads(loss_fn):
        live = tree.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = loss_fn(live, batch)
        return loss.detach(), torch.autograd.grad(loss, tree.leaves(live),
                                                  allow_unused=True)

    before = _counts()
    loss, g = grads(make_loss_fn(cfg, "full"))
    assert _delta(before) == {"flash": 2 * n_attn, "dense": 0}
    want_loss, want = grads(lambda p, b: transformer.loss_fn(
        cfg, p, b, remat=True, impl="dense"))
    assert abs(float(loss) - float(want_loss)) <= 1e-2 * abs(float(want_loss))
    num = sum(float((a - b).norm()) ** 2 for a, b in zip(g, want)
              if a is not None)
    den = sum(float(b.norm()) ** 2 for b in want if b is not None)
    assert num ** 0.5 <= 0.05 * den ** 0.5

    before = _counts()
    grads(make_loss_fn(dataclasses.replace(cfg, compute_dtype="float32"),
                       "full"))
    assert _delta(before) == {"flash": 0, "dense": 2 * n_attn}


def test_bwd_splits_spread_heads_where_the_card_would_idle():
    """The dK/dV kernel's spread of a group's query heads on a card of
    132 SMs: Qwen2's cell (4 x 2 KV heads x 16 key tiles, under half the
    card) one head a block; Mellum2's full layers, whose first key tiles
    see all 128 query tiles, two blocks a group; its sliding layers none.
    The spread always divides the group and brings the heaviest block
    under the mean a block slot gets, or reaches one head a block."""
    sms = 132
    assert fa.bwd_splits(4, 1024, 1024, 12, 2, True, None, sms) == 6
    assert fa.bwd_splits(1, 8192, 8192, 32, 4, True, None, sms) == 2
    assert fa.bwd_splits(1, 8192, 8192, 32, 4, True, 1024, sms) == 1
    for B, Sq, Sk, H, KV, causal, window in [
            (1, 70, 333, 8, 1, True, 100), (2, 65, 129, 4, 4, False, None),
            (8, 64, 64, 12, 4, True, None), (1, 2048, 2048, 32, 8, True, 512)]:
        d = fa.bwd_splits(B, Sq, Sk, H, KV, causal, window, sms)
        G = H // KV
        tiles = fa.bwd_query_tiles(Sq, Sk, causal, window)
        total = B * KV * G * int(tiles.sum())
        assert G % d == 0
        assert d == G or (G // d) * tiles.max() * 2 * sms <= total


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (200, 200, True, None), (70, 333, True, 100), (300, 1000, True, 130),
    (65, 129, False, None), (129, 129, True, 64), (33, 77, False, 20)])
def test_bwd_query_tiles_hold_every_visible_pair(Sq, Sk, causal, window):
    """For each 64-key tile the dK/dV kernel visits a run of query tiles
    that holds every query tile with a visible pair in it, and at most
    one more."""
    ok = ref.visible(Sq, Sk, causal, window)
    T = fa.BWD_TILE
    counts = fa.bwd_query_tiles(Sq, Sk, causal, window)
    for kt, n in enumerate(counts):
        seen = [qt for qt in range(-(-Sq // T))
                if bool(ok[qt * T:(qt + 1) * T, kt * T:(kt + 1) * T].any())]
        assert len(seen) <= n <= len(seen) + 1
        if seen:
            lo = max(kt * T - (Sk - Sq), 0) // T if causal else 0
            assert lo <= seen[0] and seen[-1] < lo + n
