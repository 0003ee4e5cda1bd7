"""Mellum2 in the port, on the CPU: YaRN's frequencies against their
closed form in float64, the dropless layer that holds a share of the
experts (its shares add up to the whole layer; it drops nothing where
the capacity route would), per-block recomputation, the held experts'
rows as the training pass reports them, and prefill then decode through
the cache against the full forward pass. The JAX package has no such
model; the plain reference's comparison is in
``perfbench/tests/test_perfbench_mellum2.py``.

Tolerances, all fp32: a share's sum against the whole layer and the
decode against the forward pass differ by summation order alone, within
1e-5 of the output's scale; YaRN's fp32 frequencies lie within 2 fp32
ulps (2.4e-7 relative) of the float64 closed form."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tt
from repro_torch.models.config import ATTN, SWA, YaRN
from repro_torch.train import tree
from repro_torch.train.train_step import TrainConfig, make_grad_fn

torch.set_num_threads(1)

ARCH = "mellum2-12b-a2.5b"


def _fp32(**kw):
    return dataclasses.replace(configs.get_reduced(ARCH),
                               compute_dtype="float32", **kw)


def _tokens(cfg, B=2, S=64, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32)


# -- the registered configuration ---------------------------------------------

def test_the_registered_config_is_the_published_one():
    cfg = configs.get(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        28, 2304, 32, 4, 128, 896, 98304)
    assert cfg.pattern == (SWA, SWA, SWA, ATTN) and cfg.window == 1024
    assert (cfg.num_experts, cfg.experts_per_token) == (64, 8)
    assert cfg.num_experts_held == 64 and cfg.moe_dropless
    assert cfg.rope_theta == 5e5 and not cfg.qk_norm and not cfg.qkv_bias
    # 12.1 B parameters, 2.04 B of them on one chip of 8
    assert cfg.param_count() == 12_149_915_904
    share = dataclasses.replace(cfg, experts_held=(0, 8), vocab_size=12288)
    assert share.param_count() == 2_042_691_840


def test_a_share_needs_the_dropless_layer_and_a_range_of_experts():
    cfg = configs.get(ARCH)
    with pytest.raises(ValueError, match="dropless"):
        dataclasses.replace(cfg, experts_held=(0, 8), moe_dropless=False)
    for bad in ((8, 8), (-1, 4), (60, 65)):
        with pytest.raises(ValueError, match="range"):
            dataclasses.replace(cfg, experts_held=bad)


# -- YaRN ---------------------------------------------------------------------

def _yarn_closed_form(dh, theta, factor, orig, fast, slow):
    """Hugging Face's YaRN frequencies, written out in float64."""
    def at(rot):
        return dh * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(
            theta))
    low, high = max(math.floor(at(fast)), 0), min(math.ceil(at(slow)),
                                                  dh - 1)
    out = []
    for i in range(dh // 2):
        base = theta ** (-2.0 * i / dh)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        out.append(base / factor * ramp + base * (1 - ramp))
    return np.array(out), (low, high)


def test_yarn_frequencies_and_factor_match_the_closed_form():
    cfg = configs.get(ARCH)
    y = cfg.rope_yarn
    assert layers.yarn_correction_range(y, cfg.rope_theta, 128) == (18, 35)
    inv, scale = layers.yarn_inv_freq(y, cfg.rope_theta, 128, "cpu")
    want, rng = _yarn_closed_form(128, 5e5, 16.0, 8192, 32.0, 1.0)
    assert rng == (18, 35)
    np.testing.assert_allclose(inv.double().numpy(), want, rtol=2.4e-7)
    assert scale == y.attention_factor == pytest.approx(
        0.1 * math.log(16) + 1.0, rel=1e-15)
    # Below the ramp the frequencies are theta's, above it theta's / 16.
    np.testing.assert_allclose(want[:18], 5e5 ** (-np.arange(18) / 64))
    np.testing.assert_allclose(want[35:],
                               5e5 ** (-np.arange(35, 64) / 64) / 16)


def test_only_the_full_layers_rotate_by_yarn():
    cfg = configs.get_reduced(ARCH)
    pos = torch.arange(40, dtype=torch.int32)[None]
    plain = layers.rope_freqs(dataclasses.replace(cfg, rope_yarn=None),
                              pos, ATTN)
    swa = layers.rope_freqs(cfg, pos, SWA)
    full = layers.rope_freqs(cfg, pos, ATTN)
    for a, b in zip(plain, swa):
        assert torch.equal(a, b)
    inv, scale = layers.yarn_inv_freq(cfg.rope_yarn, cfg.rope_theta,
                                      cfg.head_dim, "cpu")
    ang = pos[..., None].float() * inv
    assert torch.equal(full[0], torch.sin(ang) * scale)
    assert torch.equal(full[1], torch.cos(ang) * scale)
    assert not torch.allclose(full[1], plain[1])


# -- the dropless layer over a share of the experts ---------------------------

def _layer_params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return moe.init_moe(dataclasses.replace(cfg, experts_held=None), gen,
                        "cpu", torch.float32)


@pytest.mark.parametrize("shares", [2, 4])
def test_the_shares_of_the_experts_add_up_to_the_whole_layer(shares):
    cfg = _fp32(experts_held=None)
    whole = _layer_params(cfg)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y_all, aux_all, rows_all = moe.apply_dropless(cfg, whole, x)
    E, n = cfg.num_experts, cfg.num_experts // shares
    total, rows = torch.zeros_like(x), []
    for lo in range(0, E, n):
        part = dataclasses.replace(cfg, experts_held=(lo, lo + n))
        p = {"router": whole["router"],
             **{k: whole[k][lo:lo + n]
                for k in ("w_gate", "w_up", "w_down")}}
        y, aux, r = moe.apply_dropless(part, p, x)
        assert torch.equal(aux, aux_all)    # every share routes alike
        total += y
        rows.append(r)
    torch.testing.assert_close(total, y_all, rtol=1e-5, atol=1e-6)
    assert torch.equal(torch.cat(rows), rows_all)
    # Nothing is dropped: every token's k choices are computed.
    assert float(rows_all.sum()) == x.shape[0] * x.shape[1] * \
        cfg.experts_per_token


def test_dropless_layer_is_the_capacity_route_with_room_for_all():
    """With every expert held and a capacity no token reaches, the
    capacity route (``moe.apply_moe``) drops nothing either: the two
    give the same layer."""
    cfg = _fp32(experts_held=None)
    p = _layer_params(cfg, seed=3)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    y, aux, _ = moe.apply_dropless(cfg, p, x)
    roomy = dataclasses.replace(cfg, moe_dropless=False,
                                moe_capacity_factor=64.0)
    y2, aux2 = moe.apply_moe(roomy, p, x)
    torch.testing.assert_close(y, y2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux, aux2)


def test_the_dropless_gradient_reaches_only_the_held_pairs():
    cfg = _fp32()
    gen = torch.Generator().manual_seed(5)
    p = moe.init_moe(cfg, gen, "cpu", torch.float32)
    x = torch.randn(1, 32, cfg.d_model, generator=gen).requires_grad_()
    y, aux, rows = moe.apply_dropless(cfg, p, x)
    (y.square().sum() + aux).backward()
    assert torch.isfinite(x.grad).all()
    assert rows.shape == (cfg.num_experts_held,)
    # A token none of whose choices is held gets no gradient from y.
    x2 = x.detach().clone().requires_grad_()
    y2, _, _ = moe.apply_dropless(cfg, p, x2)
    y2.square().sum().backward()
    lo, hi = cfg.experts_held
    probs = torch.softmax(x.detach()[0] @ p["router"]["kernel"], -1)
    idx, _ = moe.topk_mask(probs, cfg.experts_per_token)
    none_held = ~((idx >= lo) & (idx < hi)).any(-1)
    assert torch.equal(x2.grad[0][none_held],
                       torch.zeros_like(x2.grad[0][none_held]))
    assert bool(torch.all(y2[0][none_held] == 0))


# -- the stack ----------------------------------------------------------------

def test_remat_per_block_gives_the_same_loss_and_grads():
    cfg = _fp32()
    params = tt.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    toks = _tokens(cfg)
    batch = {"tokens": toks, "labels": toks}
    outs = []
    for remat in ("none", "full"):
        loss, aux, grads = make_grad_fn(cfg, TrainConfig(remat=remat))(
            params, batch)
        outs.append((loss, aux["moe_rows"], tree.leaves(grads)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(outs[0][2], outs[1][2]):
        assert torch.equal(a, b)


def test_the_pass_reports_each_held_experts_rows_over_the_microbatches():
    cfg = _fp32()
    params = tt.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    toks = _tokens(cfg, B=4, S=32)
    batch = {"tokens": toks, "labels": toks}
    _, aux, _ = make_grad_fn(cfg, TrainConfig(num_microbatches=2))(
        params, batch)
    rows = aux["moe_rows"]
    assert rows.shape == (cfg.num_layers, cfg.num_experts_held)
    want = torch.zeros_like(rows)
    stats = {}
    for half in (toks[:2], toks[2:]):
        tt.forward(cfg, params, tokens=half, stats=stats)
        want += stats["moe_rows"]
    assert torch.equal(rows, want)
    # 4 x 32 tokens, 4 choices each over 16 experts, 8 of them held
    assert float(rows.sum()) < 4 * 32 * 4 * cfg.num_layers
    assert float(rows.sum()) > 0


def test_prefill_then_decode_through_the_cache_is_the_forward_pass():
    cfg = _fp32()
    params = tt.init_params(cfg, 1, device="cpu", dtype=torch.float32)
    toks = _tokens(cfg, S=48, seed=2)
    full = tt.logits_from_hidden(cfg, params, tt.forward(
        cfg, params, tokens=toks, impl="dense")[0])
    logits, state = tt.prefill(cfg, params, tokens=toks[:, :30],
                               context_len=48, impl="dense",
                               cache_dtype=torch.float32)
    scale = float(full.abs().max())
    torch.testing.assert_close(logits, full[:, :30], rtol=0,
                               atol=1e-5 * scale)
    # Past the window (16) and the ring of the sliding layers.
    for t in range(30, 48):
        lg, state = tt.decode_step(cfg, params, state, toks[:, t:t + 1], t,
                                   attn_impl="dense")
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=0,
                                   atol=1e-5 * scale)


def test_yarn_is_part_of_the_full_layers_forward():
    cfg = _fp32()
    params = tt.init_params(cfg, 1, device="cpu", dtype=torch.float32)
    toks = _tokens(cfg, S=24)
    h = tt.forward(cfg, params, tokens=toks)[0]
    for y in (None, YaRN(factor=4.0, original_max_positions=8192,
                         attention_factor=0.1 * math.log(4) + 1.0)):
        other = tt.forward(dataclasses.replace(cfg, rope_yarn=y), params,
                           tokens=toks)[0]
        assert float((other - h).abs().max()) > 1e-3
