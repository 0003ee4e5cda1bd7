"""Mellum2 in the benchmark (``archs/mellum2.py``,
``reference/mellum2.py``, its configuration and cell), on the CPU: the
port against the plain reference at a tiny size in float32 (the loss
and every gradient leaf, with the dense attention's query chunks both
whole and cut into a band), whole tiny runs of the cell (three AdamW
steps against the reference), the faults that have to make ``correct``
false, the configuration's refusal of a changed width, and the counts.

Tolerances, float32 on both sides: the loss within 1e-5 relative and
each gradient leaf within 1e-4 relative L2 plus 1e-7 of the whole
gradient's norm, as the port's own parity tests hold them to the JAX
package: the two differ by summation order (fused and unfused
projections, chunked and whole softmax rows, grouped and per-expert
products)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench import harness, spec
from perfbench import weights as wts
from perfbench.reference.common import exact_fp32
from perfbench.tests.tiny import tiny_cell

CELL = "mellum2-12b-a2.5b.train-b2s8192"
CONF = "mellum2-12b-a2.5b"
SEED = 2 ** 31 + 4242
ARCH = spec.arch("mellum2")


def _conf():
    return spec.load_json(f"{spec.HERE}/configs/{CONF}.json")


def _tiny():
    conf = ARCH.tiny(_conf())
    return ARCH.sizes(conf), ARCH.program_config(conf)


def _grads(loss_fn, params):
    paths, leaves = zip(*wts.leaves(params))
    live = [p.detach().clone().requires_grad_() for p in leaves]
    tree = {}
    for path, leaf in zip(paths, live):
        wts._put(tree, path, leaf)
    loss = loss_fn(tree)
    return float(loss.detach()), torch.autograd.grad(loss, live,
                                                    allow_unused=True)


@pytest.mark.parametrize("q_chunk", [None, 16])
def test_port_loss_and_grads_match_the_reference(monkeypatch, q_chunk):
    from repro_torch.models import attention, transformer
    if q_chunk:             # 64 tokens > 2 x 16: the band path runs
        monkeypatch.setattr(attention, "Q_CHUNK", q_chunk)
    s, cfg = _tiny()
    params = wts.draw(ARCH.layout(s), 7, "cpu", torch.float32)
    wts.check_layout(params, transformer.param_shapes(cfg))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, s["vocab"], (2, 64)), dtype=torch.int32)
    port_loss, port_g = _grads(lambda p: transformer.loss_fn(
        cfg, p, {"tokens": toks, "labels": toks}, remat=True,
        impl="dense")[0], params)
    with exact_fp32():
        ref_loss, ref_g = _grads(lambda p: ARCH.reference.lm_loss(
            s, p, toks, ARCH.reference.Prec()), params)
    assert port_loss == pytest.approx(ref_loss, rel=1e-5)
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref_g)))
    for (path, _), a, b in zip(wts.leaves(params), port_g, ref_g):
        err = float((a - b).double().norm())
        assert err <= 1e-4 * float(b.double().norm()) + 1e-7 * total, path


def test_the_fp8_control_departs_from_the_reference():
    s, _ = _tiny()
    params = wts.draw(ARCH.layout(s), 8, "cpu", torch.float32)
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, s["vocab"], (2, 32)), dtype=torch.int32)
    R = ARCH.reference
    with exact_fp32(), torch.no_grad():
        ref = float(R.lm_loss(s, params, toks, R.Prec()))
        low = float(R.lm_loss(s, params, toks, R.Prec("fp8")))
    assert 1e-4 < abs(low - ref) / ref < 0.1


# -- whole tiny runs of the cell ---------------------------------------------

def _run(trace=False, control=False):
    return harness.run_cell(tiny_cell(CELL), SEED, 1.2, trace,
                            torch.device("cpu"), time.perf_counter(),
                            control=control)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_of_the_cell_is_correct(trace):
    out = _run(trace)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:       # no device on the CPU: its metrics stay out
        assert set(out["metrics"]) == {"mfu.train",
                                       "device_idle_pct.train"}
    else:
        assert set(out["metrics"]) == {"train_tok_s", "setup_s"}
    assert {c["value"] < 1e-4 for c in out["check"].values()} == {True}


def _last_expert_dropped(monkeypatch):
    """The last held expert computes nothing: every choice of it is
    dropped."""
    from repro_torch.models import moe
    orig = moe.grouped_mm

    def drop(a, b, ends):
        ends = ends.clone()
        ends[-1] = ends[-2]
        return orig(a, b, ends)
    monkeypatch.setattr(moe, "grouped_mm", drop)


def _capacity_route(monkeypatch):
    """Held choices past a capacity of the mean load are dropped."""
    from repro_torch.models import moe
    orig = moe.apply_dropless

    def capped(cfg, p, x):
        lo, hi = cfg.experts_held
        cap = dataclasses.replace(cfg, experts_held=None, moe_dropless=False,
                                  moe_capacity_factor=1.0)
        full = {k: (v if k == "router" else torch.zeros(
            (cfg.num_experts,) + v.shape[1:], dtype=v.dtype).index_copy(
                0, torch.arange(lo, hi), v)) for k, v in p.items()}
        y, aux = moe.apply_moe(cap, full, x)
        return y, aux, orig(cfg, p, x)[2]
    monkeypatch.setattr(moe, "apply_dropless", capped)


def _full_layers_unscaled(monkeypatch):
    """The full layers rotate by theta alone, without YaRN."""
    from repro_torch.models import layers
    orig = layers.rope_freqs
    monkeypatch.setattr(layers, "rope_freqs",
                        lambda cfg, pos, kind: orig(cfg, pos, "swa"))


def _unchanged_state(monkeypatch):
    from repro_torch.train import optimizer
    monkeypatch.setattr(optimizer, "apply_updates",
                        lambda cfg, params, grads, state:
                        (params, state, {}))


@pytest.mark.parametrize("fault", [_last_expert_dropped, _capacity_route,
                                   _full_layers_unscaled, _unchanged_state],
                         ids=lambda f: f.__name__.strip("_"))
def test_the_cell_with_its_timed_path_broken_is_not_correct(monkeypatch,
                                                             fault):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["check"]


# -- the configuration and the counts ----------------------------------------

def test_the_configuration_holds_every_layer_and_width():
    conf = _conf()
    s = ARCH.sizes(conf)
    cfg = ARCH.program_config(conf)
    assert s["layers"] == cfg.num_layers == 28 and len(s["kinds"]) == 28
    assert s["kinds"].count("attn") == 7
    assert conf["reduced"] == ["num_experts", "vocab_size"]
    assert conf["published"] == {"num_experts": 64, "vocab_size": 98304}
    assert {"deployment", "assumed"} <= set(conf)
    assert cfg.experts_held == (0, 8) and cfg.num_experts == 64
    assert cfg.vocab_size == 12288 == s["vocab"]
    assert ARCH.param_count(s) == cfg.param_count() == 2_042_691_840


@pytest.mark.parametrize("key,value", [
    ("hidden_size", 2048), ("moe_intermediate_size", 1024),
    ("num_attention_heads", 16), ("num_key_value_heads", 8),
    ("head_dim", 64), ("num_experts_per_tok", 4), ("sliding_window", 512)])
def test_a_changed_width_is_refused(key, value):
    conf = _conf()
    conf[key] = value
    with pytest.raises(ValueError, match="published"):
        ARCH.program_config(conf)


def test_a_published_count_or_rope_changed_is_refused():
    conf = _conf()
    conf["published"]["num_experts"] = 32
    with pytest.raises(ValueError, match="published"):
        ARCH.program_config(conf)
    conf = _conf()
    conf["rope_parameters"]["full_attention"]["factor"] = 8
    with pytest.raises(ValueError, match="published"):
        ARCH.program_config(conf)
    conf = _conf()
    conf["layer_types"][0] = "full_attention"
    with pytest.raises(ValueError, match="periods"):
        ARCH.program_config(conf)


def test_the_counts_of_a_step():
    s = ARCH.sizes(_conf())
    B, S, w, L = 2, 8192, 1024, 28
    attn = 2304 * 4096 * 2 + 2304 * 512 * 2
    mlp = 8 * 8 / 64 * 3 * 2304 * 896 + 2304 * 64
    n = L * (attn + mlp) + 2304 * 12288
    band = w * (w + 1) // 2 + (S - w) * w
    pairs = 21 * band + 7 * S * (S + 1) // 2
    want = 6.0 * n * B * S + 3 * 4.0 * pairs * 32 * 128 * B
    assert ARCH.train_flops(s, B, S) == pytest.approx(want, rel=1e-12)
    # The held experts at the mean load: one routed row a token a layer.
    assert ARCH.expert_flops(s, B, S) == pytest.approx(
        3 * 3 * 2 * 2304 * 896 * B * S * L, rel=1e-12)
    assert ARCH.attn_pairs(s, 3) == L * 6
