"""The port's attention-only model against the JAX package, on the CPU.

The JAX parameter tree of the reduced qwen2 config is converted leaf by
leaf (``params_from_numpy``); inputs are made with numpy from a seed and
go through both frameworks. At fp32 compute, logits agree within atol
1e-4 (summation order only). KV caches are stored in bf16 in both, so
cache leaves agree to one bf16 rounding step (atol/rtol 1e-2) where
they derive from recomputed activations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro_torch import configs
from repro_torch.models import convert
from repro_torch.models import transformer as tt

torch.set_num_threads(1)

BASE = jconfigs.get_reduced("qwen2-1.5b")
CFG32 = dataclasses.replace(BASE, compute_dtype="float32")
SWA32 = dataclasses.replace(CFG32, pattern=("swa",), window=6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-2, atol=1e-2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_torch_tree(v) for k, v in tree.items()}
    arr = np.asarray(tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16
                     else tree)
    t = torch.from_numpy(arr.copy())
    return t.to(torch.bfloat16) if tree.dtype == jnp.bfloat16 else t


def _assert_tree_close(t_tree, j_tree, **tol):
    if isinstance(j_tree, dict):
        assert set(t_tree) == set(j_tree)
        for k in j_tree:
            _assert_tree_close(t_tree[k], j_tree[k], **tol)
        return
    np.testing.assert_allclose(t_tree.float().numpy(),
                               np.asarray(j_tree, np.float32), **tol)


@pytest.fixture(scope="module", params=["attn", "swa"])
def model(request):
    cfg = CFG32 if request.param == "attn" else SWA32
    jp = jt.init_params(cfg, jax.random.key(0))
    tp = convert.params_from_numpy(cfg, _np_tree(jp), device="cpu")
    return cfg, jp, tp


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, BASE.vocab_size, (B, S)).astype(np.int32)


def test_configs_copy_matches_jax():
    for name in jconfigs.ARCH_NAMES:
        assert dataclasses.asdict(configs.get(name)) == \
            dataclasses.asdict(jconfigs.get(name))
        assert dataclasses.asdict(configs.get_reduced(name)) == \
            dataclasses.asdict(jconfigs.get_reduced(name))


def test_converter_unstacks_and_keeps_norms_fp32(model):
    cfg, jp, tp = model
    assert len(tp["blocks"]) == cfg.num_repeats
    blk = tp["blocks"][1]["0"]
    np.testing.assert_array_equal(
        blk["attn"]["wq"]["kernel"].numpy(),
        np.asarray(jp["blocks"]["0"]["attn"]["wq"]["kernel"][1]))
    assert blk["norm"]["scale"].dtype == torch.float32
    bf = convert.params_from_numpy(cfg, _np_tree(jp), device="cpu",
                                   dtype=torch.bfloat16)
    assert bf["embed"]["tokens"].dtype == torch.bfloat16
    assert bf["final_norm"]["scale"].dtype == torch.float32


def test_forward_logits_match(model):
    cfg, jp, tp = model
    toks = _tokens(2, 11)
    jh, _ = jt.forward(cfg, jp, tokens=jnp.asarray(toks))
    jl = jt.logits_from_hidden(cfg, jp, jh)
    th, aux = tt.forward(cfg, tp, tokens=torch.from_numpy(toks))
    tl = tt.logits_from_hidden(cfg, tp, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert float(aux) == 0.0


def test_prefill_logits_and_cache_match(model):
    cfg, jp, tp = model
    toks = _tokens(2, 9, seed=1)
    jl, js = jt.prefill(cfg, jp, tokens=jnp.asarray(toks), context_len=16)
    tl, ts = tt.prefill(cfg, tp, tokens=torch.from_numpy(toks),
                        context_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_tree_close(ts, js, **CACHE_TOL)
    assert ts["blocks"]["0"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_decode_step_flat_matches(model, impl):
    """Ragged per-row positions over a ring the prefill filled; the same
    state goes through both frameworks, and both write the new token."""
    cfg, jp, tp = model
    toks = _tokens(3, 8, seed=2)
    _, js = jt.prefill(cfg, jp, tokens=jnp.asarray(toks), context_len=12)
    ts = _to_torch_tree(js)
    feed = _tokens(3, 1, seed=3)
    t = np.array([8, 5, 11], np.int32)        # 11 wraps a windowed ring
    jl, js2 = jt.decode_step(cfg, jp, js, jnp.asarray(feed), jnp.asarray(t),
                             attn_impl=impl)
    tl, ts2 = tt.decode_step(cfg, tp, ts, torch.from_numpy(feed),
                             torch.from_numpy(t), attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_tree_close(ts2, js2, **CACHE_TOL)


def _paged_state(cfg, P, ps, seed):
    rng = np.random.default_rng(seed)
    spec = jt.decode_state_spec(cfg, 1, 8, page_size=ps, num_pages=P)
    return jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape, np.float32),
                              s.dtype), spec)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_decode_step_paged_matches(impl):
    cfg, ps, P, n = CFG32, 4, 9, 3
    jp = jt.init_params(cfg, jax.random.key(1))
    tp = convert.params_from_numpy(cfg, _np_tree(jp), device="cpu")
    js = _paged_state(cfg, P, ps, seed=4)
    ts = _to_torch_tree(js)
    pages = np.array([[3, 5, 1], [2, 2, 0], [0, 0, 0]], np.int32)
    t = np.array([6, 3, 0], np.int32)          # row 2: all-trash pad row
    feed = _tokens(3, 1, seed=5)
    jl, js2 = jt.decode_step(cfg, jp, js, jnp.asarray(feed), jnp.asarray(t),
                             attn_impl=impl, pages=jnp.asarray(pages))
    tl, ts2 = tt.decode_step(cfg, tp, ts, torch.from_numpy(feed),
                             torch.from_numpy(t), attn_impl=impl,
                             pages=torch.from_numpy(pages))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    # Page 0 is the trash page (several rows may write it): compare the
    # rest of the pool exactly as written.
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            ts2["blocks"]["0"][leaf][:, 1:].float().numpy(),
            np.asarray(js2["blocks"]["0"][leaf][:, 1:], np.float32),
            **CACHE_TOL)


def test_prefill_extend_matches(model):
    cfg, jp, tp = model
    toks = _tokens(2, 10, seed=6)
    _, js = jt.prefill(cfg, jp, tokens=jnp.asarray(toks[:, :5]),
                       context_len=12)
    ts = _to_torch_tree(js)
    jl, js2 = jt.prefill_extend(cfg, jp, js, jnp.asarray(toks[:, 5:]),
                                jnp.int32(5))
    tl, ts2 = tt.prefill_extend(cfg, tp, ts, torch.from_numpy(toks[:, 5:]),
                                5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_tree_close(ts2, js2, **CACHE_TOL)


def test_slot_writes_and_window_views_match():
    """write_decode_slot, write_paged_slot (skipping shared pages),
    gather_paged_slot, paged_window_view and paged_window_scatter move the
    same bytes as the JAX package on random states."""
    cfg, ps, P, n = CFG32, 4, 10, 3
    rng = np.random.default_rng(7)

    def rand_tree(spec):
        return jax.tree.map(lambda s: jnp.asarray(
            rng.standard_normal(s.shape, np.float32), s.dtype), spec)

    flat = rand_tree(jt.decode_state_spec(cfg, 3, n * ps))
    one = rand_tree(jt.decode_state_spec(cfg, 1, n * ps))
    j = jt.write_decode_slot(cfg, flat, one, 1)
    t = tt.write_decode_slot(cfg, _to_torch_tree(flat), _to_torch_tree(one),
                             1)
    _assert_tree_close(t, j, rtol=0, atol=0)

    pool = rand_tree(jt.decode_state_spec(cfg, 3, n * ps, page_size=ps,
                                          num_pages=P))
    row = np.array([4, 7, 2], np.int32)
    j = jt.write_paged_slot(cfg, pool, one, 1, jnp.asarray(row), 1, ps)
    t = tt.write_paged_slot(cfg, _to_torch_tree(pool), _to_torch_tree(one),
                            1, torch.from_numpy(row), 1, ps)
    _assert_tree_close(t, j, rtol=0, atol=0)

    j = jt.gather_paged_slot(cfg, pool, 1, jnp.asarray(row), ps)
    t = tt.gather_paged_slot(cfg, _to_torch_tree(pool), 1,
                             torch.from_numpy(row), ps)
    _assert_tree_close(t, j, rtol=0, atol=0)

    pages = np.array([[4, 7, 2], [1, 3, 0], [0, 0, 0]], np.int32)
    jv = jt.paged_window_view(cfg, pool, jnp.asarray(pages))
    tv = tt.paged_window_view(cfg, _to_torch_tree(pool),
                              torch.from_numpy(pages))
    _assert_tree_close(tv, jv, rtol=0, atol=0)

    edited = rand_tree(jt.decode_state_spec(cfg, 3, n * ps))
    t0 = np.array([5, 2, 0], np.int32)
    j = jt.paged_window_scatter(cfg, pool, edited, jnp.asarray(pages),
                                jnp.asarray(t0), 4)
    t = tt.paged_window_scatter(cfg, _to_torch_tree(pool),
                                _to_torch_tree(edited),
                                torch.from_numpy(pages),
                                torch.from_numpy(t0), 4)
    for leaf in ("k", "v"):               # page 0: trash, undefined winner
        np.testing.assert_array_equal(
            t["blocks"]["0"][leaf][:, 1:].float().numpy(),
            np.asarray(j["blocks"]["0"][leaf][:, 1:], np.float32))


def test_bf16_compute_logits_close():
    """At the config's own bf16 compute, bf16 rounds at other places in
    XLA and in PyTorch's CPU kernels (matmul outputs, RoPE products,
    softmax weights), so logits agree to a bf16-sized tolerance: atol
    0.1 on logits of magnitude ~1-3, with the greedy token usually
    equal."""
    jp = jt.init_params(BASE, jax.random.key(0))
    tp = convert.params_from_numpy(BASE, _np_tree(jp), device="cpu")
    assert tp["embed"]["tokens"].dtype == torch.bfloat16
    toks = _tokens(2, 9, seed=8)
    jl, _ = jt.prefill(BASE, jp, tokens=jnp.asarray(toks), context_len=16)
    tl, _ = tt.prefill(BASE, tp, tokens=torch.from_numpy(toks),
                       context_len=16)
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), rtol=0, atol=0.1)


def test_unported_blocks_raise_naming_the_roadmap():
    for arch, item in (("recurrentgemma-2b", "Q2"), ("falcon-mamba-7b", "Q2"),
                       ("mixtral-8x7b", "Q5"),
                       ("llama-3.2-vision-11b", "Q5")):
        with pytest.raises(NotImplementedError, match=item):
            tt.init_params(configs.get_reduced(arch), device="cpu")
