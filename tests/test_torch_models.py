"""The port's models against the JAX package, on the CPU.

The JAX parameter tree of the reduced qwen2 config is converted leaf by
leaf (``params_from_numpy``); inputs are made with numpy from a seed and
go through both frameworks. At fp32 compute, logits agree within atol
1e-4 (summation order only). KV caches are stored in bf16 in both, so
cache leaves agree to one bf16 rounding step (atol/rtol 1e-2) where
they derive from recomputed activations.

The RecurrentGemma cases run the reduced config (5 layers, d 64, window
16) at fp32 compute. Their logits and fp32 recurrent state (h, conv) are
held to atol 1e-4, which covers the port's sequential scan against the
JAX package's associative scan (ROADMAP.md C6: the two sum in another
order). The Falcon-Mamba cases run its reduced config (2 Mamba blocks,
d 64, d_inner 128, N 4) at fp32 compute under the same tolerance, for
the same reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro_torch import configs
from repro_torch.models import convert
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.config import shared_fields

torch.set_num_threads(1)

BASE = configs.get_reduced("qwen2-1.5b")
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
    # The port's own fields (experts held, dropless routing, YaRN) are
    # at their defaults for every architecture the JAX package has, and
    # every other field is the JAX package's.
    for name in jconfigs.ARCH_NAMES:
        for tcfg, jcfg in ((configs.get(name), jconfigs.get(name)),
                           (configs.get_reduced(name),
                            jconfigs.get_reduced(name))):
            assert shared_fields(tcfg) == dataclasses.asdict(jcfg)


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


def test_every_arch_is_supported_and_initialises():
    """No architecture of the JAX package is refused: the port's own
    ``init_params`` builds each reduced config with the JAX tree's keys
    and leaf shapes (``blocks`` unstacked per repeat)."""
    for arch in jconfigs.ARCH_NAMES:
        cfg = configs.get_reduced(arch)
        tt.check_supported(cfg)
        tp = tt.init_params(cfg, seed=0, device="cpu")
        want = jt.param_shapes(jconfigs.get_reduced(arch))
        got = convert.params_to_numpy(cfg, tp)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want), arch
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape, arch


# -- the other attention configs: qwen3 (qk-norm), starcoder2 (LayerNorm,
# -- GELU MLP, biases, SWA), command-r-plus (LayerNorm, tied embeddings) -----

@pytest.fixture(scope="module", params=["qwen3-8b", "starcoder2-3b",
                                        "command-r-plus-104b"])
def dense_model(request):
    cfg = dataclasses.replace(configs.get_reduced(request.param),
                              compute_dtype="float32")
    jp = jt.init_params(cfg, jax.random.key(0))
    tp = convert.params_from_numpy(cfg, _np_tree(jp), device="cpu")
    return cfg, jp, tp


def test_dense_configs_forward_match(dense_model):
    cfg, jp, tp = dense_model
    toks = _tokens(2, 20, seed=9)              # past starcoder2's window
    jh, _ = jt.forward(cfg, jp, tokens=jnp.asarray(toks))
    th, _ = tt.forward(cfg, tp, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(
        tt.logits_from_hidden(cfg, tp, th).numpy(),
        np.asarray(jt.logits_from_hidden(cfg, jp, jh)), **LOGIT_TOL)


def test_dense_configs_prefill_match(dense_model):
    cfg, jp, tp = dense_model
    toks = _tokens(2, 20, seed=10)
    jl, js = jt.prefill(cfg, jp, tokens=jnp.asarray(toks), context_len=24)
    tl, ts = tt.prefill(cfg, tp, tokens=torch.from_numpy(toks),
                        context_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_tree_close(ts, js, **CACHE_TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_dense_configs_decode_step_match(dense_model, impl):
    """An fp32 cache: with a bf16 one, the new token's K/V can sit on a
    bf16 rounding midpoint and round to neighbouring values in the two
    frameworks (starcoder2 at t=9: 1e-3 on the logits), which says
    nothing about the port."""
    cfg, jp, tp = dense_model
    toks = _tokens(3, 18, seed=11)
    _, js = jt.prefill(cfg, jp, tokens=jnp.asarray(toks), context_len=24,
                       cache_dtype=jnp.float32)
    ts = _to_torch_tree(js)
    feed = _tokens(3, 1, seed=12)
    t = np.array([18, 9, 23], np.int32)
    jl, js2 = jt.decode_step(cfg, jp, js, jnp.asarray(feed), jnp.asarray(t),
                             attn_impl=impl)
    tl, ts2 = tt.decode_step(cfg, tp, ts, torch.from_numpy(feed),
                             torch.from_numpy(t), attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_tree_close(ts2, js2, **CACHE_TOL)


# -- RecurrentGemma (RG-LRU + LOCAL attention) ---------------------------------

RG32 = dataclasses.replace(configs.get_reduced("recurrentgemma-2b"),
                           compute_dtype="float32")
RG_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def rg_model():
    jp = jt.init_params(RG32, jax.random.key(0))
    return jp, convert.params_from_numpy(RG32, _np_tree(jp), device="cpu")


def _rg_tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, RG32.vocab_size, (B, S)).astype(np.int32)


def _assert_state_close(t_tree, j_tree):
    """Recurrent leaves (fp32) to RG_TOL, the bf16 LOCAL ring to
    CACHE_TOL."""
    for group in j_tree:
        assert set(t_tree[group]) == set(j_tree[group])
        for i, leaves in j_tree[group].items():
            assert set(t_tree[group][i]) == set(leaves)
            for leaf, jv in leaves.items():
                tv = t_tree[group][i][leaf]
                assert tv.shape == jv.shape
                tol = RG_TOL if leaf in ("h", "conv") else CACHE_TOL
                np.testing.assert_allclose(tv.float().numpy(),
                                           np.asarray(jv, np.float32), **tol)


def test_rg_init_and_converter_keep_the_jax_layout(rg_model):
    """Seeded init draws the JAX tree's leaves, shapes and dtypes (Λ
    fp32, matrices in the compute dtype), and the converter unstacks the
    RG-LRU leaves of the repeat axis and keeps Λ fp32 under bf16."""
    jp, tp = rg_model
    own = tt.init_params(RG32, seed=0, device="cpu")

    def walk(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                walk(a[k], b[k])
        elif isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype
    walk(own, tp)
    blk = tp["blocks"][0]["1"]["rglru"]
    np.testing.assert_array_equal(
        blk["gate_a"].numpy(),
        np.asarray(jp["blocks"]["1"]["rglru"]["gate_a"][0]))
    assert blk["conv1d"].shape == (RG32.conv1d_width, RG32.lru_width)
    bf = convert.params_from_numpy(RG32, _np_tree(jp), device="cpu",
                                   dtype=torch.bfloat16)
    assert bf["tail"]["0"]["rglru"]["lam"].dtype == torch.float32
    assert bf["tail"]["0"]["rglru"]["in_x"]["kernel"].dtype == torch.bfloat16
    lam = own["tail"]["0"]["rglru"]["lam"]          # a at r = 1 is u
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert float(a.min()) >= 0.81 - 1e-6 and float(a.max()) <= 0.998 + 1e-6


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_rg_apply_block_matches(rg_model, impl):
    """One RG-LRU block, full sequence with its final state, then one
    decode step from that state."""
    jp, tp = rg_model
    pj, pt = jp["tail"]["0"]["rglru"], tp["tail"]["0"]["rglru"]
    x = np.random.default_rng(12).standard_normal(
        (2, 21, RG32.d_model), np.float32)
    jo, js = jrglru.apply_rglru_block(RG32, pj, jnp.asarray(x),
                                      want_state=True)
    to, ts = trglru.apply_rglru_block(RG32, pt, torch.from_numpy(x),
                                      want_state=True, impl=impl)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **RG_TOL)
    for leaf in ("h", "conv"):
        assert ts[leaf].dtype == torch.float32
        np.testing.assert_allclose(ts[leaf].numpy(), np.asarray(js[leaf]),
                                   **RG_TOL)
    step = x[:, :1] * 0.5
    jo, js2 = jrglru.apply_rglru_block(RG32, pj, jnp.asarray(step), js)
    to, ts2 = trglru.apply_rglru_block(RG32, pt, torch.from_numpy(step),
                                       _to_torch_tree(js))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **RG_TOL)
    for leaf in ("h", "conv"):
        np.testing.assert_allclose(ts2[leaf].numpy(), np.asarray(js2[leaf]),
                                   **RG_TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_rg_forward_and_prefill_match(rg_model, impl):
    """forward and prefill logits, and the prefill state: h and conv of
    every RG-LRU block and the LOCAL ring, over a prompt longer than the
    window (24 > 16)."""
    jp, tp = rg_model
    toks = _rg_tokens(2, 24, seed=13)
    jh, _ = jt.forward(RG32, jp, tokens=jnp.asarray(toks))
    th, _ = tt.forward(RG32, tp, tokens=torch.from_numpy(toks), impl=impl)
    np.testing.assert_allclose(
        tt.logits_from_hidden(RG32, tp, th).numpy(),
        np.asarray(jt.logits_from_hidden(RG32, jp, jh)), **RG_TOL)
    jl, js = jt.prefill(RG32, jp, tokens=jnp.asarray(toks), context_len=32)
    tl, ts = tt.prefill(RG32, tp, tokens=torch.from_numpy(toks),
                        context_len=32, impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **RG_TOL)
    _assert_state_close(ts, js)
    assert ts["blocks"]["0"]["h"].shape == (1, 2, RG32.lru_width)
    assert ts["blocks"]["2"]["k"].shape == (1, 2, RG32.window, 1, 16)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_rg_decode_steps_match(rg_model, impl):
    """Several decode steps past the window (the LOCAL ring wraps), each
    from the same state in both frameworks; the port writes its state in
    place."""
    jp, tp = rg_model
    toks = _rg_tokens(2, 22, seed=14)
    _, js = jt.prefill(RG32, jp, tokens=jnp.asarray(toks[:, :18]),
                       context_len=32)
    for s in range(18, 22):
        feed = toks[:, s:s + 1]
        t = np.full((2,), s, np.int32)
        ts = _to_torch_tree(js)
        jl, js = jt.decode_step(RG32, jp, js, jnp.asarray(feed),
                                jnp.asarray(t), attn_impl=impl)
        tl, ts2 = tt.decode_step(RG32, tp, ts, torch.from_numpy(feed),
                                 torch.from_numpy(t), attn_impl=impl)
        assert ts2 is ts
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **RG_TOL)
        _assert_state_close(ts2, js)


def test_rg_decode_state_and_slot_writes_match():
    """The zeroed decode state has the JAX layout (recurrent leaves fp32
    under a bf16 cache) and ``write_decode_slot`` moves the same bytes."""
    rng = np.random.default_rng(15)
    spec = jt.decode_state_spec(RG32, 3, 20)
    zeros = tt.init_decode_state(RG32, 3, 20, device="cpu")
    for group in spec:
        for i, leaves in spec[group].items():
            for leaf, sd in leaves.items():
                z = zeros[group][i][leaf]
                assert z.shape == sd.shape
                assert str(z.dtype).split(".")[-1] == str(sd.dtype)

    def rand_tree(spec):
        return jax.tree.map(lambda s: jnp.asarray(
            rng.standard_normal(s.shape, np.float32), s.dtype), spec)

    flat = rand_tree(spec)
    one = rand_tree(jt.decode_state_spec(RG32, 1, 20))
    j = jt.write_decode_slot(RG32, flat, one, 2)
    t = tt.write_decode_slot(RG32, _to_torch_tree(flat), _to_torch_tree(one),
                             2)
    _assert_tree_close(t, j, rtol=0, atol=0)


# -- Falcon-Mamba (Mamba-1 blocks) ----------------------------------------------

FM32 = dataclasses.replace(configs.get_reduced("falcon-mamba-7b"),
                           compute_dtype="float32")


@pytest.fixture(scope="module")
def fm_model():
    jp = jt.init_params(FM32, jax.random.key(0))
    return jp, convert.params_from_numpy(FM32, _np_tree(jp), device="cpu")


def _fm_tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, FM32.vocab_size, (B, S)).astype(np.int32)


def test_fm_init_and_converter_keep_the_jax_layout(fm_model):
    """Seeded init draws the JAX tree's leaves, shapes and dtypes; the
    converter unstacks the repeat axis, adds no MLP leaves to a Mamba
    block and keeps A_log and D fp32 under bf16."""
    jp, tp = fm_model
    own = tt.init_params(FM32, seed=0, device="cpu")

    def walk(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                walk(a[k], b[k])
        elif isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype
    walk(own, tp)
    assert len(tp["blocks"]) == FM32.num_repeats
    for r, blk in enumerate(tp["blocks"]):
        assert set(blk["0"]) == {"norm", "mamba"}
        np.testing.assert_array_equal(
            blk["0"]["mamba"]["x_proj"]["kernel"].numpy(),
            np.asarray(jp["blocks"]["0"]["mamba"]["x_proj"]["kernel"][r]))
    di, n = tssm.d_inner(FM32), FM32.ssm_state
    own_m = own["blocks"][0]["0"]["mamba"]
    np.testing.assert_array_equal(
        own_m["A_log"].numpy(),
        np.asarray(jp["blocks"]["0"]["mamba"]["A_log"][0]))
    assert own_m["A_log"].shape == (di, n)
    torch.testing.assert_close(own_m["D"], torch.ones(di), rtol=0, atol=0)
    bf = convert.params_from_numpy(FM32, _np_tree(jp), device="cpu",
                                   dtype=torch.bfloat16)
    m = bf["blocks"][1]["0"]["mamba"]
    assert m["A_log"].dtype == torch.float32 and m["D"].dtype == torch.float32
    assert m["in_proj"]["kernel"].dtype == torch.bfloat16
    assert m["dt_proj"]["bias"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_fm_apply_block_matches(fm_model, impl):
    """One Mamba block, full sequence with its final state, then one
    decode step from that state."""
    jp, tp = fm_model
    pj = jax.tree.map(lambda a: a[1], jp["blocks"]["0"]["mamba"])
    pt = tp["blocks"][1]["0"]["mamba"]
    x = np.random.default_rng(16).standard_normal(
        (2, 19, FM32.d_model), np.float32)
    jo, js = jssm.apply_mamba_block(FM32, pj, jnp.asarray(x),
                                    want_state=True)
    to, ts = tssm.apply_mamba_block(FM32, pt, torch.from_numpy(x),
                                    want_state=True, impl=impl)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **RG_TOL)
    for leaf in ("h", "conv"):
        assert ts[leaf].dtype == torch.float32
        np.testing.assert_allclose(ts[leaf].numpy(), np.asarray(js[leaf]),
                                   **RG_TOL)
    step = x[:, :1] * 0.5
    jo, js2 = jssm.apply_mamba_block(FM32, pj, jnp.asarray(step), js)
    to, ts2 = tssm.apply_mamba_block(FM32, pt, torch.from_numpy(step),
                                     _to_torch_tree(js))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **RG_TOL)
    for leaf in ("h", "conv"):
        np.testing.assert_allclose(ts2[leaf].numpy(), np.asarray(js2[leaf]),
                                   **RG_TOL)


@pytest.mark.parametrize("S", [1, 2, 23])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_fm_forward_and_prefill_match(fm_model, impl, S):
    """forward and prefill logits and the prefill state (h and the
    pre-silu conv tail of every block), for prompts shorter than the
    conv tail (K-1 = 3) and longer."""
    jp, tp = fm_model
    toks = _fm_tokens(2, S, seed=17 + S)
    jh, _ = jt.forward(FM32, jp, tokens=jnp.asarray(toks))
    th, _ = tt.forward(FM32, tp, tokens=torch.from_numpy(toks), impl=impl)
    np.testing.assert_allclose(
        tt.logits_from_hidden(FM32, tp, th).numpy(),
        np.asarray(jt.logits_from_hidden(FM32, jp, jh)), **RG_TOL)
    jl, js = jt.prefill(FM32, jp, tokens=jnp.asarray(toks), context_len=32)
    tl, ts = tt.prefill(FM32, tp, tokens=torch.from_numpy(toks),
                        context_len=32, impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **RG_TOL)
    _assert_state_close(ts, js)
    di, n, K = tssm.d_inner(FM32), FM32.ssm_state, FM32.ssm_conv
    assert ts["blocks"]["0"]["h"].shape == (FM32.num_repeats, 2, di, n)
    assert ts["blocks"]["0"]["conv"].shape == (FM32.num_repeats, 2, K - 1,
                                               di)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_fm_decode_steps_match(fm_model, impl):
    """Several decode steps, each from the same state in both frameworks;
    the port writes its state in place, fp32 under a bf16 cache dtype."""
    jp, tp = fm_model
    toks = _fm_tokens(2, 16, seed=20)
    _, js = jt.prefill(FM32, jp, tokens=jnp.asarray(toks[:, :11]),
                       context_len=32)
    zeros = tt.init_decode_state(FM32, 2, 32, device="cpu")
    assert {leaf: z.dtype for leaf, z in zeros["blocks"]["0"].items()} \
        == {"h": torch.float32, "conv": torch.float32}
    for s in range(11, 16):
        feed = toks[:, s:s + 1]
        t = np.full((2,), s, np.int32)
        ts = _to_torch_tree(js)
        jl, js = jt.decode_step(FM32, jp, js, jnp.asarray(feed),
                                jnp.asarray(t), attn_impl=impl)
        tl, ts2 = tt.decode_step(FM32, tp, ts, torch.from_numpy(feed),
                                 torch.from_numpy(t), attn_impl=impl)
        assert ts2 is ts
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **RG_TOL)
        _assert_state_close(ts2, js)


def test_fm_bf16_compute_logits_close():
    """At the config's own bf16 compute (A_log and D stay fp32 in both),
    logits agree to a bf16-sized tolerance, as for qwen2."""
    base = configs.get_reduced("falcon-mamba-7b")
    jp = jt.init_params(base, jax.random.key(0))
    tp = convert.params_from_numpy(base, _np_tree(jp), device="cpu")
    toks = _fm_tokens(2, 9, seed=21)
    jl, _ = jt.prefill(base, jp, tokens=jnp.asarray(toks), context_len=16)
    tl, _ = tt.prefill(base, tp, tokens=torch.from_numpy(toks),
                       context_len=16)
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), rtol=0, atol=0.1)
