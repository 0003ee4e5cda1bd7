"""The port's cross-attention (VLM) stack against the JAX package, on the
CPU: reduced llama-3.2-vision-11b (4 self-attention layers and one
cross-attention layer, d 64, 16 memory tokens) at fp32 compute, weights
converted from the JAX tree through numpy, seeded numpy tokens and
"patch embeddings" (the vision tower is a stub in both packages).

Tolerances as in ``test_torch_models.py``: outputs and logits within
atol/rtol 1e-4 (summation order only), bf16 cache leaves — the cross
memory's K/V included — within one bf16 step (1e-2), greedy tokens
exact. ``impl="flash"`` runs the kernels' plain versions on the CPU:
the prefill kernel non-causal over the memory, the decode kernel with an
all-true ``valid``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.serve import decode as jdecode
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import transformer as tt
from repro_torch.serve import decode as serve_lib
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)

VLM = dataclasses.replace(tconfigs.get_reduced("llama-3.2-vision-11b"),
                          compute_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(scope="module")
def vlm():
    jp = jt.init_params(VLM, jax.random.key(0))
    tp = convert.params_from_numpy(VLM, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jp, tp


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, VLM.vocab_size, (B, S)).astype(np.int32)


def _memory(B, seed=0, cfg=VLM):
    return np.random.default_rng(seed + 100).standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _assert_tree_close(t_tree, j_tree, **tol):
    if isinstance(j_tree, dict):
        assert set(t_tree) == set(j_tree)
        for k in j_tree:
            _assert_tree_close(t_tree[k], j_tree[k], **tol)
        return
    np.testing.assert_allclose(t_tree.float().numpy(),
                               np.asarray(j_tree, np.float32), **tol)


def _to_torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_torch_tree(v) for k, v in tree.items()}
    arr = np.asarray(tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16
                     else tree)
    t = torch.from_numpy(arr.copy())
    return t.to(torch.bfloat16) if tree.dtype == jnp.bfloat16 else t


def test_pattern_has_a_cross_block():
    assert VLM.pattern[-1] == "xattn" and VLM.num_repeats == 1


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_cross_attention_matches_jax(vlm, impl):
    jp, tp = vlm
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"]["4"]["attn"])
    x = np.random.default_rng(1).standard_normal(
        (2, 7, VLM.d_model)).astype(np.float32)
    mem = _memory(2, seed=1)
    jo = jattn.cross_attention(VLM, jblk, jnp.asarray(x), jnp.asarray(mem))
    to = tattn.cross_attention(VLM, tp["blocks"][0]["4"]["attn"],
                               torch.from_numpy(x), torch.from_numpy(mem),
                               impl=impl)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_forward_matches_jax(vlm, impl):
    jp, tp = vlm
    toks, mem = _tokens(2, 9), _memory(2)
    jh, _ = jt.forward(VLM, jp, tokens=jnp.asarray(toks),
                       memory=jnp.asarray(mem))
    th, aux = tt.forward(VLM, tp, tokens=torch.from_numpy(toks),
                         memory=torch.from_numpy(mem), impl=impl)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert float(aux) == 0.0


def test_prefill_logits_and_memory_kv_match(vlm):
    jp, tp = vlm
    toks, mem = _tokens(2, 9, seed=2), _memory(2, seed=2)
    jl, js = jt.prefill(VLM, jp, tokens=jnp.asarray(toks),
                        memory=jnp.asarray(mem), context_len=16)
    tl, ts = tt.prefill(VLM, tp, tokens=torch.from_numpy(toks),
                        memory=torch.from_numpy(mem), context_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(ts, js, **CACHE_TOL)
    xs = ts["blocks"]["4"]
    assert set(xs) == {"k_mem", "v_mem"}
    assert tuple(xs["k_mem"].shape) == (1, 2, VLM.frontend_tokens,
                                        VLM.num_kv_heads, VLM.head_dim)
    assert xs["k_mem"].dtype == torch.bfloat16


def test_init_decode_state_matches_jax_spec():
    ts = tt.init_decode_state(VLM, 3, 20, device="cpu")
    spec = jt.decode_state_spec(VLM, 3, 20)
    for i in spec["blocks"]:
        assert set(ts["blocks"][i]) == set(spec["blocks"][i])
        for leaf, s in spec["blocks"][i].items():
            assert tuple(ts["blocks"][i][leaf].shape) == s.shape


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_decode_steps_match(vlm, impl):
    """Three decode steps at ragged positions from the JAX package's
    prefill state: self-attention rings grow, the cross layer reads the
    stored memory K/V."""
    jp, tp = vlm
    toks, mem = _tokens(2, 8, seed=3), _memory(2, seed=3)
    _, js = jt.prefill(VLM, jp, tokens=jnp.asarray(toks),
                       memory=jnp.asarray(mem), context_len=16)
    ts = _to_torch_tree(js)
    t = np.array([8, 6], np.int32)
    feed = _tokens(2, 1, seed=4)
    for _ in range(3):
        jl, js = jt.decode_step(VLM, jp, js, jnp.asarray(feed),
                                jnp.asarray(t), attn_impl=impl)
        tl, ts = tt.decode_step(VLM, tp, ts, torch.from_numpy(feed),
                                torch.from_numpy(t), attn_impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        feed = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        t = t + 1
    _assert_tree_close(ts, js, **CACHE_TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_generate_with_memory_matches_jax(vlm, impl):
    jp, tp = vlm
    prompt, mem = _tokens(2, 10, seed=5), _memory(2, seed=5)
    jo = jdecode.generate(VLM, jp, jnp.asarray(prompt), 6, context_len=20,
                          memory=jnp.asarray(mem), attn_impl=impl)
    to = serve_lib.generate(VLM, tp, torch.from_numpy(prompt), 6,
                            context_len=20, memory=torch.from_numpy(mem),
                            attn_impl=impl)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # The memory matters: other patch embeddings, other tokens.
    other = serve_lib.generate(VLM, tp, torch.from_numpy(prompt), 6,
                               context_len=20,
                               memory=torch.from_numpy(_memory(2, seed=6)),
                               attn_impl=impl)
    assert not torch.equal(other, to)


def test_make_prefill_takes_memory(vlm):
    _, tp = vlm
    toks, mem = _tokens(1, 5, seed=7), _memory(1, seed=7)
    step = serve_lib.make_prefill(VLM, context_len=12)
    logits, state = step(tp, torch.from_numpy(toks),
                         memory=torch.from_numpy(mem))
    want, _ = tt.prefill(VLM, tp, tokens=torch.from_numpy(toks),
                         memory=torch.from_numpy(mem), context_len=12)
    assert torch.equal(logits, want)
    assert "k_mem" in state["blocks"]["4"]


def test_bf16_prefill_close_to_jax(vlm):
    """bf16 compute: logits agree to a bf16-sized tolerance (atol 0.1
    on logits of magnitude ~1-3), as for the other families."""
    cfg = dataclasses.replace(VLM, compute_dtype="bfloat16")
    jp = jt.init_params(cfg, jax.random.key(1))
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks, mem = _tokens(2, 9, seed=8), _memory(2, seed=8)
    jl, _ = jt.prefill(cfg, jp, tokens=jnp.asarray(toks),
                       memory=jnp.asarray(mem).astype(jnp.bfloat16),
                       context_len=16)
    tl, _ = tt.prefill(cfg, tp, tokens=torch.from_numpy(toks),
                       memory=torch.from_numpy(mem).to(torch.bfloat16),
                       context_len=16)
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), rtol=0, atol=0.1)


def test_cross_stack_needs_memory(vlm):
    _, tp = vlm
    with pytest.raises(ValueError, match="memory="):
        tt.forward(VLM, tp, tokens=torch.from_numpy(_tokens(1, 4)))


def test_engine_refuses_a_cross_attention_stack(vlm):
    """The engine takes no image memory (the JAX engine's prefill fails
    on ``memory=None``); the port says so up front and names the way
    that serves it."""
    _, tp = vlm
    with pytest.raises(ValueError, match=r"generate\(memory=\.\.\.\)"):
        ServeEngine(VLM, tp, device="cpu")
