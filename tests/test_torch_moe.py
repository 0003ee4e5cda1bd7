"""The port's MoE (``repro_torch.models.moe``) and the Mixtral stacks
against the JAX package, on the CPU.

Weights come from the JAX ``init_params`` / ``init_moe`` trees through
numpy; inputs are seeded numpy arrays. At fp32 compute the MoE output,
its aux loss and the model's logits agree within atol/rtol 1e-5 (MoE
layer) and 1e-4 (logits): summation order only, since the port scatters
tokens into expert buffers by index where the JAX package multiplies
one-hot dispatch tensors, and a one-hot product with one non-zero term
is exact. Which tokens are dropped is compared exactly. KV caches are
bf16 in both, so cache leaves agree to a bf16 step (atol/rtol 1e-2).
Greedy tokens are exact.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serve import decode as jdecode
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.serve import decode as serve_lib
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)

MOE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-2, atol=1e-2)
# Capacity factor 1.0 with top-2 of 4 experts: C = S / 2 slots per
# expert, so a router that sends every token to one expert drops half.
MIX = dataclasses.replace(tconfigs.get_reduced("mixtral-8x7b"),
                          compute_dtype="float32", moe_capacity_factor=1.0)


@pytest.fixture(autouse=True)
def _reset_port_inproc_registry():
    from repro_torch.core.courier import inprocess
    inprocess.reset()
    yield
    inprocess.reset()


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


def _skewed_moe(cfg, seed=0, B=2, S=12):
    """JAX MoE params whose router sends every token to expert 0 first,
    with experts 1 and 3 tied exactly (identical router columns), and
    inputs x [B,S,D] carrying the direction that expert 0 reads."""
    rng = np.random.default_rng(seed)
    p = _np_tree(jmoe.init_moe(cfg, jax.random.key(seed)))
    d = cfg.d_model
    u = np.ones(d, np.float32) / np.sqrt(d)
    router = p["router"]["kernel"].copy()
    router[:, 0] = 4.0 * u
    router[:, 3] = router[:, 1]
    p["router"]["kernel"] = router
    x = (rng.standard_normal((B, S, d)) * 0.5 + 2.0 * u).astype(np.float32)
    return p, x


def _jax_dropped(cfg, p, x):
    """The JAX package's dropped (token, expert) choices, built from its
    own router, top-k and capacity arithmetic."""
    xj = jnp.asarray(x)
    logits = jlayers.apply_linear(
        jax.tree.map(jnp.asarray, p["router"]), xj).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    mask = jmoe._topk_mask(probs, cfg.experts_per_token)
    C = max(int(cfg.moe_capacity_factor * cfg.experts_per_token
                * x.shape[1] / cfg.num_experts), 1)
    pos = jnp.cumsum(mask, axis=1) * mask - 1.0
    in_cap = (pos >= 0) & (pos < C)
    return np.asarray((mask > 0) & ~in_cap)


def test_apply_moe_matches_jax_with_dropped_tokens():
    p, x = _skewed_moe(MIX)
    jy, jaux = jmoe.apply_moe(MIX, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x))
    tp = convert.params_from_numpy(MIX, p, device="cpu")
    ty, taux = tmoe.apply_moe(MIX, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)

    r = tmoe.route(MIX, tp, torch.from_numpy(x))
    dropped = ((r["mask"] > 0) & ~r["in_cap"]).numpy()
    want = _jax_dropped(MIX, p, x)
    assert want.sum() >= x.shape[0] * x.shape[1] // 2   # half of expert 0's
    np.testing.assert_array_equal(dropped, want)
    # Dropped choices carry no gate, and no token lost both choices here.
    assert float(r["gates"][torch.from_numpy(dropped)].abs().max()) == 0.0


def test_apply_moe_bf16_close_to_jax():
    """bf16 compute: router logits rounded to bf16 before the fp32
    softmax (so ties are common), dispatch and experts in bf16, gates
    cast to bf16 before the combine; outputs agree to bf16 steps
    (atol 5e-2 on values of magnitude ~1)."""
    cfg = dataclasses.replace(MIX, compute_dtype="bfloat16")
    p, x = _skewed_moe(cfg, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jy, _ = jmoe.apply_moe(cfg, jax.tree.map(jnp.asarray, p), xb)
    tp = convert.params_from_numpy(cfg, p, device="cpu")
    ty, _ = tmoe.apply_moe(cfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), rtol=0,
                               atol=5e-2)


def test_grouping_matches_jax(monkeypatch):
    """GShard grouping (S > GROUP_TOKENS, a whole number of groups):
    capacity is per group, on both packages alike."""
    monkeypatch.setattr(jmoe, "GROUP_TOKENS", 8)
    monkeypatch.setattr(tmoe, "GROUP_TOKENS", 8)
    p, x = _skewed_moe(MIX, seed=2, B=2, S=16)
    jy, jaux = jmoe.apply_moe(MIX, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x))
    tp = convert.params_from_numpy(MIX, p, device="cpu")
    ty, taux = tmoe.apply_moe(MIX, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)
    # Grouping changed the result: one group of 16 keeps other tokens.
    monkeypatch.setattr(tmoe, "GROUP_TOKENS", 4096)
    whole, _ = tmoe.apply_moe(MIX, tp, torch.from_numpy(x))
    assert not torch.allclose(whole, ty)


def test_topk_ties_go_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.2, 0.2, 0.5, 0.1]], np.float32)
    idx, mask = tmoe.topk_mask(torch.from_numpy(probs), 2)
    _, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jmoe._topk_mask(jnp.asarray(probs), 2)))
    # Through the bf16 router: experts 1 and 3 have identical columns,
    # so wherever their probabilities tie, 3 is never chosen over 1.
    cfg = dataclasses.replace(MIX, compute_dtype="bfloat16")
    p, x = _skewed_moe(cfg, seed=3)
    tp = convert.params_from_numpy(cfg, p, device="cpu")
    r = tmoe.route(cfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    tie = r["probs"][..., 1] == r["probs"][..., 3]
    assert bool(tie.all())
    assert bool((r["mask"][..., 1] >= r["mask"][..., 3]).all())
    assert bool((r["mask"][..., 3] == 0).all())


# -- Mixtral stacks ------------------------------------------------------------

@pytest.fixture(scope="module", params=[
    ("mixtral-8x7b", None), ("mixtral-8x22b", None), ("mixtral-8x7b", 1.0)],
    ids=["8x7b", "8x22b", "8x7b-capacity-1"])
def mix_model(request):
    """The reduced config at fp32 (4 experts top-2, window 16), its own
    capacity factor 8.0 (nothing dropped) or 1.0 (tokens dropped)."""
    arch, cf = request.param
    cfg = dataclasses.replace(tconfigs.get_reduced(arch),
                              compute_dtype="float32")
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
    jp = jt.init_params(cfg, jax.random.key(0))
    tp = convert.params_from_numpy(cfg, _np_tree(jp), device="cpu")
    return cfg, jp, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_mixtral_forward_and_aux_match(mix_model):
    cfg, jp, tp = mix_model
    toks = _tokens(cfg, 2, 20)
    jh, jaux = jt.forward(cfg, jp, tokens=jnp.asarray(toks))
    th, taux = tt.forward(cfg, tp, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)
    assert float(taux) > 0.0
    tl = tt.logits_from_hidden(cfg, tp, th)
    jl = jt.logits_from_hidden(cfg, jp, jh)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_mixtral_prefill_matches(mix_model):
    cfg, jp, tp = mix_model
    toks = _tokens(cfg, 2, 20, seed=1)          # longer than the window
    jl, js = jt.prefill(cfg, jp, tokens=jnp.asarray(toks), context_len=32)
    tl, ts = tt.prefill(cfg, tp, tokens=torch.from_numpy(toks),
                        context_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_tree_close(ts, js, **CACHE_TOL)
    assert ts["blocks"]["0"]["k"].shape[2] == cfg.window


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_mixtral_decode_steps_wrap_past_the_window(mix_model, impl):
    """Decode from t = 12 to 18 over a 16-slot SWA ring (it wraps at
    16), the JAX package's state and tokens fed to both."""
    cfg, jp, tp = mix_model
    toks = _tokens(cfg, 2, 12, seed=2)
    _, js = jt.prefill(cfg, jp, tokens=jnp.asarray(toks), context_len=40)
    ts = _to_torch_tree(js)
    t = np.array([12, 12], np.int32)
    feed = _tokens(cfg, 2, 1, seed=3)
    jstep = jax.jit(lambda s, f, t: jt.decode_step(cfg, jp, s, f, t,
                                                   attn_impl=impl))
    for _ in range(7):
        jl, js = jstep(js, jnp.asarray(feed), jnp.asarray(t))
        tl, ts = tt.decode_step(cfg, tp, ts, torch.from_numpy(feed),
                                torch.from_numpy(t), attn_impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        feed = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        t = t + 1
    assert int(t[0]) > cfg.window
    _assert_tree_close(ts, js, **CACHE_TOL)


def test_mixtral_prefill_extend_matches(mix_model):
    """Chunked prefill: each chunk is routed on its own (per-chunk
    capacity), as in the JAX package."""
    cfg, jp, tp = mix_model
    toks = _tokens(cfg, 2, 17, seed=4)
    _, js = jt.prefill(cfg, jp, tokens=jnp.asarray(toks[:, :5]),
                       context_len=32)
    ts = _to_torch_tree(js)
    for t0 in (5, 11):
        chunk = toks[:, t0:t0 + 6]
        jl, js = jt.prefill_extend(cfg, jp, js, jnp.asarray(chunk),
                                   jnp.int32(t0))
        tl, ts = tt.prefill_extend(cfg, tp, ts, torch.from_numpy(chunk), t0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_tree_close(ts, js, **CACHE_TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_mixtral_generate_matches_jax(mix_model, impl):
    cfg, jp, tp = mix_model
    prompt = _tokens(cfg, 2, 14, seed=5)
    jo = jdecode.generate(cfg, jp, jnp.asarray(prompt), 8, context_len=24,
                          attn_impl=impl)
    to = serve_lib.generate(cfg, tp, torch.from_numpy(prompt), 8,
                            context_len=24, attn_impl=impl)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _run(eng, prompts):
    futs = [eng.submit(p) for p in prompts]
    steps = 0
    while not all(f.done() for f in futs):
        eng.step()
        steps += 1
        assert steps < 500, "engine made no progress"
    return [f.result() for f in futs]


@pytest.mark.parametrize("chunk", [None, 4])
def test_mixtral_engine_matches_jax_engine(mix_model, chunk):
    """The JAX ServeEngine and the port's give the same greedy tokens
    (fp32, flat SWA rings, prompts past the window, whole or chunked
    prefill)."""
    cfg, jp, tp = mix_model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 11)]
    kw = dict(num_slots=2, context_len=32, max_new=6, sync_every=4,
              prefill_chunk=chunk)
    jo = _run(JaxServeEngine(cfg, jp, **kw), prompts)
    to = _run(ServeEngine(cfg, tp, device="cpu", **kw), prompts)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(a, b)


def test_mixtral_engine_matches_solo_serving(mix_model):
    """ROADMAP.md C7: capacity is counted along each row's own sequence
    (``cumsum`` over S), so rows in a shared decode batch never share an
    expert budget, and a decode step (S = 1 per row) drops nothing.
    Greedy tokens served three at a time equal each request served
    alone, in both packages."""
    cfg, jp, tp = mix_model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 13, 9)]
    kw = dict(num_slots=3, context_len=24, max_new=8)
    shared = _run(ServeEngine(cfg, tp, device="cpu", **kw), prompts)
    jshared = _run(JaxServeEngine(cfg, jp, **kw), prompts)
    for p, a, ja in zip(prompts, shared, jshared):
        solo = serve_lib.generate(cfg, tp, torch.from_numpy(p[None]), 8,
                                  context_len=24)[0].numpy()
        jsolo = np.asarray(jdecode.generate(cfg, jp, jnp.asarray(p[None]), 8,
                                            context_len=24)[0])
        np.testing.assert_array_equal(a, solo)
        np.testing.assert_array_equal(ja, jsolo)


def test_mixtral_init_keeps_the_jax_layout():
    cfg = tconfigs.get_reduced("mixtral-8x7b")
    tp = tt.init_params(cfg, seed=0, device="cpu")
    jshapes = jt.param_shapes(cfg)
    mlp = tp["blocks"][0]["0"]["mlp"]
    jmlp = jshapes["blocks"]["0"]["mlp"]
    assert set(mlp) == set(jmlp) == {"router", "w_gate", "w_up", "w_down"}
    for leaf in ("w_gate", "w_up", "w_down"):
        assert tuple(mlp[leaf].shape) == jmlp[leaf].shape[1:]
        assert mlp[leaf].dtype == torch.bfloat16
    assert tuple(mlp["router"]["kernel"].shape) == \
        jmlp["router"]["kernel"].shape[1:]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
def test_cli_serves_mixtral(tmp_path, capsys, arch):
    meter = tmp_path / "m.json"
    tserve.main(["--arch", arch, "--device", "cpu", "--clients", "2",
                 "--requests", "2", "--meter-json", str(meter)])
    summary = json.loads(meter.read_text())
    assert summary["count"] == 4
    assert "served 4 requests" in capsys.readouterr().out
