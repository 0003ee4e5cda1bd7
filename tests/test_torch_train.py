"""The port's training (``repro_torch.train`` and the model's loss) against
the JAX package, on the CPU.

Weights are drawn by the port, exported to the JAX tree with
``params_to_numpy`` and read by both packages; inputs are made with numpy
from a seed. Tolerances, all fp32:

* the AdamW update (params, m, v) within 1e-6 relative, the learning rate
  equal at every step (given XLA's cosine: see the schedule's test), the
  weight-decay leaf set equal;
* the loss within 1e-5 relative, and each gradient leaf within 1e-4
  relative L2, for every architecture in ``configs``. A leaf whose true
  gradient is zero (the key bias under a softmax over all keys, which
  shifts every logit of a row alike) holds two rounding residues of
  ~1e-9, so the bound adds 1e-7 of the whole gradient's norm. The
  recurrent families' scans sum in another order than the JAX package's
  associative scans (ROADMAP.md C6), inside the same bound;
* remat and microbatching against their plain counterparts as stated in
  each test, and the training state JAX -> port -> JAX bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.models import attention, convert
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree
from repro_torch.train.train_step import (Replayed, TrainConfig,
                                          make_grad_fn, make_loss_fn,
                                          make_train_state,
                                          make_train_step, split_batch,
                                          to_device)

torch.set_num_threads(1)

B, S = 2, 16


def _fp32(arch):
    return dataclasses.replace(configs.get_reduced(arch),
                               compute_dtype="float32")


def _batch(cfg, seed=0, B=B, S=S):
    """numpy inputs for the loss of ``cfg``'s family."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"embeddings": rng.normal(size=(B, S, cfg.d_model))
                .astype(np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int32),
                "mask": (rng.random((B, S)) < 0.5).astype(np.float32)}
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _params(cfg, seed=0):
    """fp32 master weights in both layouts: (port tree, JAX numpy tree)."""
    tp = tt.init_params(cfg, seed, device="cpu", dtype=torch.float32)
    return tp, convert.params_to_numpy(cfg, tp)


def _grads(loss_fn, params, batch):
    live = tree.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = loss_fn(live, batch)
    paths, leaves = zip(*tree.leaves_with_path(live))
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_path = dict(zip(paths, gs))
    return loss.detach(), tree.map_with_path(
        lambda path, p: torch.zeros_like(p) if by_path[path] is None
        else by_path[path], live)


def _assert_rel(a, b, tol, what):
    """|a - b| within ``tol`` of b, leaf-wise: in L2, and elementwise
    against the leaf's largest |b| (an element near zero, where p and
    lr * u cancel, keeps the absolute error of its neighbours)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b), what
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), what


def _flat(jtree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]]


# -- optimizer ----------------------------------------------------------------

OPT = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=30)
JOPT = jopt.OptimizerConfig(**dataclasses.asdict(OPT))


def test_schedule_matches_jax_at_every_step(monkeypatch):
    """The same fp32 arithmetic: with XLA's cosine in place of PyTorch's,
    the learning rate is equal at every step. The two cosines may differ
    by an ulp (XLA's fp32 cosine is not correctly rounded: it disagrees
    with the float64 cosine rounded to fp32 on ~1.3% of arguments), which
    the cosine phase's cancellation (1 + cos near -1) grows to a few ulps
    of the rate; the warmup has no cosine and is equal as it stands."""
    def lr(step):
        return opt_lib.schedule(OPT, torch.tensor(step, dtype=torch.int32))

    want = [np.asarray(jopt.schedule(JOPT, jnp.int32(s))) for s in range(36)]
    for step, w in enumerate(want):
        got = lr(step)
        assert got.dtype == torch.float32
        if step <= OPT.warmup_steps:
            assert got.numpy() == w, (step, float(got), float(w))
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6)
    monkeypatch.setattr(torch, "cos", lambda x: torch.from_numpy(
        np.array(jnp.cos(jnp.asarray(x.numpy())))))
    for step, w in enumerate(want):
        assert lr(step).numpy() == w, step


def test_apply_updates_matches_jax():
    cfg = _fp32("qwen2-1.5b")
    tp, jp = _params(cfg)
    rng = np.random.default_rng(3)
    jstate, tstate = jopt.init_opt_state(jp), opt_lib.init_opt_state(tp)
    jupd = jax.jit(lambda p, g, s: jopt.apply_updates(JOPT, p, g, s))
    for step in range(3):
        jg = jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), jp)
        tg = convert.params_from_numpy(cfg, jg, device="cpu",
                                       dtype=torch.float32)
        np.testing.assert_allclose(float(opt_lib.global_norm(tg)),
                                   float(jopt.global_norm(jg)), rtol=1e-6)
        jp, jstate, jm = jupd(jp, jg, jstate)
        tp, tstate, tm = opt_lib.apply_updates(OPT, tp, tg, tstate)
        assert tm["lr"].numpy() == np.asarray(jm["lr"])
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        got = convert.train_state_to_numpy(cfg, {"params": tp,
                                                 "opt": tstate})
        want = {"params": jp, "opt": jstate}
        for (pa, a), (pb, b) in zip(_flat(got), _flat(want)):
            assert pa == pb
            _assert_rel(a, b, 1e-6, pa)


def _decay_mask_tree(rng):
    """A small fp32 tree with a leaf of every ``_decay_mask`` case
    (decayed matrices, and each name that is not decayed)."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return {"blocks": [{"attn": {"wq": {"kernel": t(4, 6), "bias": t(6)}},
                        "norm": {"scale": t(4)}},
                       {"rglru": {"lam": t(5), "bias_a": t(5),
                                  "bias_x": t(5)},
                        "ssm": {"A_log": t(3, 2), "D": t(3)}}],
            "embed": {"tokens": t(7, 4)},
            "head": {"kernel": t(4, 3)}}


@pytest.mark.parametrize("on_mesh", [False, True])
@pytest.mark.parametrize("clip_norm", [0.5, None])
def test_apply_updates_in_place_equals_apply_updates(clip_norm, on_mesh):
    """The learner's in-place AdamW against the functional one over three
    steps: every p, m and v bit for bit, the same metrics and step, and
    each in-place leaf the same tensor at the same address throughout
    (the gradients' norm is ~8, so a clip of 0.5 scales them). On a 1x1
    gloo mesh every leaf is a DTensor, matrices sharded over "data", as
    a mesh learner holds them on a card."""
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.sharding.compat import make_mesh
    cfg = dataclasses.replace(OPT, clip_norm=clip_norm, warmup_steps=1)
    rng = np.random.default_rng(7)
    params = _decay_mask_tree(rng)
    assert {opt_lib._decay_mask(path) for path, _ in
            tree.leaves_with_path(params)} == {True, False}
    place = lambda x: x  # noqa: E731
    if on_mesh:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        place = lambda x: distribute_tensor(  # noqa: E731
            x, mesh, [Shard(0) if x.dim() > 1 else Replicate(), Replicate()])
    try:
        fp = tree.tree_map(place, params)
        fs = opt_lib.init_opt_state(fp)
        ip = tree.tree_map(lambda x: place(x.clone()), params)
        ist = opt_lib.init_opt_state(ip)
        held = [(x, x.data_ptr()) for x in tree.leaves((ip, ist["m"],
                                                         ist["v"]))]
        for step in range(3):
            g = tree.tree_map(lambda x: place(torch.from_numpy(rng.normal(
                size=x.shape).astype(np.float32))), params)
            fp, fs, fm = opt_lib.apply_updates(cfg, fp, g, fs)
            im = opt_lib.apply_updates_(cfg, ip, g, ist)
            assert torch.equal(im["grad_norm"], fm["grad_norm"])
            assert torch.equal(im["lr"], fm["lr"])
            assert int(ist["step"]) == int(fs["step"]) == step + 1
            if clip_norm is not None:
                assert float(fm["grad_norm"]) > 2 * clip_norm
            for (path, a), b in zip(
                    tree.leaves_with_path((ip, ist["m"], ist["v"])),
                    tree.leaves((fp, fs["m"], fs["v"]))):
                if on_mesh:
                    assert isinstance(a, DTensor), path
                    assert a.placements == b.placements, path
                    a, b = a.full_tensor(), b.full_tensor()
                assert torch.equal(a, b), (step, path)
            now = tree.leaves((ip, ist["m"], ist["v"]))
            assert all(x is y and x.data_ptr() == ptr
                       for (x, ptr), y in zip(held, now))
    finally:
        if on_mesh:
            dist.destroy_process_group()
    # The functional update left its inputs as they were.
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(params),
        tree.leaves(_decay_mask_tree(np.random.default_rng(7)))))
    bf16 = {"w": {"kernel": torch.zeros(2, dtype=torch.bfloat16)}}
    with pytest.raises(ValueError, match="fp32 moments"):
        opt_lib.apply_updates_(cfg, bf16, bf16, opt_lib.init_opt_state(bf16))
    # The functional update widens narrower moments and keeps the
    # params' dtype.
    p2, s2, _ = opt_lib.apply_updates(cfg, bf16, bf16,
                                      opt_lib.init_opt_state(bf16))
    assert p2["w"]["kernel"].dtype == torch.bfloat16
    assert s2["m"]["w"]["kernel"].dtype == torch.float32


def test_grad_fn_on_cpu_never_captures():
    """On CPU leaves the learner's gradient function (``Replayed`` over
    ``make_grad_fn``) runs eagerly on every call, the same parameters
    and batch included, counting each call in ``train.graph.eager``, and
    each call gives the first one's numbers."""
    from repro_torch.core import telemetry
    cfg = _fp32("qwen2-1.5b")
    tp, _ = _params(cfg)
    batch = _torch(_batch(cfg, B=4))
    counters = {k: telemetry.metrics().counter(f"train.graph.{k}")
                for k in ("captures", "replays", "eager")}
    before = {k: c.value for k, c in counters.items()}
    grad_fn = Replayed(make_grad_fn(cfg, TrainConfig(num_microbatches=2)), 2)
    outs = [grad_fn(tp, batch) for _ in range(3)]
    assert {k: c.value - before[k] for k, c in counters.items()} == {
        "captures": 0, "replays": 0, "eager": 3}
    for loss, _, grads in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(grads), tree.leaves(outs[0][2])))


def test_only_the_learners_task_wraps_the_gradient_pass():
    """``make_grad_fn`` and ``make_train_step`` stay plain functions that
    count nothing in the graph counters; ``launch.train.LMTask``, whose
    learner updates its parameters in place, wraps its gradient function
    in ``Replayed``."""
    from repro_torch.core import telemetry
    from repro_torch.launch.train import LMTask
    cfg = _fp32("qwen2-1.5b")
    tc = TrainConfig(num_microbatches=2)
    params, opt = make_train_state(cfg, 0, device="cpu")
    batch = _torch(_batch(cfg, B=4))
    counters = [telemetry.metrics().counter(f"train.graph.{k}")
                for k in ("captures", "replays", "eager")]
    before = [c.value for c in counters]
    grad_fn = make_grad_fn(cfg, tc)
    assert not isinstance(grad_fn, Replayed)
    grad_fn(params, batch)
    make_train_step(cfg, tc)(params, opt, batch)
    assert [c.value for c in counters] == before
    assert isinstance(LMTask(cfg, tc, device="cpu")._compute, Replayed)


def test_decay_mask_leaf_set_equals_jax():
    for arch in jconfigs.ARCH_NAMES:
        cfg = configs.get_reduced(arch)
        tp, jp = _params(cfg)
        want = {jax.tree_util.keystr(p)
                for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]
                if jopt._decay_mask(p)}
        got = {"".join(f"[{k!r}]" for k in path if isinstance(k, str))
               for path, _ in tree.leaves_with_path(tp)
               if opt_lib._decay_mask(path)}
        assert got == want, arch


# -- loss and gradients -------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_loss_and_grads_match_jax(arch):
    cfg = _fp32(arch)
    tp, jp = _params(cfg)
    batch = _batch(cfg)
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               compute_dtype="float32")
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(jcfg, p, b), has_aux=True))(jp, _jax(batch))
    tl, tg = _grads(lambda p, b: tt.loss_fn(cfg, p, b), tp, _torch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got, want = _flat(convert.params_to_numpy(cfg, tg)), _flat(jg)
    total = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                        for _, g in want))
    for (pa, a), (pb, b) in zip(got, want):
        assert pa == pb
        err = np.linalg.norm((a - b).astype(np.float64))
        assert err <= 1e-4 * np.linalg.norm(b.astype(np.float64)) \
            + 1e-7 * total, (pa, err)
    if cfg.num_experts:                     # the aux loss reached the loss
        assert float(jaux["aux"]) > 0


def test_remat_gives_equal_grads():
    cfg = _fp32("qwen2-1.5b")
    tp, _ = _params(cfg)
    batch = _torch(_batch(cfg))
    outs = [_grads(make_loss_fn(cfg, remat), tp, batch)
            for remat in ("none", "full", "dots")]
    for loss, g in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        for a, b in zip(tree.leaves(g), tree.leaves(outs[0][1])):
            assert torch.equal(a, b)


def test_microbatched_grads_match_full_batch():
    cfg = _fp32("qwen3-8b")
    tp, _ = _params(cfg, seed=1)
    batch = _torch(_batch(cfg, B=8))
    full = make_grad_fn(cfg, TrainConfig(num_microbatches=1))(tp, batch)
    micro = make_grad_fn(cfg, TrainConfig(num_microbatches=4))(tp, batch)
    np.testing.assert_allclose(float(micro[0]), float(full[0]), rtol=1e-5)
    for a, b in zip(tree.leaves(micro[2]), tree.leaves(full[2])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
    # The JAX package reports the microbatched loss as ce and 0 as aux
    # (ROADMAP.md C16).
    assert torch.equal(micro[1]["ce"], micro[0])
    assert float(micro[1]["aux"]) == 0.0


def test_microbatching_matches_full_batch():
    cfg = configs.get_reduced("qwen3-8b")
    params, opt = make_train_state(cfg, 1, device="cpu")
    src = iter(make_source(DataConfig(seq_len=16, batch_size=8,
                                      vocab_size=cfg.vocab_size)))
    batch = _torch(next(src))
    outs = []
    for nm in (1, 4):
        tc = TrainConfig(optimizer=opt_lib.OptimizerConfig(
            lr=1e-3, warmup_steps=0, total_steps=10), num_microbatches=nm)
        p2, _, m = make_train_step(cfg, tc)(params, opt, batch)
        outs.append(p2)
    for a, b in zip(tree.leaves(outs[0]), tree.leaves(outs[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-3)


def test_training_learns_synthetic():
    cfg = configs.get_reduced("qwen2-1.5b")
    tc = TrainConfig(optimizer=opt_lib.OptimizerConfig(
        lr=3e-3, warmup_steps=5, total_steps=60), num_microbatches=2)
    step = make_train_step(cfg, tc)
    params, opt = make_train_state(cfg, 0, device="cpu")
    src = iter(make_source(DataConfig(seq_len=32, batch_size=8,
                                      vocab_size=cfg.vocab_size)))
    losses = []
    for _ in range(40):
        params, opt, m = step(params, opt, _torch(next(src)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_split_batch_shapes():
    out = split_batch({"tokens": torch.zeros((8, 16), dtype=torch.int32)}, 4)
    assert out["tokens"].shape == (4, 2, 16)
    with pytest.raises(ValueError, match="microbatches"):
        split_batch({"tokens": torch.zeros((6, 16))}, 4)


def test_to_device_keeps_each_shape():
    """A restored 0-d optimizer step stays 0-d, so the next publish
    restores against the same ``like``."""
    got = to_device({"step": np.asarray(3, np.int32),
                     "x": np.arange(6, dtype=np.float32).reshape(2, 3).T},
                    "cpu")
    assert got["step"].shape == () and got["step"].dtype == torch.int32
    np.testing.assert_array_equal(got["x"].numpy(),
                                  np.arange(6).reshape(2, 3).T)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_one_train_step(arch):
    cfg = configs.get_reduced(arch)
    step = make_train_step(cfg, TrainConfig(
        optimizer=opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=10),
        num_microbatches=2))
    params, opt = make_train_state(cfg, 1, device="cpu")
    params2, opt2, metrics = step(params, opt, _torch(_batch(cfg, S=32)))
    assert bool(torch.isfinite(metrics["loss"]))
    assert int(opt2["step"]) == 1
    assert all(leaf.dtype == torch.float32 for leaf in tree.leaves(params2))
    assert any(float((a - b).abs().max()) > 0
               for a, b in zip(tree.leaves(params), tree.leaves(params2)))


# -- state conversion, devices, routes ----------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b",
                                  "falcon-mamba-7b", "mixtral-8x7b"])
def test_train_state_roundtrips_jax_port_jax_bit_for_bit(arch):
    cfg = configs.get_reduced(arch)
    _, jp = _params(cfg, seed=2)
    rng = np.random.default_rng(4)
    noise = lambda t: jax.tree.map(  # noqa: E731
        lambda x: rng.normal(size=x.shape).astype(np.float32), t)
    state = {"params": jp,
             "opt": {"m": noise(jp), "v": noise(jp),
                     "step": np.asarray(17, np.int32)},
             "ef": noise(jp)}
    port = convert.train_state_from_numpy(cfg, state, device="cpu")
    assert port["opt"]["step"].dtype == torch.int32
    assert int(port["opt"]["step"]) == 17
    assert all(leaf.dtype == torch.float32 for leaf in tree.leaves(
        {k: port[k] for k in ("params", "ef")}))
    back = convert.train_state_to_numpy(cfg, port)
    got, want = _flat(back), _flat(state)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_auto_impl_under_autograd_on_a_cuda_route_raises(monkeypatch):
    """Training runs its own route (``impl="train"``: dense on the CPU);
    ``impl="auto"`` reaching an inference kernel under autograd raises
    instead of training through a path nobody chose.
    The CUDA route is simulated by resolving "auto" to the kernels, as on
    a card (their wrappers take a CPU tensor to the plain version)."""
    resolve = attention._resolve_impl
    monkeypatch.setattr(attention, "_resolve_impl",
                        lambda impl, x: "flash" if impl == "auto"
                        else resolve(impl, x))
    for arch in ("qwen2-1.5b", "recurrentgemma-2b", "falcon-mamba-7b"):
        cfg = _fp32(arch)
        tp, _ = _params(cfg)
        batch = _torch(_batch(cfg))
        with pytest.raises(RuntimeError, match="no backward"):
            _grads(lambda p, b: tt.loss_fn(cfg, p, b, impl="auto"), tp,
                   batch)
        loss, _ = _grads(make_loss_fn(cfg, "full"), tp, batch)
        assert bool(torch.isfinite(loss))
        with torch.no_grad():           # the evaluator's route: fine
            tt.loss_fn(cfg, tp, batch, impl="auto")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = configs.get_reduced("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_state(cfg)
    # resid_tp needs no card either: without a sharding context it
    # changes nothing.
    params = tt.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    batch = _torch(_batch(cfg))
    with torch.no_grad():
        assert torch.equal(make_loss_fn(cfg, "full", resid_tp=True)(
            params, batch)[0], make_loss_fn(cfg, "full")(params, batch)[0])
