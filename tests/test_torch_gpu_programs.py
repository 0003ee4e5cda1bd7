"""The port's programs on a card (``gpu`` marker): the serving program
(flat, paged, behind a router), the training program and its evaluator
(plain and on a 1x1 mesh), the planner's estimate of a sharded prefill,
and state, learners and services on a mesh of one rank over nccl. Each
path asserts the launches of the kernels it must run.

Skipped where no CUDA device is present. This file imports neither JAX
nor the JAX package (see ``test_torch_gpu.py``):

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_gpu*.py tests/test_torch_train_trace.py

What these paths do the same on any device (routing, failover, rollout,
a killed chief's restore, meshes of several gloo processes) the CPU
tests hold against the JAX package.
"""

import dataclasses
import json
import threading
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch import core as lp
from repro_torch.ckpt.checkpoint import ModelStore
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, convert, transformer
from test_torch_gpu import _launches, _since, cuda  # noqa: F401 (a fixture)


@pytest.fixture
def no_group_left():
    """A test that starts a process group (a mesh of one rank) ends it,
    so the next one starts its own."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch,full,page_size,replicas,kernels", [
    # Full width only where it selects the path: bf16 Qwen2-1.5B's dh 128
    # and 12/2 heads, flat and paged.
    ("qwen2-1.5b", True, None, 1, ("decode_attention", "flash_attention")),
    ("qwen2-1.5b", True, 16, 1, ("paged_decode_attention",
                                 "flash_attention")),
    ("qwen2-1.5b", False, None, 2, ("decode_attention", "flash_attention")),
    ("recurrentgemma-2b", False, None, 1,
     ("decode_attention", "flash_attention", "rglru_scan")),
    ("falcon-mamba-7b", False, None, 1, ("ssm_scan",)),
    ("mixtral-8x7b", False, None, 1, ("decode_attention", "flash_attention")),
])
def test_cuda_serve_program_launches_the_kernels(cuda, tmp_path, arch, full,
                                                 page_size, replicas,
                                                 kernels):
    """``launch.serve.build_program`` in the config's own bf16 on the
    card (clients -> batcher -> engine server; with replicas, the
    registry, a router and two engine servers): every request served at
    its length, each of ``kernels`` launched, the selective scan once a
    layer a request."""
    from repro_torch.launch import serve
    cfg = configs.get(arch) if full else configs.get_reduced(arch)
    clients, per_client = 3, 2
    plen, new = (128, 32) if full else (20, 8)
    meter = tmp_path / "meter.json"
    program = serve.build_program(
        cfg, num_clients=clients, requests_per_client=per_client,
        prompt_len=plen, max_new=new, page_size=page_size,
        replicas=replicas, routers=int(replicas > 1),
        meter_json=str(meter), device=cuda)
    before = _launches()
    lp.launch_and_wait(program, timeout_s=600)
    run = _since(before)
    summary = json.loads(meter.read_text())
    total = clients * per_client
    assert summary["count"] == total
    assert summary["out_lens"] == [plen + new] * total
    assert all(run[k] for k in kernels), run
    if cfg.ssm_state:
        assert run["ssm_scan"] == cfg.num_layers * total


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6
# The evaluator's loss through K3 (bf16, P rounded to bf16 before the
# value product, as the dense path rounds it) against its dense loss on
# the same version: near ln 512 = 6.2, two bf16 paths that differ in
# summation order.
EVAL_ABS_TOL = 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [None, (1, 1)])
def test_cuda_train_program_launches_the_kernels(cuda, tmp_path,
                                                 no_group_left, mesh_shape):
    """``launch.train.build_program`` on the card at the tiny preset (bf16
    compute over fp32 master weights, dh 32): plain, its learner trains
    through K3's log-sum-exp instance and the backward kernels; on a 1x1
    mesh (nccl, a group of one) its state is DTensors, whose attention
    runs dense. Then the training program's evaluator scores the last
    version through K3 within EVAL_ABS_TOL of its dense loss."""
    cfg = launch_train.LM_TINY
    store = str(tmp_path / "store")
    program = launch_train.build_program(
        cfg, steps=TRAIN_STEPS, ckpt_dir=store, batch_size=8, seq_len=64,
        publish_every=TRAIN_STEPS // 2, mesh_shape=mesh_shape, device=cuda)
    before = _launches()
    lp.launch_and_wait(program, timeout_s=600)
    run = _since(before)
    ms = ModelStore(store)
    assert ms.latest_version() == TRAIN_STEPS
    if mesh_shape is None:
        assert run["flash_attention"] and run["flash_attention_bwd"], run
    else:
        assert run["flash_attention_bwd"] == 0, run

    like = convert.params_to_numpy(cfg, transformer.init_params(
        cfg, 0, device="cpu", dtype=cfg.param_dtype))
    params = convert.params_from_numpy(
        cfg, ms.load_version(TRAIN_STEPS, like={"params": like})["params"],
        cuda)
    data_cfg = DataConfig(seq_len=64, batch_size=8, vocab_size=cfg.vocab_size,
                          seed=999)
    batch = next(iter(make_source(data_cfg)))
    ev = launch_train.Evaluator(store, cfg, data_cfg, device=cuda)
    before = _launches()
    k3 = ev.score(params, batch)
    assert _since(before)["flash_attention"], "the evaluator launched no K3"
    assert abs(k3 - ev.score(params, batch, impl="dense")) <= EVAL_ABS_TOL


def _version_losses(store: str) -> list:
    ms = ModelStore(store)
    return [ms.metadata(v)["loss"] for v in ms.versions()]


@pytest.mark.gpu
def test_cuda_mesh_training_equals_plain_training(cuda, tmp_path,
                                                  no_group_left):
    """The training program with its learner's state on a 1x1 mesh over
    nccl (DTensors, the mesh's sharding context) takes the steps the
    plain program takes: every version's loss equal to the bit, the
    plain learner's attention held to the mesh's dense route."""
    cfg = launch_train.LM_TINY
    losses = {}
    for mesh_shape in (None, (1, 1)):
        store = str(tmp_path / f"mesh-{mesh_shape}")
        with pytest.MonkeyPatch.context() as mp:
            if mesh_shape is None:
                mp.setattr(attention, "_flash_grad_eligible",
                           lambda *a: False)
            lp.launch_and_wait(launch_train.build_program(
                cfg, steps=TRAIN_STEPS, ckpt_dir=store, batch_size=8,
                seq_len=64, with_eval=False, publish_every=1,
                mesh_shape=mesh_shape, device=cuda), timeout_s=600)
        losses[mesh_shape] = _version_losses(store)
    assert len(losses[None]) == TRAIN_STEPS
    assert all(np.isfinite(losses[None]))
    assert losses[(1, 1)] == losses[None]


@pytest.mark.gpu
def test_cuda_learner_on_a_mesh_group_of_one_equals_plain(cuda, tmp_path,
                                                          no_group_left):
    """A learner whose mesh a ``sharding.group.MeshGroup`` of one rank
    starts, as the training program starts a mesh of processes (a
    TCPStore, nccl on the card: two ranks cannot share it), at fp32 takes
    the plain learner's steps: each version's loss within 1e-5."""
    from repro_torch.core.discovery import Registry
    from repro_torch.sharding.group import MeshGroup
    from repro_torch.train import fabric
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import TrainConfig
    cfg = dataclasses.replace(configs.get_reduced("qwen2-1.5b"),
                              compute_dtype="float32")
    task = launch_train.LMTask(cfg, TrainConfig(optimizer=OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)), cuda)
    data_cfg = DataConfig(seq_len=64, batch_size=8, vocab_size=cfg.vocab_size)
    fcfg = fabric.FabricConfig(total_steps=TRAIN_STEPS, batch_size=8,
                               publish_every=1)
    losses = {}
    for route in ("plain", "group"):
        store = str(tmp_path / route)
        src = iter(make_source(data_cfg))
        group = (MeshGroup((1, 1), ("data", "model"), cuda.type)
                 if route == "group" else None)
        try:
            learner = fabric.LearnerWorker(
                task, lambda: next(src), store, Registry(), fcfg,
                device=cuda, mesh=None if group is None else group.mesh,
                group=group)
            worker = threading.Thread(target=learner.run, daemon=True)
            worker.start()
            deadline = time.monotonic() + 300
            while not learner.load()["done"]:
                assert worker.is_alive() and time.monotonic() < deadline
                time.sleep(0.05)
            learner.retire()
            worker.join(timeout=60)
            assert not worker.is_alive()
        finally:
            if group is not None:
                group.close()
        losses[route] = _version_losses(store)
    assert len(losses["plain"]) == TRAIN_STEPS
    assert all(np.isfinite(losses["plain"]))
    np.testing.assert_allclose(losses["group"], losses["plain"], rtol=1e-5,
                               atol=0)


# ---------------------------------------------------------------------------
# a mesh of one rank: state, collectives, the planner, a mesh node
# ---------------------------------------------------------------------------

def _on_mesh_bit_equal(got, want, mesh) -> None:
    """Every leaf of ``got`` a DTensor on ``mesh`` at the rules'
    placements, whose full value equals ``want``'s leaf to the bit."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import path_str, placements, spec_for_path
    from repro_torch.train import tree
    pairs = list(zip(tree.leaves_with_path(got), tree.leaves(want)))
    assert len(pairs) == len(tree.leaves(want))
    for (path, a), b in pairs:
        name = path_str(path)
        assert isinstance(a, DTensor) and a.device_mesh is mesh, name
        assert tuple(a.placements) == placements(
            mesh, spec_for_path(name, tuple(b.shape), mesh)), name
        full = a.full_tensor()
        assert full.dtype == b.dtype, name
        assert torch.equal(full, b.to(full.device)), name


@pytest.mark.gpu
def test_cuda_state_and_collectives_on_one_by_one_meshes(cuda, tmp_path,
                                                         no_group_left):
    """On 1x1 (data, model) and 1x1x1 (pod, data, model) CUDA meshes over
    nccl: an fp32 {params, opt, ef} state placed by the sharding rules,
    saved, and restored onto the other mesh (``restore_elastic``) and
    with ``restore(shardings=)``, every leaf bit-equal; the pod reduce
    the identity with one pod; the collective matmul equal to
    ``torch.matmul`` to the bit."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.ckpt.elastic import reshard, restore_elastic
    from repro_torch.sharding.collective_matmul import collective_matmul
    from repro_torch.sharding.compat import make_mesh
    from repro_torch.sharding.rules import param_sharding
    from repro_torch.train import tree
    from repro_torch.train.grad_compression import compress_reduce_pod
    cfg = configs.get_reduced("qwen2-1.5b")
    params = transformer.init_params(cfg, 0, device=cuda, dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(10)

    def noise(positive=False):
        def one(t):
            x = torch.randn(t.shape, generator=gen, device=cuda)
            return x.abs_() if positive else x
        return tree.tree_map(one, params)

    # Seeded moments and residual: a restore of zeros must not pass.
    state = {"params": params,
             "opt": {"m": noise(), "v": noise(positive=True),
                     "step": torch.tensor(7, dtype=torch.int32)},
             "ef": noise()}
    mesh = make_mesh((1, 1), ("data", "model"), cuda.type)
    mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), cuda.type)
    placed = reshard(state, mesh)
    _on_mesh_bit_equal(placed, state, mesh)
    d = str(tmp_path / "state")
    checkpoint.save(placed, d)
    _on_mesh_bit_equal(restore_elastic(d, like=state, new_mesh=mesh3),
                       state, mesh3)
    _on_mesh_bit_equal(checkpoint.restore(
        d, like=state, shardings=param_sharding(state, mesh)), state, mesh)

    grads = {"w": torch.randn((64, 128), generator=gen, device=cuda)}
    for m in (mesh, mesh3):
        for method in ("int8_ef", "bf16"):
            red, err = compress_reduce_pod(grads, None, m, method=method)
            assert red is grads and err is None
    x = torch.randn((2, 64, 64), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    w = torch.randn((64, 128), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    y = collective_matmul(x, w, mesh)
    assert torch.equal(y.full_tensor(), torch.matmul(x, w))


@pytest.mark.gpu
def test_cuda_plan_prefill_estimate_matches_the_card(cuda, no_group_left):
    """The planner against the card for a bf16 prefill: the dry run's
    trace on the 1x1 CUDA mesh counts the FLOPs the prefill runs on the
    card with DTensor parameters under the mesh's sharding context
    (within 1%) and estimates its peak within a factor of 2; the
    prefill launches K3 once a layer on the DTensors' local shards. At
    full depth: at 2 layers the logits' transients outweigh the weights,
    and the estimate read 0.47x the card's peak."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.roofline.analysis import cost_of
    from repro_torch.serve import decode as serve_lib
    from repro_torch.sharding import use_sharding
    from repro_torch.sharding.rules import param_sharding
    from repro_torch.train import tree
    cfg = configs.get("qwen2-1.5b")
    S = 1536
    mesh = make_local_mesh()
    est = cells.trace_cell(cells.build_cell(
        cfg, ShapeConfig("prefill", "prefill", S, 1), mesh), mesh)
    fn = serve_lib.make_prefill(cfg, context_len=S, impl=cells.ROUTE)

    def place(t):
        return tree.tree_map(
            lambda x, sh: DTensor.from_local(x, mesh, sh[1], run_check=False)
            if x.is_cuda else x, t, param_sharding(t, mesh))

    params = place(transformer.init_params(cfg, 0, device=cuda,
                                           dtype=torch.bfloat16))
    toks = place(torch.randint(0, cfg.vocab_size, (1, S), device=cuda,
                               generator=torch.Generator(cuda).manual_seed(9),
                               dtype=torch.int32))
    ctx = cells.sharding_ctx(mesh)
    before = _launches()
    with use_sharding(ctx), torch.no_grad():
        out, rec = cost_of(fn, (params, toks))
    assert _since(before)["flash_attention"] == cfg.num_layers
    del out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with use_sharding(ctx), torch.no_grad():
        out = fn(params, toks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert rec.cost.flops == pytest.approx(est.cost.flops, rel=1e-2)
    assert 0.5 <= est.peak_bytes / peak <= 2.0


class MeshService:
    """A mesh node's service: ``matmul`` runs ``sharding.collective_matmul``
    with its weight column-sharded over "model", ``score`` the LM loss of
    a model whose params the sharding rules place on the mesh. Weights
    from ``seed``; without a mesh, plain tensors on ``device``."""

    def __init__(self, cfg, seed: int, w_shape, mesh=None, device="cpu"):
        from repro_torch.models import layers
        from repro_torch.sharding.rules import (Spec, distribute,
                                                param_sharding, placements)
        self._cfg, self._mesh = cfg, mesh
        self._device = torch.device(mesh.device_type if mesh is not None
                                    else device)
        dtype = layers.to_dtype(cfg.compute_dtype)
        gen = torch.Generator().manual_seed(seed)
        w = (torch.randn(w_shape, generator=gen) / w_shape[0] ** 0.5).to(
            self._device, dtype)
        params = transformer.init_params(cfg, seed, device=self._device,
                                         dtype=dtype)
        if mesh is None:
            self._w, self._params = w, params
        else:
            self._w = distribute({"w": w}, {"w": (mesh, placements(
                mesh, Spec(None, "model")))})["w"]
            self._params = distribute(params, param_sharding(params, mesh))

    def matmul(self, x):
        from repro_torch.sharding.collective_matmul import collective_matmul
        x = torch.from_numpy(np.asarray(x)).to(self._device, self._w.dtype)
        y = (torch.matmul(x, self._w) if self._mesh is None else
             collective_matmul(x, self._w, self._mesh).full_tensor())
        return y.float().cpu().numpy()

    def score(self, tokens, impl: str = "auto") -> float:
        from repro_torch.launch import cells
        from repro_torch.sharding import use_sharding
        from repro_torch.sharding.rules import distribute
        t = torch.from_numpy(np.asarray(tokens)).to(self._device)
        batch = {"tokens": t, "labels": t}
        with torch.no_grad():
            if self._mesh is None:
                return float(transformer.loss_fn(self._cfg, self._params,
                                                 batch, impl=impl)[0])
            with use_sharding(cells.sharding_ctx(self._mesh)):
                loss, _ = transformer.loss_fn(
                    self._cfg, self._params,
                    distribute(batch, cells.batch_shardings(self._mesh,
                                                            batch)),
                    impl=impl)
                return float(loss.full_tensor())


class _NodeClient:
    """Sends ``requests`` to the service, keeps each reply in
    ``out.replies`` (a namespace: a node's list arguments arrive as
    copies), then stops the program (``stop``)."""

    def __init__(self, svc, requests, out, stop=True):
        self._svc, self._requests, self._out = svc, requests, out
        self._stop = stop

    def run(self):
        for method, arg in self._requests:
            self._out.replies.append(getattr(self._svc, method)(arg))
        if self._stop:
            lp.stop_program()


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["node", "group"])
def test_cuda_mesh_node_scores_through_the_prefill_kernel(cuda, route,
                                                          no_group_left):
    """``MeshService`` at the reduced Qwen2's width in bf16 on the card,
    through a ``MeshWorkerNode`` at (1, 1) or on a ``MeshGroup`` of one
    over nccl (``core.nodes.mesh.control``): each score runs K3 on the
    DTensors' local shards, within a bf16 ulp of the plain service's
    dense loss; each matmul equals the plain one's."""
    from repro_torch.core.nodes import mesh as mesh_node
    from repro_torch.sharding.group import MeshGroup
    cfg = dataclasses.replace(configs.get_reduced("qwen2-1.5b"),
                              compute_dtype="bfloat16")
    D, F = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(2)
    requests = [("matmul", rng.standard_normal((4, 64, D)).astype(np.float32))
                if i % 2 == 0 else
                ("score", rng.integers(0, cfg.vocab_size, (4, 64)).astype(
                    np.int32)) for i in range(6)]
    out = types.SimpleNamespace(replies=[])
    before = _launches()
    if route == "node":
        p = lp.Program("mesh-node")
        with p.group("svc"):
            svc = p.add_node(lp.MeshWorkerNode(MeshService, cfg, 0, (D, F)))
        with p.group("client"):
            p.add_node(lp.PyNode(_NodeClient, svc, requests, out))
        lp.launch_and_wait(p, resources={"svc": {"mesh": (1, 1),
                                                 "device": cuda.type}},
                           timeout_s=600)
    else:
        group = MeshGroup((1, 1), ("data", "model"), cuda.type)
        try:
            obj, served = mesh_node.control(group, "svc", MeshService,
                                            (cfg, 0, (D, F)))
            _NodeClient(served, requests, out, stop=False).run()
            mesh_node.release(obj)
        finally:
            group.close()
    assert _since(before)["flash_attention"], "score launched no K3"
    plain = MeshService(cfg, 0, (D, F), device=cuda)
    want = [plain.matmul(a) if m == "matmul" else plain.score(a, "dense")
            for m, a in requests]
    # One bf16 ulp at the value (a matmul's: at its largest |value|).
    for got, w in zip(out.replies, want, strict=True):
        err = abs(got - w) if isinstance(w, float) else np.abs(got - w).max()
        assert err <= 2.0 ** -7 * np.abs(w).max()
