"""The port's sharding rules and context against the JAX package's.

1. Rule parity: every leaf of ``params`` and of the AdamW ``m``/``v`` of
   every architecture gets the same spec in both packages on the 16x16,
   2x16x16, 2x4 and 1x1 meshes (JAX on an ``AbstractMesh``, the port on
   planning meshes), the port's block leaves without the JAX package's
   stacked repeat axis.
2. ``fit_spec`` always gives a divisible spec, and JAX's.
3. Placement parity: on a 2x4 mesh every rank's local shape and global
   offset equal the slice ``NamedSharding.devices_indices_map`` gives the
   device at the same mesh coordinate.
4. On a real 4-process gloo mesh (2x2, and 1x4 for TP 4 over 2 KV heads),
   reduced Qwen2, Mixtral and Falcon-Mamba at fp32 give the unsharded
   logits (relative L2 <= 1e-5), loss (<= 1e-6 relative) and gradients
   (<= 1e-5 relative L2 a leaf) under ``use_sharding``, and the same
   prefill logits through the kernels' route (the plain versions behind
   the kernels' custom ops, on local shards).

The fake process group and the gloo mesh run in subprocesses, each with
its own timeout, as ``tests/test_distributed.py`` runs its meshes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.sharding import rules as jrules
from repro.train.train_step import train_state_shapes as j_train_shapes
from repro_torch.sharding import rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def run_py(body: str, timeout: float = 120, env_extra=None,
           args=()) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", **(env_extra or {}))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(body),
                           *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def _jax_spec(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _jax_specs(mesh_key: str) -> dict:
    """{arch: {jax path: spec}} for params, m and v on an AbstractMesh."""
    shape, names = MESHES[mesh_key]
    mesh = jax.sharding.AbstractMesh(shape, names)
    out = {}
    for arch in jconfigs.ARCH_NAMES:
        params, opt = j_train_shapes(jconfigs.get(arch))
        tree = {"params": params, "m": opt["m"], "v": opt["v"]}
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        out[arch] = {
            jrules._path_str(path): (
                list(x.shape),
                _jax_spec(jrules.spec_for_path(
                    jrules._path_str(path).split("/", 1)[1], x.shape,
                    mesh)))
            for path, x in flat}
    return out


@pytest.fixture(scope="module")
def port_specs():
    """{mesh: {arch: {jax path: [repeats, shape, spec]}}} from the port,
    on planning meshes, with each block leaf's repeat index dropped."""
    out = run_py("""
    import json
    from repro_torch import configs
    from repro_torch.sharding import rules
    from repro_torch.sharding.compat import planning_mesh
    from repro_torch.train import tree
    from repro_torch.train.train_step import train_state_shapes
    MESHES = %r
    states = {a: train_state_shapes(configs.get(a))
              for a in configs.ARCH_NAMES}
    res = {}
    for key, (shape, names) in MESHES.items():
        mesh = planning_mesh(shape, names)
        res[key] = {}
        for arch, (params, opt) in states.items():
            t = {"params": params, "m": opt["m"], "v": opt["v"]}
            got = {}
            for path, x in tree.leaves_with_path(t):
                spec = rules.spec_for_path(rules.path_str(path[1:]),
                                           x.shape, mesh)
                pl = rules.placements(mesh, spec)
                jpath = list(path)
                if "blocks" in jpath:      # drop the repeat index
                    del jpath[jpath.index("blocks") + 1]
                entry = got.setdefault(rules.path_str(jpath),
                                       [0, list(x.shape), None, None])
                entry[0] += 1
                entry[2] = [list(e) if isinstance(e, tuple) else e
                            for e in spec]
                entry[3] = [repr(p) for p in pl]
            res[key][arch] = got
    print(json.dumps(res))
    """ % (MESHES,), timeout=300)
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_rule_parity_every_leaf_every_arch(port_specs, mesh_key):
    jspecs = _jax_specs(mesh_key)
    n = 0
    for arch, leaves in jspecs.items():
        cfg = jconfigs.get(arch)
        port = port_specs[mesh_key][arch]
        assert set(port) == set(leaves), arch
        for path, (shape, spec) in leaves.items():
            count, pshape, pspec, _ = port[path]
            if "/blocks/" in f"/{path}":
                assert count == cfg.num_repeats, (arch, path)
                assert pshape == shape[1:], (arch, path)
                assert spec[0] is None, (arch, path)
                assert pspec == spec[1:], (arch, path, pspec, spec)
            else:
                assert pshape == shape and pspec == spec, (arch, path)
            n += 1
    assert n > 500


@given(st.sampled_from([(1, 1), (2, 4), (4, 2), (16, 16)]),
       st.lists(st.integers(1, 512), min_size=1, max_size=3))
@settings(max_examples=50, deadline=None)
def test_fit_spec_always_divisible_and_matches_jax(mesh_shape, shape):
    names = ("data", "model")
    mesh = SimpleNamespace(mesh_dim_names=names, shape=mesh_shape)
    want = [("data", "model")] * len(shape)
    spec = rules.fit_spec(mesh, shape, want)
    assert isinstance(spec, rules.Spec)
    sizes = dict(zip(names, mesh_shape))
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        n = int(np.prod([sizes[a] for a in axes]))
        assert n > 1 and dim % n == 0
    jmesh = jax.sharding.AbstractMesh(mesh_shape, names)
    assert tuple(spec) == tuple(jrules.fit_spec(jmesh, shape, want))


def test_placements_match_jax_device_slices():
    """Every rank of a 2x4 mesh holds the slice JAX gives the device at
    its mesh coordinate, for one- and two-axis entries, and for the
    reduced Qwen2's leaves."""
    out = run_py("""
    import json
    import numpy as np
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import torch.distributed as dist
    from torch.distributed.tensor._utils import \\
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.sharding import rules
    from repro_torch.train import tree
    from repro_torch.models import transformer
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    jmesh = Mesh(devs, ("data", "model"))
    cases = [((8, 12), (("data", "model"), None)),
             ((6, 8, 16), (None, None, ("data", "model"))),
             ((4, 8), ("model", "data")), ((8,), ("data",)),
             ((3, 8), (None, "model"))]
    params = transformer.param_shapes(configs.get_reduced("qwen2-1.5b"))
    bad, n = [], 0
    for r in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=8)
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        leaf_cases = [(tuple(x.shape), tuple(rules.spec_for_path(
                          rules.path_str(p), x.shape, mesh)))
                      for p, x in tree.leaves_with_path(params)]
        for shape, spec in cases + leaf_cases:
            pl = rules.placements(mesh, spec)
            lshape, off = compute_local_shape_and_global_offset(
                shape, mesh, pl)
            idx = NamedSharding(jmesh, P(*spec)).devices_indices_map(shape)
            sl = idx[devs[r // 4, r % 4]]
            jl = tuple(len(range(*s.indices(d))) for s, d in zip(sl, shape))
            jo = tuple(s.indices(d)[0] for s, d in zip(sl, shape))
            n += 1
            if tuple(lshape) != jl or tuple(off) != jo:
                bad.append([r, shape, repr(spec), lshape, off, jl, jo])
        dist.destroy_process_group()
    print(json.dumps({"n": n, "bad": bad}))
    """, env_extra={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    res = json.loads(out.strip().splitlines()[-1])
    assert res["n"] > 100
    assert res["bad"] == []


# ---------------------------------------------------------------------------
# 4. A real mesh: 4 gloo processes
# ---------------------------------------------------------------------------

_GLOO_RANK = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.launch import cells
from repro_torch.models import transformer
from repro_torch.sharding import ShardingCtx, use_sharding
from repro_torch.sharding.compat import make_mesh
from repro_torch.sharding.rules import distribute, param_sharding
from repro_torch.train import tree

arch, shape, rdv, rank = sys.argv[1], eval(sys.argv[2]), sys.argv[3], \\
    int(sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{rdv}",
                        world_size=4, rank=rank)
torch.manual_seed(0)
cfg = configs.get_reduced(arch)
import dataclasses
cfg = dataclasses.replace(cfg, compute_dtype="float32")
params = transformer.init_params(cfg, 0, device="cpu", dtype=torch.float32)
rng = np.random.default_rng(3)
toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                        .astype(np.int32))
batch = {"tokens": toks, "labels": toks}

def grads(p, b):
    live = tree.tree_map(lambda t: t.detach().requires_grad_(), p)
    loss, _ = transformer.loss_fn(cfg, live, b, impl="dense")
    paths, leaves = zip(*tree.leaves_with_path(live))
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, dict(zip(paths, g))

with torch.no_grad():
    ref_hidden, _ = transformer.forward(cfg, params, tokens=toks,
                                        impl="dense")
    ref_logits = transformer.logits_from_hidden(cfg, params, ref_hidden)
    # the kernels' route (their plain versions on the CPU, through the
    # same custom ops and, sharded, on local shards)
    ref_prefill, _ = transformer.prefill(cfg, params, tokens=toks,
                                         impl="flash")
ref_loss, ref_g = grads(params, batch)

mesh = make_mesh(shape, ("data", "model"), "cpu")
dparams = distribute(params, param_sharding(params, mesh))
dbatch = distribute(batch, cells.batch_shardings(mesh, batch))
with use_sharding(cells.sharding_ctx(mesh)):
    with torch.no_grad():
        hidden, _ = transformer.forward(cfg, dparams,
                                        tokens=dbatch["tokens"],
                                        impl="dense")
        logits = transformer.logits_from_hidden(cfg, dparams, hidden)
        prefill, _ = transformer.prefill(cfg, dparams,
                                         tokens=dbatch["tokens"],
                                         impl="flash")
    loss, g = grads(dparams, dbatch)
logits = logits.full_tensor()
prefill = prefill.full_tensor()
loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
worst = 0.0
for path, want in ref_g.items():
    got = g[path]
    if want is None:
        continue
    got = got.full_tensor()
    worst = max(worst, float((got - want).norm()
                             / want.norm().clamp_min(1e-30)))
if rank == 0:
    print(json.dumps({
        "logits_rel_l2": float((logits - ref_logits).norm()
                               / ref_logits.norm()),
        "prefill_rel_l2": float((prefill - ref_prefill).norm()
                                / ref_prefill.norm()),
        "loss": float(loss), "ref_loss": float(ref_loss),
        "grad_worst_rel_l2": worst}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-1.5b", (2, 2)),      # TP 2 over 2 KV heads
    ("qwen2-1.5b", (1, 4)),      # TP 4: the KV heads do not divide TP
    ("mixtral-8x7b", (2, 2)),
    ("falcon-mamba-7b", (2, 2)),  # the selective scan on local shards
])
def test_sharded_forward_equals_unsharded_on_gloo(arch, shape, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    # A file rendezvous under this test's own directory: a port picked by
    # binding and releasing it could be taken by another worker's group.
    rdv = str(tmp_path / "rdv")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_RANK, arch, repr(shape), rdv, str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    assert res["logits_rel_l2"] <= 1e-5, res
    assert res["prefill_rel_l2"] <= 1e-5, res
    assert abs(res["loss"] - res["ref_loss"]) <= 1e-6 * abs(res["ref_loss"])
    assert res["grad_worst_rel_l2"] <= 1e-5, res
