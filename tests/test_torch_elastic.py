"""Elastic checkpoint round trips on real meshes: the port of
``tests/test_elastic.py``, held against the JAX package.

The whole learner state — params, optimizer moments and step, and the
int8 error-feedback residual — of a reduced transformer (qwen2) and a
reduced recurrent model (recurrentgemma), its weights converted from the
JAX package's init and its moments and residual seeded, is saved from
one mesh and restored onto another: grown from a 2-process (1,2) mesh to
a 4-process (2,2) mesh, and shrunk back. Every leaf's ``full_tensor()``
must be bit-equal to the original, on the placements the rules give the
new mesh, with the same leaf count both ways; a version without the
residual fills it from ``like`` on the new mesh. Versions published in
the store's layout cross between the packages both ways: a port mesh's
restores in the JAX package onto its (2,4) host mesh, and a JAX mesh's
restores in the port onto a (1,2) mesh.

Each mesh is a group of gloo processes (``test_torch_distributed.
run_gloo``'s harness, repeated here); the JAX side runs in a subprocess
with 8 placeholder host devices, as ``tests/test_elastic.py`` runs it.
The stages of one architecture run once and each test reads its part.
"""

import json
import os
import subprocess
import sys
import textwrap
import uuid

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro_torch.ckpt import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
ARCHS = ["qwen2-1.5b", "recurrentgemma-2b"]


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


_PRELUDE = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
torch.set_num_threads(1)
RANK, WORLD = int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{sys.argv[1]}",
                        world_size=WORLD, rank=RANK)
arch, d = sys.argv[4], sys.argv[5]
from repro_torch import configs
from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.elastic import reshard, restore_elastic
from repro_torch.models import convert, transformer
from repro_torch.sharding.compat import make_mesh
from repro_torch.sharding.rules import path_str, placements, spec_for_path
from repro_torch.train import tree
from repro_torch.train.fabric import gathered
from repro_torch.train.optimizer import init_opt_state

cfg = configs.get_reduced(arch)
p0 = transformer.init_params(cfg, 0, device="cpu", dtype=torch.float32)
store_like = convert.train_state_to_numpy(
    cfg, {"params": p0, "opt": init_opt_state(p0), "ef": p0})
state = convert.train_state_from_numpy(
    cfg, checkpoint.restore(f"{d}/ref", like=store_like), "cpu")
zero_ef = dict(state, ef=tree.tree_map(torch.zeros_like, state["ef"]))


def check(got, want, mesh):
    '''[leaves, sharded leaves, faults]: each leaf a DTensor whose full
    value is bit-equal to ``want``'s, on the rules' placements.'''
    n, sharded, bad = 0, 0, []
    for (path, g), w in zip(tree.leaves_with_path(got), tree.leaves(want)):
        n += 1
        name = path_str(path)
        if not isinstance(g, DTensor):
            bad.append([name, "not a DTensor"])
            continue
        full = g.full_tensor()
        if full.dtype != w.dtype or not torch.equal(full, w):
            bad.append([name, "values"])
        want_pl = placements(mesh, spec_for_path(name, tuple(w.shape), mesh))
        if tuple(g.placements) != want_pl:
            bad.append([name, "placements"])
        sharded += any(isinstance(p, Shard) for p in g.placements)
    if n != len(tree.leaves(want)):
        bad.append(["leaf count", n])
    return [n, sharded, bad]


out = {}
"""

# a) 2 processes, (1,2): place the state and save it three ways.
_SAVE_SMALL = """
mesh = make_mesh((1, 2), ("data", "model"), "cpu")
placed = reshard(state, mesh)
out["placed"] = check(placed, state, mesh)
checkpoint.save(placed, f"{d}/grow")
checkpoint.save({"params": placed["params"], "opt": placed["opt"]},
                f"{d}/old")                            # before the residual
checkpoint.save(convert.train_state_to_numpy(cfg, gathered(placed)),
                f"{d}/port_store")                     # as a learner publishes
"""

# b) 4 processes, (2,2): grow, fill the missing residual, save for (c).
_GROW = """
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
out["grow"] = check(restore_elastic(f"{d}/grow", like=state, new_mesh=mesh),
                    state, mesh)
try:
    restore_elastic(f"{d}/old", like=zero_ef, new_mesh=mesh)
    out["strict_raised"] = False
except KeyError:
    out["strict_raised"] = True
filled = restore_elastic(f"{d}/old", like=zero_ef, new_mesh=mesh,
                         fill_missing=True)
out["filled"] = check(filled, zero_ef, mesh)
checkpoint.save(reshard(state, mesh), f"{d}/shrink")
"""

# c) 2 processes, (1,2): shrink; restore the JAX mesh's store-layout
# version as a recovering learner does (store layout, convert, reshard).
_SHRINK = """
mesh = make_mesh((1, 2), ("data", "model"), "cpu")
out["shrink"] = check(restore_elastic(f"{d}/shrink", like=state,
                                      new_mesh=mesh), state, mesh)
from_jax = reshard(convert.train_state_from_numpy(
    cfg, restore_elastic(f"{d}/jax_store", like=store_like), "cpu"), mesh)
out["from_jax"] = check(from_jax, state, mesh)
"""

_END = """
dist.barrier()
print(json.dumps(out))
dist.destroy_process_group()
"""

# The JAX package on 8 host devices: restore the port mesh's published
# version onto its (2,4) mesh; save its own from its (2,2) mesh.
_JAX = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.ckpt import checkpoint
from repro.ckpt.elastic import reshard, restore_elastic
from repro.models import transformer
from repro.train.optimizer import init_opt_state
arch, d = sys.argv[1], sys.argv[2]
devs = np.array(jax.devices())
mesh_small = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
mesh_big = Mesh(devs.reshape(2, 4), ("data", "model"))
params = transformer.init_params(configs.get_reduced(arch), jax.random.key(0))
like = {"params": params, "opt": init_opt_state(params),
        "ef": jax.tree.map(lambda x: np.zeros(x.shape, np.float32), params)}
ref = checkpoint.restore(f"{d}/ref", like=like)
got = restore_elastic(f"{d}/port_store", like=like, new_mesh=mesh_big)
flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
bad, sharded = [], 0
for (pr, r), (pg, g) in zip(flat_r, flat_g):
    a, b = np.asarray(r), np.asarray(jax.device_get(g))
    if pr != pg or a.dtype != b.dtype or not np.array_equal(a, b):
        bad.append(jax.tree_util.keystr(pr))
    if g.sharding.mesh.devices.size != 8:
        bad.append(jax.tree_util.keystr(pg) + " mesh")
    sharded += any(s is not None for s in g.sharding.spec)
checkpoint.save(reshard(ref, mesh_small), f"{d}/jax_store")
print(json.dumps({"n": len(flat_g), "sharded": sharded, "bad": bad}))
"""


def _gloo(body: str, world: int, arch: str, d: str) -> list[dict]:
    rdv = os.path.join(d, f"rdv-{uuid.uuid4().hex}")
    code = _PRELUDE + textwrap.dedent(body) + _END
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, rdv, str(r), str(world), arch, d],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-4000:]}"
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


def _reference(arch: str, d: str) -> None:
    """The state in the store's (the JAX package's) layout: weights from
    the JAX init, moments and residual seeded, step 7."""
    params = jax.tree.map(np.asarray, jt.init_params(
        jconfigs.get_reduced(arch), jax.random.key(0)))
    rng = np.random.default_rng(7)

    def seeded(positive=False):
        def one(x):
            y = rng.standard_normal(x.shape).astype(np.float32)
            return np.abs(y) if positive else y
        return jax.tree.map(one, params)

    checkpoint.save({"params": params,
                     "opt": {"m": seeded(), "v": seeded(positive=True),
                             "step": np.asarray(7, np.int32)},
                     "ef": seeded()}, os.path.join(d, "ref"))


@pytest.fixture(scope="module", params=ARCHS)
def stages(request, tmp_path_factory):
    """Run (a) save on (1,2); then (b) grow on (2,2) beside the JAX
    process; then (c) shrink on (1,2). Returns each stage's rank
    outputs and the JAX process's."""
    arch = request.param
    d = str(tmp_path_factory.mktemp(arch))
    _reference(arch, d)
    res = {"save": _gloo(_SAVE_SMALL, 2, arch, d)}
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX, arch, d],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=_env(), cwd=ROOT)
    try:
        res["grow"] = _gloo(_GROW, 4, arch, d)
        out, err = jax_proc.communicate(timeout=TIMEOUT_S)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, err[-4000:]
    res["jax"] = json.loads(out.strip().splitlines()[-1])
    res["shrink"] = _gloo(_SHRINK, 2, arch, d)
    return res


def _clean(rec):
    n, sharded, bad = rec
    assert bad == [], bad[:10]
    assert sharded > 0          # the mesh really splits some leaves
    return n


def test_placed_on_the_save_mesh(stages):
    for r in stages["save"]:
        _clean(r["placed"])


def test_grow_restores_bit_equal_and_placed(stages):
    """Saved from 2 processes, restored onto 4: same logical values."""
    for r in stages["grow"]:
        _clean(r["grow"])


def test_shrink_restores_bit_equal_and_placed(stages):
    """Saved from 4 processes, restored onto 2."""
    for r in stages["shrink"]:
        _clean(r["shrink"])


def test_same_leaf_count_both_ways(stages):
    """Nothing silently dropped: grow and shrink see every leaf of the
    {params, opt, ef} state."""
    grown = {_clean(r["grow"]) for r in stages["grow"]}
    shrunk = {_clean(r["shrink"]) for r in stages["shrink"]}
    assert len(grown) == 1 and grown == shrunk


def test_fill_missing_onto_a_new_mesh(stages):
    """A version saved before the residual existed restores onto the
    grown mesh: strict raises; with fill_missing the caller's zero
    residual stands in, placed like everything else."""
    for r in stages["grow"]:
        assert r["strict_raised"]
        _clean(r["filled"])


def test_port_mesh_version_restores_in_jax(stages):
    """Published from the port's (1,2) mesh in the store's layout, the
    JAX package restores it bit-exactly onto its (2,4) host mesh."""
    rec = stages["jax"]
    assert rec["bad"] == [] and rec["sharded"] > 0


def test_jax_mesh_version_restores_in_port(stages):
    """Saved from the JAX package's (2,2) mesh, the port restores it in
    the store's layout, converts and reshards it onto (1,2)."""
    for r in stages["shrink"]:
        _clean(r["from_jax"])
