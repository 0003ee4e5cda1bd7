"""The port's dry run (``repro_torch.launch``) against the JAX package's:
the same cell plans, model FLOPs and input shapes for every arch x shape
on the production meshes (JAX on an ``AbstractMesh``, the port on
planning meshes of H100s, both at the JAX package's 2.5e9-byte budget);
the three cells the JAX package's own test compiles, traced at reduced
shapes on a 2x4 planning mesh; the full trace against the JAX package's
depth probe; and the hill climb's variants.

Planning meshes run in a subprocess (a fake process group), once for
the module."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import jax
import pytest

from repro import configs as jconfigs
from repro.launch import cells as jcells
from tests.test_torch_sharding import ROOT, run_py

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
JAX_CELLS = [("qwen2-1.5b", "train_4k"), ("mixtral-8x7b", "decode_32k"),
             ("falcon-mamba-7b", "long_500k")]


def _jax_leaves(tree, stacked_blocks: bool):
    """{path: (shape, dtype)}; block leaves lose their repeat axis."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        shape = list(x.shape)
        if stacked_blocks and "blocks" in keys:
            shape = shape[1:]
        out["/".join(keys)] = (shape, str(x.dtype))
    return out


@pytest.fixture(scope="module")
def port():
    out = run_py("""
    import dataclasses, json
    import torch
    from repro_torch import configs
    from repro_torch.launch import cells, dryrun, hillclimb
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import attention, layers, ssm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding.compat import planning_mesh
    from repro_torch.train import tree
    res = {"plans": {}, "inputs": {}}
    for kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=kind == "multi")
        for arch in configs.ARCH_NAMES:
            cfg = configs.get(arch)
            for name, shape in cells.SHAPES.items():
                plan = cells.plan_cell(cfg, shape, mesh, budget=2.5e9)
                res["plans"][f"{kind}/{arch}/{name}"] = [
                    dataclasses.asdict(plan),
                    cells._model_flops(cfg, shape, mesh.size())]
    for arch in configs.ARCH_NAMES:
        for name in cells.SHAPES:
            specs = cells.input_specs(arch, name)
            leaves = {}
            for path, x in tree.leaves_with_path(specs):
                keys = list(path)
                reps = None
                if "blocks" in keys and keys[0] in ("params", "opt_state"):
                    i = keys.index("blocks")
                    if keys[0] == "params" or keys[1] in ("m", "v"):
                        del keys[i + 1]
                key = "/".join(str(k) for k in keys)
                leaves[key] = [list(x.shape),
                               str(x.dtype).replace("torch.", "")]
            res["inputs"][f"{arch}/{name}"] = leaves
    # the JAX test cells at reduced shapes on a 2x4 mesh
    mesh = planning_mesh((2, 4), ("data", "model"))
    res["cells"] = {}
    for arch, name in %r:
        cfg = configs.get_reduced(arch)
        base = cells.SHAPES[name]
        small = ShapeConfig(base.name, base.kind, seq_len=256,
                            global_batch=4)
        cell, rec, _ = dryrun.trace(cfg, small, mesh)
        res["cells"][arch] = [rec.cost.flops, rec.peak_bytes,
                              rec.argument_bytes, rec.ops]
    # the depth probe against the full trace: 4 superblocks
    cfg = dataclasses.replace(configs.get_reduced("qwen2-1.5b"),
                              num_layers=4)
    small = ShapeConfig("train_4k", "train", seq_len=64, global_batch=4)
    plan = cells.plan_cell(cfg, small, mesh)
    _, full, _ = dryrun.trace(cfg, small, mesh, plan)
    est = dryrun.probe_cost(cfg, small, mesh, plan)
    res["probe"] = [est.flops / full.cost.flops,
                    est.bytes_accessed / full.cost.bytes_accessed,
                    est.wire_bytes / full.cost.wire_bytes]
    # a variant restores the module flags it set
    before = (attention.LOGITS_DTYPE, layers.NORM_RESIDENT_DTYPE,
              ssm.SCAN_DTYPE)
    # the variants at the reduced config and shape, on the 2x4 mesh
    import repro_torch.launch.mesh as mesh_lib
    configs.get = configs.get_reduced
    cells.SHAPES["train_4k"] = small
    mesh_lib.make_production_mesh = lambda multi_pod=False: mesh
    recs = [hillclimb.run_variant("qwen2-1.5b", "train_4k", v)
            for v in ("baseline", "all_bf16")]
    after = (attention.LOGITS_DTYPE, layers.NORM_RESIDENT_DTYPE,
             ssm.SCAN_DTYPE)
    res["variants"] = [[r["status"], r.get("cost", {}).get("bytes")]
                       for r in recs]
    res["flags"] = [list(before), list(after)]
    print(json.dumps(res))
    """ % (JAX_CELLS,), timeout=600)
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_plans_and_model_flops_match_jax(port, mesh_kind):
    shape, names = MESHES[mesh_kind]
    mesh = jax.sharding.AbstractMesh(shape, names)
    n = 0
    for arch in jconfigs.ARCH_NAMES:
        cfg = jconfigs.get(arch)
        for name, sh in jcells.SHAPES.items():
            plan, mflops = port["plans"][f"{mesh_kind}/{arch}/{name}"]
            assert plan == dataclasses.asdict(jcells.plan_cell(cfg, sh,
                                                               mesh))
            assert mflops == jcells._model_flops(cfg, sh, mesh.size)
            n += 1
    assert n == 40


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_input_specs_match_jax(port, arch):
    for name in jcells.SHAPES:
        want = {}
        specs = jcells.input_specs(arch, name)
        for key, sub in specs.items():
            stacked = key in ("params", "opt_state", "state") and \
                key != "state"
            for path, leaf in _jax_leaves(sub, stacked).items():
                want[f"{key}/{path}"] = leaf
        got = port["inputs"][f"{arch}/{name}"]
        assert set(got) == set(want), (name, set(got) ^ set(want))
        for path, (shape, dtype) in want.items():
            assert got[path] == [shape, dtype], (name, path)


@pytest.mark.parametrize("arch", [a for a, _ in JAX_CELLS])
def test_jax_test_cells_trace_at_reduced_shapes(port, arch):
    flops, peak, args, ops = port["cells"][arch]
    assert flops > 0 and peak > 0 and peak >= args > 0 and ops > 0


def test_depth_probe_agrees_with_the_full_trace(port):
    for ratio in port["probe"]:
        assert ratio == pytest.approx(1.0, rel=1e-2)


def test_hillclimb_variants_trace_and_restore_flags(port):
    assert [s for s, _ in port["variants"]] == ["ok", "ok"]
    # bf16 logits and norms move fewer bytes than the baseline
    assert port["variants"][1][1] < port["variants"][0][1]
    assert port["flags"][0] == port["flags"][1] == [
        "float32", "float32", "float32"]


def test_hillclimb_lists_the_jax_variants_in_order():
    def names(mod):
        proc = subprocess.run(
            [sys.executable, "-m", mod, "--list"], capture_output=True,
            text=True, timeout=120, cwd=ROOT,
            env={"PYTHONPATH": f"{ROOT}/src", "JAX_PLATFORMS": "cpu",
                 "PATH": "/usr/bin:/bin"})
        assert proc.returncode == 0, proc.stderr[-2000:]
        return proc.stdout.split()
    mine = names("repro_torch.launch.hillclimb")
    assert mine == names("repro.launch.hillclimb") and len(mine) == 18
