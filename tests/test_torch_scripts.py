"""The port's planning scripts (``scripts/torch_*.py``) against the JAX
package's (``scripts/make_tables.py``, ``kernel_adjusted.py``): the same
tables from the same records, the same classifier, and breakdowns that
sum to the trace's totals. The tracing scripts run in subprocesses (a
planning mesh needs a process of its own) at the reduced configs.
"""

import ast
import glob
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
TIMEOUT_S = 300


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def run_script(name: str, *args, cwd=ROOT) -> str:
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, name), *map(str, args)],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=_env(),
        cwd=cwd)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_scripts_import_no_jax_and_no_reference():
    for path in glob.glob(os.path.join(SCRIPTS, "torch_*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "repro"), (path, n)


# ---------------------------------------------------------------------------
# torch_make_tables against make_tables
# ---------------------------------------------------------------------------

def _records(seed: int = 3) -> dict:
    """(mesh kind, arch, shape) -> a dry-run record with the port's keys
    (``launch.dryrun``'s record functions), seeded values."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis
    rng = np.random.default_rng(seed)
    out = {}
    for mesh in ("single", "multi"):
        for arch in ("qwen2-1.5b", "falcon-mamba-7b", "mixtral-8x7b"):
            for shape in ("train_4k", "prefill_32k", "decode_32k",
                          "long_500k"):
                rec = {"arch": arch, "shape": shape, "mesh": mesh}
                if shape == "long_500k" and arch != "falcon-mamba-7b":
                    rec.update(status="skipped", reason="full attention "
                               "at 500k tokens is out of scope")
                elif mesh == "multi" and shape == "decode_32k":
                    rec.update(status="error", error="RuntimeError('x')")
                else:
                    cost = analysis.CellCost(
                        *(float(v) for v in rng.uniform(1e9, 1e13, 3)),
                        {k: int(rng.integers(0, 400))
                         for k in analysis.COLL_KINDS})
                    roof = analysis.roofline_from_cost(
                        cost, float(rng.uniform(1e9, 1e12)))
                    trace = analysis.TraceRecord(
                        cost, int(rng.integers(1e9, 9e10)), 0,
                        int(rng.integers(1e9, 9e10)), 0, {}, 1)
                    rec.update(status="ok", cost=dryrun.cost_record(cost),
                               roofline=dryrun.roofline_record(roof),
                               memory=dryrun.memory_record(trace))
                out[(mesh, arch, shape)] = rec
    return out


def test_make_tables_prints_the_jax_scripts_rows(tmp_path):
    """The same records under each package's artifact directory: every
    table row and skipped-cell line is the same (titles may differ)."""
    for (mesh, arch, shape), rec in _records().items():
        for kind in ("dryrun", "dryrun_torch"):
            d = tmp_path / "artifacts" / kind / mesh
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{arch}__{shape}.json").write_text(json.dumps(rec))
    want = run_script("make_tables.py", cwd=tmp_path)
    got = run_script("torch_make_tables.py", "--dir",
                     tmp_path / "artifacts" / "dryrun_torch")

    def rows(text):
        return [line for line in text.splitlines()
                if line.startswith(("|", "* `"))]
    # matrix: 2 + 3 archs; roofline: 2 + 10 ok cells; 2 skipped cells
    assert len(rows(want)) == 5 + 12 + 2
    assert rows(got) == rows(want)


# ---------------------------------------------------------------------------
# the breakdowns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("qwen2-1.5b", "train_4k"),
                                        ("falcon-mamba-7b", "decode_32k")])
def test_profile_bytes_buckets_sum_to_the_total(arch, shape, tmp_path):
    out = tmp_path / "bytes.json"
    text = run_script("torch_profile_bytes.py", arch, shape, "bf16",
                      "--reduced", "--json", out)
    res = json.loads(out.read_text())
    assert text.startswith("total bytes accessed:")
    assert len(text.strip().splitlines()) == 1 + min(12,
                                                     len(res["buckets"]))
    total = sum(b for _, _, b in res["buckets"])
    assert res["total_bytes"] > 0
    assert total == pytest.approx(res["total_bytes"], rel=1e-12)
    sizes = [b for _, _, b in res["buckets"]]
    assert sizes == sorted(sizes, reverse=True)


def test_profile_coll_buckets_sum_to_the_total(tmp_path):
    out = tmp_path / "coll.json"
    text = run_script("torch_profile_coll.py", "qwen2-1.5b", "train_4k", 2,
                      "--reduced", "--json", out)
    res = json.loads(out.read_text())
    assert "nm=2" in text.splitlines()[0]
    assert res["total_wire_bytes"] > 0
    assert sum(w for *_, w in res["buckets"]) == pytest.approx(
        res["total_wire_bytes"], rel=1e-12)
    for kind, _, group, _ in res["buckets"]:
        assert group > 1 and kind in ("all-reduce", "all-gather",
                                      "reduce-scatter", "all-to-all",
                                      "collective-permute")


# ---------------------------------------------------------------------------
# torch_kernel_adjusted
# ---------------------------------------------------------------------------

def _jax_kernelizable(cfg, dims_list):
    """``kernelizable`` as ``scripts/kernel_adjusted.py`` has it (a
    module-level ``cfg`` there)."""
    for dtype, d in dims_list:
        if cfg.ssm_state and len(d) >= 3 and d[-1] == cfg.ssm_state:
            return True                      # [.., Di_shard, N] scan elems
        if len(d) == 4 and d[-2] >= 1024 and d[-1] >= 1024:
            return True                      # [B, H, Sq, Sk] logits/probs
    return False


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHAPE_CASES = [
    (16, 1, 4096, 4096), (16, 1, 4096, 1024), (16, 1, 1023, 4096),
    (4, 4096, 4096), (2, 8, 2048, 2048, 1), (16, 4096, 16, 128),
    (8, 1024, 16), (8, 512, 16), (8, 16), (16,), (), (1, 1, 1024, 1024),
    (8, 2, 4096, 8), (4, 4096, 8), (2, 3, 4, 16), (8, 1024, 1024)]


@pytest.mark.parametrize("ssm_state", [0, 16, 8])
def test_kernelizable_is_the_jax_classifier(ssm_state):
    ka = _load_script("torch_kernel_adjusted")
    cfg = types.SimpleNamespace(ssm_state=ssm_state)
    for dims in SHAPE_CASES:
        for dims_list in ([("float32", dims)],
                          [("bfloat16", (3,)), ("float32", dims)]):
            assert (ka.kernelizable(dims_list, ssm_state)
                    == _jax_kernelizable(cfg, dims_list)), dims_list


def test_kernel_adjusted_scales_the_memory_term(tmp_path):
    """On a small cell without a dry-run record: the fraction lies in
    (0, 1) (the attention logits at S 4096 are kernelizable), the
    memory term is scaled by what is left, and the step and MFU follow."""
    out = tmp_path / "ka.json"
    text = run_script("torch_kernel_adjusted.py", "qwen2-1.5b", "train_4k",
                      "--reduced", "--base", tmp_path / "none.json",
                      "--json", out)
    r = json.loads(out.read_text())
    assert "kernelizable byte fraction per superblock" in text
    assert r["base"].startswith("1- and 2-superblock traces")
    assert 0 < r["fraction"] < 1
    assert r["superblock_kernelizable"] <= r["superblock_bytes"]
    assert r["memory_s_adjusted"] == pytest.approx(
        r["memory_s"] * (1 - r["fraction"]))
    assert r["memory_s_adjusted"] <= r["memory_s"]
    assert r["step_s_adjusted"] <= r["step_s"]
    assert r["mfu_adjusted"] >= r["mfu"]


def test_probe_scan_shards_names_each_point():
    """``torch_probe_scan_shards.py`` at its default reduced cell prints
    the placements and local shapes from ``in_proj`` to the scan."""
    text = run_script("torch_probe_scan_shards.py")
    lines = text.strip().splitlines()
    assert lines[0].startswith("torch ")
    labels = [line.split(":")[0] for line in lines[1:]]
    assert labels[:5] == ["in_proj out", "after shard('dp', None, 'tp')",
                          "conv in", "conv out", "scan u"]
    assert all("Shard(dim=0)" in line for line in lines[1:])
