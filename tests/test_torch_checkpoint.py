"""The port's checkpoint I/O: ``tests/test_checkpoint.py``'s unsharded
cases (roundtrip, atomicity, retention, async save, publish metadata, GC
pins, half-written dirs, the self-restoring node) on torch trees, then
the layout shared with the JAX package: byte-equal manifests and leaf
files, a port-published model version restored bit for bit by the JAX
``ModelStore``, a JAX-published one by the port's, equal config hashes,
and ``params_to_numpy`` (ROADMAP.md C12) as the exact inverse of
``params_from_numpy`` for every family: MoE (router and stacked expert
leaves), cross-attention and the audio encoder's ``embed.conv_pos``
included; and the sharded restores (``shardings=``, the elastic
reshard) on a 1x1 gloo mesh, whose process group each such test ends.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.ckpt import checkpoint
from repro_torch.models import convert
from repro_torch.models import transformer as tt

ARCHS = ("qwen2-1.5b", "recurrentgemma-2b", "falcon-mamba-7b",
         "mixtral-8x7b", "llama-3.2-vision-11b", "hubert-xlarge")


@pytest.fixture(autouse=True)
def _reset_port_inproc_registry():
    """Each test gets a clean in-process courier registry (the port's)."""
    from repro_torch.core.courier import inprocess
    inprocess.reset()
    yield
    inprocess.reset()


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g),
                   "b": torch.zeros((16,))},
        "opt": {"m": {"w": torch.randn((8, 16), generator=g),
                      "b": torch.zeros((16,))},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    return [leaf for _, leaf in checkpoint._flatten(tree)]


def _assert_tree_equal(a, b):
    assert [n for n, _ in checkpoint._flatten(a)] == \
        [n for n, _ in checkpoint._flatten(b)]
    for x, y in zip(_leaves(a), _leaves(b)):
        assert type(x) is type(y)
        torch.testing.assert_close(torch.as_tensor(x), torch.as_tensor(y),
                                   rtol=0, atol=0)


def test_save_restore_roundtrip(tmp_path):
    tree = _tree(0)
    d = str(tmp_path / "ck")
    checkpoint.save(tree, d)
    _assert_tree_equal(checkpoint.restore(d, like=tree), tree)


def test_restore_rejects_shape_mismatch(tmp_path):
    tree = _tree(0)
    d = str(tmp_path / "ck")
    checkpoint.save(tree, d)
    bad = checkpoint._tree_map(
        lambda x: torch.zeros((3,)) if x.ndim == 2 else x, tree)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(d, like=bad)


def test_manager_retention_and_latest(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    tree = _tree(1)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [3, 4]
    step, out = mgr.restore_latest(tree)
    assert step == 4 and out is not None


def test_manager_async_save(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, _tree(2))
    mgr.wait()
    assert mgr.latest_step() == 1


def test_async_save_snapshots_before_in_place_update(tmp_path):
    """A torch tensor can be updated in place (a JAX array cannot): the
    background write must see the values at ``save`` time."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=1)
    tree = _tree(2)
    want = tree["params"]["w"].clone()
    mgr.save(1, tree)
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    _, out = mgr.restore_latest(tree)
    torch.testing.assert_close(out["params"]["w"], want, rtol=0, atol=0)


def test_no_tmp_dirs_left_behind(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, _tree(3), blocking=True)
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


def test_publish_metadata_roundtrip(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=3)
    tree = _tree(5)
    meta = {"step": 7, "config_hash": "abc123", "eval": {"loss": 1.25}}
    mgr.publish(7, tree, metadata=meta)
    assert mgr.metadata(7) == meta
    # ModelStore speaks versions over the same directory layout.
    store = checkpoint.ModelStore(str(tmp_path))
    assert store.versions() == [7]
    assert store.latest_version() == 7
    _assert_tree_equal(store.load_version(7, like=tree), tree)


def test_gc_never_deletes_retained_steps(tmp_path):
    """A live-served version is pinned by retain_fn even when ``keep``
    would age it out."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=1,
                                       retain_fn=lambda: {1})
    tree = _tree(6)
    for s in (1, 2, 3):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [1, 3]      # 1 pinned, 2 collected


def test_gc_deletes_nothing_when_retain_fn_raises(tmp_path):
    def broken():
        raise ConnectionError("registry down")

    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=1,
                                       retain_fn=broken)
    tree = _tree(7)
    for s in (1, 2):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [1, 2]      # fail safe: keep everything


def test_half_written_checkpoint_is_skipped(tmp_path):
    """A dir without a manifest (crash mid-write) is invisible to
    ``all_steps``/``restore_latest`` and unloadable as a version."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=5)
    tree = _tree(8)
    mgr.save(1, tree, blocking=True)
    half = tmp_path / "step_00000002"
    half.mkdir()
    (half / "leaf_00000.npy").write_bytes(b"garbage")
    assert not checkpoint.is_complete(str(half))
    assert mgr.all_steps() == [1]
    step, out = mgr.restore_latest(tree)
    assert step == 1 and out is not None
    store = checkpoint.ModelStore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        store.load_version(2, like=tree)


def test_self_restoring_node_pattern(tmp_path):
    """Paper §6: a stateful node killed and restarted resumes from its
    checkpoint (scheduler restart + self-restore, no exact recovery)."""
    from repro_torch import core as lp

    class Learner:
        def __init__(self, ckpt_dir):
            self._mgr = checkpoint.CheckpointManager(ckpt_dir, keep=2)
            self._state = {"step": torch.tensor(0, dtype=torch.int32)}
            step, restored = self._mgr.restore_latest(self._state)
            self._start = 0
            if restored is not None:
                self._state = restored
                self._start = int(restored["step"])

        def run(self):
            step = self._start
            for _ in range(3):
                step += 1
                self._state = {"step": torch.tensor(step, dtype=torch.int32)}
                self._mgr.save(step, self._state, blocking=True)
            if step < 6:
                raise RuntimeError("simulated node failure")
            lp.stop_program()

    p = lp.Program("self-restore")
    p.add_node(lp.PyNode(Learner, str(tmp_path)))
    launcher = lp.ThreadLauncher(
        restart_policy=lp.RestartPolicy(max_restarts=3, backoff_s=0.01))
    launcher.launch(p)
    assert launcher.wait(timeout=30)
    # Crashed once at step 3, restarted, resumed 4..6.
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 6
    assert len([f for f in launcher.failures if not f.fatal]) == 1


@pytest.fixture
def mesh11():
    """A 1x1 gloo mesh; its process group ends with the test (a later
    planning mesh in the same worker needs the fake backend)."""
    from repro_torch.sharding.compat import make_mesh
    yield make_mesh((1, 1), ("data", "model"), "cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_restore_refuses_shardings(tmp_path, mesh11):
    """``shardings=`` — a tree of ``(mesh, placements)`` as
    ``param_sharding`` gives it, or a flat dict by leaf name — places
    each leaf it names on the mesh, bit-equal; the rest stay where
    ``like``'s leaves live. Refused: shardings that name a leaf ``like``
    lacks, and a leaf of another shape. ``restore_latest`` and
    ``load_version`` take shardings too."""
    from repro_torch.sharding.rules import param_sharding
    tree = _tree(9)
    d = str(tmp_path / "ck")
    checkpoint.save(tree, d)
    sh = param_sharding(tree, mesh11)
    got = checkpoint.restore(d, like=tree, shardings=sh)
    for (name, a), b in zip(checkpoint._flatten(got), _leaves(tree)):
        assert isinstance(a, DTensor), name
        assert a.device_mesh is mesh11 and torch.equal(a.full_tensor(), b)
    flat = {"params/w": sh["params"]["w"]}
    got = checkpoint.restore(d, like=tree, shardings=flat)
    assert isinstance(got["params"]["w"], DTensor)
    assert not isinstance(got["params"]["b"], DTensor)
    assert torch.equal(got["params"]["b"], tree["params"]["b"])
    with pytest.raises(KeyError, match="params/nope"):
        checkpoint.restore(d, like=tree,
                           shardings={"params/nope": sh["params"]["w"]})
    bad = dict(tree, params={"w": torch.zeros((4, 16)),
                             "b": tree["params"]["b"]})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(d, like=bad, shardings=sh)
    store = checkpoint.ModelStore(str(tmp_path / "store"))
    store.publish_version(3, tree)
    for got in (store.restore_latest(tree, sh)[1],
                store.load_version(3, like=tree, shardings=sh)):
        full = [x.full_tensor() for x in _leaves(got)]
        assert all(isinstance(x, DTensor) for x in _leaves(got))
        assert all(torch.equal(a, b) for a, b in zip(full, _leaves(tree)))


def test_save_gathers_dtensor_leaves(tmp_path, mesh11):
    """A tree of DTensors saves as its full logical values: the same
    manifest and bytes as the plain tree, which the JAX package reads."""
    from repro_torch.ckpt.elastic import reshard
    tree = _tree(10)
    placed = reshard(tree, mesh11)
    checkpoint.save(placed, str(tmp_path / "mesh"))
    checkpoint.save(tree, str(tmp_path / "plain"))
    for name in ("manifest.json", "params__w.npy", "opt__step.npy"):
        assert (tmp_path / "mesh" / name).read_bytes() == \
            (tmp_path / "plain" / name).read_bytes()
    got = jckpt.restore(str(tmp_path / "mesh"))
    np.testing.assert_array_equal(got["params/w"],
                                  tree["params"]["w"].numpy())


def test_elastic_reshard_roundtrip(tmp_path, mesh11):
    """Save unsharded, restore onto a mesh (elastic): the port of the
    JAX package's case, on a 1x1 gloo mesh."""
    from repro_torch.ckpt import elastic
    g = torch.Generator().manual_seed(4)
    tree = {"blocks": [{"0": {"mlp": {"w_up": {"kernel": torch.randn(
        (4, 8), generator=g)}}}}]}
    d = str(tmp_path / "ck")
    checkpoint.save(tree, d)
    out = elastic.restore_elastic(d, like=tree, new_mesh=mesh11)
    leaf = out["blocks"][0]["0"]["mlp"]["w_up"]["kernel"]
    assert isinstance(leaf, DTensor)
    assert torch.equal(leaf.full_tensor(),
                       tree["blocks"][0]["0"]["mlp"]["w_up"]["kernel"])
    assert leaf.device_mesh.mesh_dim_names == ("data", "model")


# -- the layout shared with the JAX package ----------------------------------

def _mixed_numpy_tree():
    rng = np.random.default_rng(0)
    return {"z": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                  "half": rng.standard_normal((3, 5)).astype(np.float32)},
            "blocks": [{"b": rng.standard_normal((2,)).astype(np.float32)},
                       {"b": rng.standard_normal((2,)).astype(np.float32)}],
            "a": {"step": np.asarray(11, np.int32)}}


def test_manifest_and_leaf_files_equal_across_packages(tmp_path):
    """The same tree — fp32, int32, a bf16 leaf and a list of blocks —
    saved by each package gives the same manifest and byte-equal .npy
    files (bf16 as ``ml_dtypes.bfloat16`` in both)."""
    base = _mixed_numpy_tree()
    jtree = jax.tree.map(jnp.asarray, base)
    jtree["z"]["half"] = jtree["z"]["half"].astype(jnp.bfloat16)
    ttree = checkpoint._tree_map(torch.from_numpy, base)
    ttree["z"]["half"] = ttree["z"]["half"].to(torch.bfloat16)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jtree, jdir, metadata={"step": 1})
    checkpoint.save(ttree, tdir, metadata={"step": 1})
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir))
    for name in files:
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    manifest = checkpoint.restore(tdir)
    assert sorted(manifest) == ["a/step", "blocks/0/b", "blocks/1/b",
                                "z/half", "z/w"]
    assert manifest["z/half"].dtype.name == "bfloat16"
    out = checkpoint.restore(tdir, like=ttree)
    assert out["z"]["half"].dtype == torch.bfloat16
    assert torch.equal(out["z"]["half"], ttree["z"]["half"])
    assert isinstance(out["blocks"], list) and len(out["blocks"]) == 2


def test_config_hash_equals_jax_package():
    from repro_torch import configs as tconfigs
    for arch in ARCHS:
        assert (checkpoint.config_hash(tconfigs.get(arch))
                == jckpt.config_hash(jconfigs.get(arch)))
        assert (checkpoint.config_hash(tconfigs.get_reduced(arch))
                == jckpt.config_hash(jconfigs.get_reduced(arch)))


def test_port_published_version_restores_bit_for_bit_in_jax(tmp_path):
    cfg = tconfigs.get_reduced("qwen2-1.5b")
    jp = jt.init_params(cfg, jax.random.key(3))
    port = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu", dtype=torch.float32)
    store = checkpoint.ModelStore(str(tmp_path))
    store.publish_version(4, convert.params_to_numpy(cfg, port),
                          metadata={"config_hash": checkpoint.config_hash(
                              cfg)})
    back = jckpt.ModelStore(str(tmp_path)).load_version(4, like=jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      np.asarray(b).view(np.int32))


def test_jax_published_version_restores_bit_for_bit_in_port(tmp_path):
    cfg = tconfigs.get_reduced("recurrentgemma-2b")
    jp = jt.init_params(cfg, jax.random.key(4))
    jckpt.ModelStore(str(tmp_path)).publish_version(2, jp)
    like = convert.params_to_numpy(cfg, tt.init_params(cfg, seed=0,
                                                       device="cpu"))
    back = checkpoint.ModelStore(str(tmp_path)).load_version(2, like=like)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.view(np.int32))


# -- params_to_numpy (C12) ---------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_inverts_params_from_numpy_bit_for_bit(arch):
    """JAX -> port (fp32) -> JAX: the same tree structure, every leaf
    fp32 and bit-equal, ``blocks`` re-stacked on the repeat axis."""
    cfg = tconfigs.get_reduced(arch)
    jp = jax.tree.map(np.asarray, jt.init_params(cfg, jax.random.key(1)))
    port = convert.params_from_numpy(cfg, jp, device="cpu",
                                     dtype=torch.float32)
    back = convert.params_to_numpy(cfg, port)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert b.dtype == np.float32 and b.shape == a.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    # A fresh copy: writing to the export leaves the port's tree alone.
    leaf = back["embed"]["tokens"]
    leaf += 1.0
    assert not np.array_equal(port["embed"]["tokens"].numpy(), leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_widens_bf16_exactly(arch):
    cfg = tconfigs.get_reduced(arch)
    port = tt.init_params(cfg, seed=2, device="cpu")       # bf16 matrices
    back = convert.params_to_numpy(cfg, port)
    blocks = {k: v for k, v in port.items() if k != "blocks"}
    flat_port = checkpoint._flatten(blocks)
    flat_back = dict(checkpoint._flatten(back))
    assert any(t.dtype == torch.bfloat16 for _, t in flat_port)
    for name, t in flat_port:
        np.testing.assert_array_equal(flat_back[name], t.float().numpy())
    for r, rep in enumerate(port["blocks"]):
        for name, t in checkpoint._flatten(rep):
            np.testing.assert_array_equal(
                dict(checkpoint._flatten(back["blocks"]))[name][r],
                t.float().numpy())
    # ...and a store round trip gives back the port's bf16 tree exactly.
    again = convert.params_from_numpy(cfg, back, device="cpu")
    for (_, a), (_, b) in zip(checkpoint._flatten(port),
                              checkpoint._flatten(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_params_to_numpy_refuses_wrong_repeat_count():
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen2-1.5b"))
    port = tt.init_params(cfg, seed=0, device="cpu")
    port["blocks"] = port["blocks"][:1]
    with pytest.raises(ValueError, match="repeats"):
        convert.params_to_numpy(cfg, port)
