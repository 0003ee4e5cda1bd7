"""Checkpointing with async save, and the versioned model store — the
port of ``repro.ckpt.checkpoint`` on the same on-disk layout.

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per tree leaf plus a
``manifest.json`` describing the tree (and, for published versions, a
``meta.json`` with step / config hash / eval metrics). Leaf names are the
``/``-joined key paths of the tree: dict keys in sorted order and list or
tuple indices as ``"0"``, ``"1"``, …, which is how ``jax.tree_util``
flattens the same tree. A store written by either package therefore
loads in the other. A tensor leaf is written from host memory
(``leaf.detach().cpu()``); a bf16 tensor as its bits viewed as
``ml_dtypes.bfloat16``, so its manifest ``dtype`` reads ``bfloat16`` as a
bf16 ``jax.Array``'s does.

Atomicity & durability: writes land in ``step_<N>.tmp.*`` and are
renamed only when complete, so a node killed mid-save never corrupts its
latest checkpoint, and a replica restoring mid-write never sees a partial
one (``all_steps``/``restore_latest`` also skip any directory without a
readable manifest). Durable saves (``save(..., durable=True)``, used by
``publish``) fsync every file and the directory before the rename.

``ModelStore`` is the serving-side view on the same layout: versions are
published atomically with metadata, replicas load them by id, and GC
never collects a version a live replica reports serving (``retain_fn``).

Device meshes: a DTensor leaf is saved as its full logical value
(``full_tensor()``, a collective that every rank of its mesh calls, in
the same leaf order). Every rank then writes the same directory, which
the overwrite dance below makes safe (last writer wins); a rank that
restores what another rank saves must wait for that save to land (a
``dist.barrier()`` after it). On restore, ``shardings=`` (``sharding.rules.param_sharding``'s tree of
``(mesh, placements)``, or a flat {name: (mesh, placements)} dict)
distributes each leaf onto its mesh. The bytes on disk are the same
either way, so a tree saved from a mesh restores in both packages.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from concurrent import futures
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.courier.serialization import tensor_as_numpy
from repro_torch.sharding.rules import distribute, full


def _is_sharding(x) -> bool:
    """A ``(mesh, placements)`` pair: a leaf of a shardings tree."""
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], DeviceMesh))


def _flatten(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(``/``-joined key path, leaf) pairs in ``jax.tree_util`` order:
    dict keys sorted, sequences by index; ``None`` is an empty subtree;
    a ``(mesh, placements)`` pair is one leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)) and not _is_sharding(tree):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves: Iterable) -> Any:
    """``like``'s structure with its leaves taken in ``_flatten`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}       # keep the caller's order
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            if isinstance(node, tuple):
                return (type(node)(*vals) if hasattr(node, "_fields")
                        else tuple(vals))
            return vals
        return None if node is None else next(it)

    return build(like)


def _tree_map(fn, tree) -> Any:
    return _unflatten(tree, [fn(leaf) for _, leaf in _flatten(tree)])


def _host(leaf, copy: bool = False) -> np.ndarray:
    """The leaf as a host numpy array (``copy``: never aliasing a CPU
    tensor that may be mutated in place later). A DTensor is gathered to
    its full value first: a collective over its mesh."""
    leaf = full(leaf)
    if isinstance(leaf, torch.Tensor):
        return tensor_as_numpy(leaf.detach().to("cpu", copy=copy))
    return np.asarray(leaf)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def config_hash(cfg: Any) -> str:
    """Stable short hash of a model config (dataclass or anything
    repr-able) — stored in version metadata so a replica can refuse to
    hot-swap weights built for a different architecture. Equal to the
    JAX package's hash of the same config (the port's own fields count
    only where they leave their defaults, ``config.shared_fields``)."""
    import dataclasses as dc

    from repro_torch.models.config import ModelConfig, shared_fields
    if isinstance(cfg, ModelConfig):
        blob = json.dumps(shared_fields(cfg), sort_keys=True, default=str)
    elif dc.is_dataclass(cfg) and not isinstance(cfg, type):
        blob = json.dumps(dc.asdict(cfg), sort_keys=True, default=str)
    else:
        blob = repr(cfg)
    return hashlib.blake2b(blob.encode(), digest_size=8).hexdigest()


def save(tree, directory: str, metadata: Optional[dict] = None,
         durable: bool = False) -> None:
    """Write ``tree`` under ``directory`` atomically (tmp dir + rename).

    ``durable=True`` additionally fsyncs every leaf file, the manifest, the
    tmp dir, and the parent dir around the rename — required for published
    model versions that must survive machine crash.

    Concurrent writers of the *same* directory are safe (last writer
    wins): each writes its own uniquely-named tmp dir, and the rename
    dance retries around a sibling landing first.
    """
    tag = f".tmp.{os.getpid()}.{threading.get_ident()}"
    tmp = directory + tag
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = []
    for name, leaf in _flatten(tree):
        arr = _host(leaf)
        fname = name.replace("/", "__") + ".npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        manifest.append({"name": name, "file": fname,
                         "dtype": str(arr.dtype), "shape": list(arr.shape)})
    if metadata is not None:
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(metadata, f)
            if durable:
                f.flush()
                os.fsync(f.fileno())
    # The manifest lands last: a directory with a manifest is complete by
    # construction.
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    if durable:
        _fsync_dir(tmp)
    # Overwrite dance: park any existing dir aside so ``directory`` never
    # exists half-built. Retried because a concurrent publisher of the
    # same step may land between our park and replace.
    for attempt in range(8):
        try:
            os.replace(tmp, directory)   # succeeds iff directory absent
            break
        except OSError:
            trash = directory + f".old{tag}.{attempt}"
            try:
                os.rename(directory, trash)
            except FileNotFoundError:
                continue                 # sibling already parked it
            shutil.rmtree(trash, ignore_errors=True)
    else:
        raise OSError(f"could not atomically land {directory} "
                      "(concurrent writers thrashing)")
    if durable:
        _fsync_dir(os.path.dirname(os.path.abspath(directory)))


def is_complete(directory: str) -> bool:
    """A checkpoint dir is complete iff its manifest is present and parses
    — the write protocol guarantees the manifest lands last."""
    try:
        with open(os.path.join(directory, "manifest.json")) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def load_metadata(directory: str) -> dict:
    """The ``meta.json`` written at publish time ({} if absent)."""
    try:
        with open(os.path.join(directory, "meta.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _load_leaf(directory: str, entry: dict) -> np.ndarray:
    arr = np.load(os.path.join(directory, entry["file"]))
    if entry["dtype"] == "bfloat16":    # np.save keeps only the 2-byte void
        import ml_dtypes
        arr = arr.view(ml_dtypes.bfloat16)
    return arr


def as_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor (a bf16 array through its bits)."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _cast_like(arr: np.ndarray, ref) -> Any:
    """``arr`` in the type, dtype (and, for a tensor, device) of ``ref``."""
    if isinstance(ref, torch.Tensor):
        return as_tensor(arr).to(device=ref.device, dtype=ref.dtype)
    return arr.astype(np.asarray(ref).dtype, copy=False)


def restore(directory: str, like=None, shardings=None,
            fill_missing: bool = False):
    """Load a checkpoint. With ``like`` (a tree of dicts, lists and
    tuples whose leaves are numpy arrays or tensors), returns that
    structure, each leaf cast to its ``like`` leaf's dtype (a tensor leaf
    comes back as a tensor on the ``like`` leaf's device); otherwise
    returns a flat {name: array} dict. ``shardings`` (a tree like
    ``like``'s, or a flat dict, of ``(mesh, placements)``) distributes
    each leaf it names onto its mesh (every rank of the mesh restores the
    same directory); naming a leaf that ``like`` lacks raises. A leaf
    missing from the checkpoint or of another shape raises.

    ``fill_missing=True`` substitutes ``like``'s own leaf for any name the
    checkpoint lacks instead of raising.
    """
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {e["name"]: _load_leaf(directory, e) for e in manifest}
    if like is None:
        return flat
    shard_named = dict(_flatten(shardings)) if shardings is not None else {}
    named = _flatten(like)
    unknown = sorted(set(shard_named) - {name for name, _ in named})
    if unknown:
        raise KeyError(f"shardings name leaves that like lacks: {unknown}")
    leaves = {}
    for name, ref in named:
        if name not in flat:
            if fill_missing:
                leaves[name] = ref
                continue
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = flat[name]
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(f"{name}: ckpt shape {arr.shape} != "
                             f"{tuple(np.shape(ref))}")
        leaves[name] = _cast_like(arr, ref)
    placed = distribute(
        {n: leaves[n] if isinstance(leaves[n], torch.Tensor)
         else as_tensor(np.asarray(leaves[n])) for n in shard_named},
        shard_named)
    return _unflatten(like, [placed.get(n, leaves[n]) for n, _ in named])


class CheckpointManager:
    """Periodic, async, retention-limited checkpoints for stateful nodes.

    ``retain_fn`` (optional) returns the set of step ids that are pinned —
    e.g. versions live serve replicas report serving (read off the
    Registry's version table). ``_gc`` never deletes a retained step, no
    matter how old, so a rollout can always roll *back* to the version the
    fleet was on.
    """

    def __init__(self, directory: str, keep: int = 3,
                 retain_fn: Optional[Callable[[], Iterable[int]]] = None):
        self.directory = directory
        self.keep = keep
        self._retain_fn = retain_fn
        os.makedirs(directory, exist_ok=True)
        self._pool = futures.ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="ckpt")
        self._pending: Optional[futures.Future] = None
        self._lock = threading.Lock()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        """Complete checkpoints only: half-written dirs (no manifest yet —
        in-flight background save, or debris from a crash mid-write) are
        invisible to readers."""
        steps = []
        for name in os.listdir(self.directory):
            if (name.startswith("step_") and ".tmp" not in name
                    and ".old" not in name):
                try:
                    step = int(name[5:])
                except ValueError:
                    continue
                if is_complete(os.path.join(self.directory, name)):
                    steps.append(step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree, blocking: bool = False,
             metadata: Optional[dict] = None, durable: bool = False) -> None:
        # Snapshot to host now (the D2H copy; a CPU tensor is copied, since
        # the caller may update it in place), write in the background on
        # the same tmp-dir + rename protocol.
        host_tree = _tree_map(lambda x: _host(x, copy=True), tree)

        def _write():
            save(host_tree, self._step_dir(step), metadata=metadata,
                 durable=durable)
            self._gc()

        with self._lock:
            if self._pending is not None:
                self._pending.result()  # one in flight at a time
            self._pending = self._pool.submit(_write)
            if blocking:
                self._pending.result()

    def publish(self, step: int, tree, metadata: Optional[dict] = None,
                blocking: bool = True) -> None:
        """Atomic, *durable* publish of a model version: fsync every file
        and directory around the rename. Blocking by default — a rollout
        must not announce a version whose bytes may still be in page
        cache."""
        self.save(step, tree, blocking=blocking, metadata=dict(metadata or {}),
                  durable=True)

    def metadata(self, step: int) -> dict:
        return load_metadata(self._step_dir(step))

    def wait(self) -> None:
        with self._lock:
            if self._pending is not None:
                self._pending.result()

    def restore_latest(self, like, shardings=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore(self._step_dir(step), like, shardings)

    def _gc(self) -> None:
        retained = set()
        if self._retain_fn is not None:
            try:
                retained = {int(s) for s in self._retain_fn()}
            except Exception:  # noqa: BLE001 - can't read pins: delete nothing
                return
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            if s in retained:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


class ModelStore(CheckpointManager):
    """Versioned model weights for the serve fabric, on the checkpoint
    layout (a version id *is* a step id — the train loop publishes, the
    fleet serves).

    The store holds no rollout state: which replica serves which version
    lives in the Registry's membership table. Wire ``retain_fn`` to the
    registry's version table so GC can never collect a version that is
    still live on some replica.
    """

    def publish_version(self, version: int, tree,
                        metadata: Optional[dict] = None) -> None:
        self.publish(int(version), tree, metadata=metadata, blocking=True)

    def version_dir(self, version: int) -> str:
        """Path of a published version (for elastic restores)."""
        return self._step_dir(int(version))

    def load_version(self, version: int, like=None, shardings=None):
        path = self._step_dir(int(version))
        if not is_complete(path):
            raise FileNotFoundError(
                f"model version {version} not published (or incomplete) "
                f"in {self.directory}")
        return restore(path, like, shardings)

    def versions(self) -> list[int]:
        return self.all_steps()

    def latest_version(self) -> Optional[int]:
        return self.latest_step()
