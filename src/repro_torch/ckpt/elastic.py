"""Elastic resharding: the port of ``repro.ckpt.elastic``.

The failure-recovery contract (paper §6 + our scale-out): a learner that
comes back on a smaller or larger mesh restores the same logical state.
Because checkpoints are full logical arrays and sharding specs are
derived from parameter *paths* (not from the mesh they were saved
under), restoring onto a new mesh is re-running the rules
(``sharding.rules.param_sharding``) against the new mesh and
distributing each leaf.

The whole learner state reshards as one tree — params, optimizer moments,
*and* the ``grad_compression`` int8 error-feedback residual. The residual
is genuine training state: dropping it across a shrink/grow restore would
silently reintroduce the quantization bias that error feedback exists to
cancel. Checkpoints published before the residual existed still restore
via ``fill_missing`` (the caller's zero residual stands in).

A torch ``DeviceMesh`` spans one process per device: every rank of the
new mesh calls ``reshard`` (and ``restore_elastic``) on the same tree.
The rules read the port's paths, so a tree in the JAX package's store
layout is turned into the port's tree first (``train.fabric.from_store``).
"""

from __future__ import annotations

from repro_torch.ckpt import checkpoint
from repro_torch.sharding.rules import distribute, full, param_sharding
from repro_torch.train import tree as tree_lib


def reshard(tree, new_mesh):
    """Re-place a tree (of tensors, or DTensors on any mesh) under the
    rules for ``new_mesh``: each leaf a DTensor."""
    logical = tree_lib.tree_map(full, tree)
    return distribute(logical, param_sharding(logical, new_mesh))


def restore_elastic(directory: str, like, new_mesh=None,
                    fill_missing: bool = False):
    """Restore a checkpoint in ``like``'s structure, dtypes and devices;
    if ``new_mesh`` is given, reshard the whole tree onto it.

    ``fill_missing=True`` tolerates schema growth: leaves absent from the
    checkpoint (e.g. an error-feedback residual added after the version
    was published) come from ``like`` instead of raising.
    """
    tree = checkpoint.restore(directory, like=like, fill_missing=fill_missing)
    if new_mesh is None:
        return tree
    return reshard(tree, new_mesh)
