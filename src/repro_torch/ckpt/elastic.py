"""Elastic restore: the port of ``repro.ckpt.elastic``.

The failure-recovery contract (paper §6): a learner that comes back
restores the same logical state — params, optimizer moments *and* the
``grad_compression`` int8 error-feedback residual, which is genuine
training state: dropping it across a restore would silently reintroduce
the quantization bias that error feedback exists to cancel. Checkpoints
published before the residual existed still restore via
``fill_missing`` (the caller's zero residual stands in).

Leaves come back where ``like``'s leaves live: a tensor leaf on its
device, so a ``like`` on the learner's card restores onto it. Re-placing
a tree on a *different* mesh (``new_mesh``, ``reshard``) waits for the
port of ``sharding/`` (ROADMAP.md Q7): there is one device here.
"""

from __future__ import annotations

from repro_torch.ckpt import checkpoint

_NO_MESH = ("restoring onto a device mesh waits for the port of "
            "sharding/ (ROADMAP.md Q7)")


def reshard(tree, new_mesh):
    """Re-place a tree under the sharding rules of ``new_mesh``: not
    ported yet."""
    raise ValueError(_NO_MESH)


def restore_elastic(directory: str, like, new_mesh=None,
                    fill_missing: bool = False):
    """Restore a checkpoint in ``like``'s structure, dtypes and devices.

    ``fill_missing=True`` tolerates schema growth: leaves absent from the
    checkpoint (e.g. an error-feedback residual added after the version
    was published) come from ``like`` instead of raising.
    """
    if new_mesh is not None:
        raise ValueError(_NO_MESH)
    return checkpoint.restore(directory, like=like, fill_missing=fill_missing)
