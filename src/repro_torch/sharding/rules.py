"""Parameter, optimizer and batch sharding rules on a ``DeviceMesh``: the
port of ``repro.sharding.rules``.

Scheme (single pod 16x16, axes ``("data", "model")``), as in the JAX
package:

  * 2-D weight sharding = FSDP('data') x TP('model'): column-parallel
    projections ``('data', 'model')``, row-parallel ``('model', 'data')``.
  * Embedding: vocab-sharded rows over the FSDP axis.
  * MoE experts: ``(None, 'data', 'model')``.
  * Multi-pod ``("pod", "data", "model")``: the pod axis is pure DP.

Every rule is divisibility-checked against the actual dim; axes that do
not divide are dropped right to left, so tiny configs replicate.

A spec is a ``Spec``: a tuple with one entry per tensor dim, each
``None``, an axis name or a tuple of axis names, as a JAX
``PartitionSpec``. ``placements`` turns it into DTensor placements. The
port keeps ``params["blocks"]`` as a list of per-layer dicts where the
JAX tree stacks a leading repeat axis, so a block leaf's spec here is the
JAX spec without its leading ``None``; paths are the ``/``-joined keys of
``train.tree.leaves_with_path`` (``blocks/3/0/attn/wq/kernel``), which
the same end-anchored patterns match.
"""

from __future__ import annotations

import re
from typing import Sequence, Union

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.sharding.compat import mesh_sizes
from repro_torch.train import tree as tree_lib

Axis = Union[None, str, tuple]


class Spec(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name
    or a tuple of names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _fit(sizes: dict, dim: int, entry: Axis) -> Axis:
    """Drop axes (right to left) until the dim divides the axis product.
    Axes the mesh doesn't have are ignored; an axis product of 1 never
    shards."""
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    axes = tuple(a for a in axes if a in sizes)
    while axes:
        n = 1
        for a in axes:
            n *= sizes[a]
        if n > 1 and dim % n == 0:
            return axes if len(axes) > 1 else axes[0]
        axes = axes[:-1]
    return None


def fit_spec(mesh, shape: Sequence[int], spec: Sequence[Axis]) -> Spec:
    if len(shape) != len(spec):
        raise ValueError(f"spec {tuple(spec)} for a tensor of shape "
                         f"{tuple(shape)}")
    sizes = mesh_sizes(mesh)
    return Spec(*[_fit(sizes, d, e) for d, e in zip(shape, spec)])


# (regex, spec for the unstacked tensor). Verbatim from the JAX package.
_RULES: list[tuple[str, tuple[Axis, ...]]] = [
    # embeddings / head. The token table is vocab-(row-)sharded over the
    # FSDP axis; the tied-head reshard to ('model', None) happens in
    # layers.lm_logits so logits come out vocab-sharded.
    (r"embed/tokens$",             ("data", None)),
    (r"embed/head/kernel$",        ("data", "model")),
    (r"embed/conv_pos$",           (None, None, ("data", "model"))),
    # attention
    (r"attn/w[qkv]/kernel$",       ("data", "model")),
    (r"attn/w[qkv]/bias$",         ("model",)),
    (r"attn/wo/kernel$",           ("model", "data")),
    (r"attn/wo/bias$",             (None,)),
    # dense mlp
    (r"mlp/w_(gate|up)/kernel$",   ("data", "model")),
    (r"mlp/w_(gate|up)/bias$",     ("model",)),
    (r"mlp/w_down/kernel$",        ("model", "data")),
    (r"mlp/w_down/bias$",          (None,)),
    # moe
    (r"mlp/router/kernel$",        ("data", None)),
    (r"mlp/router/bias$",          (None,)),
    (r"mlp/w_(gate|up)$",          (None, "data", "model")),
    (r"mlp/w_down$",               (None, "model", "data")),
    # rg-lru
    (r"rglru/in_(x|gate)/kernel$", ("data", "model")),
    (r"rglru/in_(x|gate)/bias$",   ("model",)),
    (r"rglru/out/kernel$",         ("model", "data")),
    (r"rglru/out/bias$",           (None,)),
    (r"rglru/conv1d$",             (None, "model")),
    (r"rglru/gate_[ax]$",          (None, None, "model")),
    (r"rglru/bias_[ax]$",          ("model",)),
    (r"rglru/lam$",                ("model",)),
    # mamba
    (r"mamba/in_proj/kernel$",     ("data", "model")),
    (r"mamba/in_proj/bias$",       ("model",)),
    (r"mamba/conv1d$",             (None, "model")),
    (r"mamba/conv_bias$",          ("model",)),
    (r"mamba/x_proj/kernel$",      ("model", None)),
    (r"mamba/dt_proj/kernel$",     (None, "model")),
    (r"mamba/dt_proj/bias$",       ("model",)),
    (r"mamba/A_log$",              ("model", None)),
    (r"mamba/D$",                  ("model",)),
    (r"mamba/out_proj/kernel$",    ("model", "data")),
    (r"mamba/out_proj/bias$",      (None,)),
    # norms & anything small: replicate (matched last)
    (r".*",                        ()),
]


def path_str(path: Sequence) -> str:
    """A tree path as the rules read it: keys joined by ``/``."""
    return "/".join(str(k) for k in path)


def spec_for_path(path: str, shape: Sequence[int], mesh) -> Spec:
    """The fitted spec of the (unstacked) leaf at ``path``."""
    for pattern, core in _RULES:
        if re.search(pattern, path):
            spec = tuple(core)
            if len(spec) != len(shape):
                # The replicate rule, or a shape the rule does not fit
                # (e.g. missing bias dims): replicate.
                spec = (None,) * len(shape)
            return fit_spec(mesh, shape, spec)
    raise AssertionError("unreachable: catch-all rule")


def placements(mesh, spec: Sequence[Axis]) -> tuple:
    """DTensor placements of ``spec``: mesh dim ``i`` gets ``Shard(d)``
    where tensor dim ``d``'s entry names it, else ``Replicate()``. An
    entry of several axes shards its dim over each, in mesh order
    (JAX's major-to-minor device order for the same tuple)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry!r} lists mesh axes out of the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def param_sharding(tree, mesh):
    """Tree of ``(mesh, placements)`` matching a parameter (or optimizer)
    tree: the counterpart of a tree of ``NamedSharding``."""
    return tree_lib.map_with_path(
        lambda path, x: (mesh, placements(
            mesh, spec_for_path(path_str(path), x.shape, mesh))), tree)


def batch_spec(mesh, ndim: int, batch_axis: int = 0) -> Spec:
    """Batch inputs: leading dim over all DP axes (incl. 'pod')."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    entries: list[Axis] = [None] * ndim
    entries[batch_axis] = dp if len(dp) > 1 else dp[0]
    return Spec(*entries)


def batch_shardings(mesh, batch_tree):
    """Tree of ``(mesh, placements)`` for a batch: the leading dim over
    the DP axes where it divides, a scalar replicated."""
    def leaf(x):
        spec = batch_spec(mesh, x.dim()) if x.dim() else ()
        # Divisibility fit: long_500k has global_batch=1, so it stays
        # replicated.
        return mesh, placements(mesh, fit_spec(mesh, x.shape, tuple(spec)))
    return tree_lib.tree_map(leaf, batch_tree)


def distribute(tree, shardings, src_data_rank=None):
    """Place each tensor of ``tree`` on its ``(mesh, placements)`` from
    ``shardings`` (``param_sharding``'s tree): a DTensor holding this
    rank's shard. With ``src_data_rank=None`` every rank of the mesh
    passes the same full value and keeps its own shard of it, so nothing
    is sent; with a rank, that rank's value is scattered and the others'
    are read only for their shape (a batch that each rank drew itself)."""
    return tree_lib.tree_map(
        lambda t, sh: distribute_tensor(t, sh[0], sh[1],
                                        src_data_rank=src_data_rank),
        tree, shardings)


def full(x):
    """A leaf's full logical value: a DTensor gathered over its mesh (a
    collective that every rank calls), anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x
