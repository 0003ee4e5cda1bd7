"""Trees of tensors: nested dicts and lists, walked in ``jax.tree_util``
order (dict keys sorted, lists by index), which is the order the JAX
package reduces and flattens its trees in."""

from __future__ import annotations

from typing import Any, Callable


def leaves_with_path(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(key path, leaf) pairs; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_path(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree, *rest, path: tuple = ()) -> Any:
    """``fn(path, leaf, *leaves of rest)`` over trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        path=path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest) -> Any:
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)
