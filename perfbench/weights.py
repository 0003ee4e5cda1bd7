"""Seeded weights, drawn on the device in a few large calls.

The tree has the layout that the architecture's module gives
(``archs/<name>.py`` ``layout(sizes)``): the port's, which the harness
checks before handing it over, and which the reference reads by the
same names. Each dtype's leaves are views into one flat buffer,
filled by ``normal_`` in chunks from one ``torch.Generator`` on the
device; then each leaf is scaled in place: matrices by their fan-in to
the -1/2 (the port's own init), biases to 0.1, norm scales to 1 + 0.1 x.
Norm scales are fp32 (the port keeps them so); the rest is ``dtype``."""

from __future__ import annotations

import torch

CHUNK = 1 << 28            # elements a normal_ call draws


def _put(tree: dict, path: tuple, leaf) -> None:
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def draw(items: list, seed: int, device, dtype: torch.dtype) -> dict:
    """The seeded tree of the layout ``items`` ([(path, shape, kind)] in
    drawing order; kind is "matrix", "matrix_rows", "bias" or "scale"):
    the same seed, layout, device type and dtype give the same numbers."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    groups: dict[torch.dtype, list] = {}
    for path, shape, kind in items:
        dt = torch.float32 if kind == "scale" else dtype
        groups.setdefault(dt, []).append((path, shape, kind))
    tree: dict = {}
    for dt in sorted(groups, key=str):
        members = groups[dt]
        total = sum(_numel(shape) for _, shape, _ in members)
        flat = torch.empty(total, dtype=dt, device=device)
        for a in range(0, total, CHUNK):
            flat[a:a + CHUNK].normal_(generator=gen)
        off = 0
        for path, shape, kind in members:
            n = _numel(shape)
            leaf = flat[off:off + n].view(shape)
            off += n
            if kind == "scale":
                leaf.mul_(0.1).add_(1.0)
            elif kind == "bias":
                leaf.mul_(0.1)
            elif kind == "matrix_rows":
                leaf.mul_(shape[-1] ** -0.5)
            else:
                leaf.mul_(shape[-2] ** -0.5)
            _put(tree, path, leaf)
    return tree


def _numel(shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n


def leaves(tree, prefix=()) -> list[tuple[tuple, torch.Tensor]]:
    """[(path, tensor)] of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = (enumerate(tree) if isinstance(tree, list)
             else sorted(tree.items()))
    out = []
    for k, v in items:
        out += leaves(v, prefix + (k,))
    return out


def check_layout(tree: dict, shapes: dict) -> None:
    """Refuse a tree whose paths or shapes are not the program's."""
    mine = {p: tuple(t.shape) for p, t in leaves(tree)}
    theirs = {p: tuple(t.shape) for p, t in leaves(shapes)}
    if mine != theirs:
        extra = sorted(set(mine.items()) - set(theirs.items()))[:5]
        missing = sorted(set(theirs.items()) - set(mine.items()))[:5]
        raise ValueError("the benchmark's weights do not have the "
                         f"program's layout: extra {extra}, missing "
                         f"{missing}")
