"""Nested-dict trees of tensors, keyed as the reference's pytrees are.

The training state (stacked parameters, gradients, optimizer state)
keeps the reference's tree layout: nested dicts, tuples and lists whose
leaves are tensors (or numpy arrays). Dict keys are visited in sorted
order, ``None`` is an empty subtree and a tuple subclass (a
``distributed.PartitionSpec``) is a leaf, as ``jax.tree_util`` does, so a
leaf's path joined by ``/`` is the key the reference's checkpoint gives
it (``blocks/slot0/attn/q/w``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

SEP = "/"


def leaves_with_paths(tree: Any, prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    """``(path, leaf)`` for every leaf, in the reference's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (str(k),))
    elif type(tree) in (tuple, list):
        for i, x in enumerate(tree):
            yield from leaves_with_paths(x, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def key(path: tuple[str, ...]) -> str:
    return SEP.join(path)


def map_with_path(fn: Callable[[tuple[str, ...], Any], Any], tree: Any,
                  prefix: tuple[str, ...] = ()) -> Any:
    """A tree of the same structure with ``fn(path, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if type(tree) in (tuple, list):
        return type(tree)(map_with_path(fn, x, prefix + (str(i),)) for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    return map_with_path(lambda _, leaf: fn(leaf), tree)


def get(tree: Any, path: tuple[str, ...]) -> Any:
    """The subtree at ``path``."""
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (tuple, list)) else tree[k]
    return tree
