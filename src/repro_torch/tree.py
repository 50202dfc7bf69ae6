"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are visited in sorted key order, the order ``jax.tree`` flattens a
dict in, so a leaf list lines up with the JAX package's."""
from __future__ import annotations

from typing import Callable, Iterator


def leaves_with_path(tree, path: tuple = ()) -> Iterator[tuple[tuple, object]]:
    """(key path, leaf) pairs; empty dicts have no leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, path: tuple = ()):
    """``fn(key path, leaf, *matching leaves)`` over the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)
