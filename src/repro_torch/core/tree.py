"""Nested dicts of tensors (parameter, gradient and optimizer trees): the
few pytree operations the model stack needs, in ``jax.tree``'s leaf order
(dict keys sorted)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def map_tree(fn: Callable, *trees):
    """``fn`` applied leaf by leaf to trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> Iterator[Any]:
    """The leaves, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def rebuild(like, new_leaves: List[Any]):
    """``like``'s structure with its leaves (in :func:`leaves`' order)
    replaced by ``new_leaves``."""
    return _rebuild(like, iter(new_leaves))


def _rebuild(node, it: Iterator[Any]):
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would keep ``new_leaves`` (a step's gradients)
    # alive until the cycle collector runs
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    return next(it)
