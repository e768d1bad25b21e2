"""Nested dicts of tensors (parameter, gradient and optimizer trees): the
few pytree operations the model stack needs, in ``jax.tree``'s leaf order
(dict keys sorted)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List

import torch


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


def checksums(tree) -> List[int]:
    """A checksum a tensor leaf (dicts in :func:`leaves`' order, lists and
    tuples in theirs; other leaves skipped), computed where it lies: its
    bytes (zero-padded to whole 32-bit words) summed as int32 words
    weighted 1..65521 by position, in int64 (wrapping).  Equal leaves give
    equal sums; two processes compare trees by these without moving
    them."""
    if isinstance(tree, (list, tuple)):
        return [c for t in tree for c in checksums(t)]
    if isinstance(tree, dict):
        return [c for t in leaves(tree) for c in checksums(t)]
    if not isinstance(tree, torch.Tensor):
        return []
    out = []
    for t in (tree,):
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        b = torch.nn.functional.pad(b, (0, (-b.numel()) % 4))
        w = b.view(torch.int32)
        total = torch.zeros((), dtype=torch.int64, device=w.device)
        step = 1 << 24
        for s0 in range(0, w.numel(), step):
            part = w[s0:s0 + step].to(torch.int64)
            pos = torch.arange(s0, s0 + part.numel(), device=w.device)
            total += (part * (pos % 65521 + 1)).sum()
        out.append(int(total))
    return out
