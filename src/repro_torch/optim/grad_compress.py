"""Gradient compression: the int8 per-block grid, top-k with error feedback.

The counterpart of ``repro/optim/grad_compress.py``:

1. ``quantize_leaf`` / ``dequantize_leaf``: the int8 per-block-128 grid
   every wire format shares (one quantization block == one bitpack wire
   chunk, so a per-block scale is a per-row epilogue operand).
2. ``quantize_grads``: a stateless quantize -> dequantize pass (the
   ``grad_compressor`` hook without the wire).
3. ``topk_select`` / ``topk_sparsify``: exactly-k magnitude selection with
   ties broken by index, and its error-feedback residual.

``compressed_psum`` and ``make_compressed_psum_fn`` are the seed-era int8
all-gather (dequantize, then sum over members, outside the plan IR), the
reference the compressed wire of ``distributed/collectives.py`` is held
against.  In one process they take member-stacked leaves: a leaf "sharded
over ``pod``" is one tensor whose leading axis is the member, on the
device every member shares.  One process a member (a mesh over a world's
ranks, or an installed ``distributed.spmd.Member``) they take the
member's own leaf (``make_compressed_psum_fn``: its block, a leading axis
of 1) and all-gather the int8 blocks and scales over the axis's process
group.  Rounding is ``torch.round`` (half to even, as ``jnp.round``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.tree import map_tree
from repro_torch.kernels.harness import MemberReduce

QBLOCK = 128


def quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 (nb, QBLOCK), float32 scales (nb, 1)) of a leaf's flat values,
    zero-padded to whole blocks."""
    flat = g.float().reshape(-1)
    pad = (-flat.shape[0]) % QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, QBLOCK)
    # a true division, as on the CPU: the card multiplies by the reciprocal
    # of a Python number, one ulp apart from the reference's scale at times
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / \
        torch.full((), 127.0, device=blocks.device) + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def quantize_grads(grads):
    """Stateless int8 wire-format pass (``grad_compressor`` hook)."""
    def qdq(g):
        if g.numel() < QBLOCK:
            return g
        q, s = quantize_leaf(g)
        return dequantize_leaf(q, s, g.shape, g.dtype)
    return map_tree(qdq, grads)


def _member(mesh, axis_name: str):
    from repro_torch.distributed import collectives
    return collectives.member_of(mesh, axis_name)


def compressed_psum(x: torch.Tensor, axis_name: str = "pod", *,
                    mesh=None) -> torch.Tensor:
    """int8 all-gather, then the dequantized members summed, the members
    added in order: what every member receives.  ``x``: member-stacked
    ``(n, ...)`` in one process (the sum ``x.shape[1:]``; ``mesh``, where
    given, is checked: its ``axis_name`` has ``n`` members on one device),
    or this member's own leaf on a mesh over a world's ranks or under an
    installed member (the sum ``x.shape``)."""
    member = _member(mesh, axis_name)
    if member is None:
        if mesh is not None:
            mesh.members(axis_name, x.shape[0])
        qs = [quantize_leaf(x[m]) for m in range(x.shape[0])]
        qg = torch.stack([q for q, _ in qs])   # (n, nb, B) int8 on the wire
        sg = torch.stack([s for _, s in qs])
        shape = x.shape[1:]
    else:
        from repro_torch.distributed import spmd
        q, s = quantize_leaf(x)
        with spmd.use(member):
            qg = spmd.all_gather(q[None], axis_name)
            sg = spmd.all_gather(s[None], axis_name)
        shape = x.shape
    summed = MemberReduce(qg.shape[0]).fold(qg.float() * sg)
    n = 1
    for d in shape:
        n *= int(d)
    return summed.reshape(-1)[:n].reshape(shape)


def make_compressed_psum_fn(mesh, axis: str = "pod"):
    """Tree-wise :func:`compressed_psum` over one mesh axis: leaves carry a
    leading member axis of ``mesh.shape[axis]`` (on a mesh over a world's
    ranks, this member's block of it: a leading axis of 1); each member's
    block of the result is the int8-wire sum (in one process one tensor,
    every member's row the same values)."""
    n = mesh.members(axis)
    stacked = _member(mesh, axis) is None
    rows = n if stacked else 1

    def tree_psum(tree):
        def one(leaf):
            s = compressed_psum(leaf if stacked else leaf[0], axis,
                                mesh=mesh)
            return s.unsqueeze(0).expand((rows,) + tuple(s.shape))
        return map_tree(one, tree)

    return tree_psum


def wire_bytes_f32_allreduce(nbytes: int, n: int) -> float:
    """Ring all-reduce wire bytes per member for an f32 payload."""
    return 2.0 * nbytes * (n - 1) / n


def wire_bytes_compressed(nbytes: int, n: int) -> float:
    """int8 all-gather wire bytes per member (values/4 + scales/128)."""
    payload = nbytes / 4.0 + (nbytes / 4.0 / QBLOCK) * 4.0
    return payload * (n - 1)


# ---------------------------------------------------------------------------
# top-k sparsification with error feedback
# ---------------------------------------------------------------------------


def topk_order(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest magnitudes, largest first, equal
    magnitudes in index order (a stable descending sort)."""
    return torch.sort(torch.abs(flat), descending=True, stable=True)[1][:k]


def topk_select(flat: torch.Tensor, k: int):
    """Exactly-k magnitude selection over a flat vector: ``(mask, kept)``,
    ``mask`` with exactly k True entries, ``kept = where(mask, flat, 0)``.
    Equal magnitudes keep the lower index, as ``lax.top_k`` does (a stable
    descending sort)."""
    idx = topk_order(flat, k)
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    mask[idx] = True
    return mask, torch.where(mask, flat, torch.zeros((), dtype=flat.dtype,
                                                     device=flat.device))


def topk_sparsify(g: torch.Tensor, residual: torch.Tensor,
                  frac: float = 0.01):
    """Keep exactly the top-``frac`` entries of (g + residual) by
    magnitude: ``(sparse_g, new_residual)``."""
    acc = g.float() + residual
    k = max(1, int(acc.numel() * frac))
    flat = acc.reshape(-1)
    _, kept = topk_select(flat, k)
    new_residual = (flat - kept).reshape(acc.shape)
    return kept.reshape(acc.shape).to(g.dtype), new_residual


def topk_wire_bytes(size: int, frac: float) -> float:
    """values (f16) + 1-bit bitpacked mask, per member (exact)."""
    k = max(1, int(size * frac))
    return k * 2.0 + size / 8.0
