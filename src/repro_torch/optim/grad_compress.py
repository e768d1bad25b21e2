"""Gradient compression: the int8 per-block grid, top-k with error feedback.

The counterpart of ``repro/optim/grad_compress.py``:

1. ``quantize_leaf`` / ``dequantize_leaf``: the int8 per-block-128 grid
   every wire format shares (one quantization block == one bitpack wire
   chunk, so a per-block scale is a per-row epilogue operand).
2. ``quantize_grads``: a stateless quantize -> dequantize pass (the
   ``grad_compressor`` hook without the wire).
3. ``topk_select`` / ``topk_sparsify``: exactly-k magnitude selection with
   ties broken by index, and its error-feedback residual.

``compressed_psum`` and ``make_compressed_psum_fn`` reduce over a mesh axis
and are not ported yet (ROADMAP.md Queue 1 item 11).  Rounding is
``torch.round`` (half to even, as ``jnp.round``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.tree import map_tree

QBLOCK = 128

_MESH = ("{} needs a mesh, not ported yet (ROADMAP.md Queue 1 item 11): "
         "the port runs on one device")


def quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 (nb, QBLOCK), float32 scales (nb, 1)) of a leaf's flat values,
    zero-padded to whole blocks."""
    flat = g.float().reshape(-1)
    pad = (-flat.shape[0]) % QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
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


def compressed_psum(x, axis_name: str):
    raise NotImplementedError(_MESH.format("compressed_psum"))


def make_compressed_psum_fn(mesh, axis: str = "pod"):
    raise NotImplementedError(_MESH.format("make_compressed_psum_fn"))


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


def topk_select(flat: torch.Tensor, k: int):
    """Exactly-k magnitude selection over a flat vector: ``(mask, kept)``,
    ``mask`` with exactly k True entries, ``kept = where(mask, flat, 0)``.
    Equal magnitudes keep the lower index, as ``lax.top_k`` does (a stable
    descending sort)."""
    idx = torch.sort(torch.abs(flat), descending=True, stable=True)[1][:k]
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
