"""The int8 gradient wire on one device: the bitpack wire built on the
card and decoded back through the ``DecodePlan`` dispatch.

The counterpart of the single-device half of
``repro/distributed/collectives.py``:

  encode (device)   each leaf is quantized onto the int8 per-block-128 grid
                    (``optim.grad_compress.quantize_leaf``), biased to
                    [0, 254] and packed into the bitpack codec's EXACT wire
                    layout (:func:`pack_bits_rows` mirrors
                    ``encoders.pack_bits`` row by row; :func:`wire_dev`
                    mirrors ``format.to_device``, its 128-byte lane padding
                    included), so the wire is a registry blob;
  decode (plan)     one ``plan.dispatch`` a leaf, ``plan.dispatch`` staying
                    the port's only ``ops.decode`` call site;
  epilogue (fused)  ``(u8 - 127) * s_row`` to float32 in the bitpack
                    kernel's stores: the scale is one float32 a chunk row
                    (``(nb, 1)``), which ``harness.fused_epilogue`` fuses for
                    bitpack (``DecodeSpec.row_operands``), so a leaf's wire
                    decode is one launch.

:func:`make_wire_compressor` is the ``grad_compressor`` hook of
``launch.steps.build_train_step`` (``--grad-int8``).  The collectives that
move the wire between members (``compressed_psum``, ``topk_psum``,
``make_tree_reduce``) need a mesh and are not ported yet (ROADMAP.md Queue
1 item 11): they raise.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.engine import EngineConfig, resolve_device
from repro_torch.core.tree import leaves, map_tree
from repro_torch.kernels.harness import Epilogue
from repro_torch.optim import grad_compress as gc

WIRE_CODEC = "bitpack"
WIRE_BITS = 8          # int8 deltas, biased to [0, 254]
WIRE_ZERO = 127.0
MASK_CHUNK = 2048      # top-k bitmap elements per wire chunk (256 B rows)

_MESH = ("{} moves the wire between mesh members, not ported yet "
         "(ROADMAP.md Queue 1 item 11): the port runs on one device")


# --------------------------------------------------------------------------
# device-side wire encode (the bitpack layout, built on the tensor's device)
# --------------------------------------------------------------------------


def pack_bits_rows(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack each row of ``vals`` LSB-first into uint32 words: the device
    mirror of ``encoders.pack_bits`` a chunk row.

    ``vals``: (n_chunks, chunk_elems) unsigned ints < 2**bits (any integer
    dtype; uint32 keeps its bits).  ``bits`` must divide 32; rows are
    zero-padded up to a whole word.  Fields of distinct elements are
    disjoint, so a word is the OR of its shifted lanes.  Computed in int32
    (a shift into the sign bit wraps) and viewed as uint32.
    """
    if 32 % bits:
        raise ValueError(f"wire bits must divide 32, got {bits}")
    per = 32 // bits
    n, e = vals.shape
    v = vals.view(torch.int32) if vals.dtype == torch.uint32 \
        else vals.to(torch.int32)
    if bits < 32:
        v = v & ((1 << bits) - 1)
    pad = (-e) % per
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(n, -1, per)
    words = functools.reduce(
        torch.bitwise_or, [v[:, :, i] << (i * bits) for i in range(per)])
    return words.contiguous().view(torch.uint32)


def wire_dev(words: torch.Tensor, *, chunk_elems: int,
             bits: int) -> Dict[str, Any]:
    """The ``dispatch``-consumable device table of a bitpack wire, built on
    the words' device: ``format.to_device`` of the same blob, byte for byte
    (``comp`` padded by at least 8 bytes and to a multiple of 128)."""
    n, w = words.shape
    want = int(np.ceil((w * 4 + 8) / 128) * 128)     # format.to_device pad
    words_p = torch.nn.functional.pad(words.view(torch.int32),
                                      (0, want // 4 - w)).view(torch.uint32)
    dev = words.device
    return {
        "comp": words_p.view(torch.uint8),
        "comp_words": words_p,
        "comp_lens": torch.full((n,), w * 4, dtype=torch.int32, device=dev),
        "out_lens": torch.full((n,), chunk_elems, dtype=torch.int32,
                               device=dev),
        "bitpack_bits": torch.full((1,), bits, dtype=torch.int32,
                                   device=dev),
    }


def quantized_wire(x: torch.Tensor):
    """Encode one leaf into the int8 bitpack wire: ``(device table, scales
    (nb, 1) float32)``, one quantization block a wire chunk row."""
    q, s = gc.quantize_leaf(x)
    words = pack_bits_rows(q.to(torch.int32) + int(WIRE_ZERO), WIRE_BITS)
    return wire_dev(words, chunk_elems=gc.QBLOCK, bits=WIRE_BITS), s


# --------------------------------------------------------------------------
# the collectives (need a mesh)
# --------------------------------------------------------------------------


def compressed_psum(x, axis_name: str, **_):
    raise NotImplementedError(_MESH.format("compressed_psum"))


def topk_psum(x, residual, axis_name: str, **_):
    raise NotImplementedError(_MESH.format("topk_psum"))


def make_tree_reduce(mesh, axis: str = "pod", **_):
    raise NotImplementedError(_MESH.format("make_tree_reduce"))


# --------------------------------------------------------------------------
# wire-faithful grad compressor (the per-step grad_compressor hook)
# --------------------------------------------------------------------------


def make_wire_compressor(config: Optional[EngineConfig] = None):
    """Gradient compressor whose dequantized output IS a decode output.

    The ``grad_compressor`` hook of ``launch.steps.build_train_step``: each
    leaf is encoded into the int8 bitpack wire on its device and decoded
    back through ``plan.dispatch`` with the dequant epilogue fused into the
    bitpack kernel's stores (one launch a leaf on a card), so the optimizer
    consumes exactly the values a receiving member would decode off the
    wire (equal to ``grad_compress.quantize_grads``).  Leaves smaller than
    one quantization block pass through.  ``config``: the engine's (default
    ``EngineConfig()``, the card, which must exist); every leaf must lie on
    its device.
    """
    config = config or EngineConfig()
    device = resolve_device(config.device)
    from repro_torch.core import tuning
    tune = tuning.kernel_tune(WIRE_CODEC, 1, config.tune)
    zero = torch.full((), WIRE_ZERO, dtype=torch.float32, device=device)
    epi = Epilogue(out_dtype="float32", scale_key="wire_scale",
                   zero_key="wire_zero")

    def qdq(g: torch.Tensor) -> torch.Tensor:
        if g.numel() < gc.QBLOCK:
            return g
        if g.device != device:
            raise ValueError(f"a gradient on {g.device}; this compressor "
                             f"decodes on {device}")
        dev, s = quantized_wire(g)
        dev["wire_scale"] = s
        dev["wire_zero"] = zero
        table = plan_mod.dispatch(
            dev, config=config, codec=WIRE_CODEC, width=1,
            chunk_elems=gc.QBLOCK, bits=WIRE_BITS, epilogue=epi, tune=tune)
        return table.reshape(-1)[:g.numel()].reshape(g.shape).to(g.dtype)

    return functools.partial(map_tree, qdq)


# --------------------------------------------------------------------------
# exact wire-bytes accounting (same geometry as the encoders above)
# --------------------------------------------------------------------------


def leaf_wire_bytes(size: int, *, wire: str, frac: float = 0.01) -> float:
    """Per-member all-gather payload bytes for one leaf of ``size`` f32
    elements, from the chunk geometry the encoders use."""
    if wire == "none" or size < gc.QBLOCK:
        return float(size * 4)
    nb = -(-size // gc.QBLOCK)
    if wire == "int8":
        words = (gc.QBLOCK * WIRE_BITS + 31) // 32
        return float(nb * (words * 4 + 4))          # packed rows + scales
    if wire == "topk":
        k = max(1, int(size * frac))
        padded = -(-size // MASK_CHUNK) * MASK_CHUNK
        return float(k * 2 + padded // 8)           # f16 values + bitmap
    raise ValueError(f"unknown wire {wire!r}")


def wire_report(tree, n_members: int, *, wire: str = "int8",
                frac: float = 0.01) -> Dict[str, float]:
    """Exact bytes on the wire per member for one tree sync, against the
    f32 ring all-reduce (``ratio`` = baseline / compressed)."""
    sizes = [int(np.prod(tuple(t.shape))) for t in leaves(tree)]
    nbytes = sum(s * 4 for s in sizes)
    payload = sum(leaf_wire_bytes(s, wire=wire, frac=frac) for s in sizes)
    compressed = payload * (n_members - 1)
    f32 = gc.wire_bytes_f32_allreduce(nbytes, n_members)
    return {"f32_ring_bytes": f32, "wire_bytes": compressed,
            "ratio": f32 / max(1.0, compressed)}
