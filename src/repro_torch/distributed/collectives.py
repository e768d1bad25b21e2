"""Compressed collectives: the gradient wire and the compressed all-reduces
over a mesh axis, lowered through the ``DecodePlan`` dispatch.

The counterpart of ``repro/distributed/collectives.py``:

  encode (device)   each member quantizes its leaf onto the int8
                    per-block-128 grid (``optim.grad_compress.quantize_leaf``),
                    biased to [0, 254] and packed into the bitpack codec's
                    EXACT wire layout (:func:`pack_bits_rows` mirrors
                    ``encoders.pack_bits`` row by row; :func:`wire_dev`
                    mirrors ``format.to_device``, its 128-byte lane padding
                    included), so the wire is a registry blob; or keeps
                    exactly k values (f16) and a 1-bit index bitmap (top-k);
  gather            ``plan.gather_member_tables`` lays every member's rows
                    into one table (member m's at ``[m*nb, (m+1)*nb)``);
  decode (plan)     one ``plan.dispatch`` a leaf, ``plan.dispatch`` staying
                    the port's only ``ops.decode`` call site;
  epilogue (fused)  ``(u8 - 127) * s_row`` to float32 in the bitpack
                    kernel's stores, one scale a chunk row
                    (``DecodeSpec.row_operands``); for ``compressed_psum``
                    the member sum (or mean) too (:func:`_member_reduce`,
                    ``DecodeSpec.reduce_bits``): one launch of
                    ``codag_bitpack_reduce`` a leaf on a card writes the
                    reduced leaf, and the per-member dequantized rows never
                    exist.  The top-k wire's scatter needs a prefix sum over
                    a member's whole bitmap, so it runs as torch ops after
                    the bitmap's decode, as the reference's runs in XLA
                    after its Pallas call.

Two forms.  In one process, a leaf "sharded over ``pod``" is one tensor
whose leading axis is the member, on the device every member of the mesh
(``launch.mesh.Mesh``) shares, and the all-gather is a ``torch.cat``.  One
process a member (a mesh over a world's ranks, ``launch.mesh.spawn``, or
under an installed ``distributed.spmd.Member``), a collective takes this
member's own leaf with no member axis, as the reference's ``shard_map``
body does: it encodes the leaf on its device, all-gathers the wire's
tables (``plan.gather_member_tables``' member form) and scales or top-k
values over the axis's process group, decodes the gathered table with one
``plan.dispatch`` on its own device, and returns the same reduced leaf on
every member.  A mesh over distinct devices without a rank raises,
pointing to ``launch.mesh.spawn``.

:func:`make_wire_compressor` is the ``grad_compressor`` hook of
``launch.steps.build_train_step`` (``--grad-int8``); :func:`make_tree_reduce`
is the DiLoCo outer sync's reduce (``distributed/diloco.py``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.engine import EngineConfig, resolve_device
from repro_torch.core.tree import leaves, map_tree, rebuild
from repro_torch.distributed import spmd
from repro_torch.kernels.harness import Epilogue, MemberReduce
from repro_torch.optim import grad_compress as gc
from repro_torch.roofline import count

WIRE_CODEC = "bitpack"
WIRE_BITS = 8          # int8 deltas, biased to [0, 254]
WIRE_ZERO = 127.0
MASK_CHUNK = 2048      # top-k bitmap elements per wire chunk (256 B rows)



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
# epilogues of the receive path
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _member_reduce(n_members: int, mean: bool) -> MemberReduce:
    """Epilogue fn: fold the gathered member axis in the dispatch; a kernel
    that reduces members (bitpack's) applies it in its stores."""
    return MemberReduce(n_members, mean)


@functools.lru_cache(maxsize=None)
def _mask_scatter_reduce(n_members: int, mean: bool):
    """Epilogue fn of the top-k wire: decoded 1-bit masks -> dense deltas.

    ``out`` is the ``(n * nc, MASK_CHUNK)`` decoded bitmap; each member's
    surviving values ride the table under ``topk_vals`` ``(n, k)`` in index
    order.  A mask position's value is found by a prefix sum over the
    member's whole bitmap, then gathered into place and the members summed
    in order.  Cached, so the same fn keys the same epilogue."""

    def fn(out, dev):
        vals = dev["topk_vals"].float()                       # (n, k)
        m = out.reshape(n_members, -1).to(torch.int64)        # (n, size_pad)
        cum = (m.cumsum(1) - 1).clamp(0, vals.shape[1] - 1)
        return MemberReduce(n_members, mean).fold(
            torch.gather(vals, 1, cum) * m)

    return fn


# --------------------------------------------------------------------------
# the collectives: member-stacked leaves on one device
# --------------------------------------------------------------------------


def member_of(mesh, axis_name: str):
    """The ``spmd.Member`` a collective over ``axis_name`` runs as: the
    mesh's, on a mesh over a world's ranks; with no mesh, an installed
    member of a world that has the axis; else None (the one-process form,
    member-stacked leaves)."""
    if mesh is not None:
        return spmd.member_of(mesh) if mesh.rank is not None else None
    m = spmd.current()
    if m is not None and m.transport == "group" and axis_name in m.shape:
        return m
    return None


def _resolve(config: Optional[EngineConfig], tune, x: torch.Tensor,
             mesh, axis_name: str, member=None):
    """(config, device, tune) of a collective over ``axis_name``, ``x``
    checked to lie on the engine's device (and on the mesh's: the device
    the members share, or this member's).  One process: ``x`` holds the
    axis's ``x.shape[0]`` members."""
    config = config or EngineConfig()
    device = resolve_device(config.device)
    if mesh is not None:
        if member is None:
            mesh.members(axis_name, x.shape[0])
        if mesh.member_device() != device:
            raise ValueError(f"the mesh's member holds "
                             f"{mesh.member_device()}; this engine decodes "
                             f"on {device}")
    if x.device != device:
        raise ValueError(f"a leaf on {x.device}; this engine decodes on "
                         f"{device}")
    if tune is None:
        from repro_torch.core import tuning
        tune = tuning.kernel_tune(WIRE_CODEC, 1, config.tune)
    return config, device, tune


def gathered_wire(x: torch.Tensor, axis_name: str = "pod", *,
                  mesh=None) -> Dict[str, Any]:
    """The gathered int8 wire: each member's :func:`quantized_wire`, laid
    member after member by ``plan.gather_member_tables``, with the
    gathered scales (``wire_scale``, ``(n * nb, 1)``) and the zero point
    (``wire_zero``).  ``x``: a member-stacked leaf ``(n, ...)`` in one
    process; this member's own leaf where a member runs the collective
    (:func:`member_of`), whose tables and scales are all-gathered over
    ``axis_name``."""
    member = member_of(mesh, axis_name)
    if member is None:
        wires = [quantized_wire(x[m]) for m in range(x.shape[0])]
        dev = plan_mod.gather_member_tables([w for w, _ in wires],
                                            codec=WIRE_CODEC)
        dev["wire_scale"] = torch.cat([s for _, s in wires]).reshape(-1, 1)
        count.collective("all-gather", dev["wire_scale"].numel() * 4,
                         x.device)
    else:
        own, s = quantized_wire(x)
        with spmd.use(member):
            dev = plan_mod.gather_member_tables(own, axis_name,
                                                codec=WIRE_CODEC)
            dev["wire_scale"] = spmd.all_gather(s, axis_name)
    dev["wire_zero"] = torch.full((), WIRE_ZERO, dtype=torch.float32,
                                  device=x.device)
    return dev


def compressed_psum(x: torch.Tensor, axis_name: str = "pod", *, mesh=None,
                    config: Optional[EngineConfig] = None, tune=None,
                    mean: bool = False) -> torch.Tensor:
    """int8-wire all-reduce over ``axis_name``: the sum (or ``mean``) over
    its members, what every member receives.  ``x``: a member-stacked leaf
    ``(n, ...)`` (one process; the result ``x.shape[1:]``), or this
    member's own leaf on a mesh over a world's ranks or under an installed
    member (:func:`member_of`; the result ``x.shape``).

    Each member's leaf is encoded into the bitpack wire
    (:func:`quantized_wire`), the members' tables and scales are gathered
    (:func:`gathered_wire`), and ONE ``plan.dispatch`` decodes the
    gathered table with the dequant -> member-reduce epilogue
    (:func:`_member_reduce`), fused into the bitpack kernel's stores on a
    card: the reduced float32 leaf is the decode's output.  ``mesh``
    (optional) is checked: ``axis_name``'s members hold the engine's
    device.  ``tune``: ``tuning.kernel_tune(WIRE_CODEC, 1, config.tune)``,
    resolved here when None."""
    member = member_of(mesh, axis_name)
    config, device, tune = _resolve(config, tune, x, mesh, axis_name,
                                    member)
    n = x.shape[0] if member is None else member.size(axis_name)
    dev = gathered_wire(x, axis_name, mesh=mesh)
    epi = Epilogue(out_dtype="float32", scale_key="wire_scale",
                   zero_key="wire_zero", fn=_member_reduce(n, mean))
    summed = plan_mod.dispatch(dev, config=config, codec=WIRE_CODEC,
                               width=1, chunk_elems=gc.QBLOCK,
                               bits=WIRE_BITS, epilogue=epi, tune=tune)
    shape = x.shape[1:] if member is None else x.shape
    size = int(np.prod(tuple(shape)))
    return summed.reshape(-1)[:size].reshape(shape)


def _topk_wire(flat: torch.Tensor, k: int):
    """One member's top-k wire of its flat accumulator: ``(bitmap table,
    f16 values in index order, new residual)``."""
    size = flat.shape[0]
    order = gc.topk_order(flat, k)
    mask = torch.zeros(size, dtype=torch.bool, device=flat.device)
    mask[order] = True
    kept = torch.where(mask, flat, torch.zeros((), device=flat.device))
    idx = torch.sort(order)[0]                      # ascending: index order
    vals = flat[idx].to(torch.float16)              # the f16 wire grid
    pad = (-size) % MASK_CHUNK
    maskp = torch.nn.functional.pad(mask.to(torch.int32),
                                    (0, pad)).reshape(-1, MASK_CHUNK)
    return (wire_dev(pack_bits_rows(maskp, 1), chunk_elems=MASK_CHUNK,
                     bits=1), vals, flat - kept)


def topk_psum(x: torch.Tensor, residual: torch.Tensor,
              axis_name: str = "pod", *, mesh=None, frac: float = 0.01,
              config: Optional[EngineConfig] = None, tune=None,
              mean: bool = False):
    """Top-k + error-feedback all-reduce: ``(reduced, new residual)``.
    ``x`` and ``residual``: member-stacked ``(n, ...)`` in one process
    (the reduced leaf ``x.shape[1:]``, the residuals ``(n, ...)``), or this
    member's own leaf and residual where a member runs the collective
    (:func:`member_of`; both results ``x.shape``).

    Each member keeps exactly k = max(1, int(size * frac)) entries of
    ``x + residual`` by magnitude (its new residual keeps the rest); its
    wire is the k values as f16, in index order, and a 1-bit index bitmap
    packed through the bitpack codec.  The gathered bitmaps decode through
    ONE ``plan.dispatch`` (a ``bitpack_unpack`` launch on a card); the
    epilogue (:func:`_mask_scatter_reduce`) scatters each member's values
    into place and reduces, as torch ops after the decode."""
    member = member_of(mesh, axis_name)
    config, device, tune = _resolve(config, tune, x, mesh, axis_name,
                                    member)
    acc = x.float() + residual
    if member is None:
        n = x.shape[0]
        flat = acc.reshape(n, -1)
        k = max(1, int(flat.shape[1] * frac))
        wires = [_topk_wire(flat[m], k) for m in range(n)]
        dev = plan_mod.gather_member_tables([w[0] for w in wires],
                                            codec=WIRE_CODEC)
        dev["topk_vals"] = torch.stack([w[1] for w in wires])
        count.collective("all-gather", dev["topk_vals"].numel() * 2, device)
        new_res = torch.stack([w[2] for w in wires]).reshape(x.shape)
        shape = x.shape[1:]
    else:
        n = member.size(axis_name)
        flat = acc.reshape(-1)
        table, vals, res = _topk_wire(flat, max(1, int(flat.shape[0]
                                                       * frac)))
        with spmd.use(member):
            dev = plan_mod.gather_member_tables(table, axis_name,
                                                codec=WIRE_CODEC)
            dev["topk_vals"] = spmd.all_gather(vals[None], axis_name)
        new_res = res.reshape(x.shape)
        shape = x.shape
    epi = Epilogue(fn=_mask_scatter_reduce(n, mean))
    dense = plan_mod.dispatch(dev, config=config, codec=WIRE_CODEC, width=1,
                              chunk_elems=MASK_CHUNK, bits=1, epilogue=epi,
                              tune=tune)
    size = int(np.prod(tuple(shape)))
    return dense[:size].reshape(shape), new_res


def make_tree_reduce(mesh, axis: str = "pod", *, wire: str = "int8",
                     frac: float = 0.01,
                     config: Optional[EngineConfig] = None):
    """Tree-wise compressed mean-all-reduce over one mesh axis.

    Input leaves carry a leading member axis of ``mesh.shape[axis]`` (the
    DiLoCo pods' deltas); on a mesh over a world's ranks each process
    passes its own block of that axis, a leading axis of 1 (what
    ``spmd.blocks`` gives under ``sharding.member_sharding(mesh, axis)``),
    and its residuals likewise.  Returns ``reduce(tree, residuals=None) ->
    (mean_tree, new_residuals)``: each leaf's member mean (without the
    member axis, the same on every member), through the wire ``wire``
    selects:

      "int8"  - :func:`compressed_psum` (a leaf smaller than one quant
                block takes the plain float32 member sum over ``n``)
      "topk"  - :func:`topk_psum` with per-member error-feedback residuals
                (``residuals`` required: the same tree, each leaf with the
                member axis; returned updated)
      "none"  - the plain float32 member sum over ``n`` (the baseline)

    The mesh's members share the engine's device, or each process holds
    its member's (a mesh over distinct devices without a rank raises).
    Kernel knobs are resolved here, once.
    """
    if wire not in ("int8", "topk", "none"):
        raise ValueError(f"unknown wire {wire!r}")
    config = config or EngineConfig()
    n = mesh.members(axis)
    member = member_of(mesh, axis)
    rows = n if member is None else 1      # the leading axis a leaf has
    from repro_torch.core import tuning
    tune = tuning.kernel_tune(WIRE_CODEC, 1, config.tune)

    def plain_mean(x: torch.Tensor) -> torch.Tensor:
        if member is not None:
            with spmd.use(member):
                x = spmd.all_gather(x.float(), axis)
        return MemberReduce(n, True).fold(x.float())

    def reduce_fn(tree, residuals=None):
        if wire == "topk" and residuals is None:
            raise ValueError("wire='topk' needs error-feedback residuals")
        flat = list(leaves(tree))
        res_flat = (list(leaves(residuals)) if residuals is not None
                    else [None] * len(flat))
        outs, res_out = [], []
        for x, r in zip(flat, res_flat):
            if x.shape[0] != rows:
                raise ValueError(f"a leaf of {x.shape[0]} members for mesh "
                                 f"axis {axis!r} of {n}"
                                 + ("" if member is None else
                                    ", one a process"))
            if wire == "none" or x[0].numel() < gc.QBLOCK:
                red = plain_mean(x)
            elif member is not None:
                if wire == "topk":
                    red, r = topk_psum(x[0], r[0], axis, mesh=mesh,
                                       frac=frac, config=config, tune=tune,
                                       mean=True)
                    r = r[None]
                else:
                    red = compressed_psum(x[0], axis, mesh=mesh,
                                          config=config, tune=tune,
                                          mean=True)
            elif wire == "topk":
                red, r = topk_psum(x, r, axis, mesh=mesh, frac=frac,
                                   config=config, tune=tune, mean=True)
            else:
                red = compressed_psum(x, axis, mesh=mesh, config=config,
                                      tune=tune, mean=True)
            outs.append(red)
            res_out.append(r)
        new_res = (rebuild(residuals, res_out) if residuals is not None
                   else None)
        return rebuild(tree, outs), new_res

    return reduce_fn


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
