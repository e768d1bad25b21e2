"""bitpack codec plugin and its Hopper kernel's wrapper.

The counterpart of ``repro/kernels/bitpack.py``.  Element ``i`` sits at bit
``i*bits``, LSB first, in uint32 words, so every output element unpacks on
its own: a funnel of words ``w`` and ``w+1`` (each clipped to the row's last
word), then a mask.  ``bits`` (1..32) is static and part of the group key.

Backends (every body maps the word table to ``(n, chunk_elems)`` in the
width type):

  * ``torch``  — :func:`unpack`, the reference's ``unpack_tile`` over the
    whole table; the plain twin of the kernel;
  * ``oracle`` — :func:`unpack_oracle`, the counterpart of
    ``ref.unpack_bits`` (uint32 out, then cast);
  * ``scalar`` — :func:`unpack_scalar`, one element per step (§V-E
    ablation; on a card ``kernels/scalar.py`` launches its kernel);
  * ``cuda``   — :func:`decode`, which launches ``csrc/bitpack_unpack.cu``
    on a CUDA tensor (or raises) and runs :func:`unpack` on a CPU tensor;
    it applies a fused epilogue (``harness.FusedEpilogue``) in the kernel's
    stores, or after :func:`unpack` on the CPU; its zero and scale may be
    one value a chunk row (``(n, 1)``: the int8 gradient wire's per-block
    scale, ``DecodeSpec.row_operands``); an epilogue that also folds a
    gathered table's member axis (``harness.MemberReduce``, the collective
    plane's receive path) launches the source's second entry,
    ``codag_bitpack_reduce``, which writes the members' sum (or mean)
    alone (``DecodeSpec.reduce_bits``).

As in the reference, lanes at or past ``out_len`` are not zeroed: they
unpack whatever bits lie there, which are the row's zero padding.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core import registry
from repro_torch.core import streams as st
from repro_torch.kernels import cuda_build, harness, scalar

# (width, words, n, W, chunk_elems, bits, tiles_per_row, vpt,
#  rows_per_block, out, out_code, src_code, zero, zero_code, scale,
#  scale_code, zero_stride, scale_stride, stream)
LIB = cuda_build.KernelLibrary(
    "bitpack_unpack.cu", "codag_bitpack_unpack", "ipllliliipiipipillp")

# (words, nb, members, nw, chunk_elems, bits, mean, out, src_code, zero,
#  zero_code, scale, scale_code, zero_stride, scale_stride, stream)
REDUCE = LIB.entry_point("codag_bitpack_reduce", "plilliipipipillp")

THREADS = 256          # a block: 256 threads of 16-byte output vectors

# Field widths at which the kernel folds a gathered table's member axis in
# its stores (``codag_bitpack_reduce``): those that divide 32.
REDUCE_BITS = (1, 2, 4, 8, 16, 32)

# Kernel launches (one per call that reached the card): the unpack entry's,
# and the member reduce's.
LAUNCHES = 0
REDUCE_LAUNCHES = 0


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 32:
        raise ValueError(f"bitpack bits must be in 1..32, got {bits}")


def unpack_tile(words: torch.Tensor, start, n: int, bits: int) -> torch.Tensor:
    """Elements ``[start, start+n)`` of every row, as int64 in [0, 2^32);
    ``words`` is the int64 word table (``streams.words_int64``)."""
    idx = start + torch.arange(n, dtype=torch.int64, device=words.device)
    return st.peek_bits(words, (idx * bits).expand(words.shape[0], n), bits)


def unpack(words: torch.Tensor, *, chunk_elems: int, width: int,
           bits: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``unpack_tile`` over the whole
    table, cast to the width type."""
    _check_bits(bits)
    return harness.truncate(
        unpack_tile(st.words_int64(words), 0, chunk_elems, bits), width)


def unpack_oracle(words: torch.Tensor, *, chunk_elems: int, width: int,
                  bits: int) -> torch.Tensor:
    """Counterpart of ``ref.unpack_bits``: uint32 per element, then cast;
    here a tile of 4096 elements at a time."""
    _check_bits(bits)
    w64 = st.words_int64(words)
    return torch.cat(
        [harness.truncate(unpack_tile(w64, i, min(4096, chunk_elems - i),
                                       bits), width)
         for i in range(0, chunk_elems, 4096)], dim=1)


def unpack_scalar(words: torch.Tensor, out_lens: torch.Tensor, *,
                  chunk_elems: int, width: int, bits: int) -> torch.Tensor:
    """§V-E single-thread baseline: one element unpacked per step, up to
    ``out_len`` (the rest stay zero)."""
    _check_bits(bits)
    w64 = st.words_int64(words)
    n = words.shape[0]
    buf = torch.zeros((n, chunk_elems), dtype=torch.int64, device=words.device)
    out_len = out_lens.to(torch.int64)
    for i in range(int(out_len.max()) if n else 0):
        v = unpack_tile(w64, i, 1, bits)[:, 0]
        buf[:, i] = torch.where(out_len > i, v, buf[:, i])
    return harness.truncate(buf, width)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch's shape: ``vec_elems`` output elements a vector (16
    bytes), ``vpt`` vectors a thread, ``tiles_per_row`` blocks of
    :data:`THREADS` threads a row, or ``rows_per_block`` whole rows a block
    (short rows on the fast path), ``blocks`` in all over ``rows`` rows;
    ``fast`` where ``bits`` divides 32 and a vector spans >= 16 bits (the
    kernel's ``unpack_fast``; otherwise ``unpack_tiled``)."""

    vec_elems: int
    vpt: int
    tiles_per_row: int
    blocks: int
    fast: bool
    rows_per_block: int = 1
    rows: int = 0


# The tiled path's vectors a thread, a launch-time argument of the kernel
# (``core.tuning``'s knob; the fast path fixes its own at build time).
VPT = harness.Tunable("vpt", (1, 2, 4))


@functools.lru_cache(maxsize=256)
def launch_geometry(n: int, chunk_elems: int, bits: int,
                    out_size: int, vpt: Optional[int] = None) -> Geometry:
    """The kernel's grid for ``n`` rows of ``chunk_elems`` outputs of
    ``out_size`` bytes.  A thread takes up to 4 vectors: on the fast path as
    many as keep its words in 16 registers, on the tiled one ``vpt`` if
    given, else as many as keep a block's words in 32 KiB of shared
    memory.  On the fast path a row that fills at most half of a block's
    vector slots shares its block with the next rows (the int8 gradient
    wire's 128-element rows: 32 rows a block)."""
    vec = 16 // out_size
    fast = 32 % bits == 0 and vec * bits >= 16
    if fast:
        words = max(1, vec * bits // 32)
        vpt = 1 if words >= 16 else 2 if words >= 8 else 4
    elif vpt is not None:
        if vpt not in VPT.candidates:
            raise ValueError(f"vpt must be one of {VPT.candidates}, got "
                             f"{vpt}")
    else:
        vpt = max(1, min(4, 8192 // (THREADS * vec * bits // 32)))
    tiles = -(-chunk_elems // (THREADS * vpt * vec))
    rpb = 1
    row_vectors = -(-chunk_elems // vec)
    if fast and 2 * row_vectors <= THREADS * vpt:
        rpb = THREADS * vpt // row_vectors
    return Geometry(vec, vpt, tiles, -(-n // rpb) * tiles, fast, rpb, n)


def thread_elems(geom: Geometry, chunk_elems: int, block: int,
                 thread: int):
    """[(row, first, end)] of the output elements thread ``thread`` of block
    ``block`` writes, one entry a vector, as the kernel maps them (none
    where end == first)."""
    spans = []
    for j in range(geom.vpt):
        if geom.rows_per_block == 1:
            row, tile = divmod(block, geom.tiles_per_row)
            first = ((tile * geom.vpt + j) * THREADS + thread) \
                * geom.vec_elems
        else:
            row_vectors = -(-chunk_elems // geom.vec_elems)
            r, v = divmod(j * THREADS + thread, row_vectors)
            row = block * geom.rows_per_block + r
            first = v * geom.vec_elems
            if r >= geom.rows_per_block or row >= geom.rows:
                row, first = 0, chunk_elems
        first = min(first, chunk_elems)
        spans.append((row, first, min(first + geom.vec_elems, chunk_elems)))
    return spans


def _check(words: torch.Tensor, chunk_elems: int, width: int,
           bits: int) -> None:
    _check_bits(bits)
    if width not in harness.DEV_DTYPE:
        raise ValueError(f"unsupported width {width}")
    if not 1 <= chunk_elems < 1 << 30:
        raise ValueError(f"chunk_elems must be in 1..2^30-1, got "
                         f"{chunk_elems}")
    if words.dtype != torch.uint32 or words.dim() != 2 or words.shape[1] < 1:
        raise ValueError(f"words must be a (n, W>=1) uint32 table, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")


def decode(words: torch.Tensor, *, chunk_elems: int, width: int, bits: int,
           epilogue: "harness.FusedEpilogue | None" = None,
           vpt: Optional[int] = None) -> torch.Tensor:
    """Unpack every row of a word table; ``(n, chunk_elems)`` in the width
    type (or ``epilogue.dtype``, with the epilogue applied), on the table's
    device.  ``vpt``: the tiled path's vectors a thread (:data:`VPT`; None:
    :func:`launch_geometry`'s choice)."""
    global LAUNCHES
    _check(words, chunk_elems, width, bits)
    if words.device.type == "cpu":
        out = unpack(words, chunk_elems=chunk_elems, width=width, bits=bits)
        return out if epilogue is None else epilogue.apply_plain(out)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    if epilogue is not None and epilogue.reduce is not None:
        return _reduce(words, chunk_elems=chunk_elems, bits=bits,
                       epilogue=epilogue)
    n = words.shape[0]
    fused, dtype, epi = harness.launch_store(epilogue,
                                             harness.DEV_DTYPE[width])
    out = torch.empty((n, chunk_elems), dtype=dtype, device=words.device)
    if n == 0:
        return harness.finish_store(out, epilogue)
    geom = launch_geometry(n, chunk_elems, bits, out.element_size(), vpt)
    strides = (0, 0) if fused is None else fused.row_strides()
    cuda_build.launch_on(words.device, LIB, width, words.data_ptr(), n,
                         words.shape[1], chunk_elems, bits,
                         geom.tiles_per_row, geom.vpt, geom.rows_per_block,
                         out.data_ptr(), *epi, *strides)
    LAUNCHES += 1
    return harness.finish_store(out, epilogue)


def _reduce(words: torch.Tensor, *, chunk_elems: int, bits: int,
            epilogue: "harness.FusedEpilogue") -> torch.Tensor:
    """The member reduce on the card: one launch of
    ``codag_bitpack_reduce`` over the gathered table, ``(n / members,
    chunk_elems)`` float32 out."""
    global REDUCE_LAUNCHES
    red = epilogue.reduce
    n = words.shape[0]
    if bits not in REDUCE_BITS or epilogue.dtype != torch.float32 or \
            n % red.n_members:
        raise ValueError(f"no member reduce for {n} rows of {bits}-bit "
                         f"fields into {epilogue.dtype} over "
                         f"{red.n_members} members")
    nb = n // red.n_members
    out = torch.empty((nb, chunk_elems), dtype=torch.float32,
                      device=words.device)
    if nb == 0:
        return out
    _, *epi = epilogue.kernel_args()      # the output is float32
    cuda_build.launch_on(words.device, REDUCE, words.data_ptr(), nb,
                         red.n_members, words.shape[1], chunk_elems, bits,
                         int(red.mean), out.data_ptr(), *epi,
                         *epilogue.row_strides())
    REDUCE_LAUNCHES += 1
    return out


# --------------------------------------------------------------------------
# registry plumbing
# --------------------------------------------------------------------------


def _body(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return unpack(inputs[0], chunk_elems=chunk_elems, width=width, bits=bits)


def _body_oracle(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return unpack_oracle(inputs[0], chunk_elems=chunk_elems, width=width,
                         bits=bits)


def _body_scalar(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return unpack_scalar(inputs[0], out_lens, chunk_elems=chunk_elems,
                         width=width, bits=bits)


def _scalar_kernel(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return scalar.decode_bitpack(inputs[0], out_lens, chunk_elems=chunk_elems,
                                 width=width, bits=bits)


def _kernel(inputs, consts, out_lens, *, chunk_elems, width, bits,
            epilogue=None, vpt=None):
    return decode(inputs[0], chunk_elems=chunk_elems, width=width, bits=bits,
                  epilogue=epilogue, vpt=vpt)


def _demo_data(n, rng):
    """Low-dynamic-range uint32s (gradient-index / quantized-state shaped)."""
    return rng.integers(0, 1 << 9, n).astype("uint32")


CODEC = registry.register(registry.Codec(
    name=fmt.BITPACK,
    encode=enc.compress_bitpack,
    decode=harness.DecodeSpec(
        body=_body, body_scalar=_body_scalar, body_oracle=_body_oracle,
        cuda=_kernel, scalar=_scalar_kernel,
        chunk_inputs=harness.words_inputs,
        fuses_epilogue=True, row_operands=True, reduce_bits=REDUCE_BITS,
        tunables=(VPT,)),
    needs_words=True,
    shared_extras=("bitpack_bits",),
    static_bits=lambda blob: int(blob.extras["bitpack_bits"][0]),
    demo_data=_demo_data,
))
