"""huffman (gap-array canonical Huffman) codec plugin and its kernel's wrapper.

The counterpart of ``repro/kernels/huffman.py``.  A chunk row is

  [gap table: n_segments x 5 bytes] [Huffman payload, LSB-first bits]

where gap entry g holds the u32 LE absolute bit offset of segment g's first
symbol and, in byte 4, its symbol count - 1.  Every segment of ``SUB``
symbols decodes on its own: peek 12 bits, look up (symbol, code length) in
the chunk's 4096-entry LUT, advance.  Output is bytes (width 1).

Backends (every body maps ``(comp, comp_words, lut_hsym, lut_hbits)`` and
``out_lens`` to ``(n, chunk_elems)``; the LUTs are read in their staged
types, i16 symbols and i8 code lengths):

  * ``torch``  — :func:`decode_lockstep`, the reference's ``_body``: one
    cursor per segment, ``SUB`` lockstep steps; the kernel's plain twin;
  * ``oracle`` — :func:`decode_oracle`, segment by segment, trusting the
    gap offsets and the count bytes (``_body_oracle``);
  * ``scalar`` — :func:`decode_scalar`, one sequential bit stream from
    entry 0's offset, ignoring the rest of the gap table (``_body_scalar``,
    CPU tensors only);
  * ``cuda``   — :func:`decode`, which launches ``csrc/huffman_decode.cu`` on
    a CUDA tensor (or raises) and runs :func:`decode_lockstep` on a CPU one;
    it applies a fused epilogue (``harness.FusedEpilogue``) in the kernel's
    stores, or after :func:`decode_lockstep` on the CPU.

A gap offset is read as the reference reads it: a u32 taken as int32, so an
offset of 2^31 or more is negative and its word index clips to 0.
"""
from __future__ import annotations

import torch

from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core import registry
from repro_torch.core import streams as st
from repro_torch.kernels import cuda_build, harness

SUB = enc.HUFFMAN_SUB                 # symbols per segment
GAP_ENTRY_BYTES = enc.GAP_ENTRY_BYTES  # u32 LE bit offset + (count - 1)
LUT_KEYS = ("lut_hsym", "lut_hbits")

# (comp, n, C, words, W, lut_hsym, lut_hbits, out_lens, chunk_elems, out,
#  out_code, src_code, zero, zero_code, scale, scale_code, stream)
LIB = cuda_build.KernelLibrary(
    "huffman_decode.cu", "codag_huffman_decode", "pllplppplpiipipip")

THREADS = 128          # a CTA a chunk row, two segments a thread a batch
BATCH = 2 * THREADS    # segments a batch: thread t takes t and t + THREADS

# Kernel launches (one per call that reached the card).
LAUNCHES = 0


def _int32(v: torch.Tensor) -> torch.Tensor:
    """A u32 held in int64, read as int32 (``.astype(jnp.int32)``)."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v)


def _gap_entry(comp: torch.Tensor, seg: torch.Tensor):
    """(bit offset as int32, symbol count) of gap entries ``seg``."""
    at = seg * GAP_ENTRY_BYTES
    return (_int32(st.gather_values(comp, at, 4)),
            st.read_byte_at(comp, at + 4) + 1)


def _step(words, pos, lut_sym, lut_bits):
    """One symbol per cursor: (symbol, code length) as int64."""
    v = st.peek_bits(words, pos, enc.MAX_CODE_BITS)
    flat = v.reshape(v.shape[0], -1)
    sym = torch.gather(lut_sym, 1, flat).to(torch.int64).reshape(v.shape)
    nb = torch.gather(lut_bits, 1, flat).to(torch.int64).reshape(v.shape)
    return sym, nb


def decode_lockstep(comp, words, lut_sym, lut_bits, out_lens, *,
                    chunk_elems: int, width: int = 1) -> torch.Tensor:
    """The reference's ``_decode_lockstep`` with the chunk axis written out:
    one bit cursor per segment, ``SUB`` steps over every cursor at once."""
    n, dev = comp.shape[0], comp.device
    nseg = -(-chunk_elems // SUB)
    segs = torch.arange(nseg, dtype=torch.int64, device=dev).expand(n, nseg)
    pos, _ = _gap_entry(comp, segs)
    w = st.words_int64(words)
    out = torch.zeros((n, nseg, SUB), dtype=torch.int64, device=dev)
    for t in range(SUB):
        sym, nb = _step(w, pos, lut_sym, lut_bits)
        out[:, :, t] = sym
        pos = pos + nb
    flat = out.reshape(n, -1)[:, :chunk_elems]
    idx = torch.arange(chunk_elems, device=dev)
    flat = torch.where(idx < out_lens.to(torch.int64)[:, None], flat, 0)
    return harness.truncate(flat, width)


def decode_scalar(comp, words, lut_sym, lut_bits, out_lens, *,
                  chunk_elems: int, width: int = 1) -> torch.Tensor:
    """§V-E single-thread baseline: one symbol per step from the payload's
    start (entry 0's offset); the rest of the gap table is not read."""
    n, dev = comp.shape[0], comp.device
    out_len = out_lens.to(torch.int64)
    pos, _ = _gap_entry(comp, torch.zeros((n, 1), dtype=torch.int64,
                                          device=dev))
    w = st.words_int64(words)
    buf = torch.zeros((n, chunk_elems), dtype=torch.int64, device=dev)
    for i in range(int(out_len.clamp(max=chunk_elems).max()) if n else 0):
        sym, nb = _step(w, pos, lut_sym, lut_bits)
        active = (i < out_len)[:, None]
        buf[:, i] = torch.where(active, sym, 0)[:, 0]
        pos = torch.where(active, pos + nb, pos)
    return harness.truncate(buf, width)


def decode_oracle(comp, words, lut_sym, lut_bits, out_lens, *,
                  chunk_elems: int, width: int = 1) -> torch.Tensor:
    """Segment by segment through the gap table: each segment decodes
    ``SUB`` symbols from its own offset and its first ``count`` are
    blend-written at the running count."""
    n, dev = comp.shape[0], comp.device
    out_len = out_lens.to(torch.int64)
    w = st.words_int64(words)
    buf = torch.zeros((n, chunk_elems + SUB), dtype=torch.int64, device=dev)
    g = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    cnt = torch.zeros(n, dtype=torch.int64, device=dev)
    while True:
        active = cnt < out_len
        if not bool(active.any()):
            break
        pos, count = _gap_entry(comp, g)
        vals = torch.zeros((n, SUB), dtype=torch.int64, device=dev)
        for t in range(SUB):
            sym, nb = _step(w, pos, lut_sym, lut_bits)
            vals[:, t] = sym[:, 0]
            pos = pos + nb
        buf, cnt = st.write_values(buf, cnt, vals, count[:, 0], active, SUB)
        g = g + active[:, None]
    return harness.truncate(buf[:, :chunk_elems], width)


def count_groups(row, width: int) -> int:
    """Segments of one chunk row: entry 0's bit offset is the gap table's
    own size in bits."""
    if len(row) < GAP_ENTRY_BYTES:
        return 0
    off0 = int.from_bytes(bytes(bytearray(row[:4])), "little")
    return off0 // (GAP_ENTRY_BYTES * 8)


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------


def launch_geometry(chunk_elems: int):
    """(segments, batches) of one chunk row: the kernel's CTA walks
    ``batches`` batches of :data:`BATCH` segments."""
    nseg = -(-chunk_elems // SUB)
    return nseg, -(-nseg // BATCH)


def thread_lanes(chunk_elems: int, batch: int, thread: int):
    """The output lanes thread ``thread`` writes in batch ``batch``, as the
    kernel maps them: its two segments' 32 lanes each, up to the row's
    end."""
    nseg, _ = launch_geometry(chunk_elems)
    lanes = []
    for g in (batch * BATCH + thread, batch * BATCH + THREADS + thread):
        if g < nseg:
            lanes += range(g * SUB, min(g * SUB + SUB, chunk_elems))
    return lanes


def _check(comp, words, luts, out_lens, chunk_elems: int, width: int):
    if width != 1:
        raise ValueError(f"huffman decodes bytes: width must be 1, got "
                         f"{width}")
    if not 1 <= chunk_elems < 1 << 30:
        raise ValueError(f"chunk_elems must be in 1..2^30-1, got "
                         f"{chunk_elems}")
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
        raise ValueError(f"comp must be a (n, C>=1) uint8 table, got "
                         f"{tuple(comp.shape)} {comp.dtype}")
    n = comp.shape[0]
    if (words.dtype != torch.uint32 or words.dim() != 2
            or words.shape[0] != n or words.shape[1] < 1):
        raise ValueError(f"words must be a ({n}, W>=1) uint32 table, got "
                         f"{tuple(words.shape)} {words.dtype}")
    for key, lut, dt in zip(LUT_KEYS, luts, (torch.int16, torch.int8)):
        if lut.dtype != dt or tuple(lut.shape) != (n, enc.LUT_SIZE):
            raise ValueError(f"{key} must be ({n}, {enc.LUT_SIZE}) {dt}, got "
                             f"{tuple(lut.shape)} {lut.dtype}")
    if out_lens.dtype != torch.int32 or tuple(out_lens.shape) != (n,):
        raise ValueError(f"out_lens must be ({n},) int32, got "
                         f"{tuple(out_lens.shape)} {out_lens.dtype}")
    operands = (comp, words, *luts, out_lens)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("huffman operands must be contiguous")
    if any(t.device != comp.device for t in operands):
        raise ValueError("huffman operands must share one device")


def decode(comp: torch.Tensor, words: torch.Tensor, luts,
           out_lens: torch.Tensor, *, chunk_elems: int, width: int = 1,
           epilogue: "harness.FusedEpilogue | None" = None) -> torch.Tensor:
    """Decode every row of a huffman chunk table to ``(n, chunk_elems)``
    uint8 (or ``epilogue.dtype``, with the epilogue applied) on the table's
    device.  ``comp`` holds the gap tables, ``words`` the same rows as
    uint32 words, ``luts`` the two staged LUTs."""
    global LAUNCHES
    luts = tuple(luts)
    _check(comp, words, luts, out_lens, chunk_elems, width)
    if comp.device.type == "cpu":
        out = decode_lockstep(comp, words, *luts, out_lens,
                              chunk_elems=chunk_elems, width=width)
        return out if epilogue is None else epilogue.apply_plain(out)
    if comp.device.type != "cuda":
        raise ValueError(f"no kernel for device {comp.device}")
    n = comp.shape[0]
    _, dtype, epi = harness.launch_store(epilogue, torch.uint8)
    out = torch.empty((n, chunk_elems), dtype=dtype, device=comp.device)
    if n == 0:
        return harness.finish_store(out, epilogue)
    cuda_build.launch_on(
        comp.device, LIB, comp.data_ptr(), n, comp.shape[1],
        words.data_ptr(), words.shape[1], *(t.data_ptr() for t in luts),
        out_lens.data_ptr(), chunk_elems, out.data_ptr(), *epi)
    LAUNCHES += 1
    return harness.finish_store(out, epilogue)


# --------------------------------------------------------------------------
# registry plumbing
# --------------------------------------------------------------------------


def _chunk_inputs(dev):
    """Per-chunk operands: raw bytes (gap table), word view (payload bits)
    and the two LUTs, in their staged types."""
    return (dev["comp"],) + harness.words_inputs(dev) + tuple(
        dev[k] for k in LUT_KEYS)


def _body(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return decode_lockstep(*inputs, out_lens, chunk_elems=chunk_elems,
                           width=width)


def _body_oracle(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return decode_oracle(*inputs, out_lens, chunk_elems=chunk_elems,
                         width=width)


def _body_scalar(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return decode_scalar(*inputs, out_lens, chunk_elems=chunk_elems,
                         width=width)


def _kernel(inputs, consts, out_lens, *, chunk_elems, width, bits,
            epilogue=None):
    return decode(inputs[0], inputs[1], inputs[2:], out_lens,
                  chunk_elems=chunk_elems, width=width, epilogue=epilogue)


CODEC = registry.register(registry.Codec(
    name=fmt.HUFFMAN,
    encode=enc.compress_huffman,
    decode=harness.DecodeSpec(
        body=_body, body_scalar=_body_scalar, body_oracle=_body_oracle,
        cuda=_kernel, chunk_inputs=_chunk_inputs, fuses_epilogue=True),
    needs_words=True,
    byte_stream=True,
))
