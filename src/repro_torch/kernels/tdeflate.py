"""tdeflate (Deflate-semantics) codec plugin and its Hopper kernel's wrapper.

The counterpart of ``repro/kernels/tdeflate.py``.  A chunk is an LSB-first
bit stream of canonical Huffman tokens (12-bit LUTs per chunk): literals,
and (length, distance) matches into the chunk's own output.

Backends (every body maps the word table, the four LUTs and ``out_lens`` to
``(n, chunk_elems)`` uint8; rows advance in lockstep and a row that has
stopped keeps its state, as a vmapped ``while_loop`` does):

  * ``torch``  — :func:`decode_chunk`, the reference's two-phase body:
    Phase 1 parses tokens into a command list (literals batched into runs
    of up to 256 in a side buffer), Phase 2 executes the commands with
    ``write_from`` and the overlap-safe ``memcpy``.  The plain twin of the
    kernel;
  * ``oracle`` — :func:`decode_oracle`, the classic inflate loop
    (``ref.decode_tdeflate_impl``): one token, one write, per step;
  * ``scalar`` — :func:`decode_scalar`, one output byte per step (§V-E
    ablation, CPU tensors only; ``decode_chunk_scalar``);
  * ``cuda``   — :func:`decode`, which launches ``csrc/tdeflate_decode.cu``
    on a CUDA tensor (or raises) and runs :func:`decode_chunk` on a CPU one;
    it applies a fused epilogue (``harness.FusedEpilogue``) in the kernel's
    stores, or after :func:`decode_chunk` on the CPU.

The LUTs are read in their staged types (i16 symbols, i8 code lengths).
A back-reference that reaches before the row's start reads what each
reference body reads there (see ``streams.memcpy``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core import registry
from repro_torch.core import streams as st
from repro_torch.kernels import cuda_build, harness

# the broadcast deflate tables, in the order of the reference's consts
TABLES = (enc.LEN_EXTRA, enc.LEN_BASE, enc.DIST_EXTRA, enc.DIST_BASE)
LUT_KEYS = ("lut_lsym", "lut_lbits", "lut_dsym", "lut_dbits")

LITRUN_CAP = 256          # max literals batched into one command
CMD_WIN = 272             # write window >= max(MAX_MATCH=258, LITRUN_CAP)
SCALAR_PAD = 16           # the scalar body's buffer slack

# (words, n, W, lsym, lbits, dsym, dbits, len_extra, len_base, dist_extra,
#  dist_base, out_lens, chunk_elems, out, raw, tokens, out_code, src_code,
#  zero, zero_code, scale, scale_code, stream)
LIB = cuda_build.KernelLibrary(
    "tdeflate_decode.cu", "codag_tdeflate_decode",
    "pllppppppppplpppiipipip")

# Kernel launches (one per call that reached the card).
LAUNCHES = 0


def max_cmds(out_len: int) -> int:
    # worst case: alternating match(>=3) + litrun(>=1) = 2 cmds / 4 bytes
    return out_len // 2 + 4


def _lookup(lut: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.gather(lut, 1, v[:, None])[:, 0].to(torch.int64)


def _token(words, pos, luts, tables):
    """Parse one token per row at bit ``pos`` (match fields are computed
    for every row and used where the token is a match)."""
    lsym, lbits, dsym, dbits = luts
    len_extra, len_base, dist_extra, dist_base = tables
    v = st.peek_bits(words, pos, enc.MAX_CODE_BITS)
    sym, nb = _lookup(lsym, v), _lookup(lbits, v)
    lc = (sym - 257).clamp(0, 28)
    pm = st.skip_bits(pos, nb)
    eb = len_extra[lc]
    length = len_base[lc] + st.peek_bits(words, pm, eb)
    pm = st.skip_bits(pm, eb)
    dv = st.peek_bits(words, pm, enc.MAX_CODE_BITS)
    dc = _lookup(dsym, dv).clamp(0, 29)
    pm = st.skip_bits(pm, _lookup(dbits, dv))
    deb = dist_extra[dc]
    dist = dist_base[dc] + st.peek_bits(words, pm, deb)
    return {
        "sym": sym,
        "is_lit": (sym < 256) & (nb > 0),
        "is_eob": (sym == 256) | (nb == 0),      # nb == 0: invalid, stop
        "is_match": (sym > 256) & (nb > 0),
        "length": length,
        "dist": dist,
        # the bit position after the token
        "next": torch.where((sym > 256) & (nb > 0), st.skip_bits(pm, deb),
                            st.skip_bits(pos, nb)),
    }


def _prepare(words, luts, out_lens, tables):
    tables = tuple(torch.as_tensor(t).to(device=words.device,
                                         dtype=torch.int64) for t in tables)
    return (st.words_int64(words), tuple(luts), out_lens.to(torch.int64),
            tables)


def decode_chunk(words, luts, out_lens, chunk_elems: int,
                 tables=TABLES) -> torch.Tensor:
    """The reference's ``decode_chunk`` with the chunk axis written out."""
    w, luts, out_len, tables = _prepare(words, luts, out_lens, tables)
    n, dev = w.shape[0], w.device
    rows = torch.arange(n, device=dev)
    mc = max_cmds(chunk_elems)

    # ---- Phase 1: Huffman token parse -> command list ----------------------
    # Column mc of the command tables is a dump slot for rows not writing.
    pos, ci, out_cnt, lit_cnt = (torch.zeros(n, dtype=torch.int64, device=dev)
                                 for _ in range(4))
    open_lit = torch.zeros(n, dtype=torch.bool, device=dev)
    done = torch.zeros_like(open_lit)
    lits = torch.zeros((n, chunk_elems + CMD_WIN), dtype=torch.uint8,
                       device=dev)
    kinds = torch.zeros((n, mc + 1), dtype=torch.bool, device=dev)
    cmd_a = torch.zeros((n, mc + 1), dtype=torch.int64, device=dev)
    cmd_b = torch.zeros_like(cmd_a)
    while True:
        active = ~done & (out_cnt < out_len) & (ci < mc)
        if not bool(active.any()):
            break
        t = _token(w, pos, luts, tables)
        is_lit, is_match = t["is_lit"], t["is_match"]
        lit_at = lit_cnt.clamp(max=lits.shape[1] - 1)
        lits[rows, lit_at] = torch.where(active, (t["sym"] & 0xFF).to(
            torch.uint8), lits[rows, lit_at])
        prev = (ci - 1).clamp(min=0)
        prev_a, prev_b = cmd_a[rows, prev], cmd_b[rows, prev]
        extend = open_lit & is_lit & (prev_b < LITRUN_CAP) & (ci > 0)
        write = active & ~t["is_eob"]
        slot = torch.where(write, torch.where(extend, ci - 1, ci), mc)
        kinds[rows, slot] = is_match
        cmd_a[rows, slot] = torch.where(
            is_match, t["dist"], torch.where(extend, prev_a, lit_cnt))
        cmd_b[rows, slot] = torch.where(
            is_match, t["length"], torch.where(extend, prev_b + 1, 1))
        ci = ci + (write & ~extend)
        lit_cnt = lit_cnt + (active & is_lit)
        out_cnt = out_cnt + torch.where(
            active, torch.where(is_lit, 1, torch.where(is_match, t["length"],
                                                       0)), 0)
        open_lit = torch.where(active, is_lit, open_lit)
        pos = torch.where(active, t["next"], pos)
        done = done | (active & t["is_eob"])

    # ---- Phase 2: execute the commands (Table II writes) -------------------
    buf = torch.zeros((n, chunk_elems + CMD_WIN), dtype=torch.uint8,
                      device=dev)
    opos, i = (torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(2))
    while True:
        active = (i < ci) & (opos < out_len)
        if not bool(active.any()):
            break
        at = i.clamp(max=mc - 1)
        kind, a, b = kinds[rows, at], cmd_a[rows, at], cmd_b[rows, at]
        buf, opos = st.memcpy(buf, opos, a, b, active & kind, CMD_WIN)
        buf, opos = st.write_from(buf, opos, lits, a, b, active & ~kind,
                                  CMD_WIN)
        i = i + active
    idx = torch.arange(chunk_elems, device=dev)
    return torch.where(idx < out_len[:, None], buf[:, :chunk_elems], 0)


def decode_oracle(words, luts, out_lens, chunk_elems: int,
                  tables=TABLES) -> torch.Tensor:
    """The classic inflate loop (``ref.decode_tdeflate_impl``): each step
    parses one token and writes one literal or one match."""
    w, luts, out_len, tables = _prepare(words, luts, out_lens, tables)
    n, dev = w.shape[0], w.device
    rows = torch.arange(n, device=dev)
    buf = torch.zeros((n, chunk_elems + CMD_WIN), dtype=torch.uint8,
                      device=dev)
    pos, opos = (torch.zeros(n, dtype=torch.int64, device=dev)
                 for _ in range(2))
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    while True:
        active = ~done & (opos < out_len)
        if not bool(active.any()):
            break
        t = _token(w, pos, luts, tables)
        lit = active & t["is_lit"]
        at = opos.clamp(max=buf.shape[1] - 1)
        buf[rows, at] = torch.where(lit, (t["sym"] & 0xFF).to(torch.uint8),
                                    buf[rows, at])
        buf, opos = st.memcpy(buf, opos, t["dist"], t["length"],
                              active & t["is_match"], CMD_WIN)
        opos = opos + lit
        pos = torch.where(active, t["next"], pos)
        done = done | (active & t["is_eob"])
    return buf[:, :chunk_elems].clone()


def decode_scalar(words, luts, out_lens, chunk_elems: int,
                  tables=TABLES) -> torch.Tensor:
    """§V-E single-thread baseline (``decode_chunk_scalar``): one output
    byte per step; a match copies byte by byte through a back-reference
    cursor, which reads ``buf[clip(cursor)]``."""
    w, luts, out_len, tables = _prepare(words, luts, out_lens, tables)
    n, dev = w.shape[0], w.device
    rows = torch.arange(n, device=dev)
    cap = chunk_elems + SCALAR_PAD
    buf = torch.zeros((n, cap), dtype=torch.uint8, device=dev)
    pos, opos, rem, src = (torch.zeros(n, dtype=torch.int64, device=dev)
                           for _ in range(4))
    is_m = torch.zeros(n, dtype=torch.bool, device=dev)
    done = torch.zeros_like(is_m)
    while True:
        active = ~done & (opos < out_len)
        if not bool(active.any()):
            break
        need = rem == 0
        t = _token(w, pos, luts, tables)
        rem = torch.where(active & need,
                          torch.where(t["is_lit"], 1, t["length"]), rem)
        is_m = torch.where(active & need, t["is_match"], is_m)
        src = torch.where(active & need,
                          torch.where(t["is_match"], opos - t["dist"], 0), src)
        copy_byte = buf[rows, src.clamp(0, cap - 1)]
        lit_byte = (t["sym"] & 0xFF).to(torch.uint8)
        val = torch.where(is_m | ~need, copy_byte, lit_byte)
        pos = torch.where(active & need, t["next"], pos)
        stop = need & t["is_eob"]
        done = done | (active & stop)
        emit = active & ~stop
        at = torch.where(emit, opos, chunk_elems + 8)
        buf[rows, at] = torch.where(emit, val, buf[rows, at])
        opos, rem = opos + emit, rem - emit.to(torch.int64)
        src = src + active
    return buf[:, :chunk_elems].clone()


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------


def pack_luts(lsym, lbits, dsym, dbits):
    """The kernel's shared-memory LUTs, in plain torch: one entry a u16
    (held in int32 here), ``sym | nbits << 9``.  ``sym`` is made canonical
    for what the parse does with it: a litlen symbol below 256 becomes its
    literal byte, one above 285 becomes 285 (the length code clamps there),
    a distance symbol is clamped to [0, 29]; ``nbits`` keeps its low 7
    bits.  The encoder's LUTs are already canonical (symbols <= 285 and
    < 30, code lengths <= 12), so :func:`unpack_luts` gives them back."""
    s, d = lsym.to(torch.int32), dsym.to(torch.int32)
    s = torch.where(s < 256, s & 0xFF, s.clamp(max=285))
    lit = s | (lbits.to(torch.int32) & 0x7F) << 9
    dist = d.clamp(0, 29) | (dbits.to(torch.int32) & 0x7F) << 9
    return lit, dist


def unpack_luts(packed):
    """(symbols, code lengths) of one packed LUT."""
    return packed & 0x1FF, packed >> 9


def _check(words, luts, tables, out_lens, chunk_elems: int, width: int):
    if width != 1:
        raise ValueError(f"tdeflate decodes bytes: width must be 1, got "
                         f"{width}")
    if chunk_elems < 1:
        raise ValueError(f"chunk_elems must be positive, got {chunk_elems}")
    n = words.shape[0] if words.dim() == 2 else -1
    if words.dtype != torch.uint32 or n < 0 or words.shape[1] < 1:
        raise ValueError(f"words must be a (n, W>=1) uint32 table, got "
                         f"{tuple(words.shape)} {words.dtype}")
    for key, lut, dt in zip(LUT_KEYS, luts, (torch.int16, torch.int8) * 2):
        if lut.dtype != dt or tuple(lut.shape) != (n, enc.LUT_SIZE):
            raise ValueError(f"{key} must be ({n}, {enc.LUT_SIZE}) {dt}, got "
                             f"{tuple(lut.shape)} {lut.dtype}")
    for t, ref in zip(tables, TABLES):
        if t.dtype != torch.int32 or tuple(t.shape) != ref.shape:
            raise ValueError(f"deflate tables must be int32 {ref.shape}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if out_lens.dtype != torch.int32 or tuple(out_lens.shape) != (n,):
        raise ValueError(f"out_lens must be ({n},) int32, got "
                         f"{tuple(out_lens.shape)} {out_lens.dtype}")
    operands = (words, *luts, *tables, out_lens)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("tdeflate operands must be contiguous")
    if any(t.device != words.device for t in operands):
        raise ValueError("tdeflate operands must share one device")


def decode(words: torch.Tensor, luts, tables, out_lens: torch.Tensor, *,
           chunk_elems: int, width: int = 1,
           tokens: Optional[torch.Tensor] = None,
           epilogue: "harness.FusedEpilogue | None" = None) -> torch.Tensor:
    """Decode every row of a tdeflate chunk table to ``(n, chunk_elems)``
    uint8 (or ``epilogue.dtype``, with the epilogue applied in the kernel's
    stores) on the tables' device.  ``luts`` are the four staged LUTs,
    ``tables`` the four int32 deflate tables on the same device.  On a CUDA
    tensor, ``tokens`` (an ``(n,)`` int32 tensor), if given, receives each
    row's count of literal and match tokens."""
    global LAUNCHES
    luts, tables = tuple(luts), tuple(tables)
    _check(words, luts, tables, out_lens, chunk_elems, width)
    if words.device.type == "cpu":
        out = decode_chunk(words, luts, out_lens, chunk_elems, tables)
        return out if epilogue is None else epilogue.apply_plain(out)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    n = words.shape[0]
    if tokens is not None and (tokens.dtype != torch.int32
                               or tuple(tokens.shape) != (n,)
                               or tokens.device != words.device):
        raise ValueError(f"tokens must be ({n},) int32 on {words.device}")
    fused, dtype, epi = harness.launch_store(epilogue, torch.uint8)
    out = torch.empty((n, chunk_elems), dtype=dtype, device=words.device)
    if n == 0:
        return harness.finish_store(out, epilogue)
    # the raw bytes, which later matches read, beside an epilogue's output
    raw = None if fused is None else torch.empty(
        (n, chunk_elems), dtype=torch.uint8, device=words.device)
    cuda_build.launch_on(
        words.device, LIB, words.data_ptr(), n, words.shape[1],
        *(t.data_ptr() for t in luts), *(t.data_ptr() for t in tables),
        out_lens.data_ptr(), chunk_elems, out.data_ptr(),
        None if raw is None else raw.data_ptr(),
        None if tokens is None else tokens.data_ptr(), *epi)
    LAUNCHES += 1
    return harness.finish_store(out, epilogue)


# --------------------------------------------------------------------------
# registry plumbing: device operands + the DecodeSpec bodies
# --------------------------------------------------------------------------


def _chunk_inputs(dev):
    """Per-chunk operands: the word stream plus the four per-chunk LUTs, in
    their staged types."""
    return harness.words_inputs(dev) + tuple(dev[k] for k in LUT_KEYS)


def _body(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return decode_chunk(inputs[0], inputs[1:], out_lens, chunk_elems, consts)


def _body_oracle(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return decode_oracle(inputs[0], inputs[1:], out_lens, chunk_elems, consts)


def _body_scalar(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return decode_scalar(inputs[0], inputs[1:], out_lens, chunk_elems, consts)


def _kernel(inputs, consts, out_lens, *, chunk_elems, width, bits,
            epilogue=None):
    return decode(inputs[0], inputs[1:], consts, out_lens,
                  chunk_elems=chunk_elems, width=width, epilogue=epilogue)


CODEC = registry.register(registry.Codec(
    name=fmt.TDEFLATE,
    encode=enc.compress_tdeflate,
    decode=harness.DecodeSpec(
        body=_body, body_scalar=_body_scalar, body_oracle=_body_oracle,
        cuda=_kernel, chunk_inputs=_chunk_inputs,
        consts=lambda: tuple(np.ascontiguousarray(t, np.int32)
                             for t in TABLES),
        fuses_epilogue=True),
    needs_words=True,
    byte_stream=True,
))
