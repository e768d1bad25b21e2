"""lzss (element-granular LZSS) codec plugin and its kernel's wrapper.

The counterpart of ``repro/kernels/lzss.py``.  Token stream, width = element
bytes:

  control c in [0, 127]   -> literal run of c+1 elements (1..128);
                             (c+1)*width little-endian value bytes follow
  control c in [128, 255] -> match of c-128+MIN_MATCH elements (2..129);
                             a u16 LE distance in elements follows

Backends (every body maps the byte table and ``out_lens`` to
``(n, chunk_elems)`` in the width type):

  * ``torch``  — :func:`decode_two_phase`, the reference's ``_body``: a
    serial token parse into (start, kind, dist, litoff) tables, then every
    lane points ``dist`` back (``max(idx - dist, 0)``), ``ceil(log2
    chunk_elems)`` rounds of pointer doubling, and one gather of each
    lane's terminal literal bytes.  The kernel's plain twin;
  * ``oracle`` — :func:`decode_oracle`, the serial token walk with the
    overlap-safe ``memcpy`` (``_body_oracle``);
  * ``scalar`` — :func:`decode_scalar`, one element per step through a
    back-reference cursor (``_body_scalar``); on a card
    ``kernels/scalar.py`` launches its kernel;
  * ``cuda``   — :func:`decode`, which launches ``csrc/lzss_decode.cu`` on a
    CUDA tensor (or raises) and runs :func:`decode_two_phase` on a CPU one.
    The kernel gives one warp a chunk: it stages the compressed row through
    a 4 KiB shared-memory ring, parses 32 tokens a batch, and writes the
    batch with all lanes through a shared stage, each match element reading
    its source directly (the fixed point of the reference's pointer
    doubling: element ``max(idx - dist, 0)`` stepped back inside the match,
    element 0 where the chain reaches before the row's start, its own
    literal bytes for a zero distance or a first-token match); the matches
    that read their own batch run in token order.  Every byte read clips to
    the row's last byte.  A fused epilogue (``harness.FusedEpilogue``) is
    applied in the kernel's stores (the raw row, which the matches read,
    in a scratch matrix beside it), or after the plain body on the CPU.

The three reference bodies agree on well-formed streams and differ on
malformed ones (a zero distance, a match reaching before the row's start);
each port body follows its own reference body there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core import registry
from repro_torch.core import streams as st
from repro_torch.kernels import cuda_build, harness, scalar

MIN_MATCH = enc.LZSS_MIN_MATCH
MAX_MATCH = enc.LZSS_MAX_MATCH      # 129 elements
MAX_LIT = enc.LZSS_MAX_LIT          # 128 elements
MAX_DIST = enc.LZSS_MAX_DIST        # 65535 elements
CW = 132                            # oracle blend window >= max(MAX_MATCH,
                                    # MAX_LIT)

# (width, comp, n, C, out_lens, chunk_elems, out, raw, tokens, out_code,
#  src_code, zero, zero_code, scale, scale_code, stream)
LIB = cuda_build.KernelLibrary(
    "lzss_decode.cu", "codag_lzss_decode", "ipllplpppiipipip")

# Kernel launches (one per call that reached the card).
LAUNCHES = 0


def max_tokens(out_len: int) -> int:
    return out_len + 4        # every token emits >= 1 element


def _token(comp: torch.Tensor, pos: torch.Tensor):
    """(is_match, length, dist) of the token at byte ``pos`` of each row."""
    c = st.read_byte_at(comp, pos[:, None])[:, 0]
    is_m = c >= 128
    length = torch.where(is_m, c - 128 + MIN_MATCH, c + 1)
    dist = st.read_value_at(comp, pos[:, None] + 1, 2)[:, 0]
    return is_m, length, dist


def _advance(is_m, length, width: int):
    return torch.where(is_m, 3, 1 + length * width)


def decode_two_phase(comp: torch.Tensor, out_lens: torch.Tensor, *,
                     chunk_elems: int, width: int) -> torch.Tensor:
    """The reference's ``_body`` with the chunk axis written out."""
    n, dev = comp.shape[0], comp.device
    mt = max_tokens(chunk_elems)
    out_len = out_lens.to(torch.int64)

    # ---- Phase 1: sequential token parse -> group tables ------------------
    # Column mt is a dump slot: rows that have stopped write there.
    starts = torch.full((n, mt + 1), chunk_elems, dtype=torch.int64,
                        device=dev)
    kinds = torch.zeros((n, mt + 1), dtype=torch.bool, device=dev)
    dists = torch.zeros((n, mt + 1), dtype=torch.int64, device=dev)
    litoffs = torch.zeros_like(dists)

    def parse(state):
        pos, g, cnt = state
        active = (cnt < out_len) & (g < mt)
        is_m, length, dist = _token(comp, pos)
        slot = torch.where(active, g, mt)[:, None]
        starts.scatter_(1, slot, cnt[:, None])
        kinds.scatter_(1, slot, is_m[:, None])
        dists.scatter_(1, slot, dist[:, None])
        litoffs.scatter_(1, slot, pos[:, None] + 1)
        pos = torch.where(active, pos + _advance(is_m, length, width), pos)
        cnt = torch.where(active, cnt + length, cnt)
        return (pos, g + active.to(torch.int64), cnt), active

    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    st.lockstep(parse, (zeros, zeros, zeros))

    # ---- Phase 2: lane -> token, pointer doubling, one literal gather -----
    starts = starts[:, :mt]
    marker = torch.zeros((n, chunk_elems + 1), dtype=torch.int64, device=dev)
    marker.scatter_add_(1, starts.clamp(max=chunk_elems),
                        torch.ones_like(starts))
    grp = (marker[:, :chunk_elems].cumsum(1) - 1).clamp(0, mt - 1)
    del marker
    idx = torch.arange(chunk_elems, dtype=torch.int64, device=dev)
    k = idx - torch.gather(starts, 1, grp)
    is_m = torch.gather(kinds[:, :mt], 1, grp)
    dist = torch.gather(dists[:, :mt], 1, grp)
    litbyte = torch.gather(litoffs[:, :mt], 1, grp) + k * width
    # literal lanes are fixed points; match lanes point dist elements back
    ptr = torch.where(is_m, (idx - dist).clamp(min=0), idx.expand(n, -1))
    for _ in range(max(1, (chunk_elems - 1).bit_length())):
        ptr = torch.gather(ptr, 1, ptr)
    vals = st.gather_values(comp, torch.gather(litbyte, 1, ptr), width)
    vals = torch.where(idx < out_len[:, None], vals, 0)
    return harness.truncate(vals, width)


def decode_scalar(comp: torch.Tensor, out_lens: torch.Tensor, *,
                  chunk_elems: int, width: int) -> torch.Tensor:
    """§V-E single-thread baseline: one element per step; a match proceeds
    element by element through a back-reference cursor (an element index
    for matches, a byte offset for literals)."""
    n, dev = comp.shape[0], comp.device
    out_len = out_lens.to(torch.int64)
    mask = (1 << (8 * width)) - 1
    buf = torch.zeros((n, chunk_elems), dtype=torch.int64, device=dev)
    pos, rem, src = (torch.zeros(n, dtype=torch.int64, device=dev)
                     for _ in range(3))
    is_m = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(int(out_len.clamp(max=chunk_elems).max()) if n else 0):
        need = rem == 0
        new_m, new_len, new_dist = _token(comp, pos)
        is_m = torch.where(need, new_m, is_m)
        rem = torch.where(need, new_len, rem)
        src = torch.where(need, torch.where(new_m, i - new_dist, pos + 1),
                          src)
        pos = torch.where(need, pos + _advance(new_m, new_len, width), pos)
        v_lit = st.gather_values(comp, src[:, None], width)[:, 0]
        v_m = torch.gather(buf, 1, src.clamp(0, chunk_elems - 1)[:, None])
        val = torch.where(is_m, v_m[:, 0], v_lit) & mask
        buf[:, i] = torch.where(i < out_len, val, buf[:, i])
        rem = rem - 1
        src = src + torch.where(is_m, 1, width)
    return harness.truncate(buf, width)


def decode_oracle(comp: torch.Tensor, out_lens: torch.Tensor, *,
                  chunk_elems: int, width: int) -> torch.Tensor:
    """Serial token walk with the Table II primitives: blend-write literal
    runs, overlap-safe circular-window ``memcpy`` for matches."""
    n, dev = comp.shape[0], comp.device
    out_len = out_lens.to(torch.int64)
    mask = (1 << (8 * width)) - 1
    lanes = torch.arange(CW, dtype=torch.int64, device=dev)
    buf = torch.zeros((n, chunk_elems + CW), dtype=torch.int64, device=dev)
    pos, opos = (torch.zeros(n, dtype=torch.int64, device=dev)
                 for _ in range(2))
    while True:
        active = opos < out_len
        if not bool(active.any()):
            break
        is_m, length, dist = _token(comp, pos)
        lits = st.gather_values(comp, (pos + 1)[:, None] + lanes * width,
                                width) & mask
        buf, _ = st.memcpy(buf, opos, dist, length, active & is_m, CW)
        buf, _ = st.write_values(buf, opos, lits, length, active & ~is_m, CW)
        opos = torch.where(active, opos + length, opos)
        pos = torch.where(active, pos + _advance(is_m, length, width), pos)
    idx = torch.arange(chunk_elems, device=dev)
    out = torch.where(idx < out_len[:, None], buf[:, :chunk_elems], 0)
    return harness.truncate(out, width)


def count_groups(row, width: int) -> int:
    """Tokens of one chunk row."""
    pos, n, groups = 0, len(row), 0
    while pos < n:
        c = int(row[pos])
        pos += 3 if c >= 128 else 1 + (c + 1) * width
        groups += 1
    return groups


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------


def _check(comp, out_lens, chunk_elems: int, width: int) -> None:
    if width not in harness.DEV_DTYPE:
        raise ValueError(f"unsupported width {width}")
    if chunk_elems < 1:
        raise ValueError(f"chunk_elems must be positive, got {chunk_elems}")
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
        raise ValueError(f"comp must be a (n, C>=1) uint8 table, got "
                         f"{tuple(comp.shape)} {comp.dtype}")
    n = comp.shape[0]
    if out_lens.dtype != torch.int32 or tuple(out_lens.shape) != (n,):
        raise ValueError(f"out_lens must be ({n},) int32, got "
                         f"{tuple(out_lens.shape)} {out_lens.dtype}")
    if not (comp.is_contiguous() and out_lens.is_contiguous()):
        raise ValueError("lzss operands must be contiguous")
    if out_lens.device != comp.device:
        raise ValueError("lzss operands must share one device")


def decode(comp: torch.Tensor, out_lens: torch.Tensor, *, chunk_elems: int,
           width: int, tokens: Optional[torch.Tensor] = None,
           epilogue: "harness.FusedEpilogue | None" = None) -> torch.Tensor:
    """Decode every row of an lzss chunk table to ``(n, chunk_elems)`` in
    the width type (or ``epilogue.dtype``, with the epilogue applied in the
    kernel's stores), on the table's device.  On a CUDA tensor, ``tokens``
    (an ``(n,)`` int32 tensor), if given, receives each row's token count."""
    global LAUNCHES
    _check(comp, out_lens, chunk_elems, width)
    if comp.device.type == "cpu":
        out = decode_two_phase(comp, out_lens, chunk_elems=chunk_elems,
                               width=width)
        return out if epilogue is None else epilogue.apply_plain(out)
    if comp.device.type != "cuda":
        raise ValueError(f"no kernel for device {comp.device}")
    n = comp.shape[0]
    if tokens is not None and (tokens.dtype != torch.int32
                               or tuple(tokens.shape) != (n,)
                               or tokens.device != comp.device):
        raise ValueError(f"tokens must be ({n},) int32 on {comp.device}")
    raw_dtype = harness.DEV_DTYPE[width]
    fused, dtype, epi = harness.launch_store(epilogue, raw_dtype)
    out = torch.empty((n, chunk_elems), dtype=dtype, device=comp.device)
    if n == 0:
        return harness.finish_store(out, epilogue)
    # the raw elements, which later matches read, beside an epilogue's output
    raw = None if fused is None else torch.empty(
        (n, chunk_elems), dtype=raw_dtype, device=comp.device)
    cuda_build.launch_on(
        comp.device, LIB, width, comp.data_ptr(), n, comp.shape[1],
        out_lens.data_ptr(), chunk_elems, out.data_ptr(),
        None if raw is None else raw.data_ptr(),
        None if tokens is None else tokens.data_ptr(), *epi)
    LAUNCHES += 1
    return harness.finish_store(out, epilogue)


# --------------------------------------------------------------------------
# registry plumbing
# --------------------------------------------------------------------------


def _body(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return decode_two_phase(inputs[0], out_lens, chunk_elems=chunk_elems,
                            width=width)


def _body_oracle(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return decode_oracle(inputs[0], out_lens, chunk_elems=chunk_elems,
                         width=width)


def _body_scalar(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return decode_scalar(inputs[0], out_lens, chunk_elems=chunk_elems,
                         width=width)


def _scalar_kernel(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return scalar.decode_lzss(inputs[0], out_lens, chunk_elems=chunk_elems,
                              width=width)


def _kernel(inputs, consts, out_lens, *, chunk_elems, width, bits,
            epilogue=None):
    return decode(inputs[0], out_lens, chunk_elems=chunk_elems, width=width,
                  epilogue=epilogue)


def _demo_data(n: int, rng) -> np.ndarray:
    """Repeating element motifs + sparse noise (LZ's bread and butter)."""
    motif = rng.integers(0, 1 << 12, 48).astype(np.uint32)
    out = np.tile(motif, n // motif.size + 1)[:n].copy()
    noise = rng.random(n) < 0.04
    out[noise] = rng.integers(0, 1 << 12, int(noise.sum()))
    return out


CODEC = registry.register(registry.Codec(
    name=fmt.LZSS,
    encode=enc.compress_lzss,
    decode=harness.DecodeSpec(
        body=_body, body_scalar=_body_scalar, body_oracle=_body_oracle,
        cuda=_kernel, scalar=_scalar_kernel, fuses_epilogue=True),
    plane_decompose_64=True,
    demo_data=_demo_data,
))
