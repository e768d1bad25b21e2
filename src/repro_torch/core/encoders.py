"""Host-side (numpy) encoders for the ported codecs.

Encoding is a host/offline concern, as in the paper.  These are copies of
the reference encoders (``repro/core/encoders.py``), so the port writes the
same bytes: the golden vectors' ``blob_digest`` pins that.

RLE v1  (byte-aligned, fixed-width values; ORC RLE v1 control structure)
  control c in [0,127]   -> run of length c+3 (3..130), one value follows
  control c in [128,255] -> 256-c literals (1..128), values follow

RLE v2  (adds delta + long-run modes; ORC RLE v2 in spirit)
  header h; mode = h >> 6, f = h & 63
  mode 0 -> run,     len = f+3  (3..66),  value follows
  mode 1 -> delta,   len = f+3  (3..66),  base value + delta value follow
  mode 2 -> literal, len = f+1  (1..64),  values follow
  mode 3 -> long run, len = (f<<8 | next_byte)+3 (3..16386), value follows
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import format as fmt
from repro_torch.core import registry


def _values_bytes(vals: np.ndarray, width: int) -> bytes:
    return np.ascontiguousarray(vals).astype(
        {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]
    ).tobytes()


def _find_runs(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Return (start_indices, run_lengths) of maximal equal-value runs."""
    n = x.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.empty(n, np.bool_)
    change[0] = True
    np.not_equal(x[1:], x[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lens = np.diff(np.append(starts, n))
    return starts, lens


# --------------------------------------------------------------------------
# RLE v1
# --------------------------------------------------------------------------

RLE1_MIN_RUN = 3
RLE1_MAX_RUN = 130
RLE1_MAX_LIT = 128


def encode_rle_v1_chunk(x: np.ndarray, width: int) -> bytes:
    starts, lens = _find_runs(x)
    out = bytearray()
    lit_start = None  # start elem index of pending literal group

    def flush_literals(end: int) -> None:
        nonlocal lit_start
        if lit_start is None:
            return
        i = lit_start
        while i < end:
            n = min(RLE1_MAX_LIT, end - i)
            out.append(256 - n)
            out.extend(_values_bytes(x[i : i + n], width))
            i += n
        lit_start = None

    for s, l in zip(starts.tolist(), lens.tolist()):
        if l >= RLE1_MIN_RUN:
            flush_literals(s)
            rem, pos = l, s
            while rem >= RLE1_MIN_RUN:
                n = min(RLE1_MAX_RUN, rem)
                if rem - n in (1, 2):  # avoid leaving an un-encodable tail
                    n = rem - RLE1_MIN_RUN
                    if n < RLE1_MIN_RUN:
                        break
                out.append(n - RLE1_MIN_RUN)
                out.extend(_values_bytes(x[pos : pos + 1], width))
                pos += n
                rem -= n
            if rem:  # leftover 1..2 become literals
                if lit_start is None:
                    lit_start = pos
        else:
            if lit_start is None:
                lit_start = s
    flush_literals(x.shape[0])
    return bytes(out)


# --------------------------------------------------------------------------
# RLE v2 (run / delta / literal / long-run)
# --------------------------------------------------------------------------

RLE2_MIN_RUN = 3
RLE2_MAX_SHORT = 66
RLE2_MAX_LONG = 16386
RLE2_MAX_LIT = 64
RLE2_MIN_DELTA = 4


def encode_rle_v2_chunk(x: np.ndarray, width: int) -> bytes:
    n = x.shape[0]
    out = bytearray()
    if n == 0:
        return b""
    # Segment by constant *difference* (wraparound arithmetic): an equal-value
    # run is a delta segment with d == 0.
    d = (x[1:] - x[:-1]) if n > 1 else np.zeros(0, x.dtype)
    dstarts, dlens = _find_runs(d) if n > 1 else (np.zeros(0, np.int64),) * 2

    lit_start: int | None = None

    def flush_literals(end: int) -> None:
        nonlocal lit_start
        if lit_start is None:
            return
        i = lit_start
        while i < end:
            m = min(RLE2_MAX_LIT, end - i)
            out.append((2 << 6) | (m - 1))
            out.extend(_values_bytes(x[i : i + m], width))
            i += m
        lit_start = None

    def emit_run(pos: int, length: int) -> None:
        val = x[pos : pos + 1]
        rem = length
        while rem >= RLE2_MIN_RUN:
            m = min(RLE2_MAX_LONG, rem)
            if rem - m in (1, 2):
                m = rem - RLE2_MIN_RUN
            if m <= RLE2_MAX_SHORT:
                out.append((0 << 6) | (m - 3))
            else:
                out.append((3 << 6) | ((m - 3) >> 8))
                out.append((m - 3) & 0xFF)
            out.extend(_values_bytes(val, width))
            pos += m
            rem -= m
        assert rem == 0

    def emit_delta(pos: int, length: int, delta) -> None:
        rem, p = length, pos
        while rem >= RLE2_MIN_RUN:
            m = min(RLE2_MAX_SHORT, rem)
            if rem - m in (1, 2):
                m = rem - RLE2_MIN_RUN
            out.append((1 << 6) | (m - 3))
            out.extend(_values_bytes(x[p : p + 1], width))
            out.extend(_values_bytes(np.asarray([delta], x.dtype), width))
            p += m
            rem -= m
        assert rem == 0

    dends = dstarts + dlens  # exclusive end, in diff-index space
    nseg = dstarts.shape[0]
    i = 0   # element cursor
    seg = 0
    while i < n:
        if i >= n - 1:
            # trailing single element -> literal
            if lit_start is None:
                lit_start = i
            break
        while seg < nseg and int(dends[seg]) <= i:
            seg += 1
        # invariant: dstarts[seg] <= i < dends[seg]; the constant-diff segment
        # covers elements [i, dends[seg]] inclusive.
        delta = d[i]
        elems = int(dends[seg]) - i + 1
        if delta == 0 and elems >= RLE2_MIN_RUN:
            flush_literals(i)
            emit_run(i, elems)
            i += elems
        elif delta != 0 and elems >= RLE2_MIN_DELTA:
            flush_literals(i)
            emit_delta(i, elems, delta)
            i += elems
        else:
            if lit_start is None:
                lit_start = i
            i = int(dends[seg])  # last element of segment joins the next one
    flush_literals(n)
    return bytes(out)


# --------------------------------------------------------------------------
# per-codec blob builders (each registered as its plugin's ``encode`` hook)
# --------------------------------------------------------------------------


def compress_rle_v1(arr: np.ndarray,
                    chunk_bytes: int = fmt.DEFAULT_CHUNK_BYTES,
                    bits: int | None = None) -> fmt.CompressedBlob:
    chunks, chunk_elems, width, _ = fmt.chunk_array(arr, chunk_bytes)
    encoded = [encode_rle_v1_chunk(c, width) for c in chunks]
    return fmt.build_blob(fmt.RLE_V1, arr, encoded, chunk_elems, width)


def compress_rle_v2(arr: np.ndarray,
                    chunk_bytes: int = fmt.DEFAULT_CHUNK_BYTES,
                    bits: int | None = None) -> fmt.CompressedBlob:
    chunks, chunk_elems, width, _ = fmt.chunk_array(arr, chunk_bytes)
    encoded = [encode_rle_v2_chunk(c, width) for c in chunks]
    return fmt.build_blob(fmt.RLE_V2, arr, encoded, chunk_elems, width)


def compress(arr: np.ndarray, codec: str,
             chunk_bytes: int | None = None,
             bits: int | None = None) -> fmt.CompressedBlob:
    """Encode ``arr`` through the codec registry.

    ``chunk_bytes=None`` means ``format.DEFAULT_CHUNK_BYTES``: the port has
    no tuned-defaults table yet (ROADMAP.md Queue 1 item 9).
    """
    if chunk_bytes is None:
        chunk_bytes = fmt.DEFAULT_CHUNK_BYTES
    return registry.get(codec).encode(arr, chunk_bytes, bits=bits)
