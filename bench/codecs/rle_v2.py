"""ORC RLE v2 (in spirit), frozen: the encoder the benchmark's inputs are
made with, and the plain decoder the tests hold it to.

A copy of the port's ``encode_rle_v2_chunk`` as it stands when this
benchmark was written; ``bench/tests/test_bench_frozen.py`` holds it byte
for byte to the committed golden vectors.

  header h; mode = h >> 6, f = h & 63
  mode 0 -> run,     len = f+3  (3..66),  value follows
  mode 1 -> delta,   len = f+3  (3..66),  base value + delta value follow
  mode 2 -> literal, len = f+1  (1..64),  values follow
  mode 3 -> long run, len = (f<<8 | next_byte)+3 (3..16386), value follows
"""
from __future__ import annotations

import numpy as np

from bench.codecs.rle_v1 import find_runs, values_bytes

CODEC = "rle_v2"
PLANE_SPLIT_64 = True
BYTE_STREAM = False

MIN_RUN = 3
MAX_SHORT = 66
MAX_LONG = 16386
MAX_LIT = 64
MIN_DELTA = 4


def encode_chunk(x: np.ndarray, width: int):
    """One chunk's payload, and its per-chunk extras (none)."""
    n = x.shape[0]
    out = bytearray()
    if n == 0:
        return b"", {}
    xb = values_bytes(x, width)
    mask = (1 << (8 * width)) - 1
    # segment by constant difference (wraparound arithmetic): an equal-value
    # run is a delta segment with d == 0
    d = (x[1:] - x[:-1]) if n > 1 else np.zeros(0, x.dtype)
    dstarts, dlens = find_runs(d) if n > 1 else (np.zeros(0, np.int64),) * 2
    lit_start = None

    def flush_literals(end: int) -> None:
        nonlocal lit_start
        if lit_start is None:
            return
        i = lit_start
        while i < end:
            m = min(MAX_LIT, end - i)
            out.append((2 << 6) | (m - 1))
            out.extend(xb[i * width:(i + m) * width])
            i += m
        lit_start = None

    def emit_run(pos: int, length: int) -> None:
        val = xb[pos * width:(pos + 1) * width]
        rem = length
        while rem >= MIN_RUN:
            m = min(MAX_LONG, rem)
            if rem - m in (1, 2):
                m = rem - MIN_RUN
            if m <= MAX_SHORT:
                out.append(m - 3)
            else:
                out.append((3 << 6) | ((m - 3) >> 8))
                out.append((m - 3) & 0xFF)
            out.extend(val)
            pos += m
            rem -= m
        if rem:
            raise AssertionError("rle_v2 run left a tail")

    def emit_delta(pos: int, length: int, delta) -> None:
        rem, p = length, pos
        while rem >= MIN_RUN:
            m = min(MAX_SHORT, rem)
            if rem - m in (1, 2):
                m = rem - MIN_RUN
            out.append((1 << 6) | (m - 3))
            out.extend(xb[p * width:(p + 1) * width])
            out.extend((delta & mask).to_bytes(width, "little"))
            p += m
            rem -= m
        if rem:
            raise AssertionError("rle_v2 delta left a tail")

    dends = (dstarts + dlens).tolist()
    deltas = d.tolist()
    nseg = len(dends)
    i = 0
    seg = 0
    while i < n:
        if i >= n - 1:       # trailing single element -> literal
            if lit_start is None:
                lit_start = i
            break
        while seg < nseg and dends[seg] <= i:
            seg += 1
        delta = deltas[i]
        elems = dends[seg] - i + 1
        if delta == 0 and elems >= MIN_RUN:
            flush_literals(i)
            emit_run(i, elems)
            i += elems
        elif delta != 0 and elems >= MIN_DELTA:
            flush_literals(i)
            emit_delta(i, elems, delta)
            i += elems
        else:
            if lit_start is None:
                lit_start = i
            i = dends[seg]  # last element of segment joins the next one
    flush_literals(n)
    return bytes(out), {}


def blob_extras(per_chunk: list) -> dict:
    return {}


def decode_chunk(payload: bytes, extras: dict, width: int,
                 n_out: int) -> np.ndarray:
    """The plain decoder: one group at a time, in order; deltas wrap at the
    width."""
    dt = np.dtype({1: np.uint8, 2: np.uint16, 4: np.uint32}[width])
    mask = (1 << (8 * width)) - 1
    out, pos, have = [], 0, 0
    while pos < len(payload) and have < n_out:
        h = payload[pos]
        pos += 1
        mode, f = h >> 6, h & 63
        if mode == 2:
            piece = np.frombuffer(payload, dt, f + 1, pos)
            pos += (f + 1) * width
        else:
            if mode == 3:
                length = ((f << 8) | payload[pos]) + 3
                pos += 1
            else:
                length = f + 3
            base = int(np.frombuffer(payload, dt, 1, pos)[0])
            pos += width
            step = 0
            if mode == 1:
                step = int(np.frombuffer(payload, dt, 1, pos)[0])
                pos += width
            piece = np.array([(base + step * k) & mask
                              for k in range(length)], dt)
        out.append(piece)
        have += len(piece)
    flat = np.concatenate(out) if out else np.zeros(0, dt)
    return flat[:n_out]
