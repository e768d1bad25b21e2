"""ORC RLE v1, frozen: the encoder the benchmark's inputs are made with, and
the plain decoder the tests hold it to.

A copy of the port's ``encode_rle_v1_chunk`` as it stands when this
benchmark was written, so that no later change to the program can change
the workload.  ``bench/tests/test_bench_frozen.py`` holds it byte for byte
to the committed golden vectors.

  control c in [0,127]   -> run of length c+3 (3..130), one value follows
  control c in [128,255] -> 256-c literals (1..128), values follow
"""
from __future__ import annotations

import numpy as np

CODEC = "rle_v1"
PLANE_SPLIT_64 = True     # 8-byte columns are stored as two u32 planes
BYTE_STREAM = False       # chunked in elements of the column's width

MIN_RUN = 3
MAX_RUN = 130
MAX_LIT = 128


def values_bytes(vals: np.ndarray, width: int) -> bytes:
    """The values as unsigned integers of ``width`` bytes, little-endian:
    slice ``[i * width:(i + n) * width]`` holds values ``i`` to ``i + n``."""
    return np.ascontiguousarray(vals).astype(
        {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]).tobytes()


def find_runs(x: np.ndarray):
    """(start_indices, run_lengths) of maximal equal-value runs."""
    n = x.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.empty(n, np.bool_)
    change[0] = True
    np.not_equal(x[1:], x[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lens = np.diff(np.append(starts, n))
    return starts, lens


def encode_chunk(x: np.ndarray, width: int):
    """One chunk's payload, and its per-chunk extras (none)."""
    starts, lens = find_runs(x)
    xb = values_bytes(x, width)
    out = bytearray()
    lit_start = None

    def flush_literals(end: int) -> None:
        nonlocal lit_start
        if lit_start is None:
            return
        i = lit_start
        while i < end:
            n = min(MAX_LIT, end - i)
            out.append(256 - n)
            out.extend(xb[i * width:(i + n) * width])
            i += n
        lit_start = None

    for s, l in zip(starts.tolist(), lens.tolist()):
        if l >= MIN_RUN:
            flush_literals(s)
            rem, pos = l, s
            while rem >= MIN_RUN:
                n = min(MAX_RUN, rem)
                if rem - n in (1, 2):  # avoid leaving an un-encodable tail
                    n = rem - MIN_RUN
                    if n < MIN_RUN:
                        break
                out.append(n - MIN_RUN)
                out.extend(xb[pos * width:(pos + 1) * width])
                pos += n
                rem -= n
            if rem and lit_start is None:  # leftover 1..2 become literals
                lit_start = pos
        elif lit_start is None:
            lit_start = s
    flush_literals(x.shape[0])
    return bytes(out), {}


def blob_extras(per_chunk: list) -> dict:
    return {}


def decode_chunk(payload: bytes, extras: dict, width: int,
                 n_out: int) -> np.ndarray:
    """The plain decoder: one group at a time, in order."""
    dt = np.dtype({1: np.uint8, 2: np.uint16, 4: np.uint32}[width])
    out, pos = [], 0
    while pos < len(payload) and sum(len(o) for o in out) < n_out:
        c = payload[pos]
        pos += 1
        if c < 128:
            v = np.frombuffer(payload, dt, 1, pos)
            out.append(np.repeat(v, c + MIN_RUN))
            pos += width
        else:
            n = 256 - c
            out.append(np.frombuffer(payload, dt, n, pos))
            pos += n * width
    flat = np.concatenate(out) if out else np.zeros(0, dt)
    return flat[:n_out]
