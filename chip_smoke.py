#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--gib 1.0] [--reps 5]
                          [--text-mib 8] [--td-chunks 2048]
                          [--td-plain-rows 256] [--ent-chunks 1024]
                          [--lz-plain-rows 64] [--q-layers 4]
    python3 chip_smoke.py --stage-only [--src DIR]   # phase 4's build and
                                                     # stage by part, alone

Phases, each of which must pass (any failure exits non-zero, with no result
line):

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. kernel build: one nvcc (sm_90a) per ``csrc`` source, all started
     together, with ptxas registers, spills and shared memory;
  3. each kernel vs its plain PyTorch version on the card, bit-exact, and
     every row against its input:
       - ``two_phase_rle`` for rle_v1, rle_v2 and dbp at widths 1/2/4, on a
         64-chunk table of 128 KiB chunks plus edge rows (empty chunk,
         one-element tail, 16386-long run, delta wraparound, literals at odd
         offsets, 50 runs of 3 elements) and hand-built rows for its 32-group
         batches and shared-memory ring: a header, a run value or a literal
         group across the 512-, 1,024- and 4,096-byte offsets; for dbp also
         256-element groups of 32-bit fields and malformed groups (fields of
         40 and 255 bits, a payload past the row's end); rows where the
         ``max_groups`` cap lands at groups 32 and 33 (rle_v1, rle_v2);
       - ``bitpack_unpack`` at bits 1/4/7/8/9/17/32 and widths 1/2/4, with
         tail rows, and the weight layout (4-bit fields into u8, 65,536
         elements a chunk);
       - ``tdeflate_decode`` on an empty chunk, a one-byte tail, literals
         only, long overlapping matches, a match reaching before the row's
         start, a stream cut by an invalid code, and hand-built rows for
         its 32-token batches: chained short-distance matches in one batch,
         a match whose source straddles the batch's start, and more than
         32 literals before a 258-long match of distance 1;
       - ``huffman_decode`` on a one-symbol alphabet, 12-bit codes forced by
         the Kraft fix-up, lengths 31/32/33/1023/1024, an empty chunk and a
         full chunk of log text, and rows whose segments leave the kernel's
         staged tile (random bytes, 12-bit codes, shuffled gap entries,
         offsets negative or past the row);
       - every table of every decode kernel again through each fused
         epilogue (u8 -> int8 with a zero, float32 (x - z) * s, bf16 out),
         against the plain version followed by ``Epilogue.apply``, bit for
         bit, each one launch counted as fused;
       - ``lzss_decode`` at widths 1/2/4 on dist-1 and period-3 overlaps,
         128-element literal runs, 129-element matches, a match at the
         65,535 distance limit, and hand-built rows: a match reaching before
         the row's start, a match as the row's first token, a zero
         distance, a stream cut short, and rows for its 32-token batches:
         chained short-distance matches across the batch boundary, a match
         whose source straddles a batch's start, a match whose chain runs
         back through three tokens of its batch, zero-distance matches at
         tokens 31 and 32, 128-element literal runs across the shared ring,
         and rows cut inside a literal run and inside a match's distance;
       - ``dequant_matmul`` within the stated tolerances: on the tensor
         cores (``wgmma``) at bf16 qwen3-1.7B shapes, split-K at a decode
         batch, M = 1 and M = 64; on the SIMT path at the reference test's
         f32 shapes and a bf16 shape TMA cannot describe; each case logs
         the path it took;
  4. the decode path at scale: ``api.compress_many`` ->
     ``api.decompress_many(device_out=True)`` decoding >= ``--gib`` GiB of a
     table scan through all seven codecs in one call (a tdeflate group of
     >= ``--td-chunks`` chunks of log text, a huffman group of the same text
     and an lzss group of its u32 token ids, each >= ``--ent-chunks``
     chunks), checked against the inputs, with every kernel's launch count,
     the decode time, output GB/s, and each plan group's kernel time, bound
     and plain-version time (tokens or groups a chunk for tdeflate, lzss
     and the RLE family); before it, ``DecodePlan.build`` and ``stage`` of
     the same blobs by part, cold and warm, with the upload's GB/s;
  5. epilogues in the kernels' stores against their plain torch versions:
     an rle_v2 column, a bitpack column, the log text through huffman and
     tdeflate, the lzss token shard; then the fused decode timed against
     the kernel followed by ``Epilogue.apply`` (rle_v2, tdeflate, lzss);
  6. the quantized-weight path: ``decompress_dequant_matmul`` over the seven
     projections of ``--q-layers`` layers of qwen3-1.7B (W4A16: 4-bit
     bitpacked int8 weights, bf16 activations) at M = 128 and M = 2048,
     checked against the plain version (every call on the ``wgmma``
     path, every weight decode one ``bitpack_unpack`` launch with the
     zero-point epilogue fused), then timed in its steady state (cached
     plan, no host transfers): decode, kernel, plain version and
     ``torch.matmul`` on the dequantized weights, apart, per projection,
     and one sweep over all projections a rep, whose weights exceed the L2
     cache; the weight decode split into the host clock of the call and
     the device time of its launch;
  7. the serving layer: phase 4's arrays through one
     ``DecompressionService`` (256 MiB decoded-blob cache, pow2 buckets)
     from 8 producer threads, one ``submit_array`` a request, every other
     one ``device_out``, twice (the second pass meets the cache), each
     result bit-exact, with windows, blobs and dispatches a window, dispatch
     amplification, hit rate, p50/p99 latency and GB/s, and every decode
     kernel launched; then the same two passes through services with
     and without pow2 buckets in turns (the buckets' padding cost, with
     the bytes each pass stages); ``api.decompress_many(cas)`` through
     ``default_service()`` beside the direct plan path (equal dispatches
     and outputs); then every blob written to a filesystem backend and
     restored through a ``TieredBlobStore`` under a host budget well below
     the data, ``stream_windows(window=8)`` + ``submit_key``: each key
     fetched once, evictions, bit-exact;
  8. a JSON line of the kernels, then ``{"ok": true, "device": {...}}``
     last.

It imports nothing of JAX and nothing of the JAX package ``repro``.  It
exits non-zero without a card, or without the port's sources beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
CHUNK_BYTES = 128 * 1024           # the paper's chunk size
TD_EDGE_CHUNK = 32 * 1024          # tdeflate edge rows (plain body: a step
                                   # per token, so keep the rows short)
STORE_BUDGET = 128 << 20           # the restore's host budget (phase 7):
                                   # well under phase 4's 463.5 MiB of blobs
STORE_WINDOW = 8                   # blobs a window of the restore


def log(msg: str) -> None:
    print(msg, flush=True)


def ms_of(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int) -> float:
    """Median milliseconds of the work ``fn()`` queues on the card, over
    ``reps`` runs: CUDA events with the stream held busy (a device sleep of
    about a millisecond) until ``fn`` has queued its launches, so the
    wrapper's host time does not fall between the events, as it does in
    :func:`ms_of` when the card is idle."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# LUT bytes a chunk: tdeflate's i16 + i8 pairs for litlen and distance,
# huffman's one pair
LUT_BYTES = {"tdeflate": 2 * (2 + 1) * 4096, "huffman": (2 + 1) * 4096}


def bound_ms(codec: str, comp_bytes: int, n: int, chunk_elems: int,
             width: int) -> float:
    """Least time for one decode of n rows, at the card's memory rate: each
    input read once (the compressed bytes; out_lens, except for bitpack,
    which does not read them; the per-chunk LUTs of tdeflate and huffman),
    the (n, chunk_elems) output written once."""
    read = comp_bytes + (0 if codec == "bitpack" else 4 * n)
    read += LUT_BYTES.get(codec, 0) * n
    return (read + n * chunk_elems * width) / HBM_BYTES_PER_S * 1e3


def matmul_bound(m: int, n: int, k: int, x_bytes: int):
    """(least ms, what bounds it) of one y = x @ (q * s): the larger of x,
    q (one byte a weight) and s read once and y written once over the
    memory rate, and 2*m*n*k operations over the dense bf16 tensor-core
    peak."""
    moved = m * k * x_bytes + k * n + 4 * n + m * n * x_bytes
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * m * n * k / BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


# --------------------------------------------------------------------------
# data, made from the seed
# --------------------------------------------------------------------------

DT = {1: np.uint8, 2: np.uint16, 4: np.uint32}
KERNELS = ("two_phase_rle<rle_v1>", "two_phase_rle<rle_v2>",
           "two_phase_rle<dbp>", "bitpack_unpack", "tdeflate_decode",
           "huffman_decode", "lzss_decode", "dequant_matmul")
# kernel -> (source under src/repro_torch/csrc, the TPU kernel it replaces)
SOURCES = {
    "bitpack_unpack": ("bitpack_unpack.cu", "src/repro/kernels/bitpack.py:55"),
    "tdeflate_decode": ("tdeflate_decode.cu",
                        "src/repro/kernels/tdeflate.py:50"),
    "huffman_decode": ("huffman_decode.cu",
                       "src/repro/kernels/huffman.py:237"),
    "lzss_decode": ("lzss_decode.cu", "src/repro/kernels/lzss.py:245"),
    "dequant_matmul": ("dequant_matmul.cu",
                       "src/repro/kernels/dequant_matmul.py:53"),
}
# qwen3-1.7B (src/repro/configs/qwen3_1b7.py, hf:Qwen/Qwen3-1.7B): one
# layer's projections as (name, K, N) of y = x @ W
D_MODEL, N_HEADS, N_KV_HEADS, HEAD_DIM, D_FF = 2048, 16, 8, 128, 6144
QWEN3_PROJECTIONS = (
    ("q", D_MODEL, N_HEADS * HEAD_DIM), ("k", D_MODEL, N_KV_HEADS * HEAD_DIM),
    ("v", D_MODEL, N_KV_HEADS * HEAD_DIM), ("o", N_HEADS * HEAD_DIM, D_MODEL),
    ("gate", D_MODEL, D_FF), ("up", D_MODEL, D_FF), ("down", D_FF, D_MODEL))
Q_BATCHES = (128, 2048)            # a decode batch and a prefill chunk
TOL = {torch.float32: (5e-3, 1e-4),     # the reference test's own
       torch.bfloat16: (1.6e-2, 1e-2)}  # two bf16 ulps


def kernel_of(codec: str) -> str:
    named = {"bitpack": "bitpack_unpack", "tdeflate": "tdeflate_decode",
             "huffman": "huffman_decode", "lzss": "lzss_decode"}
    return named.get(codec, f"two_phase_rle<{codec}>")


def runs(rng, values: np.ndarray, max_run: int, n: int) -> np.ndarray:
    out = np.repeat(values, rng.integers(1, max_run, len(values)))
    if len(out) < n:
        out = np.resize(out, n)
    return out[:n]


LEVELS = ("INFO", "DEBUG", "WARN", "ERROR")


def log_corpus(rng, n_bytes: int, n_tokens: int = 0):
    """Synthetic log lines: an ISO timestamp, a level, and 5-15 words drawn
    by Zipf(1.1) from a 5,000-word vocabulary of random letters.  Returns
    the first ``n_bytes`` of the text, and the first ``n_tokens`` of the
    lines' token ids as u32, as a tokenized corpus stores them (lines are
    drawn until both are long enough): a word's id is its vocabulary index,
    a level is 5000 + its index in LEVELS, an end of line 5004."""
    vocab = ["".join(chr(97 + c) for c in rng.integers(0, 26,
                                                      rng.integers(3, 11)))
             for _ in range(5000)]
    p = np.arange(1, 5001, dtype=np.float64) ** -1.1
    p /= p.sum()
    levels = ("INFO", "INFO", "INFO", "DEBUG", "WARN", "ERROR")
    lines, ids, size, ms = [], [], 0, 0
    while size < n_bytes or len(ids) < n_tokens:
        ms += int(rng.integers(0, 2000))
        sec = ms // 1000
        drawn = rng.choice(5000, int(rng.integers(5, 16)), p=p)
        words = " ".join(vocab[i] for i in drawn)
        level = levels[int(rng.integers(0, len(levels)))]
        line = (f"2026-03-{1 + sec // 86400 % 28:02d}T{sec // 3600 % 24:02d}:"
                f"{sec // 60 % 60:02d}:{sec % 60:02d}.{ms % 1000:03d}Z "
                f"{level} {words}\n")
        if size < n_bytes:
            lines.append(line)
            size += len(line)
        if len(ids) < n_tokens:
            ids.append(5000 + LEVELS.index(level))
            ids.extend(drawn.tolist())
            ids.append(5004)
    text = np.frombuffer("".join(lines).encode()[:n_bytes], np.uint8).copy()
    return text, np.array(ids[:n_tokens], np.uint32)


def log_text(rng, n_bytes: int) -> np.ndarray:
    return log_corpus(rng, n_bytes)[0]


def scan_columns(rng, col_bytes: int):
    """A table scan's columns: (name, array, codec)."""
    n4 = col_bytes // 4
    m = n4 // 30 + 1
    ids = runs(rng, np.cumsum(rng.integers(1, 1000, m)).astype(np.uint32),
               120, n4)
    seg = rng.integers(100, 5000, n4 // 100 + 1)
    steps = np.repeat(rng.integers(-5, 6, len(seg)), seg)[:n4]
    ramp = (np.int64(1 << 20) + np.cumsum(steps)).astype(np.int32)
    vals = runs(rng, rng.normal(size=m).astype(np.float32), 80, n4)
    flags = runs(rng, rng.integers(0, 4, col_bytes // 60 + 1).astype(np.uint8),
                 200, col_bytes)
    codes = runs(rng, rng.integers(0, 1000, col_bytes // 100 + 1)
                 .astype(np.uint16), 100, col_bytes // 2)
    n8 = col_bytes // 8
    ts_steps = np.repeat(rng.choice(np.array([0, 1000, 5000]), n8 // 200 + 1),
                         200)[:n8]
    ts = np.int64(1_700_000_000_000_000_000) + np.cumsum(ts_steps)
    order_ids = np.cumsum(rng.integers(0, 16, n4)).astype(np.uint32)
    event_ts = np.int64(1_773_000_000_000_000_000) + np.cumsum(
        1_000_000 + rng.integers(-200_000, 200_000, n8))
    dict_u32 = rng.integers(0, 1 << 9, n4).astype(np.uint32)
    dict_u16 = rng.integers(0, 1 << 11, col_bytes // 2).astype(np.uint16)
    return [("ids_u32", ids, "rle_v1"), ("ramp_i32", ramp, "rle_v2"),
            ("vals_f32", vals, "rle_v1"), ("flags_u8", flags, "rle_v2"),
            ("codes_u16", codes, "rle_v1"), ("ts_i64", ts, "rle_v2"),
            ("order_ids_u32", order_ids, "dbp"),
            ("event_ts_i64", event_ts, "dbp"),
            ("dict_codes_u32", dict_u32, "bitpack"),
            ("dict_codes_u16", dict_u16, "bitpack")]


def edge_arrays(rng, width: int, chunk_elems: int):
    """Edge rows for one width, each its own blob."""
    dt = DT[width]
    top = 1 << (8 * width)
    base = runs(rng, rng.integers(0, 50, 64).astype(dt), 40, chunk_elems)
    odd = np.concatenate([  # literal runs at odd byte offsets
        np.concatenate([rng.integers(0, top, 5, dtype=np.uint64).astype(dt),
                        np.full(3, 7, dt)]) for _ in range(200)])
    wrap = ((top - 50 + 7 * np.arange(3000, dtype=np.int64)) % top).astype(dt)
    threes = np.repeat(np.arange(50) % 2 + 2 * rng.integers(0, 100, 50), 3)
    return {
        "empty": np.zeros(0, dt),
        "one_elem_tail": np.resize(base, chunk_elems + 1),
        "run_16386": np.full(16386 + 5, 9, dt),
        "delta_wrap": wrap,
        "odd_literals": odd,
        "runs_of_3": threes.astype(dt),
    }


# where the RLE kernel's 1 KiB ring blocks and 4 KiB ring meet, and a
# 512-byte mark
RING_OFFSETS = (512, 1024, 4096)


def rle_ring_rows(rng, codec: str, width: int):
    """Hand-built rows for the RLE kernel's ring and 32-group batches: a
    group header, a run value or a literal group across each of
    ``RING_OFFSETS``, then 40 short groups.  (name, group list) each."""
    top = 1 << (8 * width)
    v = lambda n: rng.integers(0, top, n, dtype=np.uint64)  # noqa: E731
    if codec == "rle_v1":
        kinds = {"run_value": (1, [("run", 5, v(1)[0])]),
                 "literal_128": (3, [("lit", v(128))])}
        tail = [("run", 3, x) for x in v(20)] + [("lit", v(1))] * 20
    elif codec == "rle_v2":
        kinds = {"long_header": (1, [("long", 1000, v(1)[0])]),
                 "delta_base": (width, [("delta", 20, v(1)[0], 3)]),
                 "literal_64": (5, [("lit", v(64))])}
        tail = [("run", 3, x) for x in v(20)] + [("lit", v(1))] * 20
    else:
        kinds = {"header": (1, [("dbp", 13, v(1)[0], v(100) % 8192)]),
                 "payload": (3 + width, [("dbp", 32, v(1)[0], v(256))])}
        tail = [("dbp", 2, x, [1, 2, 3]) for x in v(40)]
    return [(f"{k}_at_{o}", [("fill", o - back)] + groups + tail)
            for o in RING_OFFSETS for k, (back, groups) in kinds.items()]


def dbp_model(row: bytes, width: int, n: int) -> np.ndarray:
    """What a dbp row decodes to, as the reference's body reads it, also
    where it is malformed: element k of a group is the 40-bit window at bit
    ``payload * 8 + k * bits``, shifted and masked to ``bits`` (all ones
    from 32 up), plus the reference, mod 2^32.  Reads past the row's bytes
    are zero (its padding)."""
    def byte(p):
        return row[p] if p < len(row) else 0

    def value(p, w):
        return sum(byte(p + b) << (8 * b) for b in range(w))

    out, pos = [], 0
    while len(out) < n:
        bits, count = byte(pos), byte(pos + 1) + 1
        ref, off = value(pos + 2, width), pos + 2 + width
        mask = 0xFFFFFFFF if bits >= 32 else (1 << bits) - 1
        for k in range(count):
            bp = off * 8 + k * bits
            out.append((ref + ((value(bp >> 3, 5) >> (bp & 7)) & mask))
                       & 0xFFFFFFFF)
        pos = off + (count * bits + 7) // 8
    return np.array(out[:n], np.uint64).astype(DT[width])


def row_blob(fmt, codec: str, row: bytes, width: int, n: int):
    """One hand-built chunk row of n elements as a blob."""
    return fmt.CompressedBlob(
        codec=codec, width=width, chunk_elems=CHUNK_BYTES // width,
        total_elems=n, orig_dtype=str(np.dtype(DT[width])), orig_shape=(n,),
        comp=np.frombuffer(row, np.uint8)[None].copy(),
        comp_lens=np.array([len(row)], np.int32),
        out_lens=np.array([n], np.int32))


def dbp_malformed(rng, fmt, width: int):
    """dbp groups no encoder writes: 256 fields of 40 bits, and of 255
    bits with the payload past the row's end.  (name, blob, expected)."""
    out = []
    for name, bits, nbytes in (("bits_40", 40, 1400), ("bits_255", 255, 900)):
        row = bytes([bits, 255]) + bytes(rng.integers(0, 256, width + nbytes,
                                                      dtype=np.uint8))
        out.append((name, row_blob(fmt, "dbp", row, width, 300),
                    dbp_model(row, width, 300)))
    return out


def dbp_wide_groups(rng, fmt, width: int):
    """A chunk of 256-element dbp groups with 32-bit fields (the encoder
    writes 128-element groups, so it is built here) and what it decodes to:
    ref + field mod 2^32, in the width type."""
    ngroups = min(8, CHUNK_BYTES // width // 256)
    refs = rng.integers(0, 1 << (8 * width), ngroups, dtype=np.uint64)
    fields = rng.integers(0, 1 << 32, (ngroups, 256), dtype=np.uint64)
    row = bytearray()
    for r, f in zip(refs, fields):
        row += bytes([32, 255]) + int(r).to_bytes(8, "little")[:width]
        row += f.astype(np.uint32).tobytes()
    want = ((refs[:, None] + fields) % (1 << 32)).astype(np.uint32) \
        .astype(DT[width]).reshape(-1)
    total = want.size
    blob = fmt.CompressedBlob(
        codec="dbp", width=width, chunk_elems=CHUNK_BYTES // width,
        total_elems=total, orig_dtype=str(np.dtype(DT[width])),
        orig_shape=(total,), comp=np.frombuffer(bytes(row), np.uint8)[None],
        comp_lens=np.array([len(row)], np.int32),
        out_lens=np.array([total], np.int32))
    return blob, want


def inflate_tokens(tokens, chunk: int) -> np.ndarray:
    """What a token list decodes to in a ``chunk``-byte row, one byte at a
    time.  A match's window starts at ``cnt - dist``; a negative start is
    placed as ``lax.dynamic_slice`` places it (plus the buffer's length,
    ``chunk + 272``, clamped to ``[0, chunk]``), and byte i reads
    ``out[start + min(i % dist, 271)]``: an earlier byte, or zero at or
    past the current position."""
    out = []
    for t in tokens:
        if t[0] == "l":
            out.append(t[1])
            continue
        _, length, dist = t
        cnt = len(out)
        start = cnt - dist
        if start < 0:
            start = min(max(start + chunk + 272, 0), chunk)
        for i in range(length):
            j = start + min(i % dist, 271)
            out.append(out[j] if j < cnt else 0)
    return np.array(out, np.uint8)


# rows for the tdeflate kernel's 32-token batches (a token list each)
TD_BATCH_ROWS = {
    # short-distance matches in one batch, each reading the one before it
    "chained_matches": [("l", 97), ("l", 98), ("l", 99)]
    + [("m", 4 + i, 3 + i) for i in range(10)] + [("l", 10)],
    # a match of the second batch whose source straddles the batch's start
    "straddles_batch_start": [("l", 65 + i % 26) for i in range(40)]
    + [("m", 10, 12)] + [("l", 48 + i) for i in range(5)],
    # more than 32 literals, then a match of distance 1 and length 258
    "literals_then_run_258": [("l", 97 + i % 26) for i in range(40)]
    + [("m", 258, 1), ("l", 33)],
}


def tdeflate_edge_blobs(rng, enc, fmt, chunk: int):
    """tdeflate edge rows: (name, blob, expected bytes)."""
    text = log_text(rng, chunk + 1)
    arrays = {
        "empty": np.zeros(0, np.uint8),
        "one_byte_tail": text,
        "literals_only": rng.integers(0, 256, chunk).astype(np.uint8),
        "overlap_ab": np.frombuffer(b"ab" * 40000, np.uint8).copy(),
        "overlap_abcd": np.frombuffer(b"abcd" * 9000 + b"a" * 300, np.uint8)
        .copy(),
    }
    out = [(k, enc.compress(a, "tdeflate", chunk), a)
           for k, a in arrays.items()]
    # a first match that reaches 3 bytes before the row's start
    tokens = [("l", 65), ("m", 5, 3), ("l", 66), ("m", 40, 30), ("m", 9, 2)]
    want = inflate_tokens(tokens, chunk)
    blob = enc.tdeflate_blob(want, [enc.encode_tdeflate_tokens(tokens)],
                             chunk, want.size)
    out.append(("before_start", blob, want))
    # a stream cut by an invalid code: '~' occurs once (log text has none),
    # and its LUT entries are cleared, so the parse stops there (nb == 0);
    # the rest of the row is zero
    cut = np.concatenate([text[:chunk // 2], np.frombuffer(b"~", np.uint8),
                          text[chunk // 2:chunk - 1]])
    blob = enc.compress(cut, "tdeflate", chunk)
    hit = blob.extras["lut_lsym"] == ord("~")
    blob.extras["lut_lbits"][hit] = 0
    blob.extras["lut_lsym"][hit] = 0
    want = cut.copy()
    want[chunk // 2:] = 0
    out.append(("cut_invalid_code", blob, want))
    for name, tokens in TD_BATCH_ROWS.items():
        want = inflate_tokens(tokens, chunk)
        out.append((name, enc.tdeflate_blob(
            want, [enc.encode_tdeflate_tokens(tokens)], chunk, want.size),
            want))
    return out


def huffman_edge_arrays(rng, chunk: int):
    """huffman edge rows: name -> bytes, each its own blob."""
    fib = [1, 1]
    while len(fib) < 24:            # Fibonacci counts want > 12-bit codes
        fib.append(fib[-1] + fib[-2])
    kraft = np.repeat(np.arange(24, dtype=np.uint8), fib)
    rng.shuffle(kraft)
    geo = lambda n: np.minimum(rng.geometric(0.25, n) - 1,  # noqa: E731
                               255).astype(np.uint8)
    return {"one_symbol": np.full(5000, 9, np.uint8),
            "kraft_12bit": kraft,
            **{f"len_{n}": geo(n) for n in (31, 32, 33, 1023, 1024)},
            "empty": np.zeros(0, np.uint8),
            "log_text_tail": log_text(rng, chunk + 1)}


def huffman_tile_rows(rng, enc, chunk: int):
    """huffman rows whose segments leave the kernel's staged tile: random
    bytes (8-bit codes fill a batch's 2,048-word tile, so its last
    segments overflow it), 12-bit codes, shuffled gap entries (offsets out
    of order), offsets negative or past the row.  (name, blob) each."""
    fib = [1, 1]
    while len(fib) < 24:
        fib.append(fib[-1] + fib[-2])
    kraft = np.repeat(np.arange(24, dtype=np.uint8), fib)
    rng.shuffle(kraft)
    text = log_text(rng, chunk)
    nseg = -(-chunk // 32)
    out = [("random_bytes", enc.compress(rng.integers(0, 256, chunk)
                                         .astype(np.uint8), "huffman",
                                         chunk)),
           ("codes_12bit", enc.compress(np.resize(kraft, chunk), "huffman",
                                        chunk))]
    blob = enc.compress(text, "huffman", chunk)
    comp = blob.comp.copy()
    gaps = comp[0, 5:5 * nseg].reshape(nseg - 1, 5)   # entry 0 stays
    comp[0, 5:5 * nseg] = gaps[rng.permutation(nseg - 1)].reshape(-1)
    out.append(("shuffled_gaps", dataclasses.replace(blob, comp=comp)))
    comp = blob.comp.copy()
    for g in range(3, nseg, 7):
        comp[0, 5 * g + 3] |= 0x80               # negative offsets
    for g in range(5, nseg, 11):
        comp[0, 5 * g:5 * g + 4] = [0, 0, 0, 0x40]   # past the row
    out.append(("bad_offsets", dataclasses.replace(blob, comp=comp)))
    return out


# the epilogues phase 3 fuses into every decode kernel's stores
FUSED_KINDS = (
    ("int8_zero", dict(out_dtype="int8", zero_key="epi_zero"),
     {"epi_zero": np.uint8(8)}),
    ("f32_affine", dict(out_dtype="float32", zero_key="epi_zero",
                        scale_key="epi_scale"),
     {"epi_zero": np.uint8(3), "epi_scale": np.float32(0.173)}),
    ("bf16_affine", dict(out_dtype="bfloat16", zero_key="epi_zero",
                         scale_key="epi_scale"),
     {"epi_zero": np.uint8(3), "epi_scale": np.float32(0.173)}),
)


def bit_view(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def lzss_model(row: bytes, width: int, out_len: int) -> list:
    """What an lzss row decodes to, one element at a time, as the
    reference's pointer doubling resolves it: a match element reads the
    element ``dist`` back, or element 0 where that reaches before the row's
    start; element 0 of a first-token match, and every element of a
    zero-distance match, reads the bytes at its own literal offset.  Reads
    past the row's bytes are zero (its padding)."""
    def byte(p):
        return row[p] if p < len(row) else 0

    def value(p):
        return sum(byte(p + b) << (8 * b) for b in range(width))

    out, pos = [], 0
    while len(out) < out_len:
        c = byte(pos)
        if c < 128:
            out += [value(pos + 1 + j * width) for j in range(c + 1)]
            pos += 1 + (c + 1) * width
            continue
        dist = byte(pos + 1) | byte(pos + 2) << 8
        for j in range(c - 126):
            idx = len(out)
            if dist == 0 or idx == 0:
                out.append(value(pos + 1 + j * width))
            else:
                out.append(out[idx - dist] if idx >= dist else out[0])
        pos += 3
    return out[:out_len]


def lzss_edge_blobs(rng, enc, fmt, width: int):
    """lzss edge rows at one width: (name, blob, expected elements)."""
    dt, top = DT[width], 1 << (8 * width)
    chunk_elems = CHUNK_BYTES // width
    rand = lambda n: rng.integers(0, top, n, dtype=np.uint64) \
        .astype(dt)  # noqa: E731
    block = rand(400)
    arrays = {
        "dist_1": np.full(3000, 7, dt),
        "period_3": np.tile(np.array([11, 250, 3], dt), 2000),
        "literal_128": rand(128 * 9),
        "match_129": np.concatenate([block, block, block]),
        "one_elem_tail": np.resize(np.tile(np.array([5, 6, 7, 8], dt), 9)
                                   .astype(dt), chunk_elems + 1),
        "empty": np.zeros(0, dt),
    }
    out = [(k, enc.compress(a, "lzss", CHUNK_BYTES), a)
           for k, a in arrays.items()]

    def lits(n):
        return [("l", rand(min(128, n - i))) for i in range(0, n, 128)]

    lead = min(65535, chunk_elems - 129)
    hand = {
        # at width 1 the match reaches back exactly 65,535 elements; at 2
        # and 4 the chunk is shorter and it reaches before the row's start
        "dist_65535": lits(lead) + [("m", 129, 65535)],
        "before_start": [("l", rand(3)), ("m", 10, 5), ("l", rand(4)),
                         ("m", 40, 30), ("m", 9, 2)],
        "match_first": [("m", 20, 3), ("l", rand(6)), ("m", 12, 4)],
        "zero_dist": [("l", rand(5)), ("m", 10, 0), ("l", rand(2))],
        # the kernel's 32-token batches
        "chained_matches": [("l", rand(4))]
        + [("m", 2 + i % 4, 1 + i % 4) for i in range(60)],
        "straddles_batch_start": [("l", rand(1)) for _ in range(40)]
        + [("m", 10, 12), ("l", rand(3))],
        "chain_through_3": [("l", rand(1)) for _ in range(32)]
        + [("m", 4, 4)] * 4 + [("l", rand(2))],
        "zero_dist_token_31": [("l", rand(1)) for _ in range(31)]
        + [("m", 5, 0), ("l", rand(2))],
        "zero_dist_token_32": [("l", rand(1)) for _ in range(32)]
        + [("m", 5, 0), ("l", rand(2))],
        # 128-element literal runs (513 bytes at width 4) across the ring
        "literal_128_runs": lits(128 * 40) + [("m", 129, 300)],
    }
    for k, tokens in hand.items():
        row = enc.encode_lzss_tokens(tokens, width)
        n = sum(len(t[1]) if t[0] == "l" else t[1] for t in tokens)
        out.append((k, row_blob(fmt, "lzss", row, width, n), lzss_model(
            row, width, n)))
    # a stream cut short: the row ends inside a token, the rest reads zeros
    n = min(2000, chunk_elems)
    full = enc.encode_lzss_chunk(np.tile(rand(50), 40)[:n], width)
    row = full[:len(full) // 2 + 1]
    out.append(("cut_short", row_blob(fmt, "lzss", row, width, n),
                lzss_model(row, width, n)))
    # rows that end inside a literal run and inside a match's distance
    full = enc.encode_lzss_tokens(
        [("l", rand(100)), ("m", 20, 3), ("l", rand(50))], width)
    for k, cut in (("cut_in_literal", 60), ("cut_in_distance",
                                             1 + 100 * width + 2)):
        out.append((k, row_blob(fmt, "lzss", full[:cut], width, 400),
                    lzss_model(full[:cut], width, 400)))
    return [(k, b, np.asarray(w, np.uint64).astype(dt)) for k, b, w in out]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_env() -> None:
    log(f"== 1 environment: python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])


def phase_build(cuda_build, libs) -> None:
    t0 = time.perf_counter()
    paths = cuda_build.build_all(libs)
    dt = time.perf_counter() - t0
    log(f"== 2 kernel build: {', '.join(p.name for p in paths)} in "
        f"{dt:.2f} s (one nvcc each, in parallel)")
    for lib in libs:
        name = " ".join((lib.source.name,) + lib.flags)
        log(f"   {name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"   {name} ptxas: {line.strip()}")


def check_rows(name, out, blobs_and_wants, fmt) -> None:
    """Each blob's rows of a decoded table against what it must decode to."""
    host = out.cpu().numpy()
    row = 0
    for key, b, want in blobs_and_wants:
        got = fmt.reassemble(b, host[row:row + b.num_chunks].copy())
        if not np.array_equal(got.reshape(-1).view(np.uint8),
                              np.ascontiguousarray(want).reshape(-1)
                              .view(np.uint8)):
            raise AssertionError(f"{name} {key}: kernel output differs from "
                                 "the input")
        row += b.num_chunks


def decode_pair(codec, dev, *, width, chunk_elems, bits, registry, harness):
    """(kernel output, plain output) of one staged table, on the card."""
    spec = registry.get(codec).decode
    inputs = spec.chunk_inputs(dev)
    lens = dev["out_lens"]
    consts = harness.consts_on(spec, lens.device)
    kw = dict(chunk_elems=chunk_elems, width=width, bits=bits)
    kern = spec.cuda(inputs, consts, lens, **kw)
    plain = spec.body(inputs, consts, lens, **kw)
    torch.cuda.synchronize()
    return kern, plain


def fused_errs(codec, dev, plain, *, width, chunk_elems, bits, registry,
               harness, counter):
    """Each of FUSED_KINDS through the kernel's stores against the plain
    version's output ``plain`` followed by ``Epilogue.apply``, on the card:
    the largest bit difference, after checking one launch and one fused
    epilogue each."""
    spec = registry.get(codec).decode
    worst = 0
    for name, kw, operands in FUSED_KINDS:
        d = {**dev, **{k: torch.from_numpy(np.asarray(v)).to(
            dev["out_lens"].device) for k, v in operands.items()}}
        epi = harness.Epilogue(**kw)
        want = epi.apply(plain, d)
        before = (counter.read(), harness.EPILOGUE_FUSED,
                  harness.EPILOGUE_UNFUSED)
        got = harness.run(spec, d, width=width, chunk_elems=chunk_elems,
                          backend="cuda", bits=bits, epilogue=epi)
        torch.cuda.synchronize()
        after = (counter.read(), harness.EPILOGUE_FUSED,
                 harness.EPILOGUE_UNFUSED)
        if after != (before[0] + 1, before[1] + 1, before[2]):
            raise AssertionError(f"{codec} {name}: launches / fused / "
                                 f"unfused went {before} -> {after}")
        if got.dtype != want.dtype:
            raise AssertionError(f"{codec} {name}: {got.dtype} != "
                                 f"{want.dtype}")
        worst = max(worst, max_abs_err(bit_view(got), bit_view(want)))
    return worst


def phase_kernel_vs_plain(rng, fmt, enc, registry, harness, errs,
                          device, counters) -> None:
    log("== 3 kernels vs plain versions on the card (bit-exact)")
    pair = dict(registry=registry, harness=harness)
    kinds = ", ".join(k for k, _, _ in FUSED_KINDS)
    for codec in ("rle_v1", "rle_v2", "dbp"):
        for width in (1, 2, 4):
            chunk_elems = CHUNK_BYTES // width
            dt = DT[width]
            moderate = runs(rng, rng.integers(0, 200, 64 * chunk_elems // 20)
                            .astype(dt), 40, 64 * chunk_elems)
            arrays = {"moderate_64": moderate,
                      **edge_arrays(rng, width, chunk_elems)}
            rows = [(k, enc.compress(a, codec, CHUNK_BYTES), a)
                    for k, a in arrays.items()]
            for k, groups in rle_ring_rows(rng, codec, width):
                row, want = enc.encode_rle_groups(codec, groups, width)
                rows.append((k, row_blob(fmt, codec, row, width, want.size),
                             want.astype(dt)))
            if codec == "dbp":
                rows.append(("groups_256_bits_32",
                             *dbp_wide_groups(rng, fmt, width)))
                rows += dbp_malformed(rng, fmt, width)
            table = fmt.concat_blobs([b for _, b, _ in rows])
            dev = fmt.to_device(table, device)
            kern, plain = decode_pair(codec, dev, width=width,
                                      chunk_elems=chunk_elems, bits=0, **pair)
            err = max(max_abs_err(kern, plain), fused_errs(
                codec, dev, plain, width=width, chunk_elems=chunk_elems,
                bits=0, counter=counters[kernel_of(codec)], **pair))
            errs[kernel_of(codec)] = max(errs[kernel_of(codec)], err)
            if err:
                raise AssertionError(f"{codec} w{width}: kernel differs "
                                     f"from plain by {err}")
            check_rows(f"{codec} w{width}", kern, rows, fmt)
            cap = ""
            if codec != "dbp":      # dbp's cap, out_len + 4, never binds
                for chunk in (64, 56, 58):  # caps of 36, 32 and 33 groups
                    cap_err = group_cap_err(rng, fmt, codec, width, device,
                                            pair, chunk)
                    if cap_err:
                        raise AssertionError(
                            f"{codec} w{width}: group-cap rows (chunk "
                            f"{chunk}) differ by {cap_err}")
                cap = "; group-cap rows (caps 36, 32, 33) max_abs_err 0"
            log(f"   {codec} w{width}: {table.num_chunks} rows x "
                f"{chunk_elems} elems, kernel == plain (max_abs_err {err}), "
                f"rows == inputs ({', '.join(k for k, _, _ in rows)}){cap}; "
                f"fused {kinds} == plain + Epilogue.apply (bit for bit)")
    for bits in (1, 4, 7, 8, 9, 17, 32):
        for width in (w for w in (1, 2, 4) if bits <= 8 * w):
            chunk_elems = CHUNK_BYTES // width
            top = 1 << bits
            arrays = {
                "random_8": rng.integers(0, top, 8 * chunk_elems,
                                         dtype=np.uint64).astype(DT[width]),
                "one_elem_tail": rng.integers(0, top, chunk_elems + 1,
                                              dtype=np.uint64)
                .astype(DT[width]),
                "all_max": np.full(1000, top - 1, np.uint64).astype(DT[width]),
            }
            rows = [(k, enc.compress(a, "bitpack", CHUNK_BYTES, bits=bits), a)
                    for k, a in arrays.items()]
            tables = [(chunk_elems, rows)]
            # tail rows: 1,000 elements a chunk (a partial last vector)
            tail = rng.integers(0, top, 2500, dtype=np.uint64) \
                .astype(DT[width])
            tables.append((1000, [("chunk_1000", enc.compress(
                tail, "bitpack", 1000 * width, bits=bits), tail)]))
            if bits == 4 and width == 1:     # the weight layout
                q = rng.integers(0, 16, 2 * 65536 + 300).astype(np.uint8)
                tables.append((65536, [("weights_65536", enc.compress(
                    q, "bitpack", 65536, bits=4), q)]))
            for ce, rows in tables:
                table = fmt.concat_blobs([b for _, b, _ in rows])
                dev = fmt.to_device(table, device)
                kern, plain = decode_pair("bitpack", dev, width=width,
                                          chunk_elems=ce, bits=bits, **pair)
                err = max_abs_err(kern, plain)
                err = max(err, fused_errs(
                    "bitpack", dev, plain, width=width, chunk_elems=ce,
                    bits=bits, counter=counters["bitpack_unpack"], **pair))
                errs["bitpack_unpack"] = max(errs["bitpack_unpack"], err)
                if err:
                    raise AssertionError(f"bitpack b{bits} w{width} chunk "
                                         f"{ce}: kernel differs from plain "
                                         f"by {err}")
                check_rows(f"bitpack b{bits} w{width}", kern, rows, fmt)
        log(f"   bitpack b{bits}: widths "
            f"{[w for w in (1, 2, 4) if bits <= 8 * w]}, chunks of "
            f"{CHUNK_BYTES} bytes and of 1,000 elements"
            + (" and the 65,536-element weight layout" if bits == 4 else "")
            + f", kernel == plain (max_abs_err 0), rows == inputs; fused "
            f"{kinds} == plain + Epilogue.apply (bit for bit)")
    chunk = TD_EDGE_CHUNK
    rows = tdeflate_edge_blobs(rng, enc, fmt, chunk)
    table = fmt.concat_blobs([b for _, b, _ in rows])
    dev = fmt.to_device(table, device)
    t0 = time.perf_counter()
    kern, plain = decode_pair("tdeflate", dev, width=1, chunk_elems=chunk,
                              bits=0, **pair)
    plain_s = time.perf_counter() - t0
    err = max(max_abs_err(kern, plain), fused_errs(
        "tdeflate", dev, plain, width=1, chunk_elems=chunk, bits=0,
        counter=counters["tdeflate_decode"], **pair))
    errs["tdeflate_decode"] = max(errs["tdeflate_decode"], err)
    if err:
        raise AssertionError(f"tdeflate: kernel differs from plain by {err}")
    check_rows("tdeflate", kern, rows, fmt)
    log(f"   tdeflate: {table.num_chunks} rows x {chunk} bytes, kernel == "
        f"plain (max_abs_err {err}; plain {plain_s:.1f} s), rows == "
        f"expected ({', '.join(k for k, _, _ in rows)}); fused {kinds} == "
        "plain + Epilogue.apply (bit for bit)")
    rows = [(k, enc.compress(a, "huffman", CHUNK_BYTES), a)
            for k, a in huffman_edge_arrays(rng, CHUNK_BYTES).items()]
    table = fmt.concat_blobs([b for _, b, _ in rows])
    dev = fmt.to_device(table, device)
    kern, plain = decode_pair("huffman", dev, width=1,
                              chunk_elems=CHUNK_BYTES, bits=0, **pair)
    err = max_abs_err(kern, plain)
    err = max(err, fused_errs("huffman", dev, plain, width=1,
                              chunk_elems=CHUNK_BYTES, bits=0,
                              counter=counters["huffman_decode"], **pair))
    errs["huffman_decode"] = max(errs["huffman_decode"], err)
    if err:
        raise AssertionError(f"huffman: kernel differs from plain by {err}")
    check_rows("huffman", kern, rows, fmt)
    tile = huffman_tile_rows(rng, enc, CHUNK_BYTES)
    dev = fmt.to_device(fmt.concat_blobs([b for _, b in tile]), device)
    kern, plain = decode_pair("huffman", dev, width=1,
                              chunk_elems=CHUNK_BYTES, bits=0, **pair)
    tile_err = max(max_abs_err(kern, plain), fused_errs(
        "huffman", dev, plain, width=1, chunk_elems=CHUNK_BYTES, bits=0,
        counter=counters["huffman_decode"], **pair))
    errs["huffman_decode"] = max(errs["huffman_decode"], tile_err)
    if tile_err:
        raise AssertionError(f"huffman tile rows: kernel differs from plain "
                             f"by {tile_err}")
    log(f"   huffman: {table.num_chunks} rows x {CHUNK_BYTES} bytes, kernel "
        f"== plain (max_abs_err {err}), rows == inputs "
        f"({', '.join(k for k, _, _ in rows)}); rows off the staged tile "
        f"({', '.join(k for k, _ in tile)}) kernel == plain (max_abs_err "
        f"{tile_err}); fused {kinds} == plain + Epilogue.apply (bit for "
        "bit)")
    for width in (1, 2, 4):
        rows = lzss_edge_blobs(rng, enc, fmt, width)
        table = fmt.concat_blobs([b for _, b, _ in rows])
        dev = fmt.to_device(table, device)
        t0 = time.perf_counter()
        kern, plain = decode_pair("lzss", dev, width=width,
                                  chunk_elems=CHUNK_BYTES // width, bits=0,
                                  **pair)
        plain_s = time.perf_counter() - t0
        err = max(max_abs_err(kern, plain), fused_errs(
            "lzss", dev, plain, width=width, chunk_elems=CHUNK_BYTES // width,
            bits=0, counter=counters["lzss_decode"], **pair))
        errs["lzss_decode"] = max(errs["lzss_decode"], err)
        if err:
            raise AssertionError(f"lzss w{width}: kernel differs from plain "
                                 f"by {err}")
        check_rows(f"lzss w{width}", kern, rows, fmt)
        log(f"   lzss w{width}: {table.num_chunks} rows x "
            f"{CHUNK_BYTES // width} elems, kernel == plain (max_abs_err "
            f"{err}; plain {plain_s:.1f} s), rows == expected "
            f"({', '.join(k for k, _, _ in rows)}); fused {kinds} == plain "
            "+ Epilogue.apply (bit for bit)")


def phase_dequant_vs_plain(rng, dq, errs, device) -> None:
    """The dequant matmul kernel against its plain version (float32, no
    TF32): bf16 on the tensor-core path at qwen3-1.7B shapes (a split-K
    decode batch among them), M = 1 and M = 64; the SIMT path at the
    reference test's f32 shapes and a bf16 shape TMA cannot describe
    (N % 16 != 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    cases = [((128, 2048, 6144), bf, "wgmma"),
             ((2048, 6144, 2048), bf, "wgmma"),
             ((128, 2048, 1024), bf, "wgmma"), ((1, 2048, 2048), bf, "wgmma"),
             ((64, 2048, 2048), bf, "wgmma"),
             ((256, 2048, 1024), bf, "wgmma"),
             ((128, 128, 128), torch.float32, "simt"),
             ((256, 384, 256), torch.float32, "simt"),
             ((128, 512, 384), torch.float32, "simt"),
             ((64, 96, 100), bf, "simt")]
    for (m, k, n), dtype, path in cases:
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)) \
            .to(device).to(dtype)
        q = torch.from_numpy(rng.integers(-127, 127, (k, n)).astype(np.int8))\
            .to(device)
        s = torch.from_numpy((np.abs(rng.normal(size=(1, n))) * 0.01)
                             .astype(np.float32)).to(device)
        before = dict(dq.LAUNCHES_BY_PATH)
        got = dq.dequant_matmul(x, q, s)
        want = dq.ref_dequant_matmul(x, q, s)
        torch.cuda.synchronize()
        took = [p for p, v in dq.LAUNCHES_BY_PATH.items() if v != before[p]]
        if took != [path]:
            raise AssertionError(f"dequant_matmul ({m},{k},{n}) {dtype} took "
                                 f"{took}, expected {path}")
        rtol, atol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        err = float((got.float() - want.float()).abs().max())
        errs["dequant_matmul"] = max(errs["dequant_matmul"], err)
        _, bm, splits = dq._launch_plan(m, n, k, dtype)
        log(f"   dequant_matmul (M,K,N)=({m},{k},{n}) {dtype}: {path} path"
            + (f" (bm {bm}, {splits} K splits)" if path == "wgmma" else "")
            + f", within rtol {rtol} atol {atol} of plain (max_abs_err "
            f"{err:.3g})")


def group_cap_err(rng, fmt, codec, width, device, pair, chunk: int) -> int:
    """Rows of one-literal groups, more than ``max_groups`` (chunk // 2 + 4)
    admits: the last admitted group must cover every lane up to out_len, as
    in the reference's lane->group map.  No encoder writes such rows, so
    they are built here, on a ``chunk``-element chunk (the cap lands at
    group 32 of a 56-element chunk, the last of the kernel's first batch,
    and at group 33 of a 58-element one); returns the kernel's max_abs_err
    against the plain version."""
    hdr = 255 if codec == "rle_v1" else 2 << 6      # one literal
    groups = rng.integers(0, 256, (3, 200, 1 + width)).astype(np.uint8)
    groups[:, :, 0] = hdr
    comp = groups.reshape(3, -1)
    table = fmt.CompressedBlob(
        codec=codec, width=width, chunk_elems=chunk, total_elems=3 * chunk,
        orig_dtype=str(np.dtype(DT[width])), orig_shape=(3 * chunk,),
        comp=comp, comp_lens=np.full(3, comp.shape[1], np.int32),
        out_lens=np.array([chunk, chunk - 14, 7], np.int32))
    kern, plain = decode_pair(codec, fmt.to_device(table, device), width=width,
                              chunk_elems=chunk, bits=0, **pair)
    return max_abs_err(kern, plain)


def build_stage_parts(plan_mod, fmt, ops, transfers, flat, device) -> None:
    """``DecodePlan.build`` and ``stage`` of ``flat`` by part, each cold
    (the first call of these sizes in the process) and warm (the second),
    on the host clock.  build: the whole call, then its parts again apart,
    grouping (``group_key``) and merging (``concat_blobs``).  stage: the
    scatter tables (``reassemble_indices``, uploaded where a blob's rows are
    not contiguous) and the chunk tables (the padded copy and the h2d
    upload, ``ops.table_inputs``), each part ending in a device
    synchronisation.  It calls only functions that every version of the
    port has, so another checkout's package is timed alike (``--stage-only
    --src``)."""
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        plan = plan_mod.DecodePlan.build(flat)
        t1 = time.perf_counter()
        by_key = {}
        for i, b in enumerate(flat):
            by_key.setdefault(fmt.group_key(b), []).append(i)
        t2 = time.perf_counter()
        merged = [fmt.concat_blobs([flat[i] for i in ids])
                  for ids in by_key.values()]
        t3 = time.perf_counter()
        del merged
        with transfers.count_host_transfers() as c_scat:
            scat = [transfers.to_device(idx, device) for g in plan.groups
                    for idx in g.scatter if idx is not None]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        with transfers.count_host_transfers() as c_tab:
            staged = [ops.table_inputs(g.merged, device) for g in plan.groups]
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        del plan, scat, staged
        torch.cuda.empty_cache()
        tab_ms = (t5 - t4) * 1e3
        log(f"   {run}: DecodePlan.build {(t1 - t0) * 1e3:.2f} ms (apart: "
            f"grouping {(t2 - t1) * 1e3:.2f} ms, concat_blobs "
            f"{(t3 - t2) * 1e3:.2f} ms); stage {(t5 - t3) * 1e3:.2f} ms = "
            f"scatter tables {(t4 - t3) * 1e3:.2f} ms ({c_scat['h2d']} "
            f"uploads) + chunk tables {tab_ms:.2f} ms ({c_tab['h2d']} "
            f"uploads, {c_tab['h2d_bytes'] / 2**20:.1f} MiB, "
            f"{c_tab['h2d_bytes'] / tab_ms / 1e6:.2f} GB/s host to card)")


def main_data(args, rng, api):
    """Phase 4's workload (§ the module docstring): the arrays, their
    ``CompressedArray``s, the distinct columns, and the texts' arrays."""
    target = int(args.gib * (1 << 30))
    t0 = time.perf_counter()
    n_text = int(args.text_mib * (1 << 20))
    text, tokens = log_corpus(rng, n_text, n_text // 4)
    [text_ca] = api.compress_many([text], "tdeflate", CHUNK_BYTES)
    text_s = time.perf_counter() - t0
    text_copies = -(-args.td_chunks // text_ca.blobs[0].num_chunks)
    t0 = time.perf_counter()
    [hf_ca] = api.compress_many([text], "huffman", CHUNK_BYTES)
    hf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    [lz_ca] = api.compress_many([tokens], "lzss", CHUNK_BYTES)
    lz_s = time.perf_counter() - t0
    hf_copies = -(-args.ent_chunks // hf_ca.blobs[0].num_chunks)
    lz_copies = -(-args.ent_chunks // lz_ca.blobs[0].num_chunks)
    rest = max(1 << 20, target - text_copies * text.nbytes)
    col_bytes = min(32 << 20, max(1 << 20, rest // 30))
    t0 = time.perf_counter()
    cols = scan_columns(rng, col_bytes)
    distinct = api.compress_many([a for _, a, _ in cols],
                                 [c for _, _, c in cols], CHUNK_BYTES)
    encode_s = time.perf_counter() - t0
    per_copy = sum(a.nbytes for _, a, _ in cols)
    copies = -(-rest // per_copy)
    arrays = ([a for _, a, _ in cols] * copies + [text] * text_copies
              + [text] * hf_copies + [tokens] * lz_copies)
    cas = (distinct * copies + [text_ca] * text_copies + [hf_ca] * hf_copies
           + [lz_ca] * lz_copies)
    log(f"   {len(cols)} distinct columns ({per_copy / 2**20:.0f} MiB, "
        f"encoded in {encode_s:.1f} s) listed {copies}x, and "
        f"{text.nbytes / 2**20:.1f} MiB of log text (tdeflate ratio "
        f"{text_ca.ratio:.4f}, encoded in {text_s:.1f} s) listed "
        f"{text_copies}x; the same text through huffman (ratio "
        f"{hf_ca.ratio:.4f}, {hf_s:.1f} s) listed {hf_copies}x, and its "
        f"{tokens.size} u32 token ids through lzss (ratio {lz_ca.ratio:.4f}, "
        f"{lz_s:.1f} s) listed {lz_copies}x: {len(cas)} arrays, "
        f"{sum(len(ca.blobs) for ca in cas)} blobs")
    return dict(arrays=arrays, cas=cas, cols=cols, distinct=distinct,
                text=text, tokens=tokens, text_ca=text_ca, hf_ca=hf_ca,
                lz_ca=lz_ca)


def phase_main(args, rng, api, plan_mod, transfers, registry, harness,
               kmods, counters, engine, errs):
    log("== 4 main path: compress_many -> decompress_many(device_out=True) "
        "on cuda")
    data = main_data(args, rng, api)
    arrays, cas = data["arrays"], data["cas"]
    out_bytes = sum(a.nbytes for a in arrays)
    comp_bytes = sum(ca.compressed_bytes for ca in cas)
    flat = [b for ca in cas for b in ca.blobs]
    log("   DecodePlan.build and stage by part (host clock):")
    build_stage_parts(plan_mod, kmods["fmt"], kmods["ops"], transfers, flat,
                      engine.device)
    t0 = time.perf_counter()
    plan = plan_mod.DecodePlan.build(flat)
    build_ms = (time.perf_counter() - t0) * 1e3
    n_groups = plan.num_dispatches
    log(f"   {plan.num_chunks} chunks, {n_groups} groups")

    # one call through the user's entry point, counted
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    outs = api.decompress_many(cas, engine, device_out=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: c.read() for k, c in counters.items()}
    if sum(launches.values()) != n_groups:
        raise AssertionError(f"kernel launches grew by "
                             f"{sum(launches.values())}, expected {n_groups}"
                             " (one per plan group)")
    missing = [k for k, v in launches.items()
               if v < 1 and k != "dequant_matmul"]
    if missing:
        raise AssertionError(f"not launched on the main path: {missing}")
    log(f"   launches grew by {sum(launches.values())} == {n_groups} plan "
        f"groups {launches}; first call {first_s * 1e3:.1f} ms (plan build, "
        "staging, decode)")
    # checked on the host only now, after the counted call
    for i, (a, o) in enumerate(zip(arrays, outs)):
        if o.device != engine.device:
            raise AssertionError(f"array {i} came back on {o.device}")
        got = o.cpu().numpy()
        if got.dtype != a.dtype or not np.array_equal(got, a):
            raise AssertionError(f"array {i} ({a.dtype}) differs from input")
    log(f"   {len(outs)} arrays bit-exact against the numpy inputs")
    del outs

    # end-to-end call time (host clock; includes plan build and staging)
    e2e = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        o = api.decompress_many(cas, engine, device_out=True)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
        del o
    # decode time of a staged plan, under the no-host-transfer guard
    t0 = time.perf_counter()
    with transfers.count_host_transfers() as h2d:
        plan.stage(engine.device)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    plan.execute_device(engine)
    torch.cuda.synchronize()

    def run_staged():
        with transfers.no_host_transfers():
            plan.execute_device(engine)

    dec_ms = ms_of(run_staged, args.reps)
    bound = sum(bound_ms(g.key[0], int(g.merged.comp_lens.sum()),
                         g.num_chunks, g.key[2], g.key[1])
                for g in plan.groups)
    log(f"   output {out_bytes / 2**30:.3f} GiB, compressed "
        f"{comp_bytes / 2**20:.1f} MiB (ratio {comp_bytes / out_bytes:.4f})")
    log(f"   decompress_many end to end: median "
        f"{np.median(e2e) * 1e3:.2f} ms over {args.reps}; of one call, "
        f"DecodePlan.build {build_ms:.2f} ms and stage {stage_ms:.2f} ms "
        f"({h2d['h2d']} uploads, {h2d['h2d_bytes'] / 2**20:.1f} MiB; host "
        "clock, once each)")
    log(f"   staged decode (execute_device, no host transfers): median "
        f"{dec_ms:.3f} ms over {args.reps} = "
        f"{out_bytes / dec_ms / 1e6:.1f} GB/s of output; bytes bound "
        f"{bound:.3f} ms ({bound / dec_ms * 100:.1f}% of it)")
    log("   library_ms: null for every decode kernel: no single PyTorch "
        "call decodes RLE, dbp, bitpack, Deflate-semantics, Huffman or LZSS "
        "streams")

    # per plan group: kernel time, plain version time, bound, on the main
    # path's own staged tables
    per = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "plain_rows": 0} for k in KERNELS}
    for gi, g in enumerate(plan.groups):
        codec, width, chunk_elems, bits = g.key
        dev = plan._staged[engine.device][gi]
        spec = registry.get(codec).decode
        inputs = spec.chunk_inputs(dev)
        lens = dev["out_lens"]
        consts = harness.consts_on(spec, lens.device)
        kw = dict(chunk_elems=chunk_elems, width=width, bits=bits)
        cap = {"tdeflate": args.td_plain_rows, "lzss": args.lz_plain_rows}
        rows = min(g.num_chunks, cap.get(codec, g.num_chunks))
        out_k = spec.cuda(inputs, consts, lens, **kw)[:rows]   # also warms
        k_ms = ms_of(lambda: spec.cuda(inputs, consts, lens, **kw), args.reps)
        d_ms = device_ms(lambda: spec.cuda(inputs, consts, lens, **kw),
                         args.reps)
        cut = tuple(t[:rows] for t in inputs)
        res = {}
        plain_ms = ms_of(lambda: res.update(
            p=spec.body(cut, consts, lens[:rows], **kw)), 1)
        err = max_abs_err(out_k, res.pop("p"))
        del out_k
        torch.cuda.empty_cache()
        name = kernel_of(codec)
        errs[name] = max(errs[name], err)
        b = bound_ms(codec, int(g.merged.comp_lens.sum()), g.num_chunks,
                     chunk_elems, width)
        per[name]["ms"] += k_ms
        per[name]["device_ms"] += d_ms
        per[name]["plain_ms"] += plain_ms
        per[name]["bound_ms"] += b
        per[name]["plain_rows"] += rows
        extra = ""
        if codec in kmods["cuda_rle"].CODEC_IDS:
            grp = torch.zeros(g.num_chunks, dtype=torch.int32,
                              device=lens.device)
            kmods["cuda_rle"].decode(codec, inputs[0], lens,
                                     chunk_elems=chunk_elems, width=width,
                                     groups=grp)
            mean = float(grp.to(torch.float64).mean())
            ns = k_ms * 1e6 / max(1.0, mean * g.num_chunks)
            extra = (f", groups per chunk mean {mean:.1f} max "
                     f"{int(grp.max())} ({ns:.3f} ns a group)")
        if codec in ("tdeflate", "lzss"):
            tok = torch.zeros(g.num_chunks, dtype=torch.int32,
                              device=lens.device)
            if codec == "tdeflate":
                kmods["tdeflate"].decode(inputs[0], inputs[1:], consts, lens,
                                         chunk_elems=chunk_elems, tokens=tok)
            else:
                kmods["lzss"].decode(inputs[0], lens, chunk_elems=chunk_elems,
                                     width=width, tokens=tok)
            mean = float(tok.to(torch.float64).mean())
            rate = mean * g.num_chunks / k_ms / 1e6
            extra = (f", tokens per chunk mean {mean:.1f} max "
                     f"{int(tok.max())} ({rate:.3f} G tokens/s)")
        log(f"   group {g.key}: {g.num_chunks} chunks, kernel {k_ms:.3f} ms "
            f"(device {d_ms:.3f} ms), bound {b:.3f} ms "
            f"({b / k_ms * 100:.1f}%), plain {plain_ms:.1f} "
            f"ms on {rows} rows, max_abs_err {err}{extra}")
        if err:
            raise AssertionError(f"group {g.key}: kernel differs from plain")
    return launches, per, data


def phase_epilogue(args, api, fmt, registry, harness, engine, data) -> None:
    """Epilogues through ``decompress_many`` against their plain torch
    versions (each fused, in the kernel's stores), then the fused decode
    timed against the kernel followed by ``Epilogue.apply``."""
    log("== 5 epilogues against their plain torch versions")
    dev = engine.device

    def operands_on(operands):
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in operands.items()}

    def check(name, ca, x, epi, operands):
        before = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
        [got] = api.decompress_many([ca], engine, device_out=True,
                                    epilogue=epi, epilogue_operands=operands)
        grew = (harness.EPILOGUE_FUSED - before[0],
                harness.EPILOGUE_UNFUSED - before[1])
        if grew != (len(ca.blobs), 0):
            raise AssertionError(f"{name}: fused / unfused epilogues grew by "
                                 f"{grew}")
        out = getattr(torch, epi.out_dtype or "float32")
        x = torch.from_numpy(x).to(dev)
        want = x.to(out)
        if epi.zero_key:
            want = want - torch.tensor(operands[epi.zero_key],
                                       device=dev).to(out)
        if epi.scale_key:
            want = want * torch.tensor(operands[epi.scale_key],
                                       device=dev).to(out)
        if got.dtype != want.dtype or not torch.equal(bit_view(got),
                                                      bit_view(want)):
            raise AssertionError(f"{name}: epilogue output differs from the "
                                 "plain torch version")
        log(f"   {name}: {x.numel()} elements -> {got.dtype}, exact against "
            "the plain torch version (epilogue in the kernel's stores)")

    def timed(name, ca, epi, operands):
        """The fused decode against the kernel followed by Epilogue.apply,
        on the array's staged table (median of ``--reps``)."""
        [blob] = ca.blobs
        d = {**fmt.to_device(blob, dev), **operands_on(operands)}
        spec = registry.get(blob.codec).decode
        bits = registry.get(blob.codec).static_bits(blob)
        kw = dict(width=blob.width, chunk_elems=blob.chunk_elems, bits=bits)
        inputs, lens = spec.chunk_inputs(d), d["out_lens"]
        consts = harness.consts_on(spec, lens.device)

        def fused():
            return harness.run(spec, d, backend="cuda", epilogue=epi, **kw)

        def unfused():
            return epi.apply(spec.cuda(inputs, consts, lens, **kw), d)

        if not torch.equal(bit_view(fused()), bit_view(unfused())):
            raise AssertionError(f"{name}: fused != kernel + Epilogue.apply")
        f_ms, u_ms = ms_of(fused, args.reps), ms_of(unfused, args.reps)
        plain_ms = ms_of(lambda: spec.cuda(inputs, consts, lens, **kw),
                         args.reps)
        out_mib = blob.num_chunks * blob.chunk_elems * blob.width / 2**20
        log(f"   {name}: {blob.num_chunks} chunks ({out_mib:.1f} MiB raw), "
            f"fused {f_ms:.3f} ms vs kernel + Epilogue.apply {u_ms:.3f} ms "
            f"({u_ms / f_ms:.2f}x; the kernel alone {plain_ms:.3f} ms)")

    cols, distinct = data["cols"], data["distinct"]
    names = [n for n, _, _ in cols]
    affine = dict(scale_key="epi_scale", zero_key="epi_zero")
    f32 = harness.Epilogue(out_dtype="float32", **affine)
    bf16 = harness.Epilogue(out_dtype="bfloat16", **affine)
    idx = names.index("flags_u8")
    rle_ops = {"epi_scale": np.float32(0.37), "epi_zero": np.uint8(2)}
    check("rle_v2 u8 column, float32 (x - zero) * scale", distinct[idx],
          cols[idx][1], f32, rle_ops)
    idx16 = names.index("dict_codes_u16")
    check("bitpack 11-bit u16 column, float32 (x - zero) * scale",
          distinct[idx16], cols[idx16][1], f32,
          {"epi_scale": np.float32(0.0123), "epi_zero": np.uint16(1024)})
    text, tokens = data["text"], data["tokens"]
    text_ops = {"epi_scale": np.float32(0.37), "epi_zero": np.uint8(97)}
    check("huffman log text, bf16 (x - zero) * scale", data["hf_ca"], text,
          bf16, text_ops)
    check("tdeflate log text, bf16 (x - zero) * scale", data["text_ca"],
          text, bf16, text_ops)
    tok_ops = {"epi_scale": np.float32(0.5), "epi_zero": np.uint32(3)}
    check("lzss token shard, float32 (x - zero) * scale", data["lz_ca"],
          tokens, f32, tok_ops)
    timed("rle_v2 flags_u8 column, f32 affine", distinct[idx], f32, rle_ops)
    timed("tdeflate log text, bf16 affine", data["text_ca"], bf16, text_ops)
    timed("lzss token shard, f32 affine", data["lz_ca"], f32, tok_ops)


def phase_quantized(args, rng, dq, harness, transfers, counters, engine, errs,
                    per) -> dict:
    """decompress_dequant_matmul over every projection of ``--q-layers``
    layers of qwen3-1.7B; returns the path's launch counts."""
    log("== 6 quantized-weight path: decompress_dequant_matmul, qwen3-1.7B "
        f"widths, {args.q_layers} layers, W4A16")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = engine.device
    t0 = time.perf_counter()
    weights = []      # (name, K, N, CompressedArray, int8 host, scale)
    for layer in range(args.q_layers):
        for name, k, n in QWEN3_PROJECTIONS:
            w = rng.standard_normal((k, n), dtype=np.float32) * np.float32(
                0.02)
            # symmetric per-output-channel int4: [-8, 7]
            scale = np.abs(w).max(axis=0, keepdims=True) / np.float32(7)
            q = np.clip(np.rint(w / scale), -8, 7).astype(np.int8)
            ca = dq.compress_weights(q, "bitpack", zero_point=8)
            weights.append((f"{layer}.{name}", k, n, ca, q,
                            torch.from_numpy(scale).to(dev)))
    enc_s = time.perf_counter() - t0
    raw = sum(q.nbytes for *_, q, _ in weights)
    comp = sum(ca.compressed_bytes for _, _, _, ca, _, _ in weights)
    log(f"   {len(weights)} projections, {raw / 2**20:.1f} MiB of int8 "
        f"weights, {comp / 2**20:.1f} MiB bitpacked at "
        f"{8 * comp / raw:.2f} bits a weight (made and encoded in "
        f"{enc_s:.1f} s)")
    ms_list = Q_BATCHES
    xs = {(m, k): torch.from_numpy(rng.standard_normal((m, k),
                                                       dtype=np.float32))
          .to(dev).to(torch.bfloat16)
          for m in ms_list for k in {k for _, k, _ in QWEN3_PROJECTIONS}}

    # one run of the path through the user's entry point, counted
    for c in counters.values():
        c.reset()
    harness.EPILOGUE_FUSED = harness.EPILOGUE_UNFUSED = 0
    by_path = dict(dq.LAUNCHES_BY_PATH)
    ys = {}
    for m in ms_list:
        for name, k, n, ca, q, s in weights:
            ys[m, name] = dq.decompress_dequant_matmul(
                xs[m, k], ca, s, zero_point=8, engine=engine)
    torch.cuda.synchronize()
    launches = {k: c.read() for k, c in counters.items()}
    want = {k: 0 for k in launches}
    want["dequant_matmul"] = want["bitpack_unpack"] = len(ys)
    if launches != want:
        raise AssertionError(f"quantized path launches {launches}, expected "
                             f"{want}")
    epilogues = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
    if epilogues != (len(ys), 0):
        raise AssertionError(f"quantized path epilogues (fused, unfused) "
                             f"{epilogues}, expected ({len(ys)}, 0)")
    paths = {p: v - by_path[p] for p, v in dq.LAUNCHES_BY_PATH.items()}
    if paths != {"wgmma": len(ys), "simt": 0}:
        raise AssertionError(f"quantized path took {paths}, expected every "
                             "call on the wgmma path")
    log(f"   {len(ys)} calls (M = {ms_list}): launches dequant_matmul "
        f"{launches['dequant_matmul']} (paths {paths}), bitpack_unpack "
        f"{launches['bitpack_unpack']}, each weight decode one launch with "
        f"its zero-point epilogue fused ({epilogues[0]} fused, "
        f"{epilogues[1]} unfused epilogue passes)")

    rtol, atol = TOL[torch.bfloat16]
    worst = 0.0
    for name, k, n, ca, q, s in weights:
        qd = dq.decode_weights(ca, zero_point=8, engine=engine)
        if qd.dtype != torch.int8 or not np.array_equal(qd.cpu().numpy(), q):
            raise AssertionError(f"{name}: decoded weights differ")
        for m in ms_list:
            got = ys.pop((m, name)).float()
            ref = dq.ref_dequant_matmul(xs[m, k], qd, s).float()
            torch.testing.assert_close(got, ref, rtol=rtol, atol=atol,
                                       msg=lambda e: f"{name} M={m}: {e}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} M={m}: non-finite output")
            worst = max(worst, float((got - ref).abs().max()))
    errs["dequant_matmul"] = max(errs["dequant_matmul"], worst)
    log(f"   every output finite and within rtol {rtol} atol {atol} of the "
        f"plain version on the decoded weights (max_abs_err {worst:.3g}); "
        "decoded weights == the host int8 weights")

    # steady state: the plan is cached on each CompressedArray
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "library_ms": 0.0}
    by = {"bytes": 0.0, "operations": 0.0}
    for m in ms_list:
        acc = {"decode": 0.0, "kernel": 0.0, "plain": 0.0, "library": 0.0,
               "bound": 0.0, "whole": 0.0, "device": 0.0}
        for name, k, n, ca, q, s in weights:
            x = xs[m, k]
            qd = dq.decode_weights(ca, zero_point=8, engine=engine)
            w = (qd.float() * s).to(torch.bfloat16)

            def guarded(fn):
                def run():
                    with transfers.no_host_transfers():
                        fn()
                return run

            fns = {
                "decode": guarded(lambda: dq.decode_weights(
                    ca, zero_point=8, engine=engine)),
                "kernel": guarded(lambda: dq.dequant_matmul(x, qd, s)),
                "whole": guarded(lambda: dq.decompress_dequant_matmul(
                    x, ca, s, zero_point=8, engine=engine)),
                "plain": lambda: dq.ref_dequant_matmul(x, qd, s),
                "library": lambda: torch.matmul(x, w),
            }
            t = {}
            for key, fn in fns.items():
                fn()                    # warm: cuBLAS picks its algorithm
                t[key] = ms_of(fn, args.reps)
            t["device"] = device_ms(fns["kernel"], args.reps)
            b, what = matmul_bound(m, n, k, x.element_size())
            t["bound"] = b
            by[what] += b
            for key, v in t.items():
                acc[key] += v
            if name.startswith("0."):
                log(f"   M={m} {name} (K,N)=({k},{n}): decode "
                    f"{t['decode']:.4f} ms, kernel {t['kernel']:.4f} ms, "
                    f"decode+kernel {t['whole']:.4f} ms, plain "
                    f"{t['plain']:.4f} ms, torch.matmul {t['library']:.4f} "
                    f"ms, bound {b:.4f} ms ({what}, "
                    f"{b / t['kernel'] * 100:.1f}%)")
        log(f"   M={m}, all {len(weights)} projections (sums of medians of "
            f"{args.reps}): decode {acc['decode']:.3f} ms, kernel "
            f"{acc['kernel']:.3f} ms (device {acc['device']:.3f} ms), "
            f"decode+kernel {acc['whole']:.3f} ms, "
            f"plain {acc['plain']:.3f} ms, torch.matmul {acc['library']:.3f} "
            f"ms, bound {acc['bound']:.3f} ms "
            f"({acc['bound'] / acc['kernel'] * 100:.1f}% of the kernel); "
            "steady state under no_host_transfers()")
        tot["ms"] += acc["kernel"]
        tot["device_ms"] += acc["device"]
        tot["plain_ms"] += acc["plain"]
        tot["bound_ms"] += acc["bound"]
        tot["library_ms"] += acc["library"]
        log(f"   M={m}: kernel / torch.matmul = "
            f"{acc['kernel'] / acc['library']:.2f} (sums of medians)")

    # the weight decode's split: the host clock of the whole decode_weights
    # call (it returns once the launch is queued) against the device time
    # of its launch, by CUDA events with the stream held busy until the
    # launch is queued (so the events see no host gap)
    host, device = [], []
    for _, k, n, ca, _, _ in weights:
        def decode():
            with transfers.no_host_transfers():
                dq.decode_weights(ca, zero_point=8, engine=engine)

        h = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode()
            h.append((time.perf_counter() - t0) * 1e3)
        host.append(float(np.median(h)))
        device.append(device_ms(decode, args.reps))
    packed = sum(ca.compressed_bytes for _, _, _, ca, _, _ in weights)
    decode_bound = (packed + raw) / HBM_BYTES_PER_S * 1e3
    log(f"   weight decode split over all {len(weights)} projections (sums "
        f"of medians of {args.reps}): host clock of decode_weights "
        f"{sum(host):.3f} ms, device time of its launch {sum(device):.3f} "
        f"ms, bytes bound {decode_bound:.3f} ms (packed read + int8 "
        f"written); per projection {sum(host) / len(weights) * 1e3:.1f} us "
        f"host, {sum(device) / len(weights) * 1e3:.1f} us device")
    per["bitpack_unpack"]["weight_decode_host_ms"] = sum(host)
    per["bitpack_unpack"]["weight_decode_device_ms"] = sum(device)

    # one sweep over every projection a rep: the int8 weights (and the
    # bf16 ones of torch.matmul) exceed the L2 cache, so each sweep reads
    # them from device memory, as a serving step does
    decoded = [(dq.decode_weights(ca, zero_point=8, engine=engine), s, k)
               for _, k, _, ca, _, s in weights]
    deq = [(qd.float() * s).to(torch.bfloat16) for qd, s, _ in decoded]
    sweep = {}
    for m in ms_list:
        def kern_sweep():
            for qd, s, k in decoded:
                dq.dequant_matmul(xs[m, k], qd, s)

        def lib_sweep():
            for (_, _, k), w in zip(decoded, deq):
                torch.matmul(xs[m, k], w)

        kern_sweep()
        lib_sweep()
        sweep[m] = (ms_of(kern_sweep, args.reps), ms_of(lib_sweep, args.reps))
        log(f"   M={m}, one sweep over all {len(weights)} projections "
            f"(median of {args.reps}, weights from device memory): kernel "
            f"{sweep[m][0]:.3f} ms, torch.matmul {sweep[m][1]:.3f} ms "
            f"({sweep[m][0] / sweep[m][1]:.2f}x)")
    del decoded, deq
    per["dequant_matmul"].update(
        tot, plain_rows=None, bound_by=max(by, key=by.get),
        sweep_ms=sum(k for k, _ in sweep.values()),
        library_sweep_ms=sum(lib for _, lib in sweep.values()))
    return launches


def expected_planes(a: np.ndarray, n: int) -> list:
    """What each of an array's ``n`` blobs decodes to: the array, or the lo
    and hi uint32 planes of an 8-byte dtype."""
    if n == 1:
        return [a]
    u64 = np.ascontiguousarray(a).reshape(-1).view(np.uint64)
    return [(u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u64 >> np.uint64(32)).astype(np.uint32)]


def same(got, want: np.ndarray) -> bool:
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    return got.dtype == want.dtype and np.array_equal(
        np.ascontiguousarray(got).reshape(-1).view(np.uint8),
        np.ascontiguousarray(want).reshape(-1).view(np.uint8))


def phase_service(args, api, fmt, ops, transfers, server, store, engine,
                  data, counters):
    """The serving layer: phase 4's arrays through one DecompressionService
    from 8 producer threads, twice; ``decompress_many`` through the default
    service beside the direct plan path; then a checkpoint-scale restore of
    every blob through the tiered store."""
    import tempfile
    import threading
    log("== 7 service: DecompressionService, default_service, TieredBlobStore")
    arrays, cas = data["arrays"], data["cas"]
    out_bytes = sum(a.nbytes for a in arrays)
    n_threads = 8

    def serve(svc, label):
        """Two passes of every request from ``n_threads`` producers."""
        prev = svc.stats()
        walls = []
        for rnd in (1, 2):
            results = [None] * len(cas)
            failed = []

            def producer(tid):
                try:
                    for i in range(tid, len(cas), n_threads):
                        results[i] = svc.submit_array(
                            cas[i], device_out=i % 2 == 1).result(timeout=600)
                except Exception as e:   # reported below, never swallowed
                    failed.append(f"request {i}: {e!r}")

            threads = [threading.Thread(target=producer, args=(t,))
                       for t in range(n_threads)]
            with transfers.count_host_transfers() as moved:
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(900)
                wall = time.perf_counter() - t0
            if failed or any(t.is_alive() for t in threads):
                raise AssertionError(f"service {label} pass {rnd}: "
                                     f"{failed[:3]}")
            st = svc.stats()
            bad = [i for i, (a, r) in enumerate(zip(arrays, results))
                   if r is None
                   or isinstance(r, torch.Tensor) != (i % 2 == 1)
                   or (isinstance(r, torch.Tensor)
                       and r.device != engine.device)
                   or not same(r, a)]
            if bad or st.errors:
                raise AssertionError(f"service {label} pass {rnd}: arrays "
                                     f"{bad[:5]} differ, {st.errors} errors")
            del results
            w = st.windows - prev.windows
            hits = st.cache_hits - prev.cache_hits
            looks = hits + st.cache_misses - prev.cache_misses
            log(f"   {label} pass {rnd}: {len(cas)} requests "
                f"({len(cas) // 2} device_out) from {n_threads} threads, {w} "
                f"windows, {(st.blobs - prev.blobs) / w:.2f} blobs and "
                f"{(st.dispatches - prev.dispatches) / w:.2f} dispatches a "
                f"window, dispatch amplification "
                f"{(st.dispatches - prev.dispatches) / (st.blobs - prev.blobs):.3f}"
                f", cache hit rate {hits / max(1, looks):.3f}; staged "
                f"{moved['h2d_bytes'] / 2**20:.1f} MiB in {moved['h2d']} "
                f"uploads; wall {wall * 1e3:.1f} ms = "
                f"{out_bytes / wall / 1e9:.2f} GB/s of output; all bit-exact")
            prev = st
            walls.append(wall * 1e3)
        log(f"   {label}, both passes: request latency p50 "
            f"{st.latency_p50_ms:.2f} ms, p99 {st.latency_p99_ms:.2f} ms; "
            f"dispatch amplification {st.dispatch_amplification:.3f}; "
            f"{st.device_dispatches}")
        return walls

    # pow2 buckets (the reference's default) against none, in turns
    # (bucketed, unbucketed, unbucketed, bucketed), a fresh service each:
    # the buckets' padding cost on the card
    for c in counters.values():
        c.reset()
    walls = {True: [], False: []}
    for bucket in (True, False, False, True):
        svc = server.DecompressionService(
            engine, cache_bytes=256 << 20, bucket_shapes=bucket,
            devices=[engine.device])
        walls[bucket].append(serve(
            svc, "bucket_shapes=True" if bucket else "bucket_shapes=False"))
        svc.close(timeout=60)
        if bucket and len(walls[True]) == 1:
            launched = {k: c.read() for k, c in counters.items()}
            missing = [k for k, v in launched.items()
                       if v < 1 and k != "dequant_matmul"]
            if missing:
                raise AssertionError(f"not launched by the service: "
                                     f"{missing}")
            log(f"   launches of the first service: {launched}")
    log("   service wall, pass 1 / pass 2 (ms): bucketed "
        + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in walls[True])
        + "; unbucketed "
        + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in walls[False]))

    # one-shot host decodes: the default service against the direct plan,
    # in turns (service, direct, direct, service), each call's outputs
    # dropped before the next
    ms = {"service": [], "direct": []}
    for path in ("service", "direct", "direct", "service"):
        with ops.count_dispatches() as calls:
            t0 = time.perf_counter()
            outs = (api.decompress_many(cas) if path == "service"
                    else api.decompress_many(cas, engine))
            ms[path].append((time.perf_counter() - t0) * 1e3)
        if len(calls) != len({fmt.group_key(b) for ca in cas
                              for b in ca.blobs}) or not all(
                same(o, a) for o, a in zip(outs, arrays)):
            raise AssertionError(f"decompress_many ({path}): {len(calls)} "
                                 "dispatches, or outputs differ")
        del outs
    log(f"   api.decompress_many(cas) via default_service(): {len(calls)} "
        f"dispatches, {ms['service'][0]:.1f} / {ms['service'][1]:.1f} ms; "
        f"direct plan (engine=): the same dispatches, "
        f"{ms['direct'][0]:.1f} / {ms['direct'][1]:.1f} ms (in turns: "
        "service, direct, direct, service); host outputs bit-exact")

    # checkpoint-scale restore: every blob through the tiered store
    blobs = [(b, w) for ca, a in zip(cas, arrays)
             for b, w in zip(ca.blobs, expected_planes(a, len(ca.blobs)))]
    keys = [f"step_1/blob{i:03d}" for i in range(len(blobs))]
    window = STORE_WINDOW
    with tempfile.TemporaryDirectory() as root:
        backend = store.FilesystemBackend(root)
        writer = store.TieredBlobStore(backend)
        t0 = time.perf_counter()
        sizes = [writer.put(k, b) for k, (b, _) in zip(keys, blobs)]
        write_s = time.perf_counter() - t0
        writer.close()
        wins = [sum(sizes[i:i + window]) for i in range(0, len(keys), window)]
        pair = max(x + y for x, y in zip(wins, wins[1:] + [0]))
        low = 0.8
        budget = max(STORE_BUDGET, int(pair / low) + 1)
        st = store.TieredBlobStore(backend, host_budget_bytes=budget,
                                   low_watermark=low)
        svc = server.DecompressionService(engine, cache_bytes=0, store=st)
        bad = []
        t0 = time.perf_counter()
        for i, objs in enumerate(st.stream_windows(keys, window=window,
                                                   release=False)):
            wkeys = keys[i * window:(i + 1) * window]
            futs = [svc.submit_key(k) for k in wkeys]
            for j, f in enumerate(futs):
                if not same(f.result(timeout=600),
                            blobs[i * window + j][1]):
                    bad.append(wkeys[j])
            del objs, futs
        restore_s = time.perf_counter() - t0
        s = st.stats()
        svc.close(timeout=60)
        st.close()
    if bad or s.backend_fetches != len(keys) or s.host_evictions < 1:
        raise AssertionError(f"store restore: {len(bad)} blobs differ, "
                             f"{s.backend_fetches} fetches for {len(keys)} "
                             f"keys, {s.host_evictions} evictions")
    log(f"   store: {len(keys)} blobs ({sum(sizes) / 2**20:.1f} MiB pickled, "
        f"written in {write_s:.2f} s) restored through "
        f"TieredBlobStore(host_budget_bytes={budget / 2**20:.1f} MiB; two "
        f"windows of {window} reach {pair / 2**20:.1f} MiB) + "
        f"stream_windows(window={window}) + submit_key: "
        f"{s.backend_fetches} fetches (each key once), {s.host_evictions} "
        f"evictions, host hit rate {s.host_hit_rate:.3f}, "
        f"{restore_s:.2f} s; all bit-exact")


class Counter:
    """A kernel's launch count on the main path: reset, then read."""

    def __init__(self, module, codec=None):
        self.module, self.codec = module, codec

    def reset(self) -> None:
        if self.codec is None:
            self.module.LAUNCHES = 0
        else:
            self.module.CODEC_LAUNCHES[self.codec] = 0

    def read(self) -> int:
        if self.codec is None:
            return self.module.LAUNCHES
        return self.module.CODEC_LAUNCHES[self.codec]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gib", type=float, default=1.0,
                    help="uncompressed GiB decoded by the main-path call")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--text-mib", type=float, default=8.0,
                    help="MiB of distinct log text encoded with tdeflate")
    ap.add_argument("--td-chunks", type=int, default=2048,
                    help="least chunks in the main path's tdeflate group")
    ap.add_argument("--td-plain-rows", type=int, default=256,
                    help="rows of the tdeflate group the plain version "
                    "decodes (its lockstep body syncs once per token step)")
    ap.add_argument("--ent-chunks", type=int, default=1024,
                    help="least chunks in each of the main path's huffman "
                    "and lzss groups")
    ap.add_argument("--lz-plain-rows", type=int, default=64,
                    help="rows of the lzss group the plain version decodes "
                    "(its token parse syncs once per token step)")
    ap.add_argument("--q-layers", type=int, default=4,
                    help="qwen3-1.7B layers of the quantized-weight path")
    ap.add_argument("--stage-only", action="store_true",
                    help="only time DecodePlan.build and stage by part on "
                    "phase 4's workload (cold, then warm), and stop")
    ap.add_argument("--src", type=Path, default=None,
                    help="with --stage-only: the directory holding another "
                    "checkout's repro_torch package, to time its staging "
                    "alike")
    args = ap.parse_args()
    if args.src is not None and not args.stage_only:
        ap.error("--src needs --stage-only")
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    src = (args.src or ROOT / "src").resolve()
    if not all((src / "repro_torch" / "csrc" / f).exists()
               for f, _ in SOURCES.values()):
        print(f"FAIL: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.core import api, encoders as enc, format as fmt
    from repro_torch.core import plan as plan_mod, registry, transfers
    from repro_torch.core.engine import CodagEngine
    from repro_torch.kernels import (bitpack, cuda_build, cuda_rle, harness,
                                     huffman, lzss, ops, tdeflate)
    from repro_torch.kernels import dequant_matmul as dq

    rng = np.random.default_rng(args.seed)
    phase_env()
    if args.stage_only:
        log(f"== 4 DecodePlan.build and stage by part only, package under "
            f"{src}")
        data = main_data(args, rng, api)
        device = torch.device("cuda", torch.cuda.current_device())
        torch.zeros(1, device=device)     # the CUDA context, before timing
        torch.cuda.synchronize()
        build_stage_parts(plan_mod, fmt, ops, transfers,
                          [b for ca in data["cas"] for b in ca.blobs], device)
        return 0
    from repro_torch.core import server, store
    phase_build(cuda_build, [cuda_rle.LIB, *cuda_rle.LIB_EPI.values(),
                             bitpack.LIB, tdeflate.LIB,
                             huffman.LIB, lzss.LIB, dq.LIB])
    engine = CodagEngine()
    errs = {k: 0 for k in KERNELS}
    counters = {kernel_of(c): Counter(cuda_rle, c) for c in cuda_rle.CODEC_IDS}
    counters["bitpack_unpack"] = Counter(bitpack)
    counters["tdeflate_decode"] = Counter(tdeflate)
    counters["huffman_decode"] = Counter(huffman)
    counters["lzss_decode"] = Counter(lzss)
    counters["dequant_matmul"] = Counter(dq)
    phase_kernel_vs_plain(rng, fmt, enc, registry, harness, errs,
                          engine.device, counters)
    phase_dequant_vs_plain(rng, dq, errs, engine.device)
    launches, per, data = phase_main(
        args, rng, api, plan_mod, transfers, registry, harness,
        {"tdeflate": tdeflate, "lzss": lzss, "cuda_rle": cuda_rle,
         "fmt": fmt, "ops": ops}, counters,
        engine, errs)
    phase_epilogue(args, api, fmt, registry, harness, engine, data)
    launches["dequant_matmul"] = phase_quantized(
        args, rng, dq, harness, transfers, counters, engine, errs,
        per)["dequant_matmul"]
    phase_service(args, api, fmt, ops, transfers, server, store, engine, data,
                  counters)
    log("== 8 kernels")
    kernels = []
    for name in KERNELS:
        source, replaces = SOURCES.get(
            name, ("two_phase_rle.cu", "src/repro/kernels/harness.py:359"))
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": per[name]["ms"],
            "device_ms": per[name]["device_ms"],
            "plain_ms": per[name]["plain_ms"],
            "plain_rows": per[name]["plain_rows"],
            "bound_ms": per[name]["bound_ms"],
            "bound_by": per[name].get("bound_by", "bytes"),
            "library_ms": per[name].get("library_ms"),
            **{k: per[name][k] for k in ("sweep_ms", "library_sweep_ms",
                                         "weight_decode_host_ms",
                                         "weight_decode_device_ms")
               if k in per[name]},
        })
        exact = name != "dequant_matmul"    # held to TOL in phases 3 and 6
        if kernels[-1]["launches"] < 1 or (exact and errs[name]):
            raise AssertionError(f"{name}: not launched on the main path, or "
                                 "differs from its plain version")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
