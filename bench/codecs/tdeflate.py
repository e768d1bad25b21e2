"""tdeflate (Deflate semantics, chunk-local window), frozen: the encoder the
benchmark's inputs are made with, and the plain inflate loop the tests hold
it to.

A copy of the port's ``encode_tdeflate_chunk`` and of the blob extras that
``tdeflate_blob`` writes, as they stand when this benchmark was written;
``bench/tests/test_bench_frozen.py`` holds it byte for byte to the
committed golden vectors.  A chunk is an LSB-first bit stream of canonical
length-limited (<= 12 bit) Huffman codes over the deflate litlen (286) and
distance (30) alphabets, codes stored bit-reversed; each chunk carries its
code lengths (``hdr_llen``, ``hdr_dlen``) and the flat 12-bit decode LUTs
built from them.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np

CODEC = "tdeflate"
PLANE_SPLIT_64 = False    # a byte codec: 8-byte columns are their bytes
BYTE_STREAM = True        # chunked in the column's width, coded as bytes

MAX_CODE_BITS = 12
LUT_SIZE = 1 << MAX_CODE_BITS
EOB = 256
NUM_LITLEN = 286
NUM_DIST = 30
MIN_MATCH = 3
MAX_MATCH = 258

LEN_EXTRA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3,
                      3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0], np.int32)
LEN_BASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
                     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227,
                     258], np.int32)
DIST_EXTRA = np.array([0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7,
                       8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13], np.int32)
DIST_BASE = np.array([1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                      193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                      6145, 8193, 12289, 16385, 24577], np.int32)
MAX_DIST = int(DIST_BASE[-1]) + (1 << int(DIST_EXTRA[-1])) - 1


# the length code of each match length and the distance code of each
# distance, looked up instead of searched
LEN_CODE = (np.searchsorted(LEN_BASE, np.arange(MAX_MATCH + 1),
                            side="right") - 1).astype(np.int32)
DIST_CODE = (np.searchsorted(DIST_BASE, np.arange(MAX_DIST + 1),
                             side="right") - 1).astype(np.int32)


def limited_huffman_lengths(freqs: np.ndarray,
                            max_bits: int = MAX_CODE_BITS) -> np.ndarray:
    """Huffman code lengths limited to ``max_bits`` (zlib-style fix-up)."""
    n = freqs.shape[0]
    active = np.flatnonzero(freqs > 0)
    lengths = np.zeros(n, np.int32)
    if active.size == 0:
        return lengths
    if active.size == 1:
        lengths[active[0]] = 1
        return lengths
    heap = [(int(freqs[i]), int(i), 0) for i in active]
    heapq.heapify(heap)
    parent: Dict[int, int] = {}
    next_id = n
    while len(heap) > 1:
        f1, i1, _ = heapq.heappop(heap)
        f2, i2, _ = heapq.heappop(heap)
        parent[i1] = next_id
        parent[i2] = next_id
        heapq.heappush(heap, (f1 + f2, next_id, 0))
        next_id += 1
    for i in active:
        d, j = 0, int(i)
        while j in parent:
            j = parent[j]
            d += 1
        lengths[i] = d
    if lengths.max() > max_bits:
        lengths = np.minimum(lengths, max_bits)
        kraft = int(np.sum((1 << (max_bits - lengths[lengths > 0]))
                           .astype(np.int64)))
        limit = 1 << max_bits
        order = np.argsort(lengths + (lengths == 0) * 1000, kind="stable")
        while kraft > limit:
            for i in order[::-1]:
                li = lengths[i]
                if 0 < li < max_bits:
                    lengths[i] = li + 1
                    kraft -= 1 << (max_bits - li - 1)
                    break
            else:
                raise RuntimeError("kraft fixup failed")
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes (deflate convention: sorted by (length, symbol))."""
    max_len = int(lengths.max()) if lengths.size else 0
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    code = 0
    next_code = np.zeros(max_len + 1, np.int64)
    for bits in range(1, max_len + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    codes = np.zeros_like(lengths, dtype=np.int64)
    for sym in range(lengths.shape[0]):
        length = int(lengths[sym])
        if length:
            codes[sym] = next_code[length]
            next_code[length] += 1
    return codes


def _bit_reverse(v: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


def build_decode_lut(lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Flat (sym, nbits) LUT indexed by a 12-bit LSB-first peek."""
    codes = canonical_codes(lengths)
    lut_sym = np.zeros(LUT_SIZE, np.int16)
    lut_bits = np.zeros(LUT_SIZE, np.int8)
    for sym in range(lengths.shape[0]):
        length = int(lengths[sym])
        if not length:
            continue
        rc = _bit_reverse(int(codes[sym]), length)
        for v in range(rc, LUT_SIZE, 1 << length):
            lut_sym[v] = sym
            lut_bits[v] = length
    return lut_sym, lut_bits


def _pack_bits(values: np.ndarray, bits: np.ndarray) -> bytes:
    """The fields ``values`` (each cut to its ``bits``) written one after
    the other into an LSB-first bit stream, the last byte padded with
    zeros."""
    bits = bits.astype(np.int64)
    total = int(bits.sum())
    field = np.repeat(np.arange(values.shape[0]), bits)
    first = np.repeat(np.cumsum(bits) - bits, bits)
    stream = (values.astype(np.int64)[field] >> (np.arange(total) - first)) & 1
    return np.packbits(stream.astype(np.uint8), bitorder="little").tobytes()


def _lz77_tokens(data: bytes) -> Tuple[List[int], List[int]]:
    """Greedy LZ77 with a hash-of-4 chain (single probe + extension): the
    tokens as (literal byte or match length, distance), distance 0 for a
    literal."""
    n = len(data)
    vals: List[int] = []
    dists: List[int] = []
    if n >= 4:
        a = np.frombuffer(data, np.uint8).astype(np.uint32)
        keys = (a[:-3] | (a[1:-2] << 8) | (a[2:-1] << 16)
                | (a[3:] << 24)).tolist()
    head: Dict[int, int] = {}
    i = 0
    while i < n:
        if i + MIN_MATCH + 1 <= n:
            key = keys[i]
            cand = head.get(key, -1)
            head[key] = i
            if cand >= 0 and i - cand <= MAX_DIST:
                # the keys are the four bytes themselves: those match
                m = 4
                lim = n - i if n - i < MAX_MATCH else MAX_MATCH
                while m < lim and data[cand + m] == data[i + m]:
                    m += 1
                vals.append(m)
                dists.append(i - cand)
                # a few hash entries inside the match, for better chains
                end = i + m if i + m < n - 4 else n - 4
                for j in range(i + 1, i + 4 if i + 4 < end else end):
                    head[keys[j]] = j
                i += m
                continue
        vals.append(data[i])
        dists.append(0)
        i += 1
    return vals, dists


def encode_chunk(x: np.ndarray, width: int = 1):
    """One chunk's payload (its bytes, whatever ``x``'s type), and its code
    lengths as per-chunk extras."""
    vals, dists = _lz77_tokens(np.ascontiguousarray(x).view(np.uint8)
                               .tobytes())
    val = np.asarray(vals, np.int64)
    dist = np.asarray(dists, np.int64)
    match = dist > 0
    lc = np.where(match, LEN_CODE[np.where(match, val, MIN_MATCH)], 0)
    dc = np.where(match, DIST_CODE[dist], 0)
    sym = np.where(match, 257 + lc, val)
    lfreq = np.bincount(sym, minlength=NUM_LITLEN).astype(np.int64)
    dfreq = np.bincount(dc[match], minlength=NUM_DIST).astype(np.int64)
    lfreq[EOB] += 1
    llen = limited_huffman_lengths(lfreq)
    dlen = limited_huffman_lengths(dfreq)
    lcodes = canonical_codes(llen)
    dcodes = canonical_codes(dlen)
    lrev = np.array([_bit_reverse(int(lcodes[s]), int(llen[s]))
                     for s in range(NUM_LITLEN)], np.int64)
    drev = np.array([_bit_reverse(int(dcodes[s]), int(dlen[s]))
                     for s in range(NUM_DIST)], np.int64)
    # four fields a token: its code, the length's extra bits, the
    # distance's code and extra bits (none of the last three for a
    # literal), then end-of-block
    fields = np.stack([lrev[sym], val - LEN_BASE[lc], drev[dc],
                       dist - DIST_BASE[dc]], 1)
    nbits = np.stack([llen[sym], LEN_EXTRA[lc], dlen[dc], DIST_EXTRA[dc]], 1)
    nbits[~match, 1:] = 0
    payload = _pack_bits(
        np.append(fields.reshape(-1), lrev[EOB]),
        np.append(nbits.reshape(-1), llen[EOB]))
    return payload, {"hdr_llen": llen.astype(np.uint8),
                     "hdr_dlen": dlen.astype(np.uint8)}


def blob_extras(per_chunk: list) -> dict:
    """A blob's extras from its chunks' code lengths: the four decode LUTs
    and the two headers, one row a chunk (``tdeflate_blob``'s layout)."""
    luts = {"lut_lsym": [], "lut_lbits": [], "lut_dsym": [], "lut_dbits": []}
    for e in per_chunk:
        ls, lb = build_decode_lut(e["hdr_llen"].astype(np.int32))
        ds, db = build_decode_lut(e["hdr_dlen"].astype(np.int32))
        for k, v in zip(luts, (ls, lb, ds, db)):
            luts[k].append(v)
    extras = {k: np.stack(v) for k, v in luts.items()}
    extras["hdr_llen"] = np.stack([e["hdr_llen"] for e in per_chunk])
    extras["hdr_dlen"] = np.stack([e["hdr_dlen"] for e in per_chunk])
    return extras


def _decode_table(lengths: np.ndarray) -> Dict[Tuple[int, int], int]:
    """(code length, canonical code) -> symbol, from the lengths alone."""
    codes = canonical_codes(lengths.astype(np.int32))
    return {(int(lengths[s]), int(codes[s])): s
            for s in range(lengths.shape[0]) if lengths[s]}


def decode_chunk(payload: bytes, extras: dict, width: int,
                 n_out: int) -> np.ndarray:
    """The plain inflate loop: read a code bit by bit (MSB of the code
    first, as deflate stores it), then a literal or a (length, distance)
    match; stop at end-of-block or after ``n_out`` bytes.  It reads only
    the payload and the two code-length headers, not the LUTs."""
    lit = _decode_table(np.asarray(extras["hdr_llen"]))
    dist = _decode_table(np.asarray(extras["hdr_dlen"]))
    bits = np.unpackbits(np.frombuffer(payload, np.uint8), bitorder="little")
    pos = 0

    def read(n: int) -> int:
        nonlocal pos
        v = 0
        for k in range(n):
            v |= int(bits[pos + k]) << k
        pos += n
        return v

    def symbol(table) -> int:
        nonlocal pos
        code = 0
        for length in range(1, MAX_CODE_BITS + 1):
            code = (code << 1) | int(bits[pos])
            pos += 1
            if (length, code) in table:
                return table[(length, code)]
        raise ValueError("invalid code")

    out = bytearray()
    while len(out) < n_out:
        s = symbol(lit)
        if s < 256:
            out.append(s)
        elif s == EOB:
            break
        else:
            lc = s - 257
            length = int(LEN_BASE[lc]) + read(int(LEN_EXTRA[lc]))
            dc = symbol(dist)
            d = int(DIST_BASE[dc]) + read(int(DIST_EXTRA[dc]))
            for _ in range(length):
                out.append(out[-d])
    return np.frombuffer(bytes(out[:n_out]), np.uint8)
