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

tdeflate (Deflate semantics, chunk-local window, LSB-first bitstream,
  canonical length-limited (<=12 bit) Huffman over the deflate litlen(286)
  and distance(30) alphabets; codes stored bit-reversed so the decoder can
  index a flat LUT with a 12-bit peek)

bitpack  (b bits/elem, LSB-first into uint32 words)

huffman  (canonical length-limited (<=12 bit) Huffman over bytes, with a gap
  array: every SUB-symbol segment starts at a bit offset stored in a 5-byte
  entry at the front of the chunk, so segments decode independently)

lzss     (element-granular LZSS: byte-aligned control tokens, literal runs of
  1..128 elements and matches of 2..129 elements at a u16 element distance)

The dbp encoder lives in its plugin, ``kernels/dbp.py``, as in the
reference.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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


def encode_rle_groups(codec: str, groups: List[Tuple],
                      width: int) -> Tuple[bytes, np.ndarray]:
    """One rle_v1 / rle_v2 / dbp row from a group list, and the elements it
    decodes to (uint32, truncated to the width).  For rows no encoder
    writes in that order (a group placed at a chosen byte offset, short
    runs back to back, 256-field dbp groups).  Groups:

      ``("run", n, v)``             rle_v1 3..130, rle_v2 3..66 elements
      ``("lit", values)``           rle_v1 1..128, rle_v2 1..64 elements
      ``("delta", n, base, d)``     rle_v2, 3..66 elements of base + d*k
      ``("long", n, v)``            rle_v2, a run of 3..16386
      ``("dbp", bits, ref, fields)`` dbp, 1..256 fields of 1..32 bits
      ``("fill", nbytes)``          literal groups (dbp: 8-bit groups) of
                                    exactly ``nbytes`` bytes, to place the
                                    next group at a chosen offset
    """
    mask = (1 << (8 * width)) - 1
    out, vals = bytearray(), []
    groups = [x for g in groups for x in (
        _fill_groups(codec, g[1], width) if g[0] == "fill" else [g])]

    def value(v) -> bytes:
        return (int(v) & mask).to_bytes(width, "little")

    for g in groups:
        kind = g[0]
        if kind == "lit":
            v = [int(x) & mask for x in np.asarray(g[1]).tolist()]
            top = RLE1_MAX_LIT if codec == fmt.RLE_V1 else RLE2_MAX_LIT
            if codec == fmt.DBP or not 1 <= len(v) <= top:
                raise ValueError(f"{codec}: literal group of {len(v)}")
            out.append(256 - len(v) if codec == fmt.RLE_V1
                       else (2 << 6) | (len(v) - 1))
            out.extend(b"".join(value(x) for x in v))
            vals += v
        elif kind == "run" and codec == fmt.RLE_V1:
            _, n, v = g
            if not RLE1_MIN_RUN <= n <= RLE1_MAX_RUN:
                raise ValueError(f"rle_v1: run of {n}")
            out.append(n - RLE1_MIN_RUN)
            out.extend(value(v))
            vals += [int(v) & mask] * n
        elif kind in ("run", "delta", "long") and codec == fmt.RLE_V2:
            n, base = g[1], g[2]
            d = g[3] if kind == "delta" else 0
            top = RLE2_MAX_LONG if kind == "long" else RLE2_MAX_SHORT
            if not RLE2_MIN_RUN <= n <= top:
                raise ValueError(f"rle_v2: {kind} of {n}")
            if kind == "long":
                out += bytes([(3 << 6) | ((n - 3) >> 8), (n - 3) & 0xFF])
            else:
                out.append((int(kind == "delta") << 6) | (n - 3))
            out.extend(value(base))
            if kind == "delta":
                out.extend(value(d))
            vals += [(int(base) + int(d) * k) & 0xFFFFFFFF & mask
                     for k in range(n)]
        elif kind == "dbp" and codec == fmt.DBP:
            _, bits, ref, fields = g
            f = np.asarray(fields, np.uint64)
            if not (1 <= f.size <= 256 and 1 <= bits <= 32):
                raise ValueError(f"dbp: {f.size} fields of {bits} bits")
            f = f & np.uint64((1 << bits) - 1)
            out += bytes([bits, f.size - 1]) + value(ref)
            out.extend(pack_bits(f, bits).tobytes()[:(f.size * bits + 7) // 8])
            vals += [(int(ref) & mask) + int(x) & 0xFFFFFFFF & mask
                     for x in f.tolist()]
        else:
            raise ValueError(f"{codec}: no group {kind!r}")
    return bytes(out), np.array(vals, np.uint32)


def _fill_groups(codec: str, nbytes: int, width: int) -> List[Tuple]:
    """Groups whose encoding takes exactly ``nbytes`` bytes (see
    :func:`encode_rle_groups`); values k mod 251."""
    if codec == fmt.DBP:       # 8-bit fields: a group of n is 2 + width + n
        lo, hi, per = 3 + width, 258 + width, 1
    else:                      # a literal group of n is 1 + n * width
        top = RLE1_MAX_LIT if codec == fmt.RLE_V1 else RLE2_MAX_LIT
        lo, hi, per = 1 + width, 1 + top * width, width
    k = -(-nbytes // hi)       # the fewest groups, then the residue mod per
    while k * lo <= nbytes and (nbytes - k * (lo - per)) % per:
        k += 1
    if nbytes and (k * lo > nbytes or (nbytes - k * (lo - per)) % per):
        raise ValueError(f"{codec}: no fill of {nbytes} bytes")
    sizes, rest = [], nbytes
    for i in range(k, 0, -1):  # largest first, leaving each later group lo
        size = min(hi, rest - (i - 1) * lo)
        size -= (size - lo) % per
        sizes.append(size)
        rest -= size
    out = []
    for size in sizes:
        n = (size - lo) // per + 1
        v = [j % 251 for j in range(n)]
        out.append(("dbp", 8, 0, v) if codec == fmt.DBP else ("lit", v))
    return out


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
# tdeflate: LZ77 + canonical length-limited Huffman
# --------------------------------------------------------------------------

MAX_CODE_BITS = 12
LUT_SIZE = 1 << MAX_CODE_BITS
EOB = 256
NUM_LITLEN = 286
NUM_DIST = 30
MIN_MATCH = 3
MAX_MATCH = 258

# deflate length code table: code 257+i -> (extra_bits, base_length)
LEN_EXTRA = np.array([0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,4,4,5,5,5,5,0], np.int32)
LEN_BASE = np.array([3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,35,43,51,59,67,83,99,115,131,163,195,227,258], np.int32)
DIST_EXTRA = np.array([0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,9,10,10,11,11,12,12,13,13], np.int32)
DIST_BASE = np.array([1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,257,385,513,769,1025,1537,2049,3073,4097,6145,8193,12289,16385,24577], np.int32)


def _length_code(l: int) -> int:
    return int(np.searchsorted(LEN_BASE, l, side="right")) - 1


def _dist_code(dist: int) -> int:
    return int(np.searchsorted(DIST_BASE, dist, side="right")) - 1


def limited_huffman_lengths(freqs: np.ndarray, max_bits: int = MAX_CODE_BITS) -> np.ndarray:
    """Optimal-ish Huffman code lengths limited to ``max_bits`` (zlib-style)."""
    n = freqs.shape[0]
    active = np.flatnonzero(freqs > 0)
    lengths = np.zeros(n, np.int32)
    if active.size == 0:
        return lengths
    if active.size == 1:
        lengths[active[0]] = 1
        return lengths
    # Build Huffman tree with a simple two-queue merge.
    import heapq

    heap = [(int(freqs[i]), int(i), 0) for i in active]  # (freq, id, depth-tag)
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
    # Length-limit with Kraft fix-up.
    if lengths.max() > max_bits:
        lengths = np.minimum(lengths, max_bits)
        # Kraft sum in units of 2^-max_bits
        kraft = int(np.sum((1 << (max_bits - lengths[lengths > 0])).astype(np.int64)))
        limit = 1 << max_bits
        # overflow: demote shortest overfull codes (increase length)
        order = np.argsort(lengths + (lengths == 0) * 1000, kind="stable")
        while kraft > limit:
            # find a symbol with length < max_bits and increment it
            for i in order[::-1]:
                li = lengths[i]
                if 0 < li < max_bits:
                    lengths[i] = li + 1
                    kraft -= 1 << (max_bits - li - 1)
                    break
            else:  # pragma: no cover
                raise RuntimeError("kraft fixup failed")
        # underflow: promote (shorten) to use slack — optional, skip (valid code)
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
        l = int(lengths[sym])
        if l:
            codes[sym] = next_code[l]
            next_code[l] += 1
    return codes


def _bit_reverse(v: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


def build_decode_lut(lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Flat (sym, nbits) LUT indexed by a MAX_CODE_BITS LSB-first peek."""
    codes = canonical_codes(lengths)
    lut_sym = np.zeros(LUT_SIZE, np.int16)
    lut_bits = np.zeros(LUT_SIZE, np.int8)
    for sym in range(lengths.shape[0]):
        l = int(lengths[sym])
        if not l:
            continue
        rc = _bit_reverse(int(codes[sym]), l)
        step = 1 << l
        for v in range(rc, LUT_SIZE, step):
            lut_sym[v] = sym
            lut_bits[v] = l
    return lut_sym, lut_bits


class _BitWriter:
    __slots__ = ("buf", "acc", "nbits")

    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int) -> None:
        self.acc |= (value & ((1 << bits) - 1)) << self.nbits
        self.nbits += bits
        while self.nbits >= 8:
            self.buf.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nbits -= 8

    def finish(self) -> bytes:
        if self.nbits:
            self.buf.append(self.acc & 0xFF)
            self.acc, self.nbits = 0, 0
        return bytes(self.buf)


def _lz77_tokens(data: bytes) -> List[Tuple]:
    """Greedy LZ77 with a hash-of-4 chain (single probe + extension)."""
    n = len(data)
    tokens: List[Tuple] = []
    head: Dict[int, int] = {}
    i = 0
    mv = memoryview(data)
    while i < n:
        if i + MIN_MATCH + 1 <= n:
            key = data[i] | (data[i + 1] << 8) | (data[i + 2] << 16) | (data[i + 3] << 24) if i + 4 <= n else data[i] | (data[i + 1] << 8) | (data[i + 2] << 16)
            cand = head.get(key, -1)
            head[key] = i
            if cand >= 0 and i - cand <= DIST_BASE[-1] + (1 << DIST_EXTRA[-1]) - 1:
                # extend match
                m = 0
                lim = min(MAX_MATCH, n - i)
                while m < lim and data[cand + m] == data[i + m]:
                    m += 1
                if m >= MIN_MATCH:
                    tokens.append(("m", m, i - cand))
                    # insert a few hash entries inside the match for better chains
                    end = min(i + m, n - 4)
                    for j in range(i + 1, min(i + 4, end)):
                        k2 = data[j] | (data[j + 1] << 8) | (data[j + 2] << 16) | (data[j + 3] << 24)
                        head[k2] = j
                    i += m
                    continue
        tokens.append(("l", data[i]))
        i += 1
    del mv
    return tokens


def encode_tdeflate_chunk(x: np.ndarray) -> Tuple[bytes, np.ndarray, np.ndarray]:
    """Encode a uint8 chunk. Returns (payload, litlen_lengths, dist_lengths)."""
    return encode_tdeflate_tokens(_lz77_tokens(x.astype(np.uint8).tobytes()))


def encode_tdeflate_tokens(tokens: List[Tuple]) -> Tuple[bytes, np.ndarray,
                                                         np.ndarray]:
    """Huffman-code a token list (``("l", byte)`` / ``("m", length,
    dist)``), then EOB.  Returns (payload, litlen_lengths, dist_lengths)."""
    # symbol frequencies
    lfreq = np.zeros(NUM_LITLEN, np.int64)
    dfreq = np.zeros(NUM_DIST, np.int64)
    for t in tokens:
        if t[0] == "l":
            lfreq[t[1]] += 1
        else:
            lfreq[257 + _length_code(t[1])] += 1
            dfreq[_dist_code(t[2])] += 1
    lfreq[EOB] += 1
    llen = limited_huffman_lengths(lfreq)
    dlen = limited_huffman_lengths(dfreq)
    lcodes = canonical_codes(llen)
    dcodes = canonical_codes(dlen)
    # pre-reverse codes for LSB-first emission
    lrev = [(_bit_reverse(int(lcodes[s]), int(llen[s])), int(llen[s])) for s in range(NUM_LITLEN)]
    drev = [(_bit_reverse(int(dcodes[s]), int(dlen[s])), int(dlen[s])) for s in range(NUM_DIST)]
    w = _BitWriter()
    for t in tokens:
        if t[0] == "l":
            c, nb = lrev[t[1]]
            w.write(c, nb)
        else:
            _, length, dist = t
            lc = _length_code(length)
            c, nb = lrev[257 + lc]
            w.write(c, nb)
            eb = int(LEN_EXTRA[lc])
            if eb:
                w.write(length - int(LEN_BASE[lc]), eb)
            dc = _dist_code(dist)
            c, nb = drev[dc]
            w.write(c, nb)
            eb = int(DIST_EXTRA[dc])
            if eb:
                w.write(dist - int(DIST_BASE[dc]), eb)
    c, nb = lrev[EOB]
    w.write(c, nb)
    return w.finish(), llen.astype(np.uint8), dlen.astype(np.uint8)


# --------------------------------------------------------------------------
# bitpack
# --------------------------------------------------------------------------


def pack_bits(x: np.ndarray, bits: int) -> np.ndarray:
    """Pack non-negative ints (< 2^bits) LSB-first into uint32 words."""
    assert 1 <= bits <= 32
    n = x.shape[0]
    x = x.astype(np.uint64) & ((1 << bits) - 1)
    total_bits = n * bits
    nwords = (total_bits + 31) // 32
    out = np.zeros(nwords + 1, np.uint64)  # +1 slack for spill
    idx = np.arange(n, dtype=np.uint64) * bits
    word = (idx >> 5).astype(np.int64)
    off = (idx & 31).astype(np.uint64)
    lo = (x << off) & np.uint64(0xFFFFFFFF)
    shift = (np.uint64(32) - off) % np.uint64(64)
    hi = np.where(off > 0, x >> shift, np.uint64(0))
    # Bit-fields of distinct elements are disjoint, so scatter-add == OR.
    np.add.at(out, word, lo)
    np.add.at(out, word + 1, hi)
    return (out[:nwords] & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def encode_bitpack_chunk(x: np.ndarray, bits: int) -> bytes:
    return pack_bits(x.astype(np.uint64), bits).tobytes()


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


def tdeflate_blob(arr: np.ndarray, encoded: List[Tuple], chunk_bytes: int,
                  total_bytes: int) -> fmt.CompressedBlob:
    """A tdeflate blob from per-chunk ``(payload, llen, dlen)``: the
    payloads plus each chunk's decode LUTs and code-length headers."""
    luts_ls, luts_lb, luts_ds, luts_db = [], [], [], []
    for _, llen, dlen in encoded:
        ls, lb = build_decode_lut(llen.astype(np.int32))
        ds, db = build_decode_lut(dlen.astype(np.int32))
        luts_ls.append(ls); luts_lb.append(lb)
        luts_ds.append(ds); luts_db.append(db)
    extras = {
        "lut_lsym": np.stack(luts_ls), "lut_lbits": np.stack(luts_lb),
        "lut_dsym": np.stack(luts_ds), "lut_dbits": np.stack(luts_db),
        "hdr_llen": np.stack([e[1] for e in encoded]),
        "hdr_dlen": np.stack([e[2] for e in encoded]),
    }
    return fmt.build_blob(fmt.TDEFLATE, arr, [e[0] for e in encoded],
                          chunk_bytes, 1, extras, total_elems=total_bytes)


def compress_tdeflate(arr: np.ndarray,
                      chunk_bytes: int = fmt.DEFAULT_CHUNK_BYTES,
                      bits: int | None = None) -> fmt.CompressedBlob:
    chunks, chunk_elems, width, _ = fmt.chunk_array(arr, chunk_bytes)
    # tdeflate is a byte codec: re-chunk at byte granularity
    chunks = [np.ascontiguousarray(c).view(np.uint8) for c in chunks]
    encoded = [encode_tdeflate_chunk(c) for c in chunks]
    return tdeflate_blob(arr, encoded, chunk_elems * width,
                         sum(int(c.shape[0]) for c in chunks))


def compress_bitpack(arr: np.ndarray,
                     chunk_bytes: int = fmt.DEFAULT_CHUNK_BYTES,
                     bits: int | None = None) -> fmt.CompressedBlob:
    chunks, chunk_elems, width, _ = fmt.chunk_array(arr, chunk_bytes)
    if bits is None:
        maxv = max((int(c.max()) for c in chunks if c.size), default=0)
        bits = max(1, maxv.bit_length())
    encoded = [encode_bitpack_chunk(c, bits) for c in chunks]
    extras = {"bitpack_bits": np.full((1,), bits, np.int32)}
    return fmt.build_blob(fmt.BITPACK, arr, encoded, chunk_elems, width, extras)


# --------------------------------------------------------------------------
# huffman: gap-array canonical Huffman over bytes
# --------------------------------------------------------------------------

HUFFMAN_SUB = 32            # symbols per self-synchronizing segment
GAP_ENTRY_BYTES = 5         # u32 LE bit offset + (count - 1) byte


def _pack_lsb(vals: np.ndarray, nbits: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """Pack variable-width fields LSB-first. Returns (payload, start bits).

    Same disjoint-bit-field scatter as :func:`pack_bits`, generalized to
    per-field widths: field bit ranges never overlap, so scatter-add is
    scatter-or and each uint64 accumulator word stays below 2^43.
    """
    nbits = nbits.astype(np.int64)
    ends = np.cumsum(nbits)
    starts = ends - nbits
    total = int(ends[-1]) if ends.size else 0
    nwords = (total + 31) // 32
    acc = np.zeros(nwords + 2, np.uint64)
    v = vals.astype(np.uint64)
    word = (starts >> 5).astype(np.int64)
    off = (starts & 31).astype(np.uint64)
    np.add.at(acc, word, (v << off) & np.uint64(0xFFFFFFFF))
    np.add.at(acc, word + 1, np.where(off > 0, v >> (np.uint64(32) - off),
                                      np.uint64(0)))
    payload = acc[:nwords].astype(np.uint32).tobytes()[: (total + 7) // 8]
    return payload, starts


def encode_huffman_chunk(data: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """Encode one uint8 chunk. Returns (gap table + payload, code lengths)."""
    data = np.ascontiguousarray(data).view(np.uint8)
    lens = limited_huffman_lengths(
        np.bincount(data, minlength=256).astype(np.int64), MAX_CODE_BITS)
    n = data.shape[0]
    if n == 0:
        return b"", lens.astype(np.uint8)
    codes = canonical_codes(lens)
    # pre-reversed for LSB-first emission, indexed by byte value
    rev = np.array([_bit_reverse(int(codes[s]), int(lens[s]))
                    for s in range(256)], np.uint64)
    payload, starts = _pack_lsb(rev[data], lens[data])
    nseg = (n + HUFFMAN_SUB - 1) // HUFFMAN_SUB
    gap_bits = nseg * GAP_ENTRY_BYTES * 8
    head = np.empty((nseg, GAP_ENTRY_BYTES), np.uint8)
    head[:, :4] = (gap_bits + starts[::HUFFMAN_SUB]).astype("<u4") \
        .view(np.uint8).reshape(nseg, 4)
    head[:, 4] = (np.minimum(HUFFMAN_SUB, n - np.arange(nseg) * HUFFMAN_SUB)
                  - 1).astype(np.uint8)
    return head.tobytes() + payload, lens.astype(np.uint8)


def compress_huffman(arr: np.ndarray,
                     chunk_bytes: int = fmt.DEFAULT_CHUNK_BYTES,
                     bits: int | None = None) -> fmt.CompressedBlob:
    chunks, chunk_elems, width, _ = fmt.chunk_array(arr, chunk_bytes)
    # byte codec: re-chunk at byte granularity (like tdeflate)
    chunks = [np.ascontiguousarray(c).view(np.uint8) for c in chunks]
    payloads, hlens, lut_s, lut_b = [], [], [], []
    for c in chunks:
        p, hl = encode_huffman_chunk(c)
        payloads.append(p)
        hlens.append(hl)
        s, b = build_decode_lut(hl.astype(np.int32))
        lut_s.append(s)
        lut_b.append(b)
    extras = {
        "hdr_hlens": np.stack(hlens),
        "lut_hsym": np.stack(lut_s),
        "lut_hbits": np.stack(lut_b),
    }
    total_bytes = sum(int(c.shape[0]) for c in chunks)
    return fmt.build_blob(fmt.HUFFMAN, arr, payloads, chunk_elems * width, 1,
                          extras, total_elems=total_bytes)


# --------------------------------------------------------------------------
# lzss: greedy hash-of-2 chain over elements (single probe)
# --------------------------------------------------------------------------

LZSS_MIN_MATCH = 2
LZSS_MAX_MATCH = LZSS_MIN_MATCH + 127   # 129 elements
LZSS_MAX_LIT = 128
LZSS_MAX_DIST = 65535


def encode_lzss_chunk(x: np.ndarray, width: int) -> bytes:
    xs = np.ascontiguousarray(x).astype(np.uint32)
    vals = xs.tolist()
    n = len(vals)
    out = bytearray()
    head: dict = {}

    def flush(lo: int, hi: int) -> None:
        i = lo
        while i < hi:
            k = min(LZSS_MAX_LIT, hi - i)
            out.append(k - 1)
            out.extend(_values_bytes(xs[i:i + k], width))
            i += k

    i, lit = 0, 0
    while i < n:
        m, dist = 0, 0
        if i + LZSS_MIN_MATCH <= n:
            key = (vals[i], vals[i + 1])
            cand = head.get(key, -1)
            head[key] = i
            if cand >= 0 and i - cand <= LZSS_MAX_DIST:
                lim = min(LZSS_MAX_MATCH, n - i)
                while m < lim and vals[cand + m] == vals[i + m]:
                    m += 1
                dist = i - cand
        # profitable only if the 3 token bytes undercut the literal bytes
        if m >= LZSS_MIN_MATCH and m * width > 3:
            flush(lit, i)
            out.append(128 + (m - LZSS_MIN_MATCH))
            out.extend(dist.to_bytes(2, "little"))
            for j in range(i + 1, min(i + 4, i + m, n - LZSS_MIN_MATCH + 1)):
                head[(vals[j], vals[j + 1])] = j
            i += m
            lit = i
        else:
            i += 1
    flush(lit, n)
    return bytes(out)


def encode_lzss_tokens(tokens: List[Tuple], width: int) -> bytes:
    """One lzss row from a token list: ``("l", values)`` is a literal run of
    1..128 elements, ``("m", length, dist)`` a match of 2..129 elements at a
    u16 distance.  For rows no greedy encoder writes (a match at the
    distance limit, or one reaching before the row's start)."""
    out = bytearray()
    for t in tokens:
        if t[0] == "l":
            vals = np.asarray(t[1])
            if not 1 <= vals.size <= LZSS_MAX_LIT:
                raise ValueError(f"literal run of {vals.size} elements")
            out.append(vals.size - 1)
            out.extend(_values_bytes(vals, width))
        else:
            _, length, dist = t
            if not (LZSS_MIN_MATCH <= length <= LZSS_MAX_MATCH
                    and 0 <= dist <= LZSS_MAX_DIST):
                raise ValueError(f"match ({length}, {dist}) out of range")
            out.append(128 + length - LZSS_MIN_MATCH)
            out.extend(int(dist).to_bytes(2, "little"))
    return bytes(out)


def compress_lzss(arr: np.ndarray,
                  chunk_bytes: int = fmt.DEFAULT_CHUNK_BYTES,
                  bits: int | None = None) -> fmt.CompressedBlob:
    chunks, chunk_elems, width, _ = fmt.chunk_array(arr, chunk_bytes)
    encoded = [encode_lzss_chunk(c, width) for c in chunks]
    return fmt.build_blob(fmt.LZSS, arr, encoded, chunk_elems, width)


def compress(arr: np.ndarray, codec: str,
             chunk_bytes: int | None = None,
             bits: int | None = None) -> fmt.CompressedBlob:
    """Encode ``arr`` through the codec registry.

    ``chunk_bytes=None`` (the default) resolves the tuned chunk size for
    this (codec, element width) on the current device kind from the
    tuned-defaults table (``core.tuning``), falling back to
    ``format.DEFAULT_CHUNK_BYTES``; an explicit value always wins.
    """
    if chunk_bytes is None:
        from repro_torch.core import tuning
        chunk_bytes = tuning.chunk_bytes_for(
            codec, tuning.encode_width(codec, arr.dtype))
        if chunk_bytes is None:
            chunk_bytes = fmt.DEFAULT_CHUNK_BYTES
    return registry.get(codec).encode(arr, chunk_bytes, bits=bits)
