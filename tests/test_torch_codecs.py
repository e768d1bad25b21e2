"""The port's dbp, bitpack and tdeflate decode against the reference.

Every port backend (``torch``, ``oracle``, ``scalar``, and ``cuda``, which
on a CPU tensor runs its plain version) must equal the reference's backend
of the same name bit for bit (``torch`` and ``cuda`` the reference's
``xla``), on seeded data and on the edge rows the CUDA kernels must get
right: empty chunks, one-element tails, dbp groups of 256 32-bit fields,
bitpack at bits 1/7/9/17/32, tdeflate literal-only rows, overlapping
matches, a match reaching before the row's start and a stream cut by an
invalid code.  One tiny case per codec also runs the reference's Pallas
kernel in interpret mode (huffman and lzss too; their edge rows are in
``tests/test_torch_entropy.py``).  All tolerances are zero.  Plus the
public path over all seven codecs, the stream helpers and the kernel
wrappers.
"""
import base64
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import encoders as ref_enc
from repro.core import format as ref_fmt
from repro.core import registry as ref_registry
from repro.core import streams as ref_st
from repro.core.engine import CodagEngine as RefEngine
from repro.core.engine import EngineConfig as RefConfig
from repro.kernels import ops as ref_ops
from repro_torch.core import api, encoders as enc, format as fmt, registry
from repro_torch.core import streams as st
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.kernels import (bitpack, cuda_rle, dbp, harness, huffman,
                                 lzss, ops, tdeflate)

DT = {1: np.uint8, 2: np.uint16, 4: np.uint32}
CPU = CodagEngine(EngineConfig(device="cpu"))
REF = RefEngine(RefConfig())
BITS_WIDTHS = [(b, w) for b in (1, 7, 9, 17, 32) for w in (1, 2, 4)
               if b <= 8 * w]


def _port(ref_blob) -> fmt.CompressedBlob:
    return fmt.blob_from_reference(dataclasses.asdict(ref_blob))


def _reference(table, backend, **kw):
    """The reference package's decode of a port table (same bytes)."""
    ref_blob = ref_fmt.CompressedBlob(**dataclasses.asdict(table))
    dev, bits = ref_ops.table_inputs(ref_blob)
    return np.asarray(ref_ops.decode(
        dev, codec=table.codec, width=table.width,
        chunk_elems=table.chunk_elems, backend=backend, bits=bits, **kw))


def _ours(table, backend):
    dev, bits = ops.table_inputs(table, "cpu")
    return ops.decode(dev, codec=table.codec, width=table.width,
                      chunk_elems=table.chunk_elems, backend=backend,
                      bits=bits).numpy()


def _assert_backends(table, backends=("torch", "cuda", "oracle", "scalar")):
    """Each port backend == the reference's; returns the reference xla."""
    want = {"xla": _reference(table, "xla")}
    for backend in backends:
        ref_name = {"torch": "xla", "cuda": "xla"}.get(backend, backend)
        if ref_name not in want:
            want[ref_name] = _reference(table, ref_name)
        got = _ours(table, backend)
        assert got.dtype == want[ref_name].dtype, backend
        assert np.array_equal(got, want[ref_name]), backend
    return want["xla"]


def _rows(want, table):
    return np.concatenate([want[i, :n] for i, n in enumerate(table.out_lens)])


# --------------------------------------------------------------------------
# streams: bit reads and output writes
# --------------------------------------------------------------------------


def test_peek_bits_matches_reference():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 1 << 32, 9, dtype=np.uint64).astype(np.uint32)
    w64 = st.words_int64(torch.from_numpy(words)[None])
    for n in (0, 1, 5, 12, 13, 17, 32):
        pos = np.array([0, 1, 31, 32, 33, 200, 287, 290, 400], np.int64)
        got = st.peek_bits(w64, torch.from_numpy(pos)[None], n)[0].numpy()
        want = [int(ref_st.peek_bits(ref_st.BitStream(words, np.int32(p)), n))
                for p in pos]
        assert got.tolist() == want, n


@pytest.mark.parametrize("pos,offset,length", [
    (10, 3, 9),      # length > offset: the circular window
    (10, 10, 10),    # from the row's start
    (4, 7, 12),      # before the row's start: the clamped window
    (30, 1, 40),     # one byte repeated
])
def test_memcpy_and_write_from_match_reference(pos, offset, length):
    rng = np.random.default_rng(pos)
    buf = np.zeros(64, np.uint8)
    buf[:pos] = rng.integers(1, 256, pos)
    src = rng.integers(0, 256, 64).astype(np.uint8)
    win = 48
    want_m = ref_st.memcpy(ref_st.OutStream(buf, np.int32(pos)),
                           np.int32(offset), np.int32(length), win)
    want_w = ref_st.write_from(ref_st.OutStream(buf, np.int32(pos)), src,
                               np.int32(5), np.int32(length), win)
    one = torch.ones(1, dtype=torch.bool)
    t = lambda v: torch.tensor([v])  # noqa: E731
    got, p = st.memcpy(torch.from_numpy(buf.copy())[None], t(pos), t(offset),
                       t(length), one, win)
    assert np.array_equal(got[0].numpy(), np.asarray(want_m.buf))
    assert int(p) == int(want_m.pos)
    got, p = st.write_from(torch.from_numpy(buf.copy())[None], t(pos),
                           torch.from_numpy(src)[None], t(5), t(length), one,
                           win)
    assert np.array_equal(got[0].numpy(), np.asarray(want_w.buf))
    # an inactive row keeps its buffer and position
    got, p = st.memcpy(torch.from_numpy(buf.copy())[None], t(pos), t(offset),
                       t(length), ~one, win)
    assert np.array_equal(got[0].numpy(), buf) and int(p) == pos


# --------------------------------------------------------------------------
# dbp
# --------------------------------------------------------------------------


def _dbp_hand_row(rng, width, bits_hdr, count, chunk_elems):
    """One chunk of hand-built dbp groups (the encoder writes 128-element
    groups and widths up to 32)."""
    row = bytearray()
    total = 0
    while total + count <= chunk_elems:
        row += bytes([bits_hdr, count - 1])
        row += rng.integers(0, 1 << (8 * width), dtype=np.uint64).item() \
            .to_bytes(8, "little")[:width]
        row += rng.integers(0, 256, (count * bits_hdr + 7) // 8,
                            dtype=np.uint8).tobytes()
        total += count
    return fmt.CompressedBlob(
        codec="dbp", width=width, chunk_elems=chunk_elems, total_elems=total,
        orig_dtype=str(np.dtype(DT[width])), orig_shape=(total,),
        comp=np.frombuffer(bytes(row), np.uint8)[None].copy(),
        comp_lens=np.array([len(row)], np.int32),
        out_lens=np.array([total], np.int32))


def _dbp_arrays(width, chunk_elems, rng):
    dt, top = DT[width], 1 << (8 * width)
    return [
        np.cumsum(rng.integers(0, 16, 3 * chunk_elems)).astype(dt),
        np.zeros(0, dt),
        rng.integers(0, top, chunk_elems + 1, dtype=np.uint64).astype(dt),
        np.full(chunk_elems // 2, top - 1, np.uint64).astype(dt),
    ]


@pytest.mark.parametrize("width", [1, 2, 4])
def test_dbp_bodies_equal_reference(width):
    rng = np.random.default_rng(20 + width)
    chunk_elems = 1024 // width
    arrays = _dbp_arrays(width, chunk_elems, rng)
    blobs = [_port(ref_enc.compress(a, "dbp", 1024)) for a in arrays]
    table = fmt.concat_blobs(blobs)
    want = _assert_backends(table)
    assert np.array_equal(_rows(want, table), np.concatenate(arrays))
    assert 0 in table.out_lens and 1 in table.out_lens


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("bits_hdr,count", [(32, 256), (40, 9), (0, 256)])
def test_dbp_hand_built_groups(bits_hdr, count, width):
    """256-element groups of 32-bit fields, a header byte above 32 (all 32
    bits kept, as the reference's mask), and zero-bit groups."""
    rng = np.random.default_rng(bits_hdr)
    _assert_backends(_dbp_hand_row(rng, width, bits_hdr, count, 1024))


def test_dbp_count_groups_matches_reference():
    rng = np.random.default_rng(3)
    a = np.cumsum(rng.integers(0, 16, 3000)).astype(np.uint32)
    blob = enc.compress(a, "dbp", 2048)
    ref_count = ref_registry.get("dbp").count_groups
    for row, n in zip(blob.comp, blob.comp_lens):
        assert dbp.count_groups(row[:n], 4) == ref_count(row[:n], 4)


# --------------------------------------------------------------------------
# bitpack
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bits,width", BITS_WIDTHS,
                         ids=[f"b{b}-w{w}" for b, w in BITS_WIDTHS])
def test_bitpack_bodies_equal_reference(bits, width):
    rng = np.random.default_rng(bits * 10 + width)
    chunk_elems = 1024 // width
    dt, top = DT[width], 1 << bits
    arrays = [rng.integers(0, top, 3 * chunk_elems, dtype=np.uint64)
              .astype(dt),
              np.full(chunk_elems + 1, top - 1, np.uint64).astype(dt),
              np.zeros(0, dt)]
    blobs = [_port(ref_enc.compress(a, "bitpack", 1024, bits=bits))
             for a in arrays]
    table = fmt.concat_blobs(blobs)
    want = _assert_backends(table)
    assert np.array_equal(_rows(want, table), np.concatenate(arrays))


# --------------------------------------------------------------------------
# tdeflate
# --------------------------------------------------------------------------


def _text(rng, n):
    words = [b"codag ", b"warp ", b"chunk ", b"decode ", b"the ", b"42 ",
             b"INFO ", b"\n"]
    out = b"".join(words[i] for i in rng.integers(0, len(words), n))
    return np.frombuffer(out[:n], np.uint8).copy()


BEFORE_START = ([("l", 65), ("m", 5, 3), ("l", 66), ("m", 40, 30),
                 ("m", 7, 2)] + [("l", 97 + i % 26) for i in range(200)]
                + [("m", 30, 1400), ("m", 10, 1)])


def _inflate(tokens, chunk):
    """A byte-at-a-time model of the reference's decode: a match's window
    starts at ``cnt - dist``, a negative start plus the buffer's length
    (``chunk + 272``) clamped to ``[0, chunk]``, as ``lax.dynamic_slice``
    places it; byte i reads ``out[start + min(i % dist, 271)]``, zero at or
    past the current position."""
    out = []
    for t in tokens:
        if t[0] == "l":
            out.append(t[1])
            continue
        cnt, start = len(out), len(out) - t[2]
        if start < 0:
            start = min(max(start + chunk + 272, 0), chunk)
        for i in range(t[1]):
            j = start + min(i % t[2], 271)
            out.append(out[j] if j < cnt else 0)
    return np.array(out, np.uint8)


def _before_start_blob():
    """Matches that reach before the row's start: by less than the buffer's
    length (they read zeros) and, at pos 253 with dist 1400, by more (the
    window is clamped to the row's start and reads earlier bytes)."""
    want = _inflate(BEFORE_START, 1024)
    return enc.tdeflate_blob(want, [enc.encode_tdeflate_tokens(BEFORE_START)],
                             1024, want.size), want


def _cut_blob(rng):
    """A stream whose one '~' has no LUT entry: the parse stops there."""
    data = np.concatenate([_text(rng, 500), np.frombuffer(b"~", np.uint8),
                           _text(rng, 400)])
    blob = enc.compress(data, "tdeflate", 1024)
    hit = blob.extras["lut_lsym"] == ord("~")
    blob.extras["lut_lbits"][hit] = 0
    blob.extras["lut_lsym"][hit] = 0
    return blob


def _tdeflate_table(rng):
    arrays = [_text(rng, 2500), rng.integers(0, 256, 700).astype(np.uint8),
              np.zeros(0, np.uint8), _text(rng, 1025),
              np.frombuffer(b"ab" * 600 + b"abcd" * 50, np.uint8).copy()]
    blobs = [_port(ref_enc.compress(a, "tdeflate", 1024)) for a in arrays]
    before, want = _before_start_blob()
    return arrays, want, fmt.concat_blobs(blobs + [before, _cut_blob(rng)])


def test_tdeflate_bodies_equal_reference():
    rng = np.random.default_rng(5)
    arrays, before, table = _tdeflate_table(rng)
    want = _assert_backends(table)
    n_in = sum(-(-a.size // 1024) or 1 for a in arrays)
    data_rows = [want[i, :n] for i, n in enumerate(table.out_lens[:n_in])]
    assert np.array_equal(np.concatenate(data_rows), np.concatenate(arrays))
    assert np.array_equal(want[n_in, :before.size], before)
    assert before[1:6].tolist() == [0] * 5 and before[253:283].any()
    # the cut row: 500 bytes, then zeros
    assert want[-1, :500].any() and not want[-1, 500:].any()


def test_tdeflate_max_cmds_cannot_bind():
    """Alternating 1-byte literals and 3-byte matches, the densest command
    stream: still fewer commands than the cap before out_len is reached."""
    tokens = [("l", 65 + i % 20) if i % 2 == 0 else ("m", 3, 1)
              for i in range(400)]
    n = 200 * 1 + 200 * 3
    blob = enc.tdeflate_blob(np.zeros(n, np.uint8),
                             [enc.encode_tdeflate_tokens(tokens)], n, n)
    assert len(tokens) // 2 + 2 < tdeflate.max_cmds(n)
    _assert_backends(blob, ("torch", "oracle"))


def _golden_arrays(codec):
    payload = json.loads((Path(__file__).parent / "vectors" /
                          f"{codec}.json").read_text())
    return [(v, np.frombuffer(base64.b64decode(v["data_b64"]),
                              np.dtype(v["dtype"])).reshape(v["shape"]))
            for v in payload["vectors"]]


def test_tdeflate_packed_luts_round_trip():
    """The kernel packs each LUT entry into a u16, ``sym | nbits << 9``:
    the reference encoder's LUTs (golden vectors and a log-text chunk) have
    litlen symbols < 512, distance symbols < 30 and code lengths <= 12, so
    all 4,096 entries of each come back unchanged."""
    blobs = [ref_enc.compress(arr, "tdeflate", v["chunk_bytes"])
             for v, arr in _golden_arrays("tdeflate")]
    blobs.append(ref_enc.compress(_text(np.random.default_rng(3), 3000),
                                  "tdeflate", 4096))
    for blob in blobs:
        for row in range(blob.num_chunks):
            lsym, lbits, dsym, dbits = (torch.from_numpy(np.ascontiguousarray(
                blob.extras[k][row])) for k in tdeflate.LUT_KEYS)
            assert lsym.shape == (enc.LUT_SIZE,) == dsym.shape
            assert 0 <= int(lsym.min()) and int(lsym.max()) < 512
            assert 0 <= int(dsym.min()) and int(dsym.max()) < 30
            for b in (lbits, dbits):
                assert 0 <= int(b.min()) and int(b.max()) <= 12
            lit, dist = tdeflate.pack_luts(lsym, lbits, dsym, dbits)
            for packed, sym, bits in ((lit, lsym, lbits), (dist, dsym, dbits)):
                assert 0 <= int(packed.min()) and int(packed.max()) < 1 << 16
                got_sym, got_bits = tdeflate.unpack_luts(packed)
                assert torch.equal(got_sym, sym.to(torch.int32))
                assert torch.equal(got_bits, bits.to(torch.int32))


def test_tdeflate_packed_luts_canonical_symbols():
    """Entries the encoder never writes pack to what the parse does with
    them: a negative litlen symbol is its literal byte, one above 285 is
    285 (length code 28), a distance symbol is clamped to [0, 29]."""
    lsym = torch.tensor([-3, 65, 256, 300, 285], dtype=torch.int16)
    dsym = torch.tensor([-1, 0, 29, 31, 7], dtype=torch.int16)
    bits = torch.tensor([1, 12, 5, 0, 3], dtype=torch.int8)
    lit, dist = tdeflate.pack_luts(lsym, bits, dsym, bits)
    assert tdeflate.unpack_luts(lit)[0].tolist() == [253, 65, 256, 285, 285]
    assert tdeflate.unpack_luts(dist)[0].tolist() == [0, 0, 29, 29, 7]
    assert tdeflate.unpack_luts(lit)[1].tolist() == bits.tolist()


# Hand-built rows for the kernel's 32-token batches
BATCH_ROWS = {
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


def _batch_model(tokens, chunk: int, out_len: int):
    """The kernel's write rule, token by token in batches of 32: a match
    whose reads all lie before the batch's first byte (``hi < bs``) copies
    from the output as it was before the batch (the byte-parallel pass);
    the others copy in token order after it.  Returns (the row, matches of
    the parallel pass, matches in order)."""
    out = np.zeros(chunk, np.uint8)
    limit = min(out_len, chunk)
    cnt, n_par, n_dep = 0, 0, 0

    def copy(c, length, src, dist, source):
        for i in range(length):
            if c + i >= limit:
                break
            j = src + min(i % dist, tdeflate.CMD_WIN - 1)
            out[c + i] = source[j] if j < c and j < limit else 0

    for b0 in range(0, len(tokens), 32):
        if cnt >= out_len:
            break
        bs, before, ordered = cnt, out.copy(), []
        for t in tokens[b0:b0 + 32]:
            if cnt >= out_len:
                break
            if t[0] == "l":
                if cnt < limit:
                    out[cnt] = t[1]
                cnt += 1
                continue
            _, length, dist = t
            src = cnt - dist
            if src < 0:
                src = min(max(src + chunk + tdeflate.CMD_WIN, 0), chunk)
            hi = min(src + min(length, dist, tdeflate.CMD_WIN) - 1, cnt - 1)
            if hi < bs:
                copy(cnt, length, src, dist, before)
                n_par += 1
            else:
                ordered.append((cnt, length, src, dist))
            cnt += length
        for c, length, src, dist in ordered:
            copy(c, length, src, dist, out)
        n_dep += len(ordered)
    return out, n_par, n_dep


@pytest.mark.parametrize("name", ["log_text", *BATCH_ROWS])
def test_tdeflate_batch_rule_model_equals_reference(name):
    """The batch rule, executed on the encoder's own tokens of a text chunk
    and on the hand-built rows, gives the reference's ``decode_chunk``
    output: no match of the parallel pass reads a byte of its own batch."""
    chunk = 4096
    if name == "log_text":
        data = _text(np.random.default_rng(3), chunk)
        tokens = enc._lz77_tokens(data.tobytes())
    else:
        tokens = BATCH_ROWS[name]
    want = _inflate(tokens, chunk)
    blob = enc.tdeflate_blob(want, [enc.encode_tdeflate_tokens(tokens)],
                             chunk, want.size)
    ref = _reference(blob, "xla")[0]
    got, n_par, n_dep = _batch_model(tokens, chunk, want.size)
    assert np.array_equal(got, ref) and np.array_equal(ref[:want.size], want)
    assert n_dep > 0
    if name == "log_text":
        assert np.array_equal(got, data) and n_par > 0


# --------------------------------------------------------------------------
# the reference's Pallas kernels, interpret mode
# --------------------------------------------------------------------------


def _tiny(codec):
    rng = np.random.default_rng(11)
    if codec in ("tdeflate", "huffman"):
        arrays = [_text(rng, 300), np.zeros(0, np.uint8)]
        return fmt.concat_blobs([_port(ref_enc.compress(a, codec, 256))
                                 for a in arrays])
    arrays = [np.cumsum(rng.integers(0, 9, 150)).astype(np.uint16),
              np.arange(3, dtype=np.uint16)]
    return fmt.concat_blobs([_port(ref_enc.compress(a, codec, 128, bits=10))
                             for a in arrays])


@pytest.mark.parametrize("codec", ["dbp", "bitpack", "tdeflate", "huffman",
                                   "lzss"])
def test_plain_kernel_version_equals_reference_pallas(codec):
    table = _tiny(codec)
    want = _reference(table, "pallas", interpret=True)
    assert np.array_equal(_ours(table, "cuda"), want)


# --------------------------------------------------------------------------
# the kernel wrappers
# --------------------------------------------------------------------------


def _staged(codec):
    table = _tiny(codec)
    dev, bits = ops.table_inputs(table, "cpu")
    spec = registry.get(codec).decode
    return (spec, spec.chunk_inputs(dev), harness.consts_on(spec, "cpu"),
            dev["out_lens"], dict(chunk_elems=table.chunk_elems,
                                  width=table.width, bits=bits))


@pytest.mark.parametrize("codec", ["dbp", "bitpack", "tdeflate", "huffman",
                                   "lzss"])
def test_wrapper_runs_plain_version_on_cpu_without_counting(codec):
    spec, inputs, consts, lens, kw = _staged(codec)
    counts = lambda: (cuda_rle.LAUNCHES,  # noqa: E731
                      dict(cuda_rle.CODEC_LAUNCHES), bitpack.LAUNCHES,
                      tdeflate.LAUNCHES, huffman.LAUNCHES, lzss.LAUNCHES)
    before = counts()
    got = spec.cuda(inputs, consts, lens, **kw)
    assert torch.equal(got, spec.body(inputs, consts, lens, **kw))
    assert counts() == before


def test_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises; a meta tensor
    has no kernel."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        bitpack.decode(torch.zeros((2, 4), dtype=torch.uint32, device=meta),
                       chunk_elems=8, width=4, bits=3)
    spec, inputs, consts, lens, kw = _staged("tdeflate")
    with pytest.raises(ValueError, match="no kernel"):
        tdeflate.decode(*(t.to(meta) for t in inputs[:1]),
                        [t.to(meta) for t in inputs[1:]],
                        [t.to(meta) for t in consts], lens.to(meta),
                        chunk_elems=kw["chunk_elems"])


@pytest.mark.parametrize("bad", ["bits", "width", "dtype", "contig"])
def test_bitpack_wrapper_checks_its_inputs(bad):
    words = torch.zeros((3, 8), dtype=torch.uint32)
    kw = dict(chunk_elems=16, width=4, bits=5)
    if bad == "bits":
        kw["bits"] = 33
    elif bad == "width":
        kw["width"] = 8
    elif bad == "dtype":
        words = words.to(torch.int32)
    else:
        words = torch.zeros((8, 3), dtype=torch.uint32).t()
    with pytest.raises(ValueError):
        bitpack.decode(words, **kw)


@pytest.mark.parametrize("bad", ["width", "lut_dtype", "lut_shape",
                                 "tables", "lens", "words"])
def test_tdeflate_wrapper_checks_its_inputs(bad):
    spec, inputs, consts, lens, kw = _staged("tdeflate")
    words, luts, tables = inputs[0], list(inputs[1:]), list(consts)
    width = 1
    if bad == "width":
        width = 2
    elif bad == "lut_dtype":
        luts[0] = luts[0].to(torch.int32)
    elif bad == "lut_shape":
        luts[1] = luts[1][:, :100]
    elif bad == "tables":
        tables[2] = tables[2].to(torch.int64)
    elif bad == "lens":
        lens = lens.to(torch.int64)
    else:
        words = inputs[0].view(torch.int32)
    with pytest.raises(ValueError):
        tdeflate.decode(words, luts, tables, lens,
                        chunk_elems=kw["chunk_elems"], width=width)


def test_new_kernel_builds_are_lazy():
    for lib in (bitpack.LIB, tdeflate.LIB, cuda_rle.LIB):
        assert not lib.loaded and lib.source.exists()


# --------------------------------------------------------------------------
# the public path over all seven codecs
# --------------------------------------------------------------------------


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    ts = np.int64(1_773_000_000_000_000_000) + np.cumsum(
        1_000_000 + rng.integers(-5000, 5000, 600))
    return [
        (np.repeat(rng.integers(0, 50, 80).astype(np.uint32), 9), "rle_v1"),
        (np.cumsum(rng.integers(-3, 4, 700)).astype(np.int32), "rle_v2"),
        (_text(rng, 1500), "tdeflate"),
        (rng.normal(size=300).astype(np.float32), "tdeflate"),
        (rng.integers(0, 1 << 9, 800).astype(np.uint32), "bitpack"),
        (rng.integers(0, 1 << 11, 900).astype(np.uint16), "bitpack"),
        (np.cumsum(rng.integers(0, 16, 1000)).astype(np.uint32), "dbp"),
        (_text(rng, 1300), "huffman"),
        (rng.integers(0, 9, 250).astype(np.uint16), "huffman"),
        (np.tile(rng.integers(0, 99, 40).astype(np.uint32), 30), "lzss"),
        (np.tile(np.arange(5, dtype=np.uint8), 130), "lzss"),
        (ts + np.tile(np.arange(3, dtype=np.int64), 200), "lzss"),
        (ts, "dbp"),
    ]


@pytest.mark.parametrize("device_out", [False, True])
def test_decompress_many_five_codecs_equals_reference(device_out):
    cols = _columns()
    arrays, codecs = [a for a, _ in cols], [c for _, c in cols]
    cas = api.compress_many(arrays, codecs, 512)
    ref_cas = ref_api.compress_many(arrays, codecs, 512)
    outs = api.decompress_many(cas, CPU, device_out=device_out)
    ref_outs = ref_api.decompress_many(ref_cas, REF)
    for a, o, r in zip(arrays, outs, ref_outs):
        o = o.numpy() if device_out else o
        assert o.dtype == a.dtype and o.shape == a.shape
        assert np.array_equal(o.view(np.uint8), a.view(np.uint8))
        assert np.array_equal(o.view(np.uint8), np.asarray(r).view(np.uint8))
    assert len(cas[-1].blobs) == 2            # int64 through dbp planes
    for ca, rca in zip(cas, ref_cas):
        assert [fmt.blob_digest(b) for b in ca.blobs] == \
               [ref_fmt.blob_digest(b) for b in rca.blobs]
    plan_keys = {fmt.group_key(b) for ca in cas for b in ca.blobs}
    with ops.count_dispatches() as calls:
        api.decompress_many(cas, CPU, device_out=True)
    assert len(calls) == len(plan_keys)


@pytest.mark.parametrize("codec", ["dbp", "bitpack", "tdeflate", "huffman",
                                   "lzss"])
def test_reference_blob_carried_across_decodes(codec):
    rng = np.random.default_rng(9)
    arr = (_text(rng, 900) if codec in ("tdeflate", "huffman")
           else np.cumsum(rng.integers(0, 7, 700)).astype(np.uint16))
    rca = ref_api.compress(arr, codec, 256)
    ca = api.CompressedArray(blobs=[_port(b) for b in rca.blobs],
                             orig_dtype=rca.orig_dtype,
                             orig_shape=rca.orig_shape)
    for device_out in (False, True):
        got = api.decompress(ca, CPU, device_out=device_out)
        got = got.numpy() if device_out else got
        assert np.array_equal(got, arr)


@pytest.mark.parametrize("backend", ["cuda", "oracle"])
def test_block_unit_equals_warp_unit_new_codecs(backend):
    cols = _columns(2)[2:]
    cas = api.compress_many([a for a, _ in cols], [c for _, c in cols], 512)
    warp = CodagEngine(EngineConfig(backend=backend, device="cpu"))
    block = CodagEngine(EngineConfig(unit="block", n_units=2, backend=backend,
                                     device="cpu"))
    for w, b in zip(api.decompress_many(cas, warp, device_out=True),
                    api.decompress_many(cas, block, device_out=True)):
        assert torch.equal(w, b)
