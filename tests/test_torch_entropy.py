"""The port's huffman and lzss decode against the reference.

Every port backend (``torch``, ``oracle``, ``scalar``, and ``cuda``, which
on a CPU tensor runs its plain version) must equal the reference's backend
of the same name bit for bit (``torch`` and ``cuda`` the reference's
``xla``), on seeded data and on the edge rows of
``tests/test_entropy_codecs.py``: single-symbol alphabets, codes at the
12-bit cap after the Kraft fix-up, chunk lengths around the 32-symbol
segment, dist-1 and period-3 overlapping matches at widths 1/2/4, int64
planes; plus hand-built lzss rows no encoder writes (a match reaching
before the row's start, a match as the first token, a zero distance, a
stream cut short) and malformed huffman gap tables.  The Pallas-interpret
cases, the plain-version wrappers, reference blobs carried across and the
seven-codec public path are in ``tests/test_torch_codecs.py``.  All
tolerances are zero: this is integer decode.
"""
import dataclasses
import re

import ctypes
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import encoders as ref_enc
from repro.core import format as ref_fmt
from repro.kernels import huffman as ref_hf
from repro.kernels import lzss as ref_lz
from repro_torch.core import api, encoders as enc, format as fmt
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.kernels import (bitpack, cuda_rle, dequant_matmul, huffman,
                                 lzss, tdeflate)

from test_torch_codecs import _assert_backends, _reference, _rows, _staged

DT = {1: np.uint8, 2: np.uint16, 4: np.uint32}
CPU = CodagEngine(EngineConfig(device="cpu"))
RNG_SEED = 17


def _geo(rng, n):
    return np.minimum(rng.geometric(0.3, n) - 1, 255).astype(np.uint8)


def _roundtrip(arr, codec, chunk_bytes):
    """The port's encoding == the reference's, and every port backend
    decodes it to ``arr`` as the reference's backends do."""
    blob = enc.compress(arr, codec, chunk_bytes)
    assert fmt.blob_digest(blob) == ref_fmt.blob_digest(
        ref_enc.compress(arr, codec, chunk_bytes))
    want = _assert_backends(blob)
    flat = _rows(want, blob).view(arr.dtype)
    assert np.array_equal(flat.reshape(arr.shape), arr)
    return blob


# --------------------------------------------------------------------------
# huffman
# --------------------------------------------------------------------------


def test_huffman_single_symbol_alphabet():
    hist = np.bincount(np.full(64, 9, np.uint8), minlength=256)
    lens = enc.limited_huffman_lengths(hist, enc.MAX_CODE_BITS)
    assert lens[9] == 1 and np.count_nonzero(lens) == 1
    for n in (1, 64, 1000):
        _roundtrip(np.full(n, 9, np.uint8), "huffman", 600)


def test_huffman_max_code_length_kraft_fixup():
    counts = [1, 1]
    while len(counts) < 24:
        counts.append(counts[-1] + counts[-2])
    data = np.repeat(np.arange(len(counts), dtype=np.uint8), counts)
    np.random.default_rng(RNG_SEED).shuffle(data)
    lens = enc.limited_huffman_lengths(np.bincount(data, minlength=256),
                                       enc.MAX_CODE_BITS)
    assert lens.max() == enc.MAX_CODE_BITS
    _roundtrip(data[:3000], "huffman", 4096)
    _roundtrip(data[:2500], "huffman", 777)      # multi-chunk + tail


@pytest.mark.parametrize("n", [huffman.SUB - 1, huffman.SUB, huffman.SUB + 1,
                               2 * huffman.SUB, 5 * huffman.SUB + 3])
def test_huffman_gap_segment_boundaries(n):
    data = _geo(np.random.default_rng(n), n)
    blob = _roundtrip(data, "huffman", 1 << 14)
    row = blob.comp[0]
    assert huffman.count_groups(row, 1) == -(-n // huffman.SUB)
    assert huffman.count_groups(row, 1) == ref_hf.CODEC.count_groups(row, 1)


def test_huffman_wide_dtypes_and_byte_tails():
    """A byte codec: u16/u32/int64 arrays are chunked at element sizes that
    leave chunk_elems off the 32-symbol grid (600 and 776 bytes)."""
    rng = np.random.default_rng(3)
    _roundtrip(rng.integers(0, 40, 700).astype(np.uint16), "huffman", 600)
    _roundtrip(rng.integers(0, 9, 333).astype(np.uint32), "huffman", 777)
    _roundtrip(rng.integers(-5, 5, 150).astype(np.int64), "huffman", 512)


def _huffman_bad_gap_table():
    """Gap entries no encoder writes: an offset at or above 2^31 (negative
    as int32), one past the row, and a count byte that overshoots."""
    rng = np.random.default_rng(8)
    blob = enc.compress(_geo(rng, 200), "huffman", 256)
    comp = blob.comp.copy()
    comp[0, 5 * 1 + 3] = 0x80                 # segment 1: negative offset
    comp[0, 5 * 2:5 * 2 + 4] = [0xFF, 0xFF, 0x00, 0x00]  # past the row
    comp[0, 5 * 3 + 4] = 200                  # count byte overshoots
    return dataclasses.replace(blob, comp=comp)


def test_huffman_malformed_gap_table_follows_reference():
    _assert_backends(_huffman_bad_gap_table())


def test_huffman_unused_code_keeps_the_cursor():
    """A LUT entry of length 0 leaves the bit cursor in place."""
    rng = np.random.default_rng(4)
    blob = enc.compress(_geo(rng, 300), "huffman", 512)
    hit = blob.extras["lut_hsym"] == 0
    blob.extras["lut_hbits"][hit] = 0
    _assert_backends(blob)


# --------------------------------------------------------------------------
# lzss
# --------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 2, 4])
def test_lzss_overlapping_backref_dist1(width):
    arr = np.full(500, 7, DT[width])
    tok = enc.encode_lzss_chunk(arr, width)
    assert tok == ref_lz.encode_lzss_chunk(arr, width)
    assert tok[0] == 0 and tok[1 + width] >= 128
    assert int.from_bytes(tok[2 + width:4 + width], "little") == 1
    _roundtrip(arr, "lzss", 600)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.uint32])
def test_lzss_overlapping_backref_period3(dt):
    _roundtrip(np.tile(np.asarray([11, 250, 3], dt), 700), "lzss", 777)


def test_lzss_period3_with_noise_and_int64_planes():
    rng = np.random.default_rng(RNG_SEED)
    arr = np.tile(np.asarray([11, 250, 3], np.uint32), 700)
    arr[rng.integers(0, arr.size, 40)] = rng.integers(0, 1 << 16, 40)
    _roundtrip(arr, "lzss", 913)
    big = np.int64(1 << 40) + np.tile(np.arange(7, dtype=np.int64), 90)
    ca, rca = api.compress(big, "lzss", 512), ref_api.compress(big, "lzss",
                                                               512)
    assert len(ca.blobs) == 2                 # lo/hi u32 planes
    assert [fmt.blob_digest(b) for b in ca.blobs] == \
        [ref_fmt.blob_digest(b) for b in rca.blobs]
    for device_out in (False, True):
        got = api.decompress(ca, CPU, device_out=device_out)
        assert np.array_equal(got.numpy() if device_out else got, big)


def _lzss_row(tokens, width, n, chunk_elems=256):
    row = enc.encode_lzss_tokens(tokens, width)
    return fmt.CompressedBlob(
        codec="lzss", width=width, chunk_elems=chunk_elems, total_elems=n,
        orig_dtype=str(np.dtype(DT[width])), orig_shape=(n,),
        comp=np.frombuffer(row, np.uint8)[None].copy(),
        comp_lens=np.array([len(row)], np.int32),
        out_lens=np.array([n], np.int32))


def _hand_rows(width):
    rng = np.random.default_rng(width)
    lit = lambda n: rng.integers(0, 1 << (8 * width), n,  # noqa: E731
                                 dtype=np.uint64).astype(DT[width])
    cases = {
        "before_start": [("l", lit(3)), ("m", 10, 5), ("l", lit(4)),
                         ("m", 40, 30), ("m", 9, 2)],
        "far_before_start": [("l", lit(20)), ("m", 50, 65535)],
        "match_first": [("m", 20, 3), ("l", lit(6)), ("m", 12, 4)],
        "zero_dist": [("l", lit(5)), ("m", 10, 0), ("l", lit(2))],
        "lit_128_match_129": [("l", lit(128)), ("m", 129, 128)],
    }
    rows = [_lzss_row(t, width, sum(len(x[1]) if x[0] == "l" else x[1]
                                     for x in t))
            for t in cases.values()]
    # a stream cut short: the row ends inside a token; reads past it are
    # the row's zero padding
    full = enc.encode_lzss_chunk(np.tile(lit(17), 12), width)
    cut = full[:len(full) // 2 + 1]
    rows.append(fmt.CompressedBlob(
        codec="lzss", width=width, chunk_elems=256, total_elems=204,
        orig_dtype=str(np.dtype(DT[width])), orig_shape=(204,),
        comp=np.frombuffer(cut, np.uint8)[None].copy(),
        comp_lens=np.array([len(cut)], np.int32),
        out_lens=np.array([204], np.int32)))
    return fmt.concat_blobs(rows)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_lzss_hand_built_rows_follow_reference(width):
    """Malformed rows have no well-defined answer, but each reference body
    gives one; each port body gives the same."""
    _assert_backends(_hand_rows(width))


def test_lzss_before_start_reads_element_zero():
    """The rule the kernel copies from the reference's pointer doubling: a
    match lane reaching before the row's start takes element 0, and a
    first-token match's lane 0 (its own fixed point) the bytes after its
    control byte."""
    table = _hand_rows(1)
    want = _reference(table, "xla")
    first = want[0]
    assert first[3] == first[4] == first[0]   # idx 3, 4: dist 5 > idx
    assert first[5] == first[0] and first[6] == first[1]
    second = want[1]
    assert (second[20:70] == second[0]).all()
    third = want[2]
    row = table.comp[2]
    assert third[0] == row[1] and (third[1:20] == row[1]).all()


def _lzss_batch_rows(width):
    """Rows for the kernel's 32-token batches and its shared ring: (token
    list, chunk_elems) by name."""
    rng = np.random.default_rng(100 + width)
    lit = lambda n: rng.integers(0, 1 << (8 * width), n,  # noqa: E731
                                 dtype=np.uint64).astype(DT[width])
    ones = lambda n: [("l", lit(1)) for _ in range(n)]  # noqa: E731
    return {
        # short-distance matches, each reading the ones before it, across
        # the boundary at token 32
        "chained_across_batch": (
            [("l", lit(4))] + [("m", 2 + i % 4, 1 + i % 4) for i in range(60)],
            256),
        # token 40 reads elements 28..37: the batch starts at element 32
        "straddles_batch_start": (ones(40) + [("m", 10, 12), ("l", lit(3))],
                                  256),
        # element 47 -> 43 -> 39 -> 35 -> 31: three tokens of its batch
        "chain_through_3": (ones(32) + [("m", 4, 4)] * 4 + [("l", lit(2))],
                            256),
        "zero_dist_token_31": (ones(31) + [("m", 5, 0), ("l", lit(2))], 256),
        "zero_dist_token_32": (ones(32) + [("m", 5, 0), ("l", lit(2))], 256),
        # 128-element literal runs: 513-byte tokens at width 4
        "literal_128_runs": ([("l", lit(128)) for _ in range(9)]
                             + [("m", 129, 300), ("l", lit(7))], 2048),
    }


def _lzss_cut_rows(width):
    """Rows whose bytes end inside a literal run and inside a match's
    distance; reads past them are the row's zero padding."""
    rng = np.random.default_rng(200 + width)
    lit = lambda n: rng.integers(0, 1 << (8 * width), n,  # noqa: E731
                                 dtype=np.uint64).astype(DT[width])
    full = enc.encode_lzss_tokens(
        [("l", lit(100)), ("m", 20, 3), ("l", lit(50))], width)
    return {"cut_in_literal": full[:60],
            "cut_in_distance": full[:1 + 100 * width + 2]}


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("name", [
    "chained_across_batch", "straddles_batch_start", "chain_through_3",
    "zero_dist_token_31", "zero_dist_token_32", "literal_128_runs",
    "cut_in_literal", "cut_in_distance"])
def test_lzss_batch_rows_follow_reference(name, width):
    """The edges of the kernel's batches and ring, through every port body
    and the reference's body of the same name."""
    if name.startswith("cut"):
        row = _lzss_cut_rows(width)[name]
        table = fmt.CompressedBlob(
            codec="lzss", width=width, chunk_elems=256, total_elems=200,
            orig_dtype=str(np.dtype(DT[width])), orig_shape=(200,),
            comp=np.frombuffer(row, np.uint8)[None].copy(),
            comp_lens=np.array([len(row)], np.int32),
            out_lens=np.array([200], np.int32))
    else:
        tokens, chunk = _lzss_batch_rows(width)[name]
        n = sum(len(t[1]) if t[0] == "l" else t[1] for t in tokens)
        table = _lzss_row(tokens, width, n, chunk)
    want = _assert_backends(table)
    if name == "chain_through_3":
        assert (want[0, 32:48] == np.tile(want[0, 28:32], 4)).all()
    if name.startswith("zero_dist"):
        k = 31 if name.endswith("31") else 32
        row = table.comp[0]
        first = k * (1 + width) + 1              # after its control byte
        assert int(want[0, k]) == int.from_bytes(
            bytes(row[first:first + width]), "little")


def test_lzss_max_tokens_cannot_bind():
    """Every token emits at least one element, so the token cap never binds
    before the count reaches out_len: the densest stream, one-element
    literals, decodes a whole chunk."""
    rng = np.random.default_rng(6)
    tokens = [("l", rng.integers(0, 256, 1).astype(np.uint8))
              for _ in range(256)]
    assert len(tokens) < lzss.max_tokens(256)
    _assert_backends(_lzss_row(tokens, 1, 256))


def test_lzss_count_groups_matches_reference():
    rng = np.random.default_rng(3)
    a = np.tile(rng.integers(0, 1 << 12, 48).astype(np.uint32), 60)
    blob = enc.compress(a, "lzss", 2048)
    for row, n in zip(blob.comp, blob.comp_lens):
        assert lzss.count_groups(row[:n], 4) == \
            ref_lz.CODEC.count_groups(row[:n], 4)


def test_encode_lzss_tokens_refuses_out_of_range():
    for bad in ([("l", np.zeros(129, np.uint8))], [("m", 1, 3)],
                [("m", 130, 3)], [("m", 5, 65536)]):
        with pytest.raises(ValueError):
            enc.encode_lzss_tokens(bad, 1)


# --------------------------------------------------------------------------
# the kernel wrappers (their plain versions, and the reference's Pallas
# kernels in interpret mode, are held in tests/test_torch_codecs.py)
# --------------------------------------------------------------------------


def test_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    spec, inputs, consts, lens, kw = _staged("huffman")
    with pytest.raises(ValueError, match="no kernel"):
        huffman.decode(inputs[0].to(meta), inputs[1].to(meta),
                       [t.to(meta) for t in inputs[2:]], lens.to(meta),
                       chunk_elems=kw["chunk_elems"])
    spec, inputs, consts, lens, kw = _staged("lzss")
    with pytest.raises(ValueError, match="no kernel"):
        lzss.decode(inputs[0].to(meta), lens.to(meta),
                    chunk_elems=kw["chunk_elems"], width=kw["width"])


@pytest.mark.parametrize("bad", ["width", "lut_dtype", "lut_shape", "lens",
                                 "words", "comp"])
def test_huffman_wrapper_checks_its_inputs(bad):
    spec, inputs, consts, lens, kw = _staged("huffman")
    comp, words, luts = inputs[0], inputs[1], list(inputs[2:])
    width = 1
    if bad == "width":
        width = 2
    elif bad == "lut_dtype":
        luts[0] = luts[0].to(torch.int32)
    elif bad == "lut_shape":
        luts[1] = luts[1][:, :100]
    elif bad == "lens":
        lens = lens.to(torch.int64)
    elif bad == "words":
        words = words.view(torch.int32)
    else:
        comp = comp.t()
    with pytest.raises(ValueError):
        huffman.decode(comp, words, luts, lens,
                       chunk_elems=kw["chunk_elems"], width=width)


@pytest.mark.parametrize("bad", ["width", "dtype", "lens", "contig"])
def test_lzss_wrapper_checks_its_inputs(bad):
    comp = torch.zeros((3, 128), dtype=torch.uint8)
    lens = torch.zeros(3, dtype=torch.int32)
    width = 4
    if bad == "width":
        width = 3
    elif bad == "dtype":
        comp = comp.to(torch.int32)
    elif bad == "lens":
        lens = lens[:2]
    else:
        comp = torch.zeros((128, 3), dtype=torch.uint8).t()
    with pytest.raises(ValueError):
        lzss.decode(comp, lens, chunk_elems=32, width=width)


def test_new_kernel_builds_are_lazy():
    for lib in (huffman.LIB, lzss.LIB, dequant_matmul.LIB):
        assert not lib.loaded and lib.source.exists()


def test_ctypes_signatures_match_the_c_entry_points():
    """Each wrapper's ctypes argument kinds equal its C entry point's
    parameters (a pointer passed as a 32-bit int would be cut)."""
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_int64: "l"}
    for lib in (cuda_rle.LIB, *cuda_rle.LIB_EPI.values(), bitpack.LIB,
                tdeflate.LIB, huffman.LIB, lzss.LIB, dequant_matmul.LIB):
        src = lib.source.read_text()
        m = re.search(rf'extern "C" int {lib.entry}\s*\(([^)]*)\)', src)
        assert m, lib.entry
        params = [p.strip() for p in m.group(1).split(",")]
        want = "".join("p" if "*" in p else "l" if "int64_t" in p else "i"
                       for p in params)
        assert "".join(kinds[t] for t in lib.argtypes) == want, lib.entry
