"""The decode epilogue as every codec's kernel applies it in its stores,
and the bitpack and huffman kernels' launch geometry.

``harness.fused_epilogue`` decides which epilogues a kernel applies: the
ones that fuse, and the ones that take the unfused route (torch ops after
the decode) and are counted.  ``_emulate`` repeats ``csrc/epilogue.cuh``'s
per-element arithmetic in plain torch, op by op with its roundings; it must
equal ``Epilogue.apply`` on every u8 value, for each fused output dtype.
The geometry helpers must cover every output element exactly once, tails
and empty rows included.  Huffman rows whose segments leave the kernel's
staged tile follow the reference bit for bit.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.kernels import bitpack, harness, huffman, ops

from test_torch_codecs import _assert_backends
from test_torch_cuda import huffman_tile_rows

# --------------------------------------------------------------------------
# which epilogues fuse
# --------------------------------------------------------------------------

Epi = harness.Epilogue


def _dev(**operands):
    dev = {"out_lens": torch.zeros(3, dtype=torch.int32)}
    dev.update(operands)
    return dev


ONE_U8 = torch.tensor(8, dtype=torch.uint8)
ONE_F32 = torch.tensor(0.5, dtype=torch.float32)

FUSES = [
    ("identity", Epi(), 1, {}, torch.uint8),
    ("view_int8", Epi(view_dtype="int8"), 1, {}, torch.int8),
    ("view_f32", Epi(view_dtype="float32"), 4, {}, torch.float32),
    ("weight_path", Epi(out_dtype="int8", zero_key="z"), 1,
     {"z": ONE_U8}, torch.int8),
    ("dequant_f32", Epi(out_dtype="float32", zero_key="z", scale_key="s"), 1,
     {"z": ONE_U8, "s": ONE_F32}, torch.float32),
    ("zero_default_f32", Epi(zero_key="z"), 2, {"z": ONE_U8}, torch.float32),
    ("bf16", Epi(out_dtype="bfloat16", scale_key="s"), 2, {"s": ONE_F32},
     torch.bfloat16),
    ("f16_from_bf16_view", Epi(view_dtype="bfloat16", out_dtype="float16"),
     2, {}, torch.float16),
    ("int16_widen", Epi(out_dtype="int16"), 1, {}, torch.int16),
    ("int32_narrow_u32", Epi(out_dtype="int32"), 4, {}, torch.int32),
    ("uint8_trunc", Epi(out_dtype="uint8"), 4, {}, torch.uint8),
    ("operand_2d", Epi(zero_key="z"), 1,
     {"z": torch.ones((1, 1), dtype=torch.int32)}, torch.float32),
]
UNFUSED = [
    ("fn", Epi(fn=lambda out, dev: out), 1, {}),
    ("view_grows", Epi(view_dtype="int16"), 1, {}),
    ("view_int64", Epi(view_dtype="int64"), 4, {}),
    ("out_int64", Epi(out_dtype="int64"), 1, {}),
    ("out_float64", Epi(out_dtype="float64"), 1, {}),
    ("out_uint16", Epi(out_dtype="uint16"), 2, {}),
    ("float_to_int", Epi(view_dtype="float32", out_dtype="int32"), 4, {}),
    ("per_row_zero", Epi(zero_key="z"), 1,
     {"z": torch.arange(3, dtype=torch.uint8)[:, None]}),
    ("per_column_scale", Epi(scale_key="s"), 1,
     {"s": torch.ones((1, 16))}),
    ("operand_3d", Epi(zero_key="z"), 1,
     {"z": torch.ones((1, 1, 1), dtype=torch.uint8)}),
    ("float_zero_int_out", Epi(out_dtype="int8", zero_key="z"), 1,
     {"z": ONE_F32}),
    ("operand_elsewhere", Epi(zero_key="z"), 1,
     {"z": torch.ones((), dtype=torch.uint8, device="meta")}),
    ("host_scalar", Epi(scale_key="s"), 1, {"s": np.float32(2)}),
]


@pytest.mark.parametrize("name,epi,width,operands,dtype", FUSES,
                         ids=[c[0] for c in FUSES])
def test_epilogues_that_fuse(name, epi, width, operands, dtype):
    fused = harness.fused_epilogue(epi, _dev(**operands), width)
    assert fused is not None and fused.dtype == dtype
    assert fused.src.itemsize == width
    codes = fused.kernel_args()
    assert codes[:2] == (harness.DTYPE_CODES[dtype],
                         harness.DTYPE_CODES[fused.src])
    assert (codes[2] is None) == (epi.zero_key is None)
    assert (codes[4] is None) == (epi.scale_key is None)


# the fused epilogues whose output bits are the decoded bits
BITS_ONLY = {"identity", "view_int8", "view_f32", "int32_narrow_u32"}


@pytest.mark.parametrize("name,epi,width,operands,dtype", FUSES,
                         ids=[c[0] for c in FUSES])
def test_bits_only_epilogues_take_the_plain_store(name, epi, width, operands,
                                                  dtype):
    """A bits-only epilogue launches the plain store (no epilogue
    arguments, no scratch) and its output is a view of the decoded bits,
    equal to ``Epilogue.apply``; every other epilogue reaches the kernel."""
    fused = harness.fused_epilogue(epi, _dev(**operands), width)
    assert fused.bits_only == (name in BITS_ONLY)
    raw = harness.DEV_DTYPE[width]
    kept, out_dtype, args = harness.launch_store(fused, raw)
    if fused.bits_only:
        assert kept is None and out_dtype == raw
        code = harness.DTYPE_CODES[raw]
        assert args == (code, code, None, 0, None, 0)
        x = torch.arange(250, dtype=torch.int64).to(raw)
        got = harness.finish_store(x, fused)
        assert got.dtype == dtype
        want = fused.apply_plain(x)
        assert torch.equal(got.view(raw), want.view(raw))
    else:
        assert kept is fused and out_dtype == dtype
        assert args == fused.kernel_args()


@pytest.mark.parametrize("name,epi,width,operands", UNFUSED,
                         ids=[c[0] for c in UNFUSED])
def test_epilogues_left_to_torch(name, epi, width, operands):
    assert harness.fused_epilogue(epi, _dev(**operands), width) is None


def _bitpack_table():
    rng = np.random.default_rng(2)
    return enc.compress(rng.integers(0, 100, 700).astype(np.uint8),
                        "bitpack", 256, bits=7)


@pytest.mark.parametrize("codec,backend,epi,fused", [
    ("bitpack", "cuda", Epi(out_dtype="int8", zero_key="z"), True),
    ("bitpack", "cuda", Epi(out_dtype="int64", zero_key="z"), False),
    ("bitpack", "torch", Epi(out_dtype="int8", zero_key="z"), False),
    ("rle_v1", "cuda", Epi(out_dtype="int8", zero_key="z"), True),
    ("rle_v1", "cuda", Epi(out_dtype="int64", zero_key="z"), False),
    ("rle_v2", "cuda", Epi(out_dtype="float32", zero_key="z"), True),
    ("dbp", "cuda", Epi(out_dtype="bfloat16", zero_key="z"), True),
    ("huffman", "cuda", Epi(out_dtype="int8", zero_key="z"), True),
    ("tdeflate", "cuda", Epi(out_dtype="float16", zero_key="z"), True),
    ("tdeflate", "cuda", Epi(view_dtype="int8"), True),
    ("tdeflate", "oracle", Epi(view_dtype="int8"), False),
    ("lzss", "cuda", Epi(out_dtype="int32", zero_key="z"), True),
    ("lzss", "cuda", Epi(fn=lambda out, dev: out), False),
])
def test_unfused_route_is_counted(codec, backend, epi, fused):
    rng = np.random.default_rng(3)
    table = (_bitpack_table() if codec == "bitpack" else enc.compress(
        rng.integers(0, 4, 700).astype(np.uint8), codec, 256))
    dev, bits = ops.table_inputs(table, "cpu")
    dev["z"] = ONE_U8
    want = epi.apply(ops.decode(dev, codec=codec, width=1,
                                chunk_elems=table.chunk_elems,
                                backend="torch", bits=bits), dev)
    before = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
    got = ops.decode(dev, codec=codec, width=1, chunk_elems=table.chunk_elems,
                     backend=backend, bits=bits, epilogue=epi)
    grew = (harness.EPILOGUE_FUSED - before[0],
            harness.EPILOGUE_UNFUSED - before[1])
    assert grew == ((1, 0) if fused else (0, 1))
    assert torch.equal(got, want)


def test_dtype_codes_match_the_header():
    src = (bitpack.LIB.source.parent / "epilogue.cuh").read_text()
    enum = dict(re.findall(r"k(\w+) = (\d+)", src.split("enum Code")[1]
                           .split("};")[0]))
    names = {"U8": torch.uint8, "I8": torch.int8, "U16": torch.uint16,
             "I16": torch.int16, "U32": torch.uint32, "I32": torch.int32,
             "F32": torch.float32, "BF16": torch.bfloat16,
             "F16": torch.float16, "I64": torch.int64, "F64": torch.float64,
             "Bool": torch.bool}
    assert {names[k]: int(v) for k, v in enum.items()} == harness.DTYPE_CODES


# --------------------------------------------------------------------------
# epilogue.cuh's arithmetic, emulated
# --------------------------------------------------------------------------

_INT_BITS = {torch.uint8: 8, torch.int8: 8, torch.int16: 16, torch.int32: 32}


def _emulate(raw: torch.Tensor, f: harness.FusedEpilogue) -> torch.Tensor:
    """``epi::Store<O>`` op by op, in plain torch: the raw u8 bits read as
    ``src``; an integer output wraps (x - z) * s to its width; a float one
    takes int -> float32 rounded, then rounds to O, and each of - z and * s
    is a float32 op rounded to O after it.  Operands: integer -> float32
    rounded, float64 -> float32 rounded, then -> O rounded."""
    x = raw.to(torch.int64)
    if f.src == torch.int8:
        x = torch.where(x >= 128, x - 256, x)
    out = f.dtype
    if out in _INT_BITS:
        n = _INT_BITS[out]
        z = 0 if f.zero is None else int(f.zero.to(torch.int64))
        s = 1 if f.scale is None else int(f.scale.to(torch.int64))
        v = ((x - z) * s) & ((1 << n) - 1)
        if out.is_signed:
            v = torch.where(v >= 1 << (n - 1), v - (1 << n), v)
        return v.to(out)

    def operand(t):
        return t.to(torch.float32).to(out)

    v = x.to(torch.float32).to(out)
    if f.zero is not None:
        v = (v.to(torch.float32) - operand(f.zero).to(torch.float32)).to(out)
    if f.scale is not None:
        v = (v.to(torch.float32) * operand(f.scale).to(torch.float32)) \
            .to(out)
    return v


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


SCALES = [np.float32(0.173), np.float32(-3.5), np.float64(0.1),
          np.int32(3), np.uint8(200)]


@pytest.mark.parametrize("out", [str(d).removeprefix("torch.")
                                 for d in harness.FUSED_OUTS])
@pytest.mark.parametrize("view", [None, "int8"])
def test_header_arithmetic_equals_epilogue_apply(out, view):
    raw = torch.arange(256, dtype=torch.int64).to(torch.uint8)[None]
    floats = out in ("float32", "bfloat16", "float16")
    zeros = [None, np.uint8(3), np.int8(-5)] + (
        [np.float32(2.75), np.float64(1e-3)] if floats else [np.int32(1000)])
    scales = [None] + [s for s in SCALES
                       if floats or not np.issubdtype(s.dtype, np.floating)]
    for z in zeros:
        for s in scales:
            epi = Epi(view_dtype=view, out_dtype=out,
                      zero_key=None if z is None else "z",
                      scale_key=None if s is None else "s")
            dev = _dev()
            for key, v in (("z", z), ("s", s)):
                if v is not None:
                    dev[key] = torch.from_numpy(np.asarray(v))
            f = harness.fused_epilogue(epi, dev, 1)
            assert f is not None, (z, s)
            want = epi.apply(raw, dev)
            got = _emulate(raw, f)
            assert got.dtype == want.dtype
            assert torch.equal(_bits(got), _bits(want)), (z, s)


# --------------------------------------------------------------------------
# launch geometry: every output element exactly once
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,chunk_elems,bits,out_size", [
    (3, 1000, 9, 4),        # tiled path, a partial last vector
    (2, 4096, 4, 1),        # the weight layout's fast path, exact tiles
    (1, 17, 1, 1),          # one vector and a tail
    (2, 8195, 11, 2),       # a partial last tile
    (1, 1, 32, 4),
    (2, 3000, 32, 1),       # fast path, 16 words a vector: one a thread
    (1, 5000, 31, 1),       # tiled path, a tile capped at 32 KiB
    (0, 64, 7, 1),          # no rows
    (7, 128, 8, 4),         # the int8 gradient wire: rows share a block
    (70, 128, 8, 4),        # ... 32 rows a block, a partial last block
    (5, 100, 8, 1),         # short rows with a partial last vector
    (3, 8, 1, 1),           # one vector a row
])
def test_bitpack_geometry_covers_every_element_once(n, chunk_elems, bits,
                                                    out_size):
    geom = bitpack.launch_geometry(n, chunk_elems, bits, out_size)
    assert geom.vec_elems * out_size == 16 and 1 <= geom.vpt <= 4
    assert geom.blocks == -(-n // geom.rows_per_block) * geom.tiles_per_row
    if geom.rows_per_block > 1:   # whole rows share a block's slots
        assert geom.fast and geom.tiles_per_row == 1
        assert geom.rows_per_block * -(-chunk_elems // geom.vec_elems) <= \
            bitpack.THREADS * geom.vpt
    assert geom.fast == (32 % bits == 0 and geom.vec_elems * bits >= 16)
    if not geom.fast:   # the block's words fit the kernel's 48 KiB
        assert 4 * (bitpack.THREADS * geom.vpt * geom.vec_elems * bits // 32
                    + 12) <= 48 * 1024
    seen = np.zeros((n, chunk_elems), np.int64)
    for block in range(geom.blocks):
        for thread in range(bitpack.THREADS):
            for row, first, end in bitpack.thread_elems(geom, chunk_elems,
                                                        block, thread):
                seen[row, first:end] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("chunk_elems", [1, 31, 32, 33, 1000, 8192, 8225,
                                         131072])
def test_huffman_geometry_covers_every_lane_once(chunk_elems):
    nseg, batches = huffman.launch_geometry(chunk_elems)
    seen = np.zeros(chunk_elems, np.int64)
    for b in range(batches):
        for t in range(huffman.THREADS):
            seen[huffman.thread_lanes(chunk_elems, b, t)] += 1
    assert (seen == 1).all()
    assert nseg * huffman.SUB >= chunk_elems > (nseg - 1) * huffman.SUB


def test_kernel_constants_match_the_geometry():
    bp = bitpack.LIB.source.read_text()
    hf = huffman.LIB.source.read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", bp).group(1) == \
        str(bitpack.THREADS)
    assert re.search(r"constexpr int kThreads = (\d+);", hf).group(1) == \
        str(huffman.THREADS)
    assert "constexpr int kBatch = 2 * kThreads;" in hf
    assert huffman.BATCH == 2 * huffman.THREADS


def test_huffman_out_len_zero_rows_are_the_epilogue_of_zero():
    """A row with out_len 0 reads nothing; the epilogue still maps each of
    its zero lanes."""
    rng = np.random.default_rng(6)
    table = fmt.concat_blobs([
        enc.compress(rng.integers(0, 9, 300).astype(np.uint8), "huffman",
                     512),
        enc.compress(np.zeros(0, np.uint8), "huffman", 512)])
    dev, _ = ops.table_inputs(table, "cpu")
    dev["z"] = ONE_U8
    epi = Epi(out_dtype="int8", zero_key="z")
    got = ops.decode(dev, codec="huffman", width=1, chunk_elems=512,
                     backend="cuda", epilogue=epi)
    assert got.dtype == torch.int8
    assert (got[1] == -8).all()


# --------------------------------------------------------------------------
# huffman rows whose segments leave the kernel's staged tile
# --------------------------------------------------------------------------


def test_huffman_rows_off_the_tile_follow_reference():
    rng = np.random.default_rng(9)
    for blob in huffman_tile_rows(rng, 16384):
        _assert_backends(blob, backends=("torch", "cuda", "oracle"))
