"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a card.  The file imports nothing
of JAX or of the reference package, so it runs where the kernels run:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each decode kernel's output must equal its plain version's on the same
staged table (tolerance zero), the dequant matmul's within the stated
tolerance, and each launch must add one to its count.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import api, encoders as enc, format as fmt, registry
from repro_torch.core import server as srv
from repro_torch.kernels import (bitpack, cuda_rle, harness, huffman, lzss,
                                 ops, tdeflate)
from repro_torch.kernels import dequant_matmul as dq

DT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _launches(codec: str) -> int:
    if codec in cuda_rle.CODEC_IDS:
        return cuda_rle.CODEC_LAUNCHES[codec]
    return {"bitpack": bitpack, "tdeflate": tdeflate, "huffman": huffman,
            "lzss": lzss}[codec].LAUNCHES


def _table(codec: str, width: int) -> fmt.CompressedBlob:
    rng = np.random.default_rng(5)
    if codec in ("tdeflate", "huffman"):
        arrays = [np.frombuffer(b"codag warp chunk decode " * 40, np.uint8),
                  rng.integers(0, 256, 300).astype(np.uint8),
                  np.full(33, 9, np.uint8), np.zeros(0, np.uint8)]
    elif codec == "lzss":
        dt = DT[width]
        arrays = [np.tile(np.array([11, 250, 3], dt), 300),
                  np.full(200, 7, dt),
                  rng.integers(0, 1 << 10, 500).astype(dt),
                  np.zeros(0, dt)]
    else:
        dt = DT[width]
        arrays = [np.repeat(rng.integers(0, 1 << 10, 60), 12).astype(dt),
                  rng.integers(0, 1 << 10, 500).astype(dt),
                  np.zeros(0, dt)]
    return fmt.concat_blobs([enc.compress(a, codec, 512, bits=10)
                             for a in arrays])


def _decode(table, device):
    """The ``cuda`` backend's wrapper on one staged table: the kernel on a
    card, its plain version on the CPU."""
    dev, bits = ops.table_inputs(table, device)
    spec = registry.get(table.codec).decode
    lens = dev["out_lens"]
    return spec.cuda(spec.chunk_inputs(dev), harness.consts_on(spec,
                                                               lens.device),
                     lens, chunk_elems=table.chunk_elems, width=table.width,
                     bits=bits)


@pytest.mark.cuda
@pytest.mark.parametrize("codec,width", [
    ("rle_v1", 1), ("rle_v2", 4), ("dbp", 2), ("bitpack", 2),
    ("tdeflate", 1), ("huffman", 1), ("lzss", 1), ("lzss", 2), ("lzss", 4)])
def test_kernels_equal_plain_versions_on_the_card(card, codec, width):
    table = _table(codec, width)
    want = _decode(table, "cpu")
    before = _launches(codec)
    got = _decode(table, card)
    torch.cuda.synchronize()
    assert _launches(codec) == before + 1
    assert got.device.type == "cuda" and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("codec,width,body", [
    ("tdeflate", 1, "body"), ("lzss", 1, "body"), ("lzss", 4, "body"),
    ("tdeflate", 1, "body_scalar"), ("rle_v1", 1, "body_scalar"),
    ("rle_v2", 4, "body_scalar"), ("dbp", 2, "body_scalar")])
def test_plain_lockstep_graphs_equal_the_cpu_loop_on_the_card(card, codec,
                                                              width, body):
    """On a card the plain bodies' lockstep loops (the two-phase bodies of
    tdeflate and lzss, the single-thread bodies of tdeflate and the RLE
    family) run as replayed CUDA graphs (``streams.lockstep``): equal to
    the CPU's step-by-step loop on the same table, rows past their last
    token included, and the kernel equal to both."""
    table = _table(codec, width)
    dev, bits = ops.table_inputs(table, "cpu")
    spec = registry.get(codec).decode
    kw = dict(chunk_elems=table.chunk_elems, width=table.width, bits=bits)

    def plain(device):
        inputs = tuple(t.to(device) for t in spec.chunk_inputs(dev))
        lens = dev["out_lens"].to(device)
        return getattr(spec, body)(
            inputs, harness.consts_on(spec, lens.device), lens, **kw)

    want = plain("cpu")
    got = plain(card)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert torch.equal(_decode(table, card).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 5e-3, 1e-4),      # the reference test's tolerance
    (torch.bfloat16, 1.6e-2, 1e-2)])  # two bf16 ulps
def test_dequant_matmul_equals_plain_version_on_the_card(card, dtype, rtol,
                                                        atol):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(256, 384)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 127, (384, 256)).astype(np.int8))
    s = torch.from_numpy((np.abs(rng.normal(size=(1, 256))) * 0.01)
                         .astype(np.float32))
    x = x.to(dtype)
    want = dq.ref_dequant_matmul(x, q, s)
    before = dq.LAUNCHES
    got = dq.dequant_matmul(x.to(card), q.to(card), s.to(card))
    torch.cuda.synchronize()
    assert dq.LAUNCHES == before + 1
    assert got.device.type == "cuda" and got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (2048, 128, 1024),   # no split: 128 output tiles
    (64, 256, 128),      # bm 64, K split
    (1, 512, 256),       # bm 8, K split
    (37, 104, 48)])      # ragged M, K and N, all TMA-describable
def test_dequant_matmul_tensor_core_path_on_the_card(card, m, k, n):
    """bf16 shapes TMA can describe take the wgmma entry: within two bf16
    ulps of the plain version, one launch on that path."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)) \
        .to(torch.bfloat16)
    q = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy((np.abs(rng.normal(size=(1, n))) * 0.01)
                         .astype(np.float32))
    want = dq.ref_dequant_matmul(x, q, s)
    before = dict(dq.LAUNCHES_BY_PATH)
    got = dq.dequant_matmul(x.to(card), q.to(card), s.to(card))
    torch.cuda.synchronize()
    assert dq.LAUNCHES_BY_PATH == {"wgmma": before["wgmma"] + 1,
                                   "simt": before["simt"]}
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1.6e-2,
                               atol=1e-2)
    again = dq.dequant_matmul(x.to(card), q.to(card), s.to(card))
    assert torch.equal(got, again)      # no atomics: bit-identical reruns


# tdeflate rows for the kernel's 32-token batches: chained short-distance
# matches, a match straddling the batch's start, > 32 literals then a
# 258-long match of distance 1
TD_BATCH_ROWS = [
    [("l", 97), ("l", 98), ("l", 99)]
    + [("m", 4 + i, 3 + i) for i in range(10)] + [("l", 10)],
    [("l", 65 + i % 26) for i in range(40)] + [("m", 10, 12)]
    + [("l", 48 + i) for i in range(5)],
    [("l", 97 + i % 26) for i in range(40)] + [("m", 258, 1), ("l", 33)],
]


@pytest.mark.cuda
def test_tdeflate_batch_rows_on_the_card(card):
    blobs = []
    for tokens in TD_BATCH_ROWS:
        n = sum(1 if t[0] == "l" else t[1] for t in tokens)
        blobs.append(enc.tdeflate_blob(np.zeros(n, np.uint8),
                                       [enc.encode_tdeflate_tokens(tokens)],
                                       1024, n))
    table = fmt.concat_blobs(blobs)
    want = _decode(table, "cpu")
    before = tdeflate.LAUNCHES
    got = _decode(table, card)
    torch.cuda.synchronize()
    assert tdeflate.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


def _lzss_batch_table(width: int) -> fmt.CompressedBlob:
    """Rows for the lzss kernel's 32-token batches and shared ring."""
    rng = np.random.default_rng(width)
    lit = lambda n: rng.integers(0, 1 << (8 * width), n,  # noqa: E731
                                 dtype=np.uint64).astype(DT[width])
    ones = lambda n: [("l", lit(1)) for _ in range(n)]  # noqa: E731
    rows = [
        [("l", lit(4))] + [("m", 2 + i % 4, 1 + i % 4) for i in range(60)],
        ones(40) + [("m", 10, 12), ("l", lit(3))],
        ones(32) + [("m", 4, 4)] * 4 + [("l", lit(2))],
        ones(31) + [("m", 5, 0), ("l", lit(2))],
        ones(32) + [("m", 5, 0), ("l", lit(2))],
        [("l", lit(128)) for _ in range(40)] + [("m", 129, 300)],
    ]
    blobs = []
    for tokens in rows:
        row = enc.encode_lzss_tokens(tokens, width)
        n = sum(len(t[1]) if t[0] == "l" else t[1] for t in tokens)
        blobs.append(_blob("lzss", width, row, n, 8192))
    full = enc.encode_lzss_tokens(
        [("l", lit(100)), ("m", 20, 3), ("l", lit(50))], width)
    blobs += [_blob("lzss", width, full[:cut], 400, 8192)
              for cut in (60, 1 + 100 * width + 2)]
    return fmt.concat_blobs(blobs)


def _blob(codec, width, row, n, chunk_elems):
    return fmt.CompressedBlob(
        codec=codec, width=width, chunk_elems=chunk_elems, total_elems=n,
        orig_dtype=str(np.dtype(DT[width])), orig_shape=(n,),
        comp=np.frombuffer(row, np.uint8)[None].copy(),
        comp_lens=np.array([len(row)], np.int32),
        out_lens=np.array([n], np.int32))


def _rle_ring_table(codec: str, width: int) -> fmt.CompressedBlob:
    """Rows for the RLE kernel's 32-group batches and shared ring: groups
    across the 512-, 1,024- and 4,096-byte offsets, 50 runs of 3."""
    rng = np.random.default_rng(width)
    v = lambda n: rng.integers(0, 1 << (8 * width), n,  # noqa: E731
                               dtype=np.uint64)
    if codec == "rle_v1":
        kinds = [(1, [("run", 5, 77)]), (3, [("lit", v(128))])]
        tail = [("run", 3, x) for x in v(50)]
    elif codec == "rle_v2":
        kinds = [(1, [("long", 1000, 5)]), (width, [("delta", 20, 9, 3)]),
                 (5, [("lit", v(64))])]
        tail = [("run", 3, x) for x in v(50)]
    else:
        kinds = [(1, [("dbp", 13, 7, v(100) % 8192)]),
                 (3 + width, [("dbp", 32, 7, v(256))])]
        tail = [("dbp", 2, x, [1, 2, 3]) for x in v(50)]
    blobs = []
    for groups in [[("fill", o - back)] + g + tail
                   for o in (512, 1024, 4096) for back, g in kinds]:
        row, vals = enc.encode_rle_groups(codec, groups, width)
        blobs.append(_blob(codec, width, row, vals.size, 8192))
    if codec == "dbp":      # 40- and 255-bit fields, a payload past the end
        for bits, nbytes in ((40, 1400), (255, 900)):
            row = bytes([bits, 255]) + bytes(
                rng.integers(0, 256, width + nbytes, dtype=np.uint8))
            blobs.append(_blob(codec, width, row, 300, 8192))
    return fmt.concat_blobs(blobs)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 4])
def test_lzss_batch_rows_on_the_card(card, width):
    table = _lzss_batch_table(width)
    want = _decode(table, "cpu")
    before = lzss.LAUNCHES
    got = _decode(table, card)
    torch.cuda.synchronize()
    assert lzss.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("codec", ["rle_v1", "rle_v2", "dbp"])
def test_rle_ring_rows_on_the_card(card, codec, width):
    table = _rle_ring_table(codec, width)
    want = _decode(table, "cpu")
    before = cuda_rle.CODEC_LAUNCHES[codec]
    got = _decode(table, card)
    torch.cuda.synchronize()
    assert cuda_rle.CODEC_LAUNCHES[codec] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [56, 58])
@pytest.mark.parametrize("codec", ["rle_v1", "rle_v2"])
def test_rle_group_cap_and_counts_on_the_card(card, codec, chunk):
    """The cap at group 32 / 33 of one-literal groups; the ``groups``
    output counts the groups each row parsed."""
    rng = np.random.default_rng(chunk)
    comp = rng.integers(0, 256, (3, 200, 2)).astype(np.uint8)
    comp[:, :, 0] = 255 if codec == "rle_v1" else 2 << 6   # one literal
    cap = chunk // 2 + 4
    comp_t = torch.from_numpy(comp.reshape(3, -1).copy())
    lens = torch.tensor([chunk, cap + 1, cap - 1], dtype=torch.int32)
    want = cuda_rle.plain(codec, comp_t, lens, chunk_elems=chunk, width=1)
    groups = torch.zeros(3, dtype=torch.int32, device=card)
    got = cuda_rle.decode(codec, comp_t.to(card), lens.to(card),
                          chunk_elems=chunk, width=1, groups=groups)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert groups.cpu().tolist() == [cap, cap, cap - 1]


# --------------------------------------------------------------------------
# the decode epilogue in every decode kernel's stores
# --------------------------------------------------------------------------

FUSED_EPILOGUES = [
    ("identity", {}, {}),
    ("view_signed", dict(view_dtype="int"), {}),
    ("int8_zero", dict(out_dtype="int8", zero_key="z"), {"z": np.uint8(8)}),
    ("uint8_zero", dict(out_dtype="uint8", zero_key="z"), {"z": np.int32(-3)}),
    ("int16_affine", dict(view_dtype="int", out_dtype="int16", zero_key="z",
                          scale_key="s"),
     {"z": np.int16(300), "s": np.int16(-7)}),
    ("int32", dict(out_dtype="int32"), {}),
    ("f32_affine", dict(out_dtype="float32", zero_key="z", scale_key="s"),
     {"z": np.uint8(3), "s": np.float32(0.173)}),
    ("bf16_affine", dict(out_dtype="bfloat16", zero_key="z", scale_key="s"),
     {"z": np.uint8(3), "s": np.float32(0.173)}),
    ("f16_scale", dict(out_dtype="float16", scale_key="s"),
     {"s": np.float64(0.37)}),
]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def huffman_tile_rows(rng, chunk: int):
    """Rows the huffman kernel cannot decode from its staged tile alone:
    random bytes (8-bit codes fill a batch's 2,048-word tile, so its last
    segments overflow it), 12-bit codes, gap entries shuffled (offsets out
    of order), and offsets negative or past the row."""
    fib = [1, 1]
    while len(fib) < 24:
        fib.append(fib[-1] + fib[-2])
    kraft = np.repeat(np.arange(24, dtype=np.uint8), fib)
    rng.shuffle(kraft)
    text = np.resize(np.frombuffer(b"codag decodes a warp a chunk ", np.uint8),
                     chunk)
    blobs = [enc.compress(rng.integers(0, 256, chunk).astype(np.uint8),
                          "huffman", chunk),
             enc.compress(np.resize(kraft, chunk), "huffman", chunk)]
    nseg = -(-chunk // 32)
    shuffled = enc.compress(text, "huffman", chunk)
    comp = shuffled.comp.copy()
    gaps = comp[0, 5:5 * nseg].reshape(nseg - 1, 5)   # entry 0 stays
    comp[0, 5:5 * nseg] = gaps[rng.permutation(nseg - 1)].reshape(-1)
    blobs.append(dataclasses.replace(shuffled, comp=comp))
    bad = enc.compress(text, "huffman", chunk)
    comp = bad.comp.copy()
    for g in range(3, nseg, 7):             # negative offsets
        comp[0, 5 * g + 3] |= 0x80
    for g in range(5, nseg, 11):            # past the row
        comp[0, 5 * g:5 * g + 4] = [0, 0, 0, 0x40]
    blobs.append(dataclasses.replace(bad, comp=comp))
    return blobs


def _fused_table(codec: str, width: int, bits: int) -> fmt.CompressedBlob:
    rng = np.random.default_rng(bits)
    if codec not in ("bitpack", "huffman"):
        return _table(codec, width)
    if codec == "huffman":
        return fmt.concat_blobs(huffman_tile_rows(rng, 16384) + [
            enc.compress(np.zeros(0, np.uint8), "huffman", 16384),
            enc.compress(rng.integers(0, 9, 20000).astype(np.uint8),
                         "huffman", 16384)])
    top = 1 << bits
    chunk = 1000                # a partial last vector at every width
    arrays = [rng.integers(0, top, n, dtype=np.uint64).astype(DT[width])
              for n in (3 * chunk, chunk + 1, 7)]
    return fmt.concat_blobs([enc.compress(a, "bitpack", chunk * width,
                                          bits=bits) for a in arrays])


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,operands", FUSED_EPILOGUES,
                         ids=[e[0] for e in FUSED_EPILOGUES])
@pytest.mark.parametrize("codec,width,bits", [
    ("bitpack", 1, 4), ("bitpack", 1, 7), ("bitpack", 2, 11),
    ("bitpack", 2, 16), ("bitpack", 4, 9), ("bitpack", 4, 32),
    ("huffman", 1, 8), ("rle_v1", 1, 0), ("rle_v1", 4, 0), ("rle_v2", 2, 0),
    ("rle_v2", 4, 0), ("dbp", 1, 0), ("dbp", 4, 0), ("tdeflate", 1, 0),
    ("lzss", 1, 0), ("lzss", 2, 0), ("lzss", 4, 0)])
def test_fused_epilogue_equals_plain_then_apply_on_the_card(
        card, codec, width, bits, name, kw, operands):
    """The kernel's fused output == its plain twin, then Epilogue.apply,
    both on the card, bit for bit; one launch, counted as fused."""
    if kw.get("view_dtype") == "int":
        kw = {**kw, "view_dtype": f"int{8 * width}"}
    epi = harness.Epilogue(**kw)
    table = _fused_table(codec, width, bits)
    dev, b = ops.table_inputs(table, card)
    dev.update({k: torch.from_numpy(np.asarray(v)).to(card)
                for k, v in operands.items()})
    spec = registry.get(codec).decode
    plain = spec.body(spec.chunk_inputs(dev),
                      harness.consts_on(spec, dev["out_lens"].device),
                      dev["out_lens"], chunk_elems=table.chunk_elems,
                      width=width, bits=b)
    want = epi.apply(plain, dev)
    before = (_launches(codec), harness.EPILOGUE_FUSED,
              harness.EPILOGUE_UNFUSED)
    got = ops.decode(dev, codec=codec, width=width,
                     chunk_elems=table.chunk_elems, backend="cuda", bits=b,
                     epilogue=epi)
    torch.cuda.synchronize()
    assert (_launches(codec), harness.EPILOGUE_FUSED,
            harness.EPILOGUE_UNFUSED) == (before[0] + 1, before[1] + 1,
                                          before[2])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["weight_layout", "unaligned_stride",
                                  "tail_17"])
def test_bitpack_layouts_on_the_card(card, case):
    """The weight path's layout (4-bit fields into u8, 65,536-element
    chunks, int8 - 8 fused), a word row whose stride is not 16-byte
    aligned (4-byte loads, clipped), and a 17-element row."""
    rng = np.random.default_rng(21)
    epi = None
    if case == "weight_layout":
        q = rng.integers(-8, 8, 3 * 65536 + 100).astype(np.int8)
        table = enc.compress((q.astype(np.int16) + 8).astype(np.uint8),
                             "bitpack", 65536, bits=4)
        words = ops.table_inputs(table, "cpu")[0]["comp_words"]
        chunk, width, bits = 65536, 1, 4
        epi = harness.Epilogue(out_dtype="int8", zero_key="z")
    elif case == "unaligned_stride":
        words = torch.from_numpy(rng.integers(0, 1 << 32, (5, 7),
                                              dtype=np.uint64)
                                 .astype(np.uint32))
        chunk, width, bits = 300, 2, 13       # reads run past each row
    else:
        words = torch.from_numpy(rng.integers(0, 1 << 32, (2, 32),
                                              dtype=np.uint64)
                                 .astype(np.uint32))
        chunk, width, bits = 17, 4, 32
    z = torch.tensor(8, dtype=torch.uint8)
    fused_cpu = None if epi is None else harness.fused_epilogue(
        epi, {"out_lens": z, "z": z}, width)
    fused_card = None if epi is None else harness.fused_epilogue(
        epi, {"out_lens": z.to(card), "z": z.to(card)}, width)
    want = bitpack.decode(words, chunk_elems=chunk, width=width, bits=bits,
                          epilogue=fused_cpu)
    before = bitpack.LAUNCHES
    got = bitpack.decode(words.to(card), chunk_elems=chunk, width=width,
                         bits=bits, epilogue=fused_card)
    torch.cuda.synchronize()
    assert bitpack.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)
    if case == "weight_layout":
        assert np.array_equal(got.cpu().reshape(-1)[:q.size].numpy(), q)


# --------------------------------------------------------------------------
# staging, and the service on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
def test_pinned_staging_equals_cpu_staging_on_the_card(card):
    """Staging through pinned memory uploads the same arrays, bytes and
    counts as staging to the CPU; the staged tensors are equal."""
    from repro_torch.core import transfers
    for codec, width in (("tdeflate", 1), ("bitpack", 2), ("lzss", 4)):
        table = _table(codec, width)
        with transfers.count_host_transfers() as c_cpu:
            on_cpu = fmt.to_device(table, "cpu")
        with transfers.count_host_transfers() as c_card:
            on_card = fmt.to_device(table, card)
        torch.cuda.synchronize()
        assert c_card == c_cpu and c_cpu["h2d"] == 3 + len(table.extras)
        assert on_card.keys() == on_cpu.keys()
        for k, v in on_cpu.items():
            assert on_card[k].device.type == "cuda"
            assert torch.equal(on_card[k].cpu(), v), (codec, k)


def _service_arrays():
    rng = np.random.default_rng(17)
    arrays = [np.repeat(rng.integers(0, 1 << 10, 300), 20).astype(np.uint32),
              np.frombuffer(b"codag service window " * 400, np.uint8).copy(),
              np.repeat(rng.integers(0, 1 << 40, 50).astype(np.int64), 30)]
    cas = [api.compress(a, c, 4096) for a, c in
           zip(arrays, ("rle_v2", "tdeflate", "lzss"))]
    return arrays, cas


@pytest.mark.cuda
def test_service_device_out_read_on_a_side_stream(card):
    """A ``device_out`` future resolves to a complete tensor: a consumer on
    another stream reads it without waiting on the default stream."""
    arrays, cas = _service_arrays()
    with srv.DecompressionService(cache_bytes=0) as svc:
        futs = [svc.submit_array(ca, device_out=True) for ca in cas]
        outs = [f.result(timeout=60) for f in futs]
        side = torch.cuda.Stream(card)
        with torch.cuda.stream(side):
            copies = [o.clone() for o in outs]
        side.synchronize()
        assert svc.stats().dispatches >= 1
    for a, o, c in zip(arrays, outs, copies):
        assert o.device.type == "cuda" and c.dtype == o.dtype
        assert np.array_equal(c.cpu().numpy(), a)


@pytest.mark.cuda
def test_service_cache_hit_device_out_read_on_a_side_stream(card):
    """A ``device_out`` cache hit is staged from the host LRU and resolves
    only once its copy has landed: a consumer on another stream reads the
    whole array.  The block the hit is staged into is first filled with
    0xFF, so a read before the copy lands shows."""
    a = np.repeat(np.arange(1 << 17, dtype=np.uint32), 64)     # 32 MiB
    (blob,) = api.compress(a, "rle_v2", 1 << 16).blobs
    with srv.DecompressionService(cache_bytes=64 << 20) as svc:
        first = svc.submit(blob, device_out=True).result(timeout=60)
        side = torch.cuda.Stream(card)
        for _ in range(3):
            poison = torch.full((a.nbytes,), 255, dtype=torch.uint8,
                                device=card)
            del poison
            hit = svc.submit(blob, device_out=True).result(timeout=60)
            with torch.cuda.stream(side):
                copy = hit.clone()
            side.synchronize()
            assert torch.equal(copy.cpu(), first.cpu())
        stats = svc.stats()
        assert stats.cache_hits == 3 and stats.dispatches == 1
    assert np.array_equal(first.cpu().numpy(), a)


@pytest.mark.cuda
def test_service_decodes_while_another_thread_forbids_transfers(card):
    """The service's worker stages, decodes and materializes host results
    while another thread holds ``no_host_transfers()``; that thread's own
    host materialization still raises."""
    import threading
    from repro_torch.core import transfers
    arrays, cas = _service_arrays()
    inside, leave = threading.Event(), threading.Event()
    raised = []

    def guard():
        with transfers.no_host_transfers():
            inside.set()
            try:
                transfers.to_host(torch.zeros(4, device=card))
            except RuntimeError as e:
                raised.append(str(e))
            leave.wait(60)

    t = threading.Thread(target=guard)
    t.start()
    try:
        assert inside.wait(60)
        with srv.DecompressionService(cache_bytes=1 << 20) as svc:
            outs = [svc.submit_array(ca).result(timeout=60) for ca in cas]
            devs = [svc.submit_array(ca, device_out=True).result(timeout=60)
                    for ca in cas]
            assert svc.stats().errors == 0
    finally:
        leave.set()
        t.join(60)
    assert not t.is_alive() and raised and "no_host_transfers" in raised[0]
    for a, o, d in zip(arrays, outs, devs):
        assert np.array_equal(o, a)
        assert np.array_equal(d.cpu().numpy(), a)


# --------------------------------------------------------------------------
# the single-thread kernel (csrc/scalar_decode.cu), all_thread=False
# --------------------------------------------------------------------------


def _scalar(table, device, epilogue=None, operands=None):
    """The ``scalar`` backend on one staged table: the single-thread kernel
    on a card, the plain scalar body on the CPU."""
    dev, bits = ops.table_inputs(table, device)
    dev.update({k: torch.as_tensor(v, device=device)
                for k, v in (operands or {}).items()})
    return harness.run(registry.get(table.codec).decode, dev,
                       width=table.width, chunk_elems=table.chunk_elems,
                       backend="scalar", bits=bits, epilogue=epilogue)


def _tdeflate_batch_table():
    blobs = []
    for tokens in TD_BATCH_ROWS:
        n = sum(1 if t[0] == "l" else t[1] for t in tokens)
        blobs.append(enc.tdeflate_blob(np.zeros(n, np.uint8),
                                       [enc.encode_tdeflate_tokens(tokens)],
                                       1024, n))
    return fmt.concat_blobs(blobs)


SCALAR_CASES = [(c, w) for c in ("rle_v1", "rle_v2", "dbp", "lzss",
                                 "bitpack") for w in (1, 2, 4)] + [
    ("tdeflate", 1), ("huffman", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("codec,width", SCALAR_CASES)
def test_scalar_kernel_equals_plain_scalar_body_on_the_card(card, codec,
                                                            width):
    from repro_torch.kernels import scalar
    table = _table(codec, width)
    want = _scalar(table, "cpu")
    before = scalar.CODEC_LAUNCHES[codec]
    got = _scalar(table, card)
    torch.cuda.synchronize()
    assert scalar.CODEC_LAUNCHES[codec] == before + 1
    assert got.device.type == "cuda" and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,codec,width", [
    ("ring", "rle_v1", 1), ("ring", "rle_v2", 2), ("ring", "dbp", 4),
    ("ring", "dbp", 1), ("lzss", "lzss", 1), ("lzss", "lzss", 4),
    ("tdeflate", "tdeflate", 1)])
def test_scalar_kernel_edge_rows_on_the_card(card, rows, codec, width):
    """The all-thread kernels' edge rows (malformed dbp fields, lzss
    matches before the row's start and of zero distance, tdeflate matches
    reaching before the row) through the single-thread kernel, against the
    plain scalar body."""
    table = {"ring": lambda: _rle_ring_table(codec, width),
             "lzss": lambda: _lzss_batch_table(width),
             "tdeflate": _tdeflate_batch_table}[rows]()
    want = _scalar(table, "cpu")
    got = _scalar(table, card)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_scalar_engine_block_unit_and_epilogue_on_the_card(card):
    """``EngineConfig(all_thread=False)`` through the plan on a card: one
    single-thread launch a group (``unit="warp"``) or a batch of
    ``n_units`` rows (``unit="block"``), bit-exact against the inputs; an
    epilogue follows the kernel as ``Epilogue.apply``."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.engine import CodagEngine, EngineConfig
    from repro_torch.kernels import scalar
    rng = np.random.default_rng(8)
    arrays = [np.repeat(rng.integers(0, 900, 80), 20).astype(np.uint32),
              rng.integers(0, 1 << 9, 3000).astype(np.uint32),
              np.frombuffer(b"single thread decode " * 90, np.uint8).copy()]
    codecs = ["rle_v2", "bitpack", "tdeflate"]
    blobs = [enc.compress(a, c, 1024) for a, c in zip(arrays, codecs)]
    plan = plan_mod.DecodePlan.build(blobs)
    for unit, n_units in (("warp", 8), ("block", 3)):
        eng = CodagEngine(EngineConfig(all_thread=False, unit=unit,
                                       n_units=n_units))
        before = dict(scalar.CODEC_LAUNCHES)
        outs = plan.execute_device(eng)
        torch.cuda.synchronize()
        for a, o, b, c in zip(arrays, outs, blobs, codecs):
            assert np.array_equal(o.cpu().numpy(), a)
            want = 1 if unit == "warp" else -(-b.num_chunks // n_units)
            assert scalar.CODEC_LAUNCHES[c] - before[c] == want
    epi = harness.Epilogue(out_dtype="float32", scale_key="s")
    table = _table("rle_v1", 2)
    unfused = harness.EPILOGUE_UNFUSED
    got = _scalar(table, card, epi, {"s": np.float32(0.5)})
    want = _scalar(table, "cpu", epi, {"s": np.float32(0.5)})
    torch.cuda.synchronize()
    assert harness.EPILOGUE_UNFUSED == unfused + 2
    assert got.dtype == torch.float32 and torch.equal(got.cpu(), want)


# --------------------------------------------------------------------------
# the decode path's consumers: checkpoint, token loader, runner
# --------------------------------------------------------------------------


def _ckpt_state():
    rng = np.random.default_rng(12)
    return {"w": torch.from_numpy(rng.normal(size=(64, 48)).astype(
                np.float32)).to(torch.bfloat16),
            "m": torch.from_numpy(rng.integers(-127, 128, 6000).astype(
                np.int8)),
            "ids": torch.from_numpy(np.repeat(np.arange(60, dtype=np.int64)
                                              << 33, 40)),
            "step": torch.tensor(7, dtype=torch.int32),
            "small": torch.ones(3, dtype=torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["none", "rle_v2", "tdeflate", "bitpack"])
def test_checkpoint_device_restore_equals_host_restore_on_the_card(
        card, tmp_path, codec):
    """``restore(device_out=True)`` decodes on the card (the codec's kernel
    launched) and equals the host restore and the saved state, bit for
    bit, through ``store=`` too."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import store as bs
    s = _ckpt_state()
    ckpt.save(str(tmp_path), 1, s, codec=codec)
    host = ckpt.restore(str(tmp_path), 1, s)
    before = None if codec == "none" else _launches(codec)
    dev = ckpt.restore(str(tmp_path), 1, s, device_out=True)
    with bs.filesystem_store(tmp_path, host_budget_bytes=4096) as st:
        streamed = ckpt.restore(str(tmp_path), 1, s, device_out=True,
                                store=st, decode_window=1)
    torch.cuda.synchronize()
    if before is not None:
        assert _launches(codec) - before >= 2
    for k, want in s.items():
        assert host[k].device.type == "cpu"
        for got in (host[k], dev[k], streamed[k]):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.cpu(), want), (codec, k)
        assert dev[k].device.type == "cuda"
        assert streamed[k].device.type == "cuda"


@pytest.mark.cuda
def test_loader_device_batches_equal_host_batches_on_the_card(card):
    """Token shards decode on the card through ``two_phase_rle``: the
    ``device_out`` loader's batches are card tensors equal to the host
    loader's and to the corpus, in engine and service modes."""
    from repro_torch.data import pipeline
    toks = pipeline.synthetic_corpus(1 << 16, 151936, seed=4)
    store = pipeline.CompressedTokenStore.build(toks, 151936,
                                                shard_tokens=1 << 13)
    seq, batch = 512, 4
    want = toks.astype(np.int32) % 151936
    before = cuda_rle.CODEC_LAUNCHES["rle_v2"]
    host = iter(pipeline.CompressedLoader(store, batch=batch, seq=seq,
                                          prefetch=False))
    dev = iter(pipeline.CompressedLoader(store, batch=batch, seq=seq,
                                         device_out=True))
    with srv.DecompressionService(max_delay_ms=5) as svc:
        via_svc = iter(pipeline.CompressedLoader(
            store, batch=batch, seq=seq, service=svc, device_out=True))
        for i in range(40):           # past an epoch's end
            h, d, v = next(host), next(dev), next(via_svc)
            assert d["tokens"].device.type == "cuda"
            assert v["tokens"].device.type == "cuda"
            for k in ("tokens", "labels"):
                assert torch.equal(d[k].cpu(), h[k])
                assert torch.equal(v[k].cpu(), h[k])
            lo = (i * batch * seq) % len(toks)
            if lo + batch * seq <= len(toks):
                assert np.array_equal(h["tokens"].reshape(-1).numpy(),
                                      want[lo:lo + batch * seq])
        via_svc.close()
    dev.close()
    assert cuda_rle.CODEC_LAUNCHES["rle_v2"] > before


@pytest.mark.cuda
def test_runner_restarts_on_the_card(card, tmp_path):
    """A runner whose state lives on the card restores it there: two
    injected failures, each restore ``device_out`` through the decode
    kernels and equal to the state saved at that step."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed import fault
    saved, restored = {}, []
    real_save, real_restore = ckpt.save, ckpt.restore

    def spy_save(d, step, state, **kw):
        saved[step] = state["w"].clone()
        return real_save(d, step, state, **kw)

    def spy_restore(d, step, like, **kw):
        out = real_restore(d, step, like, **kw)
        restored.append((step, kw["device_out"], out["w"]))
        return out

    def step_fn(state, batch):
        w = state["w"] - 0.2 * (state["w"] - batch)
        return {"w": w}, float(((w - batch) ** 2).mean())

    ckpt.save, ckpt.restore = spy_save, spy_restore
    try:
        before = cuda_rle.CODEC_LAUNCHES["rle_v2"]
        runner = fault.FaultTolerantRunner(
            step_fn, str(tmp_path), ckpt_every=5, ckpt_codec="rle_v2",
            injector=fault.FailureInjector(fail_at_steps=[7, 13]))
        target = torch.full((4096,), 3.0, device=card)
        state, report = runner.run({"w": torch.zeros(4096, device=card)},
                                   (target for _ in iter(int, 1)), 20)
    finally:
        ckpt.save, ckpt.restore = real_save, real_restore
    assert report.restarts == 2 and report.steps_done == 20
    assert [s for s, _, _ in restored] == [5, 10]
    for step, device_out, w in restored:
        assert device_out and w.device.type == "cuda"
        assert torch.equal(w, saved[step])
    assert cuda_rle.CODEC_LAUNCHES["rle_v2"] - before >= 2
    assert state["w"].device.type == "cuda"


# --------------------------------------------------------------------------
# the per-row epilogue operand, the gradient wire, the model on the card
# --------------------------------------------------------------------------


def _wire_rows(n, chunk, bits, device, seed=0):
    """A bitpack table of ``n`` rows of ``chunk`` ``bits``-bit values made
    on ``device`` (``bits`` dividing 32; else packed by the host encoder),
    with a float32 scale a row (``(n, 1)``) and a zero."""
    from repro_torch.distributed import collectives
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.randint(0, 1 << min(bits, 31), (n, chunk), generator=g,
                      device=device, dtype=torch.int32)
    if 32 % bits:
        words = torch.from_numpy(np.stack([
            enc.pack_bits(r, bits) for r in u.cpu().numpy()])).to(device)
    else:
        words = collectives.pack_bits_rows(u, bits)
    dev = collectives.wire_dev(words, chunk_elems=chunk, bits=bits)
    dev["s"] = torch.rand((n, 1), generator=g, device=device) * 1e-2
    dev["z"] = torch.full((), 127.0, device=device)
    return dev


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["row", "one"])
@pytest.mark.parametrize("rows", [1, 7, 6_400_000])
def test_per_row_fused_epilogue_equals_plain_then_apply_on_the_card(
        card, rows, operand):
    """The gradient wire's decode, ``(u8 - 127) * s`` to float32 with ``s``
    of shape ``(n, 1)`` or ``(1,)``, is one fused ``bitpack_unpack``
    launch equal bit for bit to the plain bitpack body followed by
    ``Epilogue.apply``; 6.4 M rows is a 4-layer full-width qwen3-1.7B
    step's gradient."""
    dev = _wire_rows(rows, 128, 8, card)
    if operand == "one":
        dev["s"] = dev["s"][:1, 0].contiguous()
    epi = harness.Epilogue(out_dtype="float32", scale_key="s", zero_key="z")
    before = (bitpack.LAUNCHES, harness.EPILOGUE_FUSED,
              harness.EPILOGUE_UNFUSED)
    got = ops.decode(dev, codec="bitpack", width=1, chunk_elems=128,
                     backend="cuda", bits=8, epilogue=epi)
    torch.cuda.synchronize()
    assert (bitpack.LAUNCHES - before[0], harness.EPILOGUE_FUSED - before[1],
            harness.EPILOGUE_UNFUSED - before[2]) == (1, 1, 0)
    want = epi.apply(bitpack.unpack(dev["comp_words"], chunk_elems=128,
                                    width=1, bits=8), dev)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,bits,width,out", [
    (100, 8, 1, "float32"),     # rows share a block, a partial last vector
    (1000, 9, 2, "float32"),    # the tiled path, a row a block
    (65536, 4, 1, "bfloat16"),  # the weight layout, tiles of one row
    (8, 1, 1, "float16")])      # one vector a row
def test_per_row_operands_at_other_geometries_on_the_card(card, chunk, bits,
                                                          width, out):
    dev = _wire_rows(37, chunk, bits, card, seed=chunk)
    epi = harness.Epilogue(out_dtype=out, scale_key="s", zero_key="z")
    before = bitpack.LAUNCHES
    got = ops.decode(dev, codec="bitpack", width=width, chunk_elems=chunk,
                     backend="cuda", bits=bits, epilogue=epi)
    torch.cuda.synchronize()
    assert bitpack.LAUNCHES == before + 1
    want = epi.apply(bitpack.unpack(dev["comp_words"], chunk_elems=chunk,
                                    width=width, bits=bits), dev)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_row_operand_on_another_kernel_is_unfused_on_the_card(card):
    """rle_v2 reads no per-row operand: it decodes, then the epilogue runs
    as torch ops, counted in ``EPILOGUE_UNFUSED``, with the same values."""
    rng = np.random.default_rng(3)
    table = enc.compress(rng.integers(0, 6, 20000).astype(np.uint8),
                         "rle_v2", 1024)
    dev, bits = ops.table_inputs(table, card)
    dev["s"] = torch.rand((table.num_chunks, 1), device=card)
    epi = harness.Epilogue(out_dtype="float32", scale_key="s")
    before = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
    got = ops.decode(dev, codec="rle_v2", width=1,
                     chunk_elems=table.chunk_elems, backend="cuda", bits=bits,
                     epilogue=epi)
    raw = ops.decode(dev, codec="rle_v2", width=1,
                     chunk_elems=table.chunk_elems, backend="cuda", bits=bits)
    torch.cuda.synchronize()
    assert (harness.EPILOGUE_FUSED - before[0],
            harness.EPILOGUE_UNFUSED - before[1]) == (0, 1)
    assert torch.equal(got, raw.to(torch.float32) * dev["s"])


@pytest.mark.cuda
@pytest.mark.parametrize("codec,width", [
    ("rle_v1", 1), ("rle_v2", 4), ("dbp", 2), ("bitpack", 2),
    ("tdeflate", 1), ("huffman", 1), ("lzss", 1), ("lzss", 4)])
def test_padding_rows_through_every_kernel_on_the_card(card, codec, width):
    """The sharded executor's zero-length padding rows (each group padded
    to a multiple of a mesh axis whose members share the card) through the
    kernel, its fused epilogue and the single-thread kernel: every
    member's shard equal to the CPU's, one launch a group."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.engine import CodagEngine, EngineConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.kernels import scalar
    table = _table(codec, width)
    n = next(k for k in (3, 4, 5, 7) if table.num_chunks % k)
    out = {}
    for where in ("cpu", card):
        mesh = mesh_lib.make_test_mesh((n,), ("data",), device=str(where))
        sh = sharding.NamedSharding(mesh, sharding.P("data"))
        plan = plan_mod.DecodePlan.build([table])
        got = []
        for config in (EngineConfig(device=str(where)),
                       EngineConfig(device=str(where), all_thread=False)):
            before = (_launches(codec), scalar.LAUNCHES)
            [o] = plan.execute_sharded(mesh, engine=CodagEngine(config),
                                       out_shardings=sh)
            if where == card:
                grew = (_launches(codec) - before[0],
                        scalar.LAUNCHES - before[1])
                assert grew == ((1, 0) if config.all_thread else (0, 1))
            got.append(o)
        if codec not in ("tdeflate", "huffman"):
            epi = harness.Epilogue(out_dtype="float32", scale_key="s",
                                   zero_key="z")
            [o] = plan.execute_sharded(
                mesh, engine=CodagEngine(EngineConfig(device=str(where))),
                epilogue=epi, epilogue_operands={"s": np.float32(0.5),
                                                 "z": np.float32(3.0)},
                out_shardings=sh)
            got.append(o)
        assert plan._staged[(mesh, "data")][0]["comp"].shape[0] % n == 0
        out[str(where)] = got
    for c, g in zip(out["cpu"], out[str(card)]):
        pairs = zip(c.shards, g.shards) if isinstance(
            c, sharding.ShardedTensor) else [(c, g)]
        for a, b in pairs:
            assert b.device.type == "cuda"
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.cpu().reshape(-1).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("sqrt_domain", [False, True])
def test_int8_moments_on_the_card_equal_the_cpu(card, sqrt_domain):
    """``optim/adamw.py``'s quantizer on the card and on the CPU: q and s
    equal bit for bit, on planted ties at the grid's half points and on
    2^20 random values of the size of AdamW moments (the card divides by a
    tensor, as the CPU does, not by the reciprocal of 127; the CPU takes
    its square roots in float64, correctly rounded as the card's are)."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(31)
    e = rng.integers(3, 16, (64, 1))
    ties = (rng.integers(-127, 127, (64, adamw.QBLOCK)) + 0.5) * np.exp2(-e)
    ties[:, 0] = 127.0 * np.exp2(-e[:, 0])
    g = rng.standard_normal(1 << 20).astype(np.float32)
    x = np.concatenate([ties.reshape(-1), 1e-4 * g]).astype(np.float32)
    if sqrt_domain:     # not squares of floats: their roots round
        x = np.concatenate([np.square(ties.reshape(-1)),
                            np.float32(5e-8) * g * g]).astype(np.float32)
    x = torch.from_numpy(x)
    q, s = adamw._quantize(x.to(card), sqrt_domain)
    qc, sc = adamw._quantize(x, sqrt_domain)
    assert torch.equal(q.cpu(), qc)
    assert torch.equal(s.cpu().view(torch.int32), sc.view(torch.int32))


@pytest.mark.cuda
def test_wire_compressor_on_the_card(card):
    """One fused ``bitpack_unpack`` launch a leaf of a block or more,
    equal bit for bit to ``quantize_grads``; bf16 leaves stay bf16."""
    from repro_torch.distributed import collectives
    from repro_torch.optim import grad_compress as gc
    g = torch.Generator(device=card).manual_seed(1)
    grads = {"a": torch.randn((3000, 257), generator=g, device=card),
             "b": {"c": torch.randn((6, 2048), generator=g,
                                    device=card).to(torch.bfloat16),
                   "d": torch.randn((100,), generator=g, device=card)}}
    before = (bitpack.LAUNCHES, harness.EPILOGUE_UNFUSED)
    got = collectives.make_wire_compressor()(grads)
    torch.cuda.synchronize()
    assert (bitpack.LAUNCHES - before[0],
            harness.EPILOGUE_UNFUSED - before[1]) == (2, 0)
    want = gc.quantize_grads(grads)
    assert torch.equal(got["a"], want["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], want["b"]["c"])
    assert got["b"]["d"] is grads["b"]["d"]


@pytest.mark.cuda
def test_model_on_the_card_equals_the_cpu(card):
    """qwen3-1.7B at full width, 2 layers, float32 with TF32 off: the
    port's ``forward`` and ``loss_fn`` on the card equal the same on the
    CPU, on the same weights, within rtol=1e-3, atol=1e-3 (float32 sums in
    another order; the head sums over 2,048 products)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import map_tree
    from repro_torch.models import model
    cfg = dataclasses.replace(get_arch("qwen3-1.7b"), n_layers=2,
                              dtype="float32")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = model.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        gpu = map_tree(lambda t: t.to(card), cpu)
        rng = np.random.default_rng(0)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(
            np.int32))
        lab = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(
            np.int32))
        with torch.no_grad():
            want = model.forward(cfg, cpu, tok)
            got = model.forward(cfg, gpu, tok.to(card))
            lw = model.loss_fn(cfg, cpu, tok, lab)
            lg = model.loss_fn(cfg, gpu, tok.to(card), lab.to(card))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(lg.cpu(), lw, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dyadic", "ties"])
def test_moe_routing_on_the_card_equals_the_cpu(card, case):
    """qwen3-moe's routing width (128 experts, top-8) at 256 tokens, with
    capacity drops (C = 20): ``moe._dispatch_group`` on the card against the
    CPU on the same float32 inputs, whose logits both compute exactly
    (dyadic values; small integers for ties at the 8th place in most rows).
    The token table equal, the gate table within rtol 1e-5 (the two
    devices' softmax rounds its ``exp`` and sum apart); a tie goes to the
    lower expert on both, as ``lax.top_k`` sends it."""
    from repro_torch.models import moe
    rng = np.random.default_rng({"dyadic": 1, "ties": 2}[case])
    T, D, E, K, C = 256, 64, 128, 8, 20
    if case == "ties":
        xt = rng.integers(-1, 2, (T, 4)).astype(np.float32)
        router = rng.integers(-1, 2, (4, E)).astype(np.float32)
        srt = -np.sort(-(xt @ router), axis=1)
        assert (srt[:, K - 1] == srt[:, K]).mean() > 0.5
    else:
        xt = (rng.integers(-64, 65, (T, D)) / 32).astype(np.float32)
        router = (rng.integers(-64, 65, (D, E)) / 256).astype(np.float32)
    x, r = torch.from_numpy(xt), torch.from_numpy(router)
    tc, gc_ = moe._dispatch_group(x, r, E, K, C)
    tg, gg = moe._dispatch_group(x.to(card), r.to(card), E, K, C)
    assert torch.equal(tg.cpu(), tc)
    torch.testing.assert_close(gg.cpu(), gc_, rtol=1e-5, atol=0)
    assert int((tc < T).sum()) < T * K                   # drops happened


@pytest.mark.cuda
def test_wire_on_an_moe_expert_leaf_on_the_card(card):
    """A full-width MoE expert leaf, (1, 128, 4096, 1536) float32: 805 M
    elements, 6,291,456 wire rows of 128 and a 3.2 GB output, past 2^31
    bytes.  One fused ``bitpack_unpack`` launch; the decode equal bit for
    bit to ``quantize_grads`` on the same values, taken in slices of 2^20
    rows (a slice is whole quantization blocks)."""
    from repro_torch.distributed import collectives
    from repro_torch.optim import grad_compress as gc
    g = torch.Generator(device=card).manual_seed(3)
    leaf = torch.randn((1, 128, 4096, 1536), generator=g, device=card)
    before = (bitpack.LAUNCHES, harness.EPILOGUE_UNFUSED)
    got = collectives.make_wire_compressor()({"w": leaf})["w"]
    torch.cuda.synchronize()
    assert (bitpack.LAUNCHES - before[0],
            harness.EPILOGUE_UNFUSED - before[1]) == (1, 0)
    assert got.shape == leaf.shape and got.dtype == torch.float32
    flat, out = leaf.reshape(-1), got.reshape(-1)
    step = (1 << 20) * gc.QBLOCK
    for s in range(0, flat.numel(), step):
        want = gc.quantize_grads({"w": flat[s:s + step]})["w"]
        assert torch.equal(out[s:s + step], want), s


@pytest.mark.cuda
def test_hybrid_float32_decode_at_full_depth_tells_a_shared_kv_apart(card):
    """zamba2-2.7B at full width and depth (54 Mamba2 layers, the shared
    block applied 9 times), float32, TF32 off, 8 x 48 tokens: decode within
    1.5 of ``forward`` at every position (``chip_smoke.SERVE_F32_TOL``),
    and a cache whose 9 applications share one K/V store, as a decode that
    read another application's K/V would, beyond it at every position
    after the first (at the first each application reads the row it just
    wrote)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model
    cfg = dataclasses.replace(get_arch("zamba2-2.7b"), dtype="float32")
    params = model.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                               device=card)
    seq = torch.randint(0, cfg.vocab, (8, 48), device=card, dtype=torch.int32,
                        generator=torch.Generator(device=card).manual_seed(1))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            full = model.forward(cfg, params, seq)

            def replay(shared_kv: bool) -> torch.Tensor:
                cache = model.init_cache(cfg, 8, 56, device=card)
                assert cache["k"].shape[0] == 9
                if shared_kv:
                    for k in ("k", "v"):
                        cache[k] = cache[k][:1].expand_as(cache[k])
                dec = []
                for i in range(seq.shape[1]):
                    lg, cache = model.decode_step(cfg, params, cache,
                                                  seq[:, i:i + 1])
                    dec.append(lg)
                return (torch.cat(dec, 1) - full).abs().amax(dim=(0, 2))

            good, bad = replay(False), replay(True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert float(good.max()) <= 1.5, good.tolist()
    assert float(bad[1:].min()) > 1.5, bad.tolist()


# --------------------------------------------------------------------------
# the collective plane: the member reduce in bitpack's stores, DiLoCo
# --------------------------------------------------------------------------


def _gathered(n, nb, chunk, bits, device, seed=0):
    """A gathered table of ``n`` members' ``nb`` rows each, a scale a row and
    a zero (``_wire_rows`` of n * nb rows)."""
    return _wire_rows(n * nb, chunk, bits, device, seed=seed)


def _reduce_plain(dev, epi, chunk, width, bits):
    """The plain version: the bitpack body, the affine, then the member
    reduce (``harness.MemberReduce.__call__``)."""
    return epi.apply(bitpack.unpack(dev["comp_words"], chunk_elems=chunk,
                                    width=width, bits=bits), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_member_reduce_equals_plain_version_on_the_card(card, n, mean):
    """``compressed_psum`` of a leaf that is not a multiple of 128 (37 rows
    and a 77-element tail) over 1, 2, 3 and 8 members: one
    ``codag_bitpack_reduce`` launch, no unfused epilogue, and the result
    equal bit for bit to the plain version on the same gathered table and
    to the seed path's dequantize-then-sum (the same adds in the same
    order)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.engine import EngineConfig
    from repro_torch.distributed import collectives
    from repro_torch.optim import grad_compress as gc
    size = 37 * 128 + 77
    x = torch.randn((n, size), device=card,
                    generator=torch.Generator(device=card).manual_seed(n))
    seen = []
    real = plan_mod.dispatch

    def spy(dev, **kw):
        out = real(dev, **kw)
        seen.append((dev, kw, out))
        return out

    before = (bitpack.REDUCE_LAUNCHES, bitpack.LAUNCHES,
              harness.EPILOGUE_UNFUSED)
    plan_mod.dispatch = spy
    try:
        got = collectives.compressed_psum(x, config=EngineConfig(), mean=mean)
    finally:
        plan_mod.dispatch = real
    torch.cuda.synchronize()
    assert (bitpack.REDUCE_LAUNCHES - before[0], bitpack.LAUNCHES - before[1],
            harness.EPILOGUE_UNFUSED - before[2]) == (1, 0, 0)
    (dev, kw, out), = seen
    want = _reduce_plain(dev, kw["epilogue"], 128, 1, 8)
    assert out.shape == (38, 128) and torch.equal(out, want)
    seed = gc.compressed_psum(x)
    if mean:
        seed = seed / torch.full((), n, dtype=torch.float32, device=card)
    assert got.shape == (size,) and torch.equal(got, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,bits,width", [
    (128, 8, 1), (100, 8, 1), (2048, 1, 1), (300, 2, 2), (64, 4, 1),
    (130, 16, 2), (6, 32, 4)])
@pytest.mark.parametrize("operand", ["row", "one"])
def test_member_reduce_at_other_geometries_on_the_card(card, chunk, bits,
                                                       width, operand):
    """The reduce entry at every field width it takes (a partial last
    vector, rows of 6 elements, a scale a row or one for all), 3 members:
    equal to the plain version bit for bit."""
    dev = _gathered(3, 11, chunk, bits, card, seed=bits)
    if operand == "one":
        dev["s"] = dev["s"][:1, 0].contiguous()
    epi = harness.Epilogue(out_dtype="float32", scale_key="s", zero_key="z",
                           fn=harness.MemberReduce(3, True))
    before = bitpack.REDUCE_LAUNCHES
    got = ops.decode(dev, codec="bitpack", width=width, chunk_elems=chunk,
                     backend="cuda", bits=bits, epilogue=epi)
    torch.cuda.synchronize()
    assert bitpack.REDUCE_LAUNCHES == before + 1
    want = _reduce_plain(dev, epi, chunk, width, bits)
    assert got.shape == (11, chunk) and torch.equal(got, want)


@pytest.mark.cuda
def test_member_reduce_of_a_ragged_gather_on_the_card(card):
    """Ragged members (2 and 3 real rows, padded to 3): the padding row's
    lens are zeroed by the gather and, as in the plain version and the
    reference, it adds its words' dequantized values; the reduce entry
    equals the plain version bit for bit, and a member reduce at a width
    the entry does not take runs unfused."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.distributed import collectives
    vals = torch.arange(2 * 3 * 128, device=card, dtype=torch.int32) \
        .reshape(2, 3, 128) % 251
    tables = [collectives.wire_dev(collectives.pack_bits_rows(vals[m], 8),
                                   chunk_elems=128, bits=8) for m in (0, 1)]
    g = plan_mod.gather_member_tables(tables, codec="bitpack",
                                      row_counts=[2, 3])
    assert g["out_lens"].tolist() == [128, 128, 0, 128, 128, 128]
    g["s"] = torch.rand((6, 1), device=card)
    g["z"] = torch.full((), 127.0, device=card)
    epi = harness.Epilogue(out_dtype="float32", scale_key="s", zero_key="z",
                           fn=harness.MemberReduce(2, False))
    got = ops.decode(g, codec="bitpack", width=1, chunk_elems=128,
                     backend="cuda", bits=8, epilogue=epi)
    torch.cuda.synchronize()
    assert torch.equal(got, _reduce_plain(g, epi, 128, 1, 8))
    dev = _gathered(2, 4, 50, 7, card)
    before = harness.EPILOGUE_UNFUSED
    got = ops.decode(dev, codec="bitpack", width=1, chunk_elems=50,
                     backend="cuda", bits=7, epilogue=epi)
    assert harness.EPILOGUE_UNFUSED == before + 1
    assert torch.equal(got, _reduce_plain(dev, epi, 50, 1, 7))


@pytest.mark.cuda
def test_outer_sync_on_a_side_stream_on_the_card(card):
    """An outer sync launched on the pipeline's side stream while the
    caller's stream keeps working gives what the sync gives run alone, bit
    for bit (int8 and top-k wires); every pod rebased alike."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.distributed import diloco
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_test_mesh((2, 1), ("pod", "data"))
    g = torch.Generator(device=card).manual_seed(4)
    params = {"w": torch.randn((1000, 129), generator=g, device=card),
              "b": torch.randn((7,), generator=g, device=card)}
    for wire in ("int8", "topk"):
        cfgd = diloco.DiLoCoConfig(wire=wire)
        sync = diloco.make_outer_sync(mesh, cfgd, config=EngineConfig())
        outer = diloco.init_outer_state(params, mesh=mesh, cfg=cfgd)
        pod = diloco.replicate_for_pods(params, 2, mesh)
        pod = {k: v + 1e-2 * torch.randn(v.shape, generator=g, device=card)
               for k, v in pod.items()}
        want_pod, want_outer = sync(pod, outer)
        pipe = diloco.OuterSyncPipeline(sync)
        pipe.launch(pod, outer)
        busy = torch.randn((4096, 4096), generator=g, device=card)
        for _ in range(4):
            busy = busy @ busy / 64.0
        got_pod, got_outer = pipe.finish()
        torch.cuda.synchronize()
        for k in params:
            assert torch.equal(got_pod[k], want_pod[k])
            assert torch.equal(got_pod[k][0], got_pod[k][1])
            assert torch.equal(got_outer["anchor"][k], want_outer["anchor"][k])


@pytest.mark.cuda
def test_diloco_training_on_the_card(card, tmp_path):
    """``train --diloco 2`` on the card at the ``tiny`` preset: the loss
    falls, each outer sync's int8 reduce is one ``codag_bitpack_reduce``
    launch a leaf of a block or more, nothing runs unfused."""
    from repro_torch.core.tree import leaves
    from repro_torch.launch import train
    args = train.build_parser().parse_args(
        ["--preset", "tiny", "--steps", "9", "--batch", "2", "--seq", "64",
         "--diloco", "2", "--outer-every", "3", "--grad-int8",
         "--ckpt-dir", str(tmp_path)])
    before = (bitpack.REDUCE_LAUNCHES, harness.EPILOGUE_UNFUSED)
    m = train.run_training(args)
    n_wire = sum(t[0].numel() >= 128 for t in leaves(m["state"][0]))
    assert m["overlap"]["syncs"] == 2
    assert bitpack.REDUCE_LAUNCHES - before[0] == 2 * n_wire > 0
    assert harness.EPILOGUE_UNFUSED == before[1]
    assert m["losses"][-1] < m["losses"][0]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["tp", "dp"])
def test_sharded_train_step_on_the_card_equals_the_unsharded(card, policy):
    """Reduced qwen3-1.7b on the card, one step through the int8 gradient
    wire with int8 moments: ``steps.sharded_step`` on a (pod 2, data 2,
    model 2) mesh of the card equals the unsharded step on the card bit for
    bit (loss, every parameter, every moment), each member keeping its own
    blocks; the wire is one fused bitpack launch a gradient leaf."""
    from repro_torch.configs import ShapeSpec, get_arch, reduced
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import mesh as mesh_lib, steps
    from repro_torch.models import model
    from repro_torch.optim import adamw
    cfg = reduced(get_arch("qwen3-1.7b"))
    params = model.init_params(cfg, torch.Generator(card).manual_seed(0),
                               device=card)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                                 .astype(np.int32)).to(card)
             for k in ("tokens", "labels")}
    oc = adamw.AdamWConfig(lr=1e-4, compress_moments=True)
    step = steps.build_train_step(
        cfg, oc, grad_compressor=collectives.make_wire_compressor(
            EngineConfig(device="cuda")))
    opt = adamw.init(params, oc)
    whole = step(params, opt, batch)
    mesh = mesh_lib.make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    with sharding.use_mesh(mesh, policy):
        ins, outs = steps.train_shardings(cfg, ShapeSpec("t", 32, 4, "train"),
                                          mesh, oc)
        fn = steps.sharded_step(step, ins, outs)
    before = bitpack.LAUNCHES
    p2, o2, loss = fn(params, opt, batch)
    assert bitpack.LAUNCHES - before == sum(
        p.numel() >= 128 for p in leaves(params))
    assert torch.equal(whole[2], loss.full())
    for got, want in ((p2, whole[0]), (o2, whole[1])):
        got = list(leaves(sharding.gather(got)))
        want = list(leaves(want))
        assert len(got) == len(want)
        assert all(g.device.type == "cuda" and torch.equal(g, w)
                   for g, w in zip(got, want))
    wq = p2["blocks"]["attn"]["wq"]
    assert len({s.data_ptr() for s in wq.shards}) == mesh.size
