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
