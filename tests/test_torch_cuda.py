"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a card.  The file imports nothing
of JAX or of the reference package, so it runs where the kernels run:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each decode kernel's output must equal its plain version's on the same
staged table (tolerance zero), the dequant matmul's within the stated
tolerance, and each launch must add one to its count.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import encoders as enc, format as fmt, registry
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
