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
