"""The per-blob decode entry points of the dispatch layer held to the
reference's on the CPU.

``repro_torch.kernels.ops.decode_blob`` / ``decode_table`` /
``decode_table_device`` and ``repro_torch.core.format.reassemble_device``
against ``repro.kernels.ops`` and ``repro.core.format``: every golden
vector of every codec through the port's ``torch``, ``oracle`` and
``scalar`` backends equal to the reference's ``xla`` decode and to the
committed input bit for bit, dtype and shape included (the reference's
``pallas`` and ``scalar`` backends are its own slow tier); a fused
``concat_blobs`` table of two blobs as one dispatch; a dequant epilogue
within ``PERF.md`` §2's float32 tolerance; the device reassembly with and
without staged indices, on a row-padded table and on epilogue output.  With
no card the default ``device="cuda"`` raises, and the ``cuda`` backend
asked for on the CPU raises: nothing falls back to the CPU.
"""
import base64
import dataclasses
import functools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoders as ref_enc
from repro.core import format as ref_fmt
from repro.kernels import ops as ref_ops
from repro.kernels.harness import Epilogue as RefEpilogue
from repro_torch.core import encoders as enc, format as fmt, transfers
from repro_torch.kernels import harness, ops

VEC_DIR = Path(__file__).parent / "vectors"
CODECS = ("rle_v1", "rle_v2", "tdeflate", "bitpack", "dbp", "huffman",
          "lzss")
PORT_BACKENDS = ("torch", "oracle", "scalar")
# PERF.md §2: float32 results within rtol 5e-3, atol 1e-4
RTOL, ATOL = 5e-3, 1e-4
CHUNK = 512


def _vectors(codec: str):
    payload = json.loads((VEC_DIR / f"{codec}.json").read_text())
    return [(v, np.frombuffer(base64.b64decode(v["data_b64"]),
                              np.dtype(v["dtype"])).reshape(v["shape"]))
            for v in payload["vectors"]]


@functools.lru_cache(maxsize=None)
def _reference_decodes(codec: str) -> tuple:
    """The reference's ``decode_blob(backend="xla")`` of every vector of
    ``codec``, encoded by the reference's encoder."""
    return tuple(ref_ops.decode_blob(
        ref_enc.compress(arr, codec, v["chunk_bytes"], bits=v["bits"]),
        backend="xla") for v, arr in _vectors(codec))


def _runs(rng, n: int, dtype) -> np.ndarray:
    vals = rng.integers(0, 200, n // 6 + 1).astype(dtype)
    return np.resize(np.repeat(vals, rng.integers(1, 12, len(vals))), n)


def _pair(codec: str, seed: int = 0):
    """Two seeded arrays of one dtype (one group key), the port's and the
    reference's blobs of each."""
    rng = np.random.default_rng(seed)
    arrs = [_runs(rng, n, np.uint8) for n in (1500, 700)]
    return (arrs, [enc.compress(a, codec, CHUNK) for a in arrs],
            [ref_enc.compress(a, codec, CHUNK) for a in arrs])


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("codec", CODECS)
def test_decode_blob_matches_the_reference_and_the_vectors(codec, backend):
    """Every golden vector decodes to its committed input, equal to the
    reference's ``xla`` decode in dtype, shape and bits."""
    want = _reference_decodes(codec)
    for (v, arr), ref in zip(_vectors(codec), want):
        blob = enc.compress(arr, codec, v["chunk_bytes"], bits=v["bits"])
        got = ops.decode_blob(blob, backend, device="cpu")
        label = f"{codec}/{backend}/{v['name']}"
        assert isinstance(got, np.ndarray), label
        assert got.dtype == arr.dtype == ref.dtype, label
        assert got.shape == arr.shape == ref.shape, label
        assert np.array_equal(got, arr), label
        assert np.array_equal(got, ref), label


@pytest.mark.parametrize("codec", CODECS)
def test_fused_table_is_one_dispatch_equal_to_the_reference(codec):
    """Two blobs of one group merged by ``concat_blobs`` decode with one
    dispatch to the reference's ``decode_table`` of its own merge, and
    each blob's rows reassemble to its input."""
    arrs, ours, refs = _pair(codec)
    merged = fmt.concat_blobs(ours)
    ref_merged = ref_fmt.concat_blobs(refs)
    assert fmt.blob_digest(merged) == ref_fmt.blob_digest(ref_merged)
    with ops.count_dispatches() as calls, \
            transfers.count_host_transfers() as moved:
        got = ops.decode_table(merged, "torch", device="cpu")
    assert len(calls) == 1 and calls[0]["num_chunks"] == merged.num_chunks
    assert moved["h2d"] >= 3 and moved["d2h"] == 1
    want = ref_ops.decode_table(ref_merged, backend="xla")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    row = 0
    for a, b in zip(arrs, ours):
        assert np.array_equal(
            fmt.reassemble(b, got[row:row + b.num_chunks]), a)
        row += b.num_chunks


@pytest.mark.parametrize("codec", ("rle_v2", "bitpack", "tdeflate"))
def test_decode_table_device_with_a_dequant_epilogue(codec):
    """``(x - z) * s`` in float32, the operands in the table's extras, on
    the device table against the reference's ``decode_table_device``."""
    arrs, ours, refs = _pair(codec, seed=1)
    ops_ = {"z": np.uint8(7), "s": np.float32(0.0375)}
    ours = dataclasses.replace(ours[0], extras={**ours[0].extras, **ops_})
    refs = dataclasses.replace(refs[0], extras={**refs[0].extras, **ops_})
    epi = harness.Epilogue(out_dtype="float32", zero_key="z", scale_key="s")
    got = ops.decode_table_device(ours, "torch", device="cpu", epilogue=epi)
    want = np.asarray(ref_ops.decode_table_device(
        refs, "xla", epilogue=RefEpilogue(out_dtype="float32",
                                          zero_key="z", scale_key="s")))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    out = fmt.reassemble_device(ours, got, transformed=True)
    np.testing.assert_allclose(
        out.numpy(), (arrs[0].astype(np.float32) - 7) * np.float32(0.0375),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("codec", CODECS)
def test_reassemble_device_matches_the_host_and_the_reference(codec):
    """On every vector: ``reassemble_device`` of the device table equals
    ``reassemble`` of the host table and the reference's
    ``reassemble_device``; with the indices staged beforehand it moves
    nothing between host and device.  On a table padded with zero-length
    rows, a cast epilogue's output (``transformed=True``) equals the host
    path cast."""
    for v, arr in _vectors(codec):
        blob = enc.compress(arr, codec, v["chunk_bytes"], bits=v["bits"])
        table = ops.decode_table_device(blob, "torch", device="cpu")
        got = fmt.reassemble_device(blob, table)
        want = fmt.reassemble(blob, table.numpy())
        ref_blob = ref_fmt.CompressedBlob(**dataclasses.asdict(blob))
        ref = np.asarray(ref_fmt.reassemble_device(
            ref_blob, jnp.asarray(table.numpy())))
        assert got.dtype == fmt.torch_dtype(arr.dtype), v["name"]
        assert np.array_equal(got.numpy(), want), v["name"]
        assert np.array_equal(got.numpy(), ref) and ref.shape == arr.shape
        padded = fmt.pad_table_rows(blob, blob.num_chunks + 3)
        cast = ops.decode_table_device(
            padded, "torch", device="cpu",
            epilogue=harness.Epilogue(out_dtype="float32"))
        assert cast.shape[0] == blob.num_chunks + 3
        out = fmt.reassemble_device(blob, cast, transformed=True)
        ref_out = np.asarray(ref_fmt.reassemble_device(
            ref_blob, jnp.asarray(cast.numpy()), transformed=True))
        assert out.dtype == torch.float32 and out.shape == ref_out.shape
        assert np.array_equal(out.numpy(), ref_out)
        # the decoded elements cast (tdeflate and huffman decode bytes)
        assert np.array_equal(out.numpy().reshape(-1), table.reshape(
            -1)[:blob.total_elems].numpy().astype(np.float32))


def test_reassemble_device_with_staged_indices():
    """A merged table's rows are not the standard layout, so reassembly
    gathers: with ``indices=`` staged it equals the reference's gather
    and makes no host transfer; without them the gather is derived and
    uploaded through the funnel."""
    arrs, ours, refs = _pair("rle_v1", seed=2)
    merged = fmt.concat_blobs(ours)
    table = ops.decode_table_device(merged, "torch", device="cpu")
    idx = fmt.reassemble_indices(merged)
    assert idx is not None
    staged = transfers.to_device(idx, table.device)
    with transfers.no_host_transfers(), \
            transfers.count_host_transfers() as moved:
        got = fmt.reassemble_device(merged, table, indices=staged)
    assert moved == {"d2h": 0, "bytes": 0, "h2d": 0, "h2d_bytes": 0}
    want = np.asarray(ref_fmt.reassemble_device(
        ref_fmt.concat_blobs(refs), jnp.asarray(table.numpy())))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.concatenate(arrs))
    with transfers.count_host_transfers() as moved:
        again = fmt.reassemble_device(merged, table)
    assert moved["h2d"] == 1 and moved["d2h"] == 0
    assert torch.equal(again, got)


@pytest.mark.parametrize("entry", ["decode_blob", "decode_table",
                                   "decode_table_device"])
def test_entry_points_never_fall_back_to_the_cpu(entry, monkeypatch):
    """Without a card (as here, or as the test makes it look) the defaults
    (``cuda`` on ``device="cuda"``) and any backend on ``device="cuda"``
    raise; the ``cuda`` backend on the CPU raises rather than run the
    plain bodies; nothing is dispatched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = enc.compress(np.arange(300, dtype=np.uint32), "rle_v2", CHUNK)
    fn = getattr(ops, entry)
    with ops.count_dispatches() as calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(blob)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(blob, "torch")
        with pytest.raises(ValueError, match="cuda backend"):
            fn(blob, "cuda", device="cpu")
    assert calls == []
    with pytest.raises(ValueError, match="unknown backend"):
        fn(blob, "xla", device="cpu")
