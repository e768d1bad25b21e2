"""The port's container format against the reference package.

The byte format is the contract: the port's encoders must reproduce every
committed golden-vector digest, its device layout must equal the
reference's ``CompressedBlob.to_device()``, and a reference-encoded blob
carried across with ``blob_from_reference`` must decode in the port.  Also
the port gates: no JAX and nothing of ``repro`` inside ``repro_torch`` or
``chip_smoke.py``.
"""
import ast
import base64
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import encoders as ref_enc
from repro.core import format as ref_fmt
from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core.engine import CodagEngine, EngineConfig

ROOT = Path(__file__).resolve().parents[1]
VEC_DIR = Path(__file__).parent / "vectors"
CPU = CodagEngine(EngineConfig(device="cpu"))


def _vectors():
    cases = []
    for codec in ("rle_v1", "rle_v2", "tdeflate", "bitpack", "dbp", "huffman",
                  "lzss"):
        payload = json.loads((VEC_DIR / f"{codec}.json").read_text())
        cases += [pytest.param(codec, v, id=f"{codec}-{v['name']}")
                  for v in payload["vectors"]]
    return cases


def _array(vec) -> np.ndarray:
    raw = base64.b64decode(vec["data_b64"])
    return np.frombuffer(raw, np.dtype(vec["dtype"])).reshape(vec["shape"]).copy()


def _runs(rng, n, dtype, top=50, max_run=40):
    vals = rng.integers(0, top, max(4, n // 10)).astype(dtype)
    return np.resize(np.repeat(vals, rng.integers(1, max_run, len(vals))), n)


# --------------------------------------------------------------------------
# golden vectors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("codec,vec", _vectors())
def test_encoder_reproduces_golden_digest(codec, vec):
    blob = enc.compress(_array(vec), codec, vec["chunk_bytes"], bits=vec["bits"])
    assert blob.num_chunks == vec["num_chunks"]
    assert fmt.blob_digest(blob) == vec["blob_digest"]


@pytest.mark.parametrize("codec,vec", _vectors())
def test_golden_vector_decodes_to_input(codec, vec):
    arr = _array(vec)
    blob = enc.compress(arr, codec, vec["chunk_bytes"], bits=vec["bits"])
    got = CPU.decompress(blob)
    assert got.dtype == arr.dtype and got.shape == arr.shape
    assert np.array_equal(got, arr)


@pytest.mark.parametrize("codec,vec", _vectors())
def test_to_device_equals_reference_layout(codec, vec):
    arr = _array(vec)
    ref_blob = ref_enc.compress(arr, codec, vec["chunk_bytes"])
    want = ref_blob.to_device()
    got = fmt.to_device(enc.compress(arr, codec, vec["chunk_bytes"]), "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "cpu"
        assert got[k].numpy().dtype == v.dtype, k
        assert np.array_equal(got[k].numpy(), v), k


# --------------------------------------------------------------------------
# host helpers are copies of the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["rle_v1", "rle_v2"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.float32])
def test_blob_from_reference_carries_a_reference_blob(codec, dtype):
    rng = np.random.default_rng(3)
    arr = _runs(rng, 700, dtype)
    ref_blob = ref_enc.compress(arr, codec, 256)
    blob = fmt.blob_from_reference(dataclasses.asdict(ref_blob))
    assert fmt.blob_digest(blob) == ref_fmt.blob_digest(ref_blob)
    assert fmt.blob_digest(blob) == fmt.blob_digest(enc.compress(arr, codec, 256))
    assert np.array_equal(CPU.decompress(blob), arr)


def test_blob_from_reference_rejects_foreign_fields():
    fields = dataclasses.asdict(ref_enc.compress(np.arange(9, dtype=np.uint8),
                                                 "rle_v1", 256))
    fields["extra"] = 1
    with pytest.raises(ValueError, match="blob fields"):
        fmt.blob_from_reference(fields)


def test_concat_pad_and_indices_match_reference():
    rng = np.random.default_rng(5)
    arrs = [_runs(rng, n, np.uint32) for n in (300, 129, 1)]
    ours = [enc.compress(a, "rle_v2", 512) for a in arrs]
    refs = [ref_enc.compress(a, "rle_v2", 512) for a in arrs]
    merged, ref_merged = fmt.concat_blobs(ours), ref_fmt.concat_blobs(refs)
    assert fmt.blob_digest(merged) == ref_fmt.blob_digest(ref_merged)
    padded = fmt.pad_table_rows(merged, merged.num_chunks + 3)
    ref_padded = ref_fmt.pad_table_rows(ref_merged, merged.num_chunks + 3)
    assert fmt.blob_digest(padded) == ref_fmt.blob_digest(ref_padded)
    assert fmt.group_key(merged) == ref_fmt.group_key(ref_merged)
    # the merged table's out_lens are not the standard layout: a real gather
    idx, ref_idx = fmt.reassemble_indices(merged), ref_fmt.reassemble_indices(ref_merged)
    assert idx is not None and np.array_equal(idx, ref_idx)
    assert fmt.reassemble_indices(ours[0]) is None
    with pytest.raises(ValueError):
        fmt.concat_blobs([ours[0], enc.compress(arrs[0], "rle_v1", 512)])


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.float64])
def test_combine_planes_host_and_device(dtype):
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 1 << 63, 257, dtype=np.uint64)
    arr[::3] |= np.uint64(1 << 63)                 # hi plane with the top bit
    arr = arr.view(dtype).reshape(257)
    lo = (arr.view(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (arr.view(np.uint64) >> np.uint64(32)).astype(np.uint32)
    host = fmt.combine_planes([lo, hi], str(arr.dtype), arr.shape)
    ref = ref_fmt.combine_planes([lo, hi], str(arr.dtype), arr.shape)
    dev = fmt.combine_planes_device([torch.from_numpy(lo), torch.from_numpy(hi)],
                                    str(arr.dtype), arr.shape)
    assert np.array_equal(host.view(np.uint64), arr.view(np.uint64))
    assert np.array_equal(ref.view(np.uint64), arr.view(np.uint64))
    assert dev.dtype == fmt.torch_dtype(arr.dtype)
    assert np.array_equal(dev.numpy().view(np.uint64), arr.view(np.uint64))


def test_device_view_widens_and_narrows():
    raw = np.arange(16, dtype=np.uint8)
    flat = torch.from_numpy(raw.copy())
    assert np.array_equal(fmt.device_view(flat, "float32", (2, 2)).numpy(),
                          raw.view(np.float32).reshape(2, 2))
    words = torch.from_numpy(raw.view(np.uint32).copy())
    assert np.array_equal(fmt.device_view(words, "uint16").numpy(),
                          raw.view(np.uint16))
    with pytest.raises(ValueError, match="view evenly"):
        fmt.device_view(flat[:3], "uint16")


def test_reassemble_rows_device_matches_host():
    rng = np.random.default_rng(9)
    arrs = [_runs(rng, n, np.uint16) for n in (70, 200)]
    blobs = [enc.compress(a, "rle_v1", 64) for a in arrs]
    merged = fmt.concat_blobs(blobs)
    table = torch.from_numpy(CPU.decompress_table(merged))
    row = 0
    for a, b in zip(arrs, blobs):
        got = fmt.reassemble_rows_device(
            table, row0=row, num_chunks=b.num_chunks,
            total_elems=b.total_elems, orig_dtype=b.orig_dtype,
            orig_shape=b.orig_shape)
        assert np.array_equal(got.numpy(), a)
        row += b.num_chunks
    idx = torch.from_numpy(fmt.reassemble_indices(merged))
    got = fmt.reassemble_rows_device(
        table, row0=0, num_chunks=merged.num_chunks,
        total_elems=merged.total_elems, orig_dtype="uint16",
        orig_shape=(merged.total_elems,), indices=idx)
    assert np.array_equal(got.numpy(), np.concatenate(arrs))


# --------------------------------------------------------------------------
# port gates
# --------------------------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "examples").glob("torch_*.py")) + sorted(
        (ROOT / "scripts").glob("torch_*.py"))


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    names = {p.name for p in files}
    assert {"tdeflate.py", "bitpack.py", "dbp.py", "cuda_build.py",
            "huffman.py", "lzss.py", "dequant_matmul.py", "batch.py",
            "server.py", "store.py", "tuning.py", "scalar.py",
            "checkpoint.py", "pipeline.py", "fault.py", "base.py",
            "qwen3_1b7.py", "layers.py", "attention.py", "model.py",
            "moe.py", "ssm.py",
            "adamw.py", "grad_compress.py", "sharding.py", "collectives.py",
            "steps.py", "serve.py", "train.py", "analysis.py", "count.py",
            "dryrun.py", "spmd.py", "mesh.py"} <= names
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.core.api, repro_torch.kernels.rle_v1, "
        "repro_torch.kernels.rle_v2, repro_torch.kernels.tdeflate, "
        "repro_torch.kernels.bitpack, repro_torch.kernels.dbp, "
        "repro_torch.kernels.cuda_build, repro_torch.kernels.huffman, "
        "repro_torch.kernels.lzss, repro_torch.kernels.dequant_matmul, "
        "repro_torch.core.batch, repro_torch.core.server, "
        "repro_torch.core.store, repro_torch.core.tuning, "
        "repro_torch.kernels.scalar, repro_torch.checkpoint.checkpoint, "
        "repro_torch.data.pipeline, repro_torch.distributed.fault, "
        "repro_torch.configs, repro_torch.models.layers, "
        "repro_torch.models.attention, repro_torch.models.model, "
        "repro_torch.models.moe, repro_torch.models.ssm, "
        "repro_torch.optim.adamw, repro_torch.optim.grad_compress, "
        "repro_torch.distributed.sharding, "
        "repro_torch.distributed.collectives, repro_torch.launch.steps, "
        "repro_torch.launch.serve, repro_torch.launch.train, "
        "repro_torch.roofline.analysis, repro_torch.roofline.count, "
        "repro_torch.distributed.spmd, repro_torch.launch.mesh, "
        "repro_torch.launch.dryrun\n"
        "from repro_torch.core import registry\n"
        "for c in ('rle_v1', 'rle_v2', 'tdeflate', 'bitpack', 'dbp', "
        "'huffman', 'lzss'):\n"
        "    registry.get(c)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
