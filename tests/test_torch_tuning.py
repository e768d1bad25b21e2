"""The port's tuning layer (``repro_torch.core.tuning``) against the
reference's (``repro.core.tuning``), on the CPU.

The cases of ``tests/test_tuning.py`` (table, lookup, merge, version,
explicit-wins, bucket floor, and the compile cache across processes, here
with a stand-in ``nvcc``), and then what ties the two packages together:

  * the committed port table holds the reference's ``cpu`` rows;
  * ``compress(arr, codec)`` with ``chunk_bytes=None`` and the device kind
    pinned to ``cpu`` writes the reference's blob, byte for byte, for all
    seven codecs and 1-, 2-, 4- and 8-byte dtypes;
  * kernel knobs flow from ``EngineConfig.tune`` and the table through
    ``plan.dispatch`` to the codec's kernel wrapper;
  * ``autotune`` runs over the port's engine.

The reference's Pallas pipelined-wrapper case has no counterpart.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import tuning as ref_tuning
from repro_torch.core import api, format as fmt, plan as plan_mod
from repro_torch.core import registry, server as srv, tuning
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.kernels import bitpack, cuda_build, harness

RNG = np.random.default_rng(3)
ROOT = Path(__file__).resolve().parent.parent
CPU = CodagEngine(EngineConfig(device="cpu"))
CODECS = ("rle_v1", "rle_v2", "dbp", "bitpack", "tdeflate", "huffman",
          "lzss")


def _table(codec="rle_v2", width=4, kind="cpu", **knobs):
    return {"version": tuning.TABLE_VERSION,
            "codecs": {codec: {f"w{width}": {kind: dict(knobs)}}}}


@pytest.fixture
def cpu_kind(monkeypatch):
    """Pin the port's device kind to ``cpu``: the reference under
    ``JAX_PLATFORMS=cpu`` reads ``cpu`` too, also beside a card."""
    monkeypatch.setattr(tuning, "device_kind", lambda: "cpu")


# --------------------------------------------------------------------------
# lookup semantics
# --------------------------------------------------------------------------


def test_unknown_device_kind_falls_back_to_constants():
    with tuning.override(_table(chunk_bytes=4096)):
        assert tuning.lookup("rle_v2", 4, "tpu-v99") == {}
        assert tuning.chunk_bytes_for("rle_v2", 4, "nvidia-h100") is None
        assert tuning.bucket_cols_floor("rle_v2", 4, "tpu-v99") is None


def test_missing_levels_fall_back(cpu_kind):
    with tuning.override(_table(chunk_bytes=4096)):
        assert tuning.lookup("nope", 4) == {}          # unknown codec
        assert tuning.lookup("rle_v2", 2) == {}        # unknown width
    with tuning.override({"version": 1, "codecs": {"rle_v2": {}}}):
        assert tuning.lookup("rle_v2", 4) == {}        # explicit {} fallback


def test_lookup_strips_provenance_keys(cpu_kind):
    with tuning.override(_table(chunk_bytes=8192, _tuned_MBps=123.4)):
        assert tuning.lookup("rle_v2", 4) == {"chunk_bytes": 8192}


def test_device_kind_normalization():
    assert tuning.normalize_kind("TPU v4") == "tpu-v4"
    assert tuning.normalize_kind(" NVIDIA H100 80GB HBM3 ") == \
        "nvidia-h100-80gb-hbm3"
    with tuning.override(_table(chunk_bytes=4096,
                                kind="nvidia-h100-80gb-hbm3")):
        assert tuning.lookup("rle_v2", 4, "NVIDIA H100 80GB HBM3") == {
            "chunk_bytes": 4096}
    if not torch.cuda.is_available():
        assert tuning.device_kind() == "cpu"


def test_merge_tables_preserves_other_device_kinds():
    base = _table(chunk_bytes=1024, kind="nvidia-h100-80gb-hbm3")
    new = _table(chunk_bytes=4096, kind="cpu")
    merged = tuning.merge_tables(base, new)
    kinds = merged["codecs"]["rle_v2"]["w4"]
    assert kinds["nvidia-h100-80gb-hbm3"] == {"chunk_bytes": 1024}
    assert kinds["cpu"] == {"chunk_bytes": 4096}


def test_load_table_version_mismatch_raises(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"version": 99, "codecs": {}}))
    with pytest.raises(ValueError, match="version"):
        tuning.load_table(p)
    assert tuning.load_table(tmp_path / "missing.json") == tuning.empty_table()


def test_set_table_and_override_restore(tmp_path, cpu_kind):
    p = tuning.save_table(_table(chunk_bytes=2048), tmp_path / "t.json")
    try:
        tuning.set_table(None, p)
        assert tuning.chunk_bytes_for("rle_v2", 4) == 2048
        with tuning.override(None):
            assert tuning.chunk_bytes_for("rle_v2", 4) is None
        assert tuning.chunk_bytes_for("rle_v2", 4) == 2048
    finally:
        tuning.set_table(None)
    assert tuning.chunk_bytes_for("rle_v2", 4) == 262144


# --------------------------------------------------------------------------
# explicit values beat tuned defaults at every consulting layer
# --------------------------------------------------------------------------


def test_compress_consults_table_and_explicit_wins(cpu_kind):
    arr = np.repeat(RNG.integers(0, 9, 40), 50).astype(np.uint32)
    with tuning.override(_table(chunk_bytes=4096)):
        tuned = api.compress(arr, "rle_v2")
        assert tuned.blobs[0].chunk_elems == 4096 // 4
        explicit = api.compress(arr, "rle_v2", chunk_bytes=8192)
        assert explicit.blobs[0].chunk_elems == 8192 // 4
    with tuning.override(None):   # no table at all -> hand-picked default
        default = api.compress(arr, "rle_v2")
        assert default.blobs[0].chunk_elems == fmt.DEFAULT_CHUNK_BYTES // 4


def test_a_kind_without_a_row_keeps_the_default_chunk(monkeypatch):
    """A card has no row in the committed table: 128 KiB, as the
    reference's accelerator."""
    monkeypatch.setattr(tuning, "device_kind",
                        lambda: "nvidia-h100-80gb-hbm3")
    arr = np.repeat(RNG.integers(0, 9, 40), 50).astype(np.uint32)
    for codec in CODECS:
        a = arr.astype(np.uint8) if codec in ("tdeflate", "huffman") else arr
        blob = api.compress(a, codec).blobs[0]
        assert blob.chunk_elems * blob.width == fmt.DEFAULT_CHUNK_BYTES


def test_bucket_floor_default_unchanged_without_entry():
    arr = np.repeat(RNG.integers(0, 9, 30), 40).astype(np.uint32)
    blob = api.compress(arr, "rle_v2", chunk_bytes=1024).blobs[0]
    with tuning.override(None):
        assert fmt.pad_table_to_bucket(blob).comp.shape[1] == 128
        assert fmt.bucket_shape(blob)[1] == 128


def test_bucket_floor_tuned_and_explicit(cpu_kind):
    arr = np.repeat(RNG.integers(0, 9, 30), 40).astype(np.uint32)
    blob = api.compress(arr, "rle_v2", chunk_bytes=1024).blobs[0]
    with tuning.override(_table(bucket_cols_floor=512)):
        assert fmt.pad_table_to_bucket(blob).comp.shape[1] == 512
        # explicit floor wins over the tuned entry
        assert fmt.pad_table_to_bucket(blob,
                                       cols_floor=256).comp.shape[1] == 256
        # the plan's buckets and the service's bucket_cols_floor=None
        plan = plan_mod.DecodePlan.build([blob], bucket=True)
        assert plan.groups[0].bucket[1] == 512
        assert plan_mod.DecodePlan.build(
            [blob], bucket=True, bucket_floor=256).groups[0].bucket[1] == 256
        with srv.DecompressionService(CPU, max_delay_ms=0.0) as svc:
            assert svc.bucket_cols_floor is None
            got = svc.submit_array(api.compress(arr, "rle_v2",
                                                chunk_bytes=1024))
            np.testing.assert_array_equal(got.result(timeout=60), arr)


def test_kernel_tune_merges_and_explicit_wins(cpu_kind):
    with tuning.override(_table("bitpack", chunk_bytes=4096, vpt=4)):
        # host knobs never leak into the kernel tune tuple
        assert tuning.kernel_tune("bitpack", 4) == (("vpt", 4),)
        # EngineConfig.tune-style explicit override wins per knob
        assert tuning.kernel_tune("bitpack", 4, (("vpt", 2),)) == \
            (("vpt", 2),)
    with tuning.override(None):
        assert tuning.kernel_tune("bitpack", 4) == ()


def test_tuned_defaults_decode_end_to_end(cpu_kind):
    # a tuned chunk_bytes flows compress -> plan -> decode bit-exactly
    arr = np.repeat(RNG.integers(0, 50, 60), RNG.integers(1, 80, 60)) \
        .astype(np.uint32)
    with tuning.override(_table(chunk_bytes=4096)):
        ca = api.compress(arr, "rle_v2")
        assert ca.blobs[0].chunk_elems == 1024
        np.testing.assert_array_equal(api.decompress(ca, CPU), arr)


def test_kernel_knobs_reach_the_wrapper(monkeypatch, cpu_kind):
    """``EngineConfig.tune`` and the table's kernel knobs reach the codec's
    ``cuda`` wrapper through ``plan.dispatch`` -> ``ops.decode`` ->
    ``harness.run`` (explicit wins); other backends take none; a knob the
    codec does not declare is refused."""
    seen = []
    real = bitpack.decode

    def spy(words, **kw):
        seen.append(kw.get("vpt"))
        return real(words, **kw)

    monkeypatch.setattr(bitpack, "decode", spy)
    arr = RNG.integers(0, 1 << 9, 3000).astype(np.uint32)
    ca = api.compress(arr, "bitpack", chunk_bytes=4096)
    with tuning.override(_table("bitpack", vpt=2)):
        np.testing.assert_array_equal(api.decompress(ca, CPU), arr)
        np.testing.assert_array_equal(api.decompress(ca, CodagEngine(
            EngineConfig(device="cpu", tune=(("vpt", 1),)))), arr)
        np.testing.assert_array_equal(api.decompress(ca, CodagEngine(
            EngineConfig(device="cpu", backend="torch"))), arr)
    with tuning.override(None):
        np.testing.assert_array_equal(api.decompress(ca, CPU), arr)
    assert seen == [2, 1, None]
    with pytest.raises(ValueError, match="unknown kernel knobs"):
        api.decompress(api.compress(arr, "rle_v2", chunk_bytes=4096),
                       CodagEngine(EngineConfig(device="cpu",
                                                tune=(("vpt", 2),))))


def test_bitpack_vpt_shapes_only_the_tiled_launch():
    """bitpack's knob is the tiled path's vectors a thread, a launch-time
    argument; the fast path fixes its own at build time.  The default is
    the launch's own choice, so no launch changes without a knob."""
    tiled = bitpack.launch_geometry(10, 32768, 9, 4)
    assert not tiled.fast and tiled.vpt == 4
    for v in bitpack.VPT.candidates:
        g = bitpack.launch_geometry(10, 32768, 9, 4, v)
        assert g.vpt == v and g.tiles_per_row == -(-32768 // (256 * v * 4))
    fast = bitpack.launch_geometry(10, 32768, 4, 4)
    assert fast.fast and bitpack.launch_geometry(10, 32768, 4, 4, 1) == fast
    with pytest.raises(ValueError, match="vpt"):
        bitpack.launch_geometry(10, 32768, 9, 4, 3)
    spec = registry.get("bitpack").decode
    assert [t.name for t in spec.tunables] == ["vpt"]
    assert bitpack.VPT.default is None
    assert bitpack.VPT.name not in tuning.KNOWN_KNOBS


# --------------------------------------------------------------------------
# the committed table
# --------------------------------------------------------------------------


def test_committed_table_covers_registry():
    table = tuning.load_table()
    codecs = table.get("codecs", {})
    for name in registry.names():
        assert name in codecs, f"{name} missing from tuned_defaults.json"
        allowed = set(tuning.KNOWN_KNOBS) | {
            t.name for t in registry.get(name).decode.tunables}
        for kinds in codecs[name].values():
            for knobs in kinds.values():
                unknown = {k for k in knobs
                           if not k.startswith("_")} - allowed
                assert not unknown, f"{name}: unknown knobs {unknown}"


def test_committed_table_round_trips(tmp_path):
    table = tuning.load_table()
    p = tuning.save_table(table, tmp_path / "t.json")
    assert tuning.load_table(p) == table


def test_committed_table_equals_the_reference_cpu_rows():
    """The port's table holds the reference's ``cpu`` rows, copied, and
    no other kind: no card row until a benchmark tunes at full size."""
    ours = tuning.load_table()["codecs"]
    ref = ref_tuning.load_table()["codecs"]
    ref_cpu = {c: {w: {"cpu": kinds["cpu"]} for w, kinds in ws.items()
                   if "cpu" in kinds} for c, ws in ref.items()}
    assert ours == ref_cpu
    assert sorted(ours) == sorted(registry.names())


# --------------------------------------------------------------------------
# chunk_bytes=None writes the reference's blob
# --------------------------------------------------------------------------

DTYPES = ("uint8", "int16", "uint16", "uint32", "float32", "int64",
          "uint64", "float64")


def _parity_array(codec, dtype, n=3000):
    rng = np.random.default_rng(10 * CODECS.index(codec) + DTYPES.index(dtype))
    base = registry.get(codec).demo_data(n, rng)
    return (base.astype(np.int64) % 251).astype(dtype)


def _blob_fields(blob):
    d = dataclasses.asdict(blob)
    return {k: (np.asarray(v).tobytes() if isinstance(v, np.ndarray) else
                {e: np.asarray(a).tobytes() for e, a in v.items()}
                if isinstance(v, dict) else v) for k, v in d.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("codec", CODECS)
def test_default_chunk_geometry_writes_the_reference_blob(cpu_kind, codec,
                                                          dtype):
    arr = _parity_array(codec, dtype)
    try:
        want = ref_api.compress(arr, codec)
    except Exception as e:            # the reference refuses: so must we
        with pytest.raises(type(e)):
            api.compress(arr, codec)
        return
    got = api.compress(arr, codec)
    assert (got.orig_dtype, got.orig_shape) == (want.orig_dtype,
                                                want.orig_shape)
    assert len(got.blobs) == len(want.blobs)
    for g, w in zip(got.blobs, want.blobs):
        assert g.chunk_elems == w.chunk_elems
        assert fmt.blob_digest(g) == ref_api.fmt.blob_digest(w)
        assert _blob_fields(g) == _blob_fields(w)
    if np.dtype(dtype).itemsize == 8:
        # the reference's own 64-bit device path fails under this jax:
        # hold the decode to the numpy input instead
        np.testing.assert_array_equal(api.decompress(got, CPU), arr)


# --------------------------------------------------------------------------
# the compile cache, across processes (a stand-in nvcc)
# --------------------------------------------------------------------------

_CHILD = textwrap.dedent("""
    import json, sys
    from repro_torch.core import server, tuning
    from repro_torch.core.engine import CodagEngine, EngineConfig
    from repro_torch.kernels import (bitpack, cuda_build, cuda_rle,
                                     dequant_matmul, huffman, lzss, scalar,
                                     tdeflate)
    cache = sys.argv[1]
    if cache != "-":
        server.DecompressionService(CodagEngine(EngineConfig(device="cpu")),
                                    compile_cache=cache).close()
    libs = [cuda_rle.LIB, *cuda_rle.LIB_EPI.values(), bitpack.LIB,
            tdeflate.LIB, huffman.LIB, lzss.LIB, dequant_matmul.LIB,
            scalar.LIB]
    paths = cuda_build.build_all(libs)
    print(json.dumps({"nvcc": cuda_build.NVCC_RUNS,
                      "dir": str(cuda_build.BUILD_DIR),
                      "libs": sorted(p.name for p in paths)}))
""")


def _child(cache, tmp_path):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    if not nvcc.exists():
        nvcc.parent.mkdir(parents=True)
        nvcc.write_text(
            '#!/bin/sh\nout=""; prev=""\n'
            'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; '
            'done\necho "ptxas info    : Used 8 registers"\n: > "$out"\n')
        nvcc.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"))
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _CHILD, cache],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_compile_cache_across_processes(tmp_path):
    """A second process that enables the same cache directory (through
    ``DecompressionService(compile_cache=)``) finds every library and runs
    no nvcc; the first ran one a library."""
    cache = str(tmp_path / "kernel-cache")
    cold = _child(cache, tmp_path)
    assert cold["dir"] == str(Path(cache).resolve())
    assert cold["nvcc"] == len(cold["libs"]) == 10
    assert sorted(p.name for p in Path(cache).iterdir()) == cold["libs"]
    warm = _child(cache, tmp_path)
    assert warm["nvcc"] == 0 and warm["libs"] == cold["libs"]
    other = _child(str(tmp_path / "elsewhere"), tmp_path)
    assert other["nvcc"] == 10


def test_enable_compile_cache_idempotent_and_keeps_loaded(tmp_path,
                                                          monkeypatch):
    """Enabling points every later build at the directory; a library
    already loaded stays loaded; enabling twice is one enable; the default
    is the port's own env var (not the reference's)."""
    from repro_torch.kernels import scalar
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(tuning, "_cache_enabled_at", None)
    monkeypatch.setattr(scalar.LIB, "_dll", object())   # "loaded"
    p1 = tuning.enable_compile_cache(tmp_path / "c")
    p2 = tuning.enable_compile_cache(tmp_path / "c")
    assert p1 == p2 == (tmp_path / "c").resolve() and p1.is_dir()
    assert cuda_build.BUILD_DIR == p1 == tuning.compile_cache_dir()
    assert bitpack.LIB.path.parent == p1
    assert scalar.LIB.loaded
    assert tuning.CACHE_DIR_ENV != ref_tuning.CACHE_DIR_ENV
    monkeypatch.setenv(tuning.CACHE_DIR_ENV, str(tmp_path / "env"))
    assert tuning.enable_compile_cache() == (tmp_path / "env").resolve()


# --------------------------------------------------------------------------
# autotune over the port's engine
# --------------------------------------------------------------------------


def test_autotune_on_the_cpu_engine():
    table, rows = tuning.autotune(["rle_v2", "bitpack"], smoke=True,
                                  engine=CPU, iters=1,
                                  chunk_bytes_candidates=(4096,))
    assert table["version"] == tuning.TABLE_VERSION
    for codec in ("rle_v2", "bitpack"):
        entry = table["codecs"][codec]["w4"]["cpu"]
        assert entry["chunk_bytes"] in (4096, fmt.DEFAULT_CHUNK_BYTES)
        assert set(entry) <= {"chunk_bytes", "_tuned_MBps",
                              "_default_MBps", "_size_mb"}
        assert entry["_default_MBps"] > 0
        assert entry["_tuned_MBps"] >= entry["_default_MBps"]
    names = [r[0] for r in rows]
    assert "autotune/rle_v2/speedup" in names
    assert names[-1] == "autotune/codecs_improved"
    # never saved: the committed table is unchanged
    assert tuning.load_table()["codecs"]["rle_v2"]["w4"]["cpu"][
        "chunk_bytes"] == 262144


def test_kernel_knob_space_only_on_the_card_kernels():
    """The codec's tunables are searched only where the kernels run: the
    ``cuda`` backend, all-thread, on a card; the launch's own choice comes
    first, so the hand-picked point is always measured."""
    bp = registry.get("bitpack")

    @dataclasses.dataclass
    class Stand:
        config: EngineConfig
        device: torch.device

    card = Stand(EngineConfig(), torch.device("cuda", 0))
    assert list(tuning._kernel_knob_space(bp, card)) == [
        (), (("vpt", 1),), (("vpt", 2),), (("vpt", 4),)]
    assert list(tuning._kernel_knob_space(registry.get("lzss"), card)) == \
        [()]
    for cfg, dev in ((EngineConfig(device="cpu"), "cpu"),
                     (EngineConfig(backend="torch"), "cuda"),
                     (EngineConfig(all_thread=False), "cuda")):
        assert list(tuning._kernel_knob_space(
            bp, Stand(cfg, torch.device(dev)))) == [()]
    assert harness.Tunable("x", (1,)).default is None
