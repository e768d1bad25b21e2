"""The port's DecompressionService against the reference's, on the CPU.

The same blobs, made from a numpy seed, go through the reference's service
(JAX on the CPU) and the port's (``device="cpu"``): equal outputs and equal
dispatches per ``decode_arrays`` call, and the same window, dedupe and
cache accounting.  Then the service's own contract: error isolation, a
cancelled future, ``close(timeout)``, the default service, ``devices=``,
``device_out`` futures, bucketed plans and a threaded stress run.  Every
``result()`` has a timeout.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import format as ref_fmt
from repro.core import plan as ref_plan
from repro.core import server as ref_srv
from repro.kernels import ops as ref_ops
from repro_torch.core import api, format as fmt, plan as plan_mod
from repro_torch.core import server as srv
from repro_torch.core import transfers
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.kernels import ops

CPU = CodagEngine(EngineConfig(device="cpu"))
CODECS = ("rle_v1", "rle_v2", "dbp", "bitpack", "tdeflate", "huffman",
          "lzss")
T = 60          # seconds any future may take


def _runs_u32(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 90, max(4, n // 40)).astype(np.uint32)
    return np.resize(np.repeat(vals, rng.integers(1, 80, len(vals))), n)


def _array(codec, n, seed):
    """An array each codec encodes well (bytes for the byte codecs)."""
    a = _runs_u32(n, seed)
    return a.astype(np.uint8) if codec in ("tdeflate", "huffman") else a


def _compress(codec, a):
    kw = {"bits": 7} if codec == "bitpack" else {}
    return (api.compress(a, codec, 512, **kw),
            ref_api.compress(a, codec, 512, **kw))


def _ref_blob(blob):
    return ref_fmt.CompressedBlob(**dataclasses.asdict(blob))


def _svc(**kw):
    return srv.DecompressionService(CPU, **kw)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


# --------------------------------------------------------------------------
# parity with the reference's service
# --------------------------------------------------------------------------


def test_decode_arrays_equals_reference_with_equal_dispatches():
    """Every codec plus a 64-bit plane-split array in one ``decode_arrays``
    call: the same outputs and the same dispatches as the reference's
    service, one per group key."""
    arrays = [_array(c, 700 + 40 * i, 10 + i) for i, c in enumerate(CODECS)]
    arrays.append(np.repeat(np.arange(20, dtype=np.uint64) << np.uint64(40),
                            30))
    codecs = list(CODECS) + ["rle_v2"]
    pairs = [_compress(c, a) for c, a in zip(codecs, arrays)]
    with _svc(cache_bytes=0, bucket_shapes=False) as svc, \
            ops.count_dispatches() as calls:
        outs = svc.decode_arrays([p for p, _ in pairs])
    with ref_srv.DecompressionService(cache_bytes=0,
                                      bucket_shapes=False) as ref, \
            ref_ops.count_dispatches() as ref_calls:
        ref_outs = ref.decode_arrays([r for _, r in pairs])
    assert len(calls) == len(ref_calls) == len(codecs) - 1
    assert [c["num_chunks"] for c in calls] == \
        [c["num_chunks"] for c in ref_calls]
    for a, o, r in zip(arrays, outs, ref_outs):
        _same(o, a)
        _same(o, r)


@pytest.mark.parametrize("bucket", [False, True])
def test_window_coalescing_equals_reference(bucket):
    """Eight same-group blobs submitted atomically: one window and one
    dispatch in both services (bucketed or not), outputs bit-exact."""
    arrays = [_runs_u32(700, 100 + i) for i in range(8)]
    pairs = [_compress("rle_v2", a) for a in arrays]
    got = {}
    for name, mod, eng, counter in (
            ("port", srv, {"engine": CPU}, ops.count_dispatches),
            ("ref", ref_srv, {}, ref_ops.count_dispatches)):
        blobs = [(p if name == "port" else r).blobs[0] for p, r in pairs]
        with mod.DecompressionService(cache_bytes=0, bucket_shapes=bucket,
                                      max_batch_blobs=8, max_delay_ms=2000,
                                      idle_ms=2000, **eng) as svc, \
                counter() as calls:
            outs = [f.result(timeout=T) for f in svc.submit_many(blobs)]
            stats = svc.stats()
        got[name] = (len(calls), stats.windows, stats.blobs,
                     stats.dispatch_amplification)
        for a, o in zip(arrays, outs):
            _same(o, a)
    assert got["port"] == got["ref"] == (1, 1, 8, 1 / 8)


def test_dedupe_and_cache_accounting_equal_reference():
    """The same request sequence through both services: identical blobs in
    a window decode once; repeats hit the decoded-blob LRU; the counts of
    hits, misses and dispatches are the reference's."""
    a, b = _runs_u32(900, 7), _runs_u32(900, 8)
    (pa, ra), (pb, rb) = _compress("rle_v2", a), _compress("rle_v2", b)
    got = {}
    for name, mod, eng, counter, x, y in (
            ("port", srv, {"engine": CPU}, ops.count_dispatches,
             pa.blobs[0], pb.blobs[0]),
            ("ref", ref_srv, {}, ref_ops.count_dispatches,
             ra.blobs[0], rb.blobs[0])):
        with mod.DecompressionService(cache_bytes=8 << 20, **eng) as svc, \
                counter() as calls:
            dup = [f.result(timeout=T) for f in svc.submit_many([x] * 5)]
            first = svc.decode(x)
            first[:10] = 0                  # the cached copy is private
            again = svc.decode(x)
            other = svc.decode(y)
            stats = svc.stats()
        for o in dup + [again]:
            _same(o, a)
        _same(other, b)
        got[name] = (len(calls), stats.cache_hits, stats.cache_misses,
                     stats.cache_bytes > 0)
    assert got["port"] == got["ref"]


def test_cache_byte_budget_evicts_as_reference():
    a = _runs_u32(800, 9)
    pa, ra = _compress("rle_v2", a)
    got = {}
    for name, mod, eng, blob in (("port", srv, {"engine": CPU}, pa.blobs[0]),
                                 ("ref", ref_srv, {}, ra.blobs[0])):
        with mod.DecompressionService(cache_bytes=64, **eng) as svc:
            svc.decode(blob)
            svc.decode(blob)
            s = svc.stats()
        got[name] = (s.cache_hits, s.cache_misses, s.cache_bytes)
    assert got["port"] == got["ref"] == (0, 2, 0)


def test_lru_reput_refreshes_recency():
    a, b, c = (np.full(100, i, np.uint8) for i in range(3))
    cache = srv._LRUCache(max_bytes=200)
    cache.put("a", a)
    cache.put("b", b)
    cache.put("a", a)                          # a re-put is a use
    cache.put("c", c)
    assert cache.get("b") is None
    _same(cache.get("a"), a)
    assert cache.bytes == 200 and len(cache) == 2


def test_pad_table_to_bucket_and_bucketed_plan_equal_reference():
    """Bucketed shapes equal the reference's: pow2 rows of zero-length
    chunks, pow2 columns with the 128 floor (or an explicit one), and the
    bucketed plan decodes its real rows bit for bit."""
    arrays = [_runs_u32(n, 60 + n) for n in (700, 1300, 90)]
    pairs = [_compress("rle_v2", a) for a in arrays]
    merged = fmt.concat_blobs([p.blobs[0] for p, _ in pairs])
    ref_merged = ref_fmt.concat_blobs([r.blobs[0] for _, r in pairs])
    for floor in (None, 64, 4096):
        got = fmt.pad_table_to_bucket(merged, cols_floor=floor)
        want = ref_fmt.pad_table_to_bucket(ref_merged, cols_floor=floor)
        assert got.comp.shape == want.comp.shape
        assert np.array_equal(got.comp, want.comp)
        assert np.array_equal(got.out_lens, want.out_lens)
        assert np.array_equal(got.comp_lens, want.comp_lens)
    assert srv.pad_table_to_bucket is fmt.pad_table_to_bucket
    assert srv.blob_digest is fmt.blob_digest
    blobs = [p.blobs[0] for p, _ in pairs] + [
        api.compress(np.arange(300, dtype=np.uint8), "lzss", 256).blobs[0]]
    ref_blobs = [_ref_blob(b) for b in blobs]
    plan = plan_mod.DecodePlan.build(blobs, bucket=True, bucket_floor=256)
    ref = ref_plan.DecodePlan.build(ref_blobs, bucket=True, bucket_floor=256)
    assert [(g.num_chunks, g.bucket[1]) for g in plan.groups] == \
        [g.merged.comp.shape for g in ref.groups]
    # the bucket is padded while staging: the staged table holds the padded
    # table's bytes, one upload an array
    g = plan.groups[0]
    padded = fmt.pad_table_to_bucket(g.merged, cols_floor=256)
    with transfers.count_host_transfers() as c:
        dev = g.stage("cpu")
    assert c["h2d"] == 3 + len(g.merged.extras) and c["d2h"] == 0
    comp = dev["comp"].numpy()
    assert comp.shape == (g.num_chunks, max(g.bucket[1],
                                            -(-(g.merged.comp.shape[1] + 8)
                                              // 128) * 128))
    assert np.array_equal(comp[:, :g.bucket[1]], padded.comp)
    assert not comp[:, g.bucket[1]:].any()
    assert np.array_equal(dev["comp_lens"].numpy(), padded.comp_lens)
    assert np.array_equal(dev["out_lens"].numpy(), padded.out_lens)
    assert [g.row_offsets for g in plan.groups] == \
        [g.row_offsets for g in ref.groups]
    outs = plan.execute_device(CPU)
    for b, o in zip(blobs, outs):
        _same(o.numpy(), fmt.reassemble(b, CPU.decompress_table(b)))
    table = plan.decode_group_device(0, CPU)
    assert table.shape == (plan.groups[0].num_chunks, blobs[0].chunk_elems)
    assert not table[sum(b.num_chunks for b in blobs[:3]):].any()


# --------------------------------------------------------------------------
# the service's own contract
# --------------------------------------------------------------------------


def test_bad_blob_fails_alone():
    """A blob with an unknown codec, and one whose metadata fails after the
    decode, each fail their own future; window-mates resolve and the
    worker keeps serving."""
    good_arr = _runs_u32(600, 41)
    good = api.compress(good_arr, "rle_v2", 512).blobs[0]
    bad_codec = dataclasses.replace(good, codec="no_such_codec")
    bad_shape = dataclasses.replace(good, orig_shape=(999_999,))
    with _svc() as svc:
        futs = svc.submit_many([bad_codec, bad_shape, good])
        with pytest.raises(ValueError, match="no_such_codec"):
            futs[0].result(timeout=T)
        with pytest.raises(ValueError):
            futs[1].result(timeout=T)
        _same(futs[2].result(timeout=T), good_arr)
        _same(svc.decode(good), good_arr)
        assert svc.stats().errors == 2 and svc._worker.is_alive()


def test_bad_group_fails_alone():
    """A group whose table cannot decode fails its own requests only."""
    good_arr = _runs_u32(600, 42)
    good = api.compress(good_arr, "rle_v2", 512).blobs[0]
    bits = api.compress(np.arange(100, dtype=np.uint8), "bitpack", 256,
                        bits=7).blobs[0]
    broken = dataclasses.replace(                      # 0-bit fields
        bits, extras={"bitpack_bits": np.zeros(1, np.int32)})
    with _svc(cache_bytes=0) as svc:
        f_bad, f_good = svc.submit_many([broken, good])
        with pytest.raises(Exception):
            f_bad.result(timeout=T)
        _same(f_good.result(timeout=T), good_arr)


def test_cancelled_future_does_not_kill_worker():
    arr = _runs_u32(500, 44)
    blob = api.compress(arr, "rle_v2", 512).blobs[0]
    with _svc(max_delay_ms=200, idle_ms=200) as svc:
        fut = svc.submit(blob)
        fut.cancel()
        _same(svc.decode(blob), arr)
        assert svc._worker.is_alive()


def test_close_timeout_reports_unfinished_drain(monkeypatch):
    arr = _runs_u32(400, 91)
    blob = api.compress(arr, "rle_v2", 512).blobs[0]
    svc = _svc(max_delay_ms=1, idle_ms=1)
    release = threading.Event()
    orig = svc._process_window

    def stalled(window):
        release.wait(T)
        orig(window)

    monkeypatch.setattr(svc, "_process_window", stalled)
    fut = svc.submit(blob)
    assert svc.close(timeout=0.05) is False
    assert svc._worker.is_alive()
    release.set()
    assert svc.close(timeout=T) is True
    assert not svc._worker.is_alive()
    _same(fut.result(timeout=T), arr)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(blob)


def test_close_drains_a_long_window():
    arrays = [_runs_u32(500, 30 + i) for i in range(12)]
    blobs = [api.compress(a, "rle_v2", 512).blobs[0] for a in arrays]
    svc = _svc(max_delay_ms=5000, idle_ms=5000, max_batch_blobs=1000)
    futs = [svc.submit(b) for b in blobs]
    assert svc.close(timeout=T) is True
    for a, f in zip(arrays, futs):
        assert f.done()
        _same(f.result(timeout=0), a)
    assert svc.close() is True                 # a second close is a no-op


def test_default_service_recreated_after_close():
    svc = srv.default_service("cpu")
    assert srv.default_service(torch.device("cpu")) is svc
    assert not svc.bucket_shapes and svc._cache is None
    svc.close(timeout=T)
    svc2 = srv.default_service("cpu")
    assert svc2 is not svc and not svc2.closed
    arr = _runs_u32(400, 80)
    (out,) = api.decompress_many([api.compress(arr, "rle_v2", 512)],
                                 device="cpu")
    _same(out, arr)


def test_default_service_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.default_service()


def test_compile_cache_names_its_roadmap_item(tmp_path, monkeypatch):
    """``compile_cache=`` enables the kernels' compile cache, as the
    reference's service enables its jit cache: a path pins the directory,
    True takes the port's own env var."""
    from repro_torch.core import tuning
    from repro_torch.kernels import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(tuning, "_cache_enabled_at", None)
    _svc(compile_cache=tmp_path / "a").close()
    assert cuda_build.BUILD_DIR == (tmp_path / "a").resolve()
    monkeypatch.setenv(tuning.CACHE_DIR_ENV, str(tmp_path / "b"))
    _svc(compile_cache=True).close()
    assert tuning.compile_cache_dir() == (tmp_path / "b").resolve()
    assert cuda_build.BUILD_DIR == (tmp_path / "b").resolve()


def test_submit_array_and_device_out():
    """A plane-split 64-bit array recombines, as ndarray and as a tensor;
    a device requester's cache hit is a tensor too."""
    rng = np.random.default_rng(12)
    arr = np.repeat(rng.integers(0, 2 ** 50, 20).astype(np.uint64),
                    rng.integers(1, 50, 20))
    ca = api.compress(arr, "rle_v2", 512)
    assert len(ca.blobs) == 2
    small = _runs_u32(300, 13)
    blob = api.compress(small, "rle_v1", 512).blobs[0]
    with _svc(cache_bytes=8 << 20) as svc:
        _same(svc.submit_array(ca).result(timeout=T), arr)
        dev = svc.submit_array(ca, device_out=True).result(timeout=T)
        assert isinstance(dev, torch.Tensor)
        _same(dev.numpy(), arr)
        miss = svc.submit(blob, device_out=True).result(timeout=T)
        hit = svc.submit(blob, device_out=True).result(timeout=T)
        stats = svc.stats()
    for t in (miss, hit):
        assert isinstance(t, torch.Tensor) and t.device == CPU.device
        _same(t.numpy(), small)
    assert stats.cache_hits >= 1


def test_devices_round_robin_counts_dispatches():
    """Groups go round robin across ``devices``, counted per device."""
    arrays = [_runs_u32(500, 20), np.arange(500, dtype=np.uint16),
              np.arange(300, dtype=np.uint8)]
    cas = [api.compress(a, "rle_v1", 512) for a in arrays]
    with _svc(cache_bytes=0, devices=["cpu", torch.device("cpu")]) as svc:
        outs = svc.decode_arrays(cas)
        stats = svc.stats()
    for a, o in zip(arrays, outs):
        _same(o, a)
    assert stats.dispatches == 3 and stats.device_dispatches == {"cpu": 3}


def test_stress_many_producers_lose_no_update():
    """More producer threads than cores, a short switch interval: every
    request resolves bit-exactly and the service counts every blob once
    (a lost update in its counters would break ``blobs``)."""
    arrays = [_runs_u32(300, 200 + i) for i in range(6)]
    blobs = [api.compress(a, "rle_v2", 512).blobs[0] for a in arrays]
    n_threads, per = 24, 5
    bad = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _svc(cache_bytes=1 << 20, max_delay_ms=1) as svc, \
                ops.count_dispatches() as calls:
            def producer(tid):
                for k in range(per):
                    i = (tid + k) % len(blobs)
                    if not np.array_equal(svc.decode(blobs[i]), arrays[i]):
                        bad.append((tid, k))

            threads = [threading.Thread(target=producer, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(T)
            assert not any(t.is_alive() for t in threads)
            stats = svc.stats()
    finally:
        sys.setswitchinterval(old)
    assert not bad
    assert stats.blobs == n_threads * per
    assert stats.cache_hits + stats.cache_misses == n_threads * per
    assert stats.dispatches == len(calls) <= stats.cache_misses
