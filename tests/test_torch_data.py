"""The port's compressed token pipeline (``repro_torch.data.pipeline``)
against the reference's, on the CPU.

Each case of ``tests/test_data.py`` and the pipeline cases of
``tests/test_store.py`` and ``tests/test_device_resident.py`` run on the
port with a CPU engine.  Then parity: ``synthetic_corpus`` is the
reference's array, each shard blob the reference's, and the port's loader
streams the reference loader's batches, in engine and service modes, at
decode windows 1 and 4.
"""
import dataclasses
import gc
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.server import DecompressionService as RefService
from repro.data import pipeline as ref_pl
from repro.kernels import ops as ref_ops
from repro_torch.core import format as fmt
from repro_torch.core import server as srv
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.data import pipeline
from repro_torch.kernels import ops

CPU = CodagEngine(EngineConfig(device="cpu"))


def _loader(store, **kw):
    kw.setdefault("engine", CPU)
    return pipeline.CompressedLoader(store, **kw)


# --------------------------------------------------------------------------
# tests/test_data.py
# --------------------------------------------------------------------------


def test_synthetic_corpus_compressible():
    toks = pipeline.synthetic_corpus(1 << 16, vocab=50000)
    store = pipeline.CompressedTokenStore.build(toks, 50000,
                                                codec=fmt.RLE_V2)
    assert store.ratio < 0.9          # zipf + runs compress
    ref = ref_pl.CompressedTokenStore.build(toks, 50000, codec=fmt.RLE_V2)
    assert store.ratio == ref.ratio


def test_loader_roundtrip_and_shapes():
    toks = pipeline.synthetic_corpus(1 << 15, vocab=1000, seed=3)
    store = pipeline.CompressedTokenStore.build(
        toks, 1000, shard_tokens=1 << 13, codec=fmt.RLE_V2,
        chunk_bytes=4096)
    it = iter(_loader(store, batch=4, seq=64, prefetch=False))
    b1 = next(it)
    next(it)
    assert b1["tokens"].shape == (4, 64)
    assert b1["tokens"].dtype == torch.int32
    # labels are next-token shifted
    flat_t = b1["tokens"].reshape(-1).numpy()
    flat_l = b1["labels"].reshape(-1).numpy()
    np.testing.assert_array_equal(flat_t[1:], flat_l[:-1])
    # decoded stream matches the original corpus
    np.testing.assert_array_equal(flat_t,
                                  toks[:4 * 64].astype(np.int32) % 1000)


def test_loader_prefetch_thread():
    toks = pipeline.synthetic_corpus(1 << 14, vocab=500, seed=5)
    store = pipeline.CompressedTokenStore.build(
        toks, 500, shard_tokens=1 << 12, codec=fmt.RLE_V1, chunk_bytes=2048)
    batches = []
    for i, b in enumerate(_loader(store, batch=2, seq=32, prefetch=True)):
        batches.append(b)
        if i >= 3:
            break
    assert len(batches) == 4
    flat = torch.cat([b["tokens"].reshape(-1)[:1] for b in batches])
    np.testing.assert_array_equal(
        flat.numpy(), toks[[0, 64, 128, 192]].astype(np.int32) % 500)


def test_windowed_batched_decode_matches_per_shard():
    """decoded_shards(window=N) fuses shard chunks into batched launches
    and is bit-exact against the per-shard path, in the same order, with
    the reference's launch count."""
    toks = pipeline.synthetic_corpus(1 << 15, vocab=800, seed=7)
    store = pipeline.CompressedTokenStore.build(
        toks, 800, shard_tokens=1 << 12, codec=fmt.RLE_V2, chunk_bytes=2048)
    assert len(store.blobs) >= 4
    per_shard = list(store.decoded_shards(CPU, window=1))
    with ops.count_dispatches() as calls:
        windowed = list(store.decoded_shards(CPU, window=4))
    assert len(windowed) == len(per_shard)
    for a, b in zip(per_shard, windowed):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    # all shards share one group key -> one launch per window of 4 shards
    assert len(calls) == (len(store.blobs) + 3) // 4
    ref = ref_pl.CompressedTokenStore.build(
        toks, 800, shard_tokens=1 << 12, codec=fmt.RLE_V2, chunk_bytes=2048)
    from repro.core.engine import CodagEngine as RefEngine
    with ref_ops.count_dispatches() as ref_calls:
        list(ref.decoded_shards(RefEngine(), window=4))
    assert len(ref_calls) == len(calls)


def test_loader_service_mode_matches_engine_mode():
    """CompressedLoader(service=) replaces the prefetch thread with
    DecompressionService futures and streams identical batches."""
    toks = pipeline.synthetic_corpus(1 << 14, vocab=700, seed=13)
    store = pipeline.CompressedTokenStore.build(
        toks, 700, shard_tokens=1 << 12, codec=fmt.RLE_V2, chunk_bytes=2048)
    ref_loader = _loader(store, batch=2, seq=48, prefetch=False)
    with srv.DecompressionService(CPU, max_delay_ms=10) as svc:
        svc_loader = pipeline.CompressedLoader(store, batch=2, seq=48,
                                               service=svc)
        assert svc_loader.engine is None
        for i, (ref, got) in enumerate(zip(ref_loader, svc_loader)):
            assert torch.equal(ref["tokens"], got["tokens"])
            assert torch.equal(ref["labels"], got["labels"])
            if i >= 3:
                break
        stats = svc.stats()
    assert stats.blobs >= len(store.blobs)
    # epoch 2 re-reads the same shards: the decoded-blob cache absorbs them
    assert stats.cache_hits > 0 or stats.blobs == len(store.blobs)


def test_decoded_shards_async_order_and_exactness():
    toks = pipeline.synthetic_corpus(1 << 14, vocab=400, seed=17)
    store = pipeline.CompressedTokenStore.build(
        toks, 400, shard_tokens=1 << 12, codec=fmt.RLE_V1, chunk_bytes=2048)
    eng_shards = list(store.decoded_shards(CPU, window=1))
    with srv.DecompressionService(CPU) as svc:
        svc_shards = list(store.decoded_shards_async(svc, lookahead=3))
    assert len(svc_shards) == len(eng_shards)
    for a, b in zip(eng_shards, svc_shards):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_tdeflate_token_store():
    toks = pipeline.synthetic_corpus(1 << 14, vocab=30000, seed=9)
    store = pipeline.CompressedTokenStore.build(
        toks, 30000, codec=fmt.TDEFLATE, chunk_bytes=8192)
    b = next(iter(_loader(store, batch=2, seq=128, prefetch=False)))
    np.testing.assert_array_equal(b["tokens"].reshape(-1).numpy(),
                                  toks[:256].astype(np.int32) % 30000)


# --------------------------------------------------------------------------
# tests/test_store.py and tests/test_device_resident.py
# --------------------------------------------------------------------------


def test_loader_iterator_dropped_without_leaking_thread():
    """Dropping a prefetching loader's iterator stops its worker, which
    would otherwise block on ``q.put`` forever."""
    toks = pipeline.synthetic_corpus(1 << 14, vocab=500, seed=5)
    store = pipeline.CompressedTokenStore.build(
        toks, 500, shard_tokens=1 << 12, chunk_bytes=2048)
    it = iter(_loader(store, batch=2, seq=32, prefetch=True))
    next(it)                                   # worker is now running
    it.close()                                 # generator finalization path
    del it
    gc.collect()
    deadline = time.time() + 5
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t.name.startswith("codag-loader-prefetch")
                  and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"prefetch worker leaked: {leaked}"


@pytest.mark.parametrize("mode", ["engine", "service"])
def test_a_decode_error_raises_in_the_consumer(mode):
    """A shard whose decode raises (an unknown codec on the second of four
    shards) raises its error in the consumer's thread within 10 s: from the
    prefetch thread in engine mode, from the service's future in service
    mode.  No prefetch thread is left behind."""
    toks = pipeline.synthetic_corpus(1 << 14, vocab=500, seed=21)
    store = pipeline.CompressedTokenStore.build(
        toks, 500, shard_tokens=1 << 12, codec=fmt.RLE_V2, chunk_bytes=2048)
    store.blobs[1] = dataclasses.replace(store.blobs[1],
                                         codec="no_such_codec")
    got = {"batches": 0}

    def consume(loader):
        try:
            for _ in loader:
                got["batches"] += 1
        except Exception as e:           # the error the loader raised
            got["error"] = e

    with srv.DecompressionService(CPU) as svc:
        loader = (_loader(store, batch=2, seq=48, decode_window=1)
                  if mode == "engine" else
                  pipeline.CompressedLoader(store, batch=2, seq=48,
                                            service=svc, decode_window=1))
        th = threading.Thread(target=consume, args=(loader,), daemon=True)
        th.start()
        th.join(10.0)
        assert not th.is_alive(), "the consumer hangs on a decode error"
    assert isinstance(got.get("error"), ValueError), got
    assert "no_such_codec" in str(got["error"])
    assert got["batches"] == (1 << 12) // 97   # shard 0's batches came first
    gc.collect()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("codag-loader-prefetch")
                and t.is_alive()]


def test_service_counts_a_window_before_its_futures_resolve(monkeypatch):
    """A caller holding a result reads stats that include its window: each
    request's resolve sees its window, blob and dispatch counted."""
    toks = pipeline.synthetic_corpus(1 << 13, vocab=300, seed=22)
    store = pipeline.CompressedTokenStore.build(
        toks, 300, shard_tokens=1 << 11, codec=fmt.RLE_V2, chunk_bytes=2048)
    seen = []
    real = srv.DecompressionService._resolve

    def resolve(self, req, value):
        seen.append(self.stats())
        real(self, req, value)

    monkeypatch.setattr(srv.DecompressionService, "_resolve", resolve)
    with srv.DecompressionService(CPU, max_batch_blobs=1,
                                  cache_bytes=0) as svc:
        for i, blob in enumerate(store.blobs):
            svc.submit(blob).result()
            s = svc.stats()
            assert (s.windows, s.blobs, s.dispatches) == (i + 1,) * 3
    assert [(s.windows, s.blobs, s.dispatches) for s in seen] == \
        [(i + 1,) * 3 for i in range(len(store.blobs))]


def test_closing_a_service_loader_settles_its_lookahead(monkeypatch):
    """A service-mode loader dropped after its first batch returns only
    once the shard requests it had in flight have been decoded and
    counted, however slow the service: the stats read after it count all
    four."""
    toks = pipeline.synthetic_corpus(1 << 14, vocab=700, seed=23)
    store = pipeline.CompressedTokenStore.build(
        toks, 700, shard_tokens=1 << 12, codec=fmt.RLE_V2, chunk_bytes=2048)
    real = srv.DecompressionService._process_window
    calls = []

    def slow(self, window):
        calls.append(len(window))
        if len(calls) > 1:
            time.sleep(0.2)              # later windows lag the consumer
        real(self, window)

    monkeypatch.setattr(srv.DecompressionService, "_process_window", slow)
    with srv.DecompressionService(CPU, max_batch_blobs=1,
                                  cache_bytes=0) as svc:
        it = iter(pipeline.CompressedLoader(store, batch=2, seq=48,
                                            service=svc))
        next(it)
        it.close()
        stats = svc.stats()
    assert len(store.blobs) == 4
    assert (stats.windows, stats.blobs, stats.errors) == (4, 4, 0)


def test_token_store_spill_dir_bit_exact(tmp_path):
    toks = pipeline.synthetic_corpus(1 << 14, vocab=700, seed=2)
    in_mem = pipeline.CompressedTokenStore.build(
        toks, 700, shard_tokens=1 << 12, chunk_bytes=2048)
    spilled = pipeline.CompressedTokenStore.build(
        toks, 700, shard_tokens=1 << 12, chunk_bytes=2048,
        spill_dir=tmp_path, host_budget_bytes=1 << 16)
    assert spilled.spilled and not in_mem.spilled
    assert spilled.num_shards == in_mem.num_shards
    assert abs(spilled.ratio - in_mem.ratio) < 1e-9
    a = np.concatenate([x.reshape(-1) for x in in_mem.decoded_shards(CPU)])
    b = np.concatenate([x.reshape(-1)
                        for x in spilled.decoded_shards(CPU, window=2)])
    np.testing.assert_array_equal(a, b)
    s = spilled.store.stats()
    assert s.backend_fetches == spilled.num_shards   # demand-paged once
    spilled.store.close()


def test_pipeline_device_shards():
    """``device_out`` on a CPU engine: int32 tensors equal to the host
    shards, and a loader whose batches equal the host loader's."""
    toks = pipeline.synthetic_corpus(40000, 500, seed=2)
    store = pipeline.CompressedTokenStore.build(toks, 500, shard_tokens=8192,
                                                chunk_bytes=2048)
    host = list(store.decoded_shards(CPU, window=2))
    dev = list(store.decoded_shards(CPU, window=2, device_out=True))
    assert len(host) == len(dev)
    for h, d in zip(host, dev):
        assert isinstance(d, torch.Tensor) and d.dtype == torch.int32
        np.testing.assert_array_equal(d.numpy(), h)
    b = next(iter(_loader(store, batch=2, seq=128, prefetch=False,
                          device_out=True)))
    assert b["tokens"].shape == (2, 128)
    hb = next(iter(_loader(store, batch=2, seq=128, prefetch=False)))
    assert torch.equal(b["tokens"], hb["tokens"])


def test_mesh_names_its_roadmap_item():
    """``mesh=`` runs on a mesh whose members share one device
    (``tests/test_torch_sharded.py``) and on a mesh over a world's ranks
    (``tests/test_torch_spmd_decode.py``); a mesh over distinct devices in
    one process raises, pointing to ``launch.mesh.spawn``."""
    from repro_torch.launch import mesh as mesh_lib
    spread = mesh_lib.Mesh([torch.device("cpu"), torch.device("meta")],
                           ("data",))
    toks = pipeline.synthetic_corpus(4096, 500)
    store = pipeline.CompressedTokenStore.build(toks, 500, chunk_bytes=2048)
    with pytest.raises(NotImplementedError, match="launch.mesh.spawn"):
        pipeline.CompressedLoader(store, batch=2, seq=8, engine=CPU,
                                  mesh=spread)
    with pytest.raises(NotImplementedError, match="launch.mesh.spawn"):
        next(store.decoded_shards(CPU, mesh=spread))


# --------------------------------------------------------------------------
# parity with the reference pipeline
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,vocab", [(0, 1 << 15, 151936),
                                          (5, 40000, 500), (9, 1, 7)])
def test_synthetic_corpus_equals_reference(seed, n, vocab):
    got = pipeline.synthetic_corpus(n, vocab, seed=seed)
    want = ref_pl.synthetic_corpus(n, vocab, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["engine", "service"])
@pytest.mark.parametrize("window", [1, 4])
def test_loader_batches_equal_reference(tmp_path, mode, window):
    """The same corpus through both packages' stores (spilled, under a
    host budget below the corpus) and loaders: equal shard blobs, and the
    first batches equal, past an epoch's end."""
    toks = pipeline.synthetic_corpus(20000, 900, seed=21)
    kw = dict(shard_tokens=2048, chunk_bytes=1024, host_budget_bytes=4096)
    store = pipeline.CompressedTokenStore.build(
        toks, 900, spill_dir=tmp_path / "port", **kw)
    ref = ref_pl.CompressedTokenStore.build(
        toks, 900, spill_dir=tmp_path / "ref", **kw)
    for i in range(store.num_shards):
        want = dataclasses.asdict(ref.blob(i))
        got = dataclasses.asdict(store.blob(i))
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(np.asarray(got[k]), np.asarray(v)), (i, k)
    n_batches = 10                    # 10 x (2 x 1200 + 1) > 20000 tokens
    loaders = {}
    with srv.DecompressionService(CPU, max_delay_ms=5) as svc, \
            RefService(max_delay_ms=5) as ref_svc:
        if mode == "engine":
            loaders["port"] = _loader(store, batch=2, seq=1200,
                                      decode_window=window)
            loaders["ref"] = ref_pl.CompressedLoader(
                ref, batch=2, seq=1200, decode_window=window)
        else:
            loaders["port"] = pipeline.CompressedLoader(
                store, batch=2, seq=1200, service=svc,
                decode_window=window)
            loaders["ref"] = ref_pl.CompressedLoader(
                ref, batch=2, seq=1200, service=ref_svc,
                decode_window=window)
        its = {k: iter(v) for k, v in loaders.items()}
        for _ in range(n_batches):
            got, want = next(its["port"]), next(its["ref"])
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
        for it in its.values():
            it.close()
    store.store.close()
    ref.store.close()
