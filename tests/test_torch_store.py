"""The port's tiered blob store (a copy of ``repro.core.store``) against the
reference's.

The same sequence of operations runs on both stores, each over its own
backend holding the same payloads: equal ``StoreStats`` counts (fetches,
evictions, host hits and misses, releases) after every scenario.  Then a
streaming restore through the port's service (``submit_key`` over
``stream_windows``) is bit-exact for every codec, with the same store
counts as the reference's service on the same keys.
"""
import pickle
import threading
import time

import numpy as np
import pytest

from repro.core import api as ref_api
from repro.core import server as ref_srv
from repro.core import store as ref_bs
from repro_torch.core import api
from repro_torch.core import server as srv
from repro_torch.core import store as bs
from repro_torch.core.engine import CodagEngine, EngineConfig

CPU = CodagEngine(EngineConfig(device="cpu"))
MODS = {"port": bs, "ref": ref_bs}
T = 60


def _counts(s) -> tuple:
    return (s.host_hits, s.host_misses, s.host_evictions, s.host_released,
            s.host_bytes, s.host_entries, s.backend_fetches,
            s.backend_bytes_fetched)


def _put_objs(mod, backend, n, nbytes=2000):
    st = mod.TieredBlobStore(backend)
    keys = [f"k{i:03d}" for i in range(n)]
    objs = {k: np.full(nbytes // 8, i, np.int64) for i, k in enumerate(keys)}
    sizes = {k: st.put(k, objs[k]) for k in keys}
    st.close()
    return keys, objs, sizes


def _gated(mod):
    class Gated(mod.MemoryBackend):
        """``get`` waits on a per-key event and records the order fetches
        start."""

        def __init__(self):
            super().__init__()
            self.gates, self.started = {}, []
            self._order = threading.Lock()

        def gate(self, key):
            self.gates[key] = threading.Event()
            return self.gates[key]

        def get(self, key):
            with self._order:
                self.started.append(key)
            ev = self.gates.get(key)
            if ev is not None and not ev.wait(timeout=30):
                raise TimeoutError(key)
            return super().get(key)

    return Gated()


def _both(scenario):
    """Run ``scenario(mod)`` on the port's and the reference's store; the
    results (stats counts and whatever else it returns) must agree."""
    got = {name: scenario(mod) for name, mod in MODS.items()}
    assert got["port"] == got["ref"], got
    return got["port"]


def test_promotion_and_release_demotion():
    def scenario(mod):
        be = mod.MemoryBackend()
        keys, objs, _ = _put_objs(mod, be, 3)
        with mod.TieredBlobStore(be) as st:
            got = st.get(keys[0])
            np.testing.assert_array_equal(got, objs[keys[0]])
            assert st.get(keys[0]) is got          # tier-1 hit, same object
            first = _counts(st.stats())
            st.release([keys[0]])
            resident = st.resident(keys[0])
            np.testing.assert_array_equal(st.get(keys[0]), objs[keys[0]])
            return first, resident, _counts(st.stats())

    first, resident, last = _both(scenario)
    assert first[:2] == (1, 1) and first[6] == 1 and not resident
    assert last[3] == 1 and last[6] == 2


def test_watermark_eviction_hysteresis():
    def scenario(mod):
        be = mod.MemoryBackend()
        keys, _, sizes = _put_objs(mod, be, 10)
        per = next(iter(sizes.values()))
        with mod.TieredBlobStore(be, host_budget_bytes=5 * per + per // 2,
                                 low_watermark=0.5) as st:
            for k in keys[:6]:
                st.get(k)
            return (_counts(st.stats()), st.resident(keys[5]),
                    st.resident(keys[0]), st.resident(keys[4]))

    counts, newest, oldest, kept = _both(scenario)
    assert counts[2] == 4 and newest and not oldest and kept


def test_oversized_entry_and_prefetch_join():
    def scenario(mod):
        be = _gated(mod)
        keys, objs, _ = _put_objs(mod, be, 2, nbytes=4000)
        ev = be.gate(keys[1])
        with mod.TieredBlobStore(be, host_budget_bytes=100) as st:
            st.get(keys[0])
            st.get(keys[0])                       # oversized, still a hit
            st.prefetch([keys[1]])
            time.sleep(0.05)                      # parked on the gate
            inflight = st.stats().inflight_fetches
            ev.set()
            np.testing.assert_array_equal(st.get(keys[1]), objs[keys[1]])
            return inflight, _counts(st.stats())

    inflight, counts = _both(scenario)
    assert inflight == 1 and counts[6] == 2 and counts[0] == 2


def test_stream_windows_exactly_once_and_bounded():
    def scenario(mod):
        be = mod.MemoryBackend()
        keys, objs, sizes = _put_objs(mod, be, 8)
        win_bytes = 2 * next(iter(sizes.values()))
        peak = 0
        with mod.TieredBlobStore(be, host_budget_bytes=2 * win_bytes + 64) \
                as st:
            for i, w in enumerate(st.stream_windows(keys, window=2)):
                np.testing.assert_array_equal(w[0], objs[keys[2 * i]])
                peak = max(peak, st.stats().host_bytes)
            return peak <= 2 * win_bytes + 64, _counts(st.stats())

    bounded, counts = _both(scenario)
    assert bounded and counts[6] == 8 and counts[3] == 8 and counts[4] == 0


def test_stream_windows_lookahead_orders():
    """lookahead=1 starts window i+1's fetches and nothing past them;
    lookahead=0 starts only the current window's."""
    def scenario(mod):
        started = []
        for lookahead in (1, 0):
            be = _gated(mod)
            keys, _, _ = _put_objs(mod, be, 6)
            if lookahead:
                for k in keys[4:]:
                    be.gate(k)
            with mod.TieredBlobStore(be) as st:
                it = st.stream_windows(keys, window=2, lookahead=lookahead)
                next(it)
                time.sleep(0.05)
                started.append(sorted(be.started))
                for k in keys[4:]:
                    if k in be.gates:
                        be.gates[k].set()
                list(it)
        return started

    with_ahead, serial = _both(scenario)
    assert with_ahead == [f"k{i:03d}" for i in range(4)]
    assert serial == ["k000", "k001"]


def test_backend_faults_surface(tmp_path):
    def scenario(mod):
        root = tmp_path / mod.__name__
        be = mod.FilesystemBackend(root)
        be.put("good", pickle.dumps({"x": 1}))
        (root / "crashed.tmp").write_bytes(b"partial garbage")
        be.put("corrupt", b"\x80\x05 not a pickle")
        be.put("a/b/c", b"payload")
        out = [be.list_keys(), be.size("a/b/c")]
        for key in ("crashed", "../../etc/passwd"):
            with pytest.raises(mod.StoreError):
                be.get(key)
        with mod.TieredBlobStore(be) as st:
            out.append(st.get("good"))
            with pytest.raises(mod.StoreError):
                st.get("corrupt")
            st.prefetch(["ghost"])
            with pytest.raises(mod.BlobMissing):
                st.get("ghost")
            out.append(_counts(st.stats()))
        return out

    keys, size, good, _ = _both(scenario)
    assert keys == ["a/b/c", "corrupt", "good"] and size == 7
    assert good == {"x": 1}


def _codec_arrays(codec, rng):
    if codec in ("tdeflate", "huffman"):
        text = np.frombuffer(b"restore a window of compressed blobs " * 60,
                             np.uint8)
        return [text, rng.integers(0, 4, 3000).astype(np.uint8)]
    top = 1 << 7
    return [np.repeat(rng.integers(0, top, 80), rng.integers(1, 40, 80))
            .astype(np.uint32),
            rng.integers(0, top, 1500).astype(np.uint16),
            np.repeat(rng.integers(0, 1 << 40, 30).astype(np.int64), 20)]


@pytest.mark.parametrize("codec", ["rle_v1", "rle_v2", "dbp", "bitpack",
                                   "tdeflate", "huffman", "lzss"])
def test_streaming_restore_through_the_service_every_codec(tmp_path, codec):
    """Each array written to a filesystem store, then read back through
    ``stream_windows`` + ``submit_key`` on a service with the store attached,
    under a host budget of about two windows: bit-exact, each key fetched
    once, the same store counts as the reference's service on the same
    payloads."""
    arrays = _codec_arrays(codec, np.random.default_rng(31))
    if codec in ("bitpack", "huffman", "tdeflate"):
        arrays = [a for a in arrays if a.dtype.itemsize < 8]
    kw = {"bits": 7} if codec == "bitpack" else {}
    keys = [f"step_1/leaf{i}.blob" for i in range(len(arrays))]

    def restore(mod, svc_mod, compress, engine):
        root = tmp_path / mod.__name__
        w = mod.TieredBlobStore(mod.FilesystemBackend(root))
        sizes = [w.put(k, compress(a, codec, 512, **kw))
                 for k, a in zip(keys, arrays)]
        w.close()
        outs = []
        with mod.filesystem_store(root, host_budget_bytes=2 * max(sizes)
                                  + 64) as st, \
                svc_mod.DecompressionService(cache_bytes=1 << 20, store=st,
                                             **engine) as svc:
            # the window's keys are resident while it is consumed, so each
            # submit_key is a host hit
            for k, window in zip(keys, st.stream_windows(keys, window=1)):
                assert len(window) == 1
                outs.append(svc.submit_key(k).result(timeout=T))
            stats = st.stats()
        return outs, _counts(stats)[:4] + (stats.backend_fetches,)

    outs, counts = restore(bs, srv, api.compress, {"engine": CPU})
    ref_outs, ref_counts = restore(ref_bs, ref_srv, ref_api.compress, {})
    assert counts == ref_counts
    assert counts[4] == len(keys)           # each key fetched once
    for a, o, r in zip(arrays, outs, ref_outs):
        np.testing.assert_array_equal(o, a)
        assert o.dtype == a.dtype and np.array_equal(o, np.asarray(r))


def test_submit_key_streams_each_key_once_and_hits_tier0(tmp_path):
    """``stream_windows`` feeding ``submit_key``: every key fetched once,
    bit-exact; a repeat of a key hits the service's decoded cache (tier
    0), both counted in ``store.stats()``."""
    rng = np.random.default_rng(5)
    arrays = [np.repeat(rng.integers(0, 50, 40), 25).astype(np.int32)
              for _ in range(6)]
    keys = [f"w/{i}" for i in range(len(arrays))]
    w = bs.TieredBlobStore(bs.FilesystemBackend(tmp_path))
    for k, a in zip(keys, arrays):
        w.put(k, api.compress(a, "rle_v2", 512))
    w.close()
    with bs.filesystem_store(tmp_path, host_budget_bytes=1 << 20) as st, \
            srv.DecompressionService(CPU, cache_bytes=1 << 20,
                                     store=st) as svc:
        outs = []
        for i, window in enumerate(st.stream_windows(keys, window=2)):
            futs = [svc.submit_key(k) for k in keys[2 * i:2 * i + 2]]
            outs += [f.result(timeout=T) for f in futs]
            assert len(window) == len(futs)
        again = svc.submit_key(keys[0]).result(timeout=T)
        s = st.stats()
    for a, o in zip(arrays, outs):
        np.testing.assert_array_equal(o, a)
    np.testing.assert_array_equal(again, arrays[0])
    assert s.backend_fetches == len(keys) + 1   # the released key again
    assert s.decoded_hits == 1 and s.decoded_misses == len(keys)
