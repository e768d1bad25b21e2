"""Tiered blob store: demand-paged compressed blobs with async prefetch.

A copy of ``repro/core/store.py`` (which imports no JAX, but the port
imports nothing of the reference package), pinned to it by
``tests/test_torch_store.py``: the same operations on both give the same
``StoreStats`` counts.  Three tiers:

    tier 0 — the decoded-blob cache of the ``DecompressionService`` attached
             with ``DecompressionService(store=)``; its hit/miss counters
             surface in :meth:`TieredBlobStore.stats`.
    tier 1 — host compressed-blob cache: a byte-budgeted LRU with
             WATERMARK eviction: it admits up to the high byte mark, then
             evicts LRU entries down to the low byte mark (hysteresis: one
             oversized window does not cause eviction on every insert).
    tier 2 — a :class:`BlobBackend`: the filesystem
             (:class:`FilesystemBackend`, atomic writes) or any object store
             implementing ``get/put/size/list_keys/delete``.

Demand paging: :meth:`TieredBlobStore.get` serves tier-1 hits, joins a
fetch already in flight, or pages the blob in from the backend.
:meth:`TieredBlobStore.prefetch` schedules fetches on a small thread pool
without blocking; :meth:`TieredBlobStore.stream_windows` is the overlap
loop of a streaming consumer: while it decodes window i, the pool fetches
the next ``lookahead`` windows, and consumed windows are released back
under the byte budget, so a restore larger than host memory runs with
bounded resident bytes and the backend I/O hidden behind decode.

    store = TieredBlobStore(FilesystemBackend(root), host_budget_bytes=1 << 28)
    ca = store.get("step_1/layer0.npy.blob")      # demand-page (pickle)
    store.prefetch(keys)                          # async, non-blocking
    for window in store.stream_windows(keys, window=8):
        ...decode window...                       # i+1 already in flight
    store.stats()                                 # per-tier hits/misses/
                                                  # evictions/bytes in flight
"""
from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence


class StoreError(RuntimeError):
    """A blob could not be read or deserialized from the backend."""


class BlobMissing(StoreError, KeyError):
    """The backend has no (complete) payload under the requested key."""


# --------------------------------------------------------------------------
# tier 2 — backends
# --------------------------------------------------------------------------


class BlobBackend:
    """S3-style object-store interface for compressed blob payloads.

    Implementations must make ``put`` ATOMIC: a reader never observes a
    partially-written payload under a published key (crash mid-put leaves
    garbage that ``get``/``list_keys`` ignore).  Keys are ``/``-separated
    strings; payloads are opaque bytes.
    """

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def size(self, key: str) -> Optional[int]:
        """Payload size in bytes, or None if unknown/absent (used for the
        bytes-in-flight gauge; a backend may answer cheaply via metadata)."""
        raise NotImplementedError

    def list_keys(self) -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class FilesystemBackend(BlobBackend):
    """Disk tier rooted at a directory; one file per key.

    * ``put`` writes ``<key>.tmp`` then ``os.replace``s it into place — a
      crash mid-write leaves only the ``.tmp``, which every read path
      ignores, so a published key is always a complete payload.
    * ``read_delay_s`` injects a per-``get`` latency, standing in for an
      object store's round trip on a fast local disk.
    """

    def __init__(self, root, *, read_delay_s: float = 0.0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.read_delay_s = float(read_delay_s)

    def _path(self, key: str) -> Path:
        p = (self.root / key).resolve()
        if self.root.resolve() not in p.parents and p != self.root.resolve():
            raise StoreError(f"key {key!r} escapes the backend root")
        return p

    def get(self, key: str) -> bytes:
        if self.read_delay_s:
            time.sleep(self.read_delay_s)
        p = self._path(key)
        try:
            return p.read_bytes()
        except FileNotFoundError:
            raise BlobMissing(key) from None

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_name(p.name + ".tmp")
        tmp.write_bytes(data)
        os.replace(tmp, p)            # atomic publish; crash leaves only .tmp

    def size(self, key: str) -> Optional[int]:
        try:
            return self._path(key).stat().st_size
        except FileNotFoundError:
            return None

    def list_keys(self) -> List[str]:
        return sorted(
            str(p.relative_to(self.root))
            for p in self.root.rglob("*")
            if p.is_file() and not p.name.endswith(".tmp"))

    def delete(self, key: str) -> None:
        try:
            self._path(key).unlink()
        except FileNotFoundError:
            pass


class MemoryBackend(BlobBackend):
    """Dict-backed stub with the object-store interface (tests, and the
    seam where a real object-store client would plug in)."""

    def __init__(self, *, read_delay_s: float = 0.0):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.read_delay_s = float(read_delay_s)

    def get(self, key: str) -> bytes:
        if self.read_delay_s:
            time.sleep(self.read_delay_s)
        with self._lock:
            try:
                return self._data[key]
            except KeyError:
                raise BlobMissing(key) from None

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(data)

    def size(self, key: str) -> Optional[int]:
        with self._lock:
            d = self._data.get(key)
        return None if d is None else len(d)

    def list_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._data)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)


# --------------------------------------------------------------------------
# stats
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StoreStats:
    """Per-tier snapshot (cumulative counters, point-in-time gauges)."""

    # tier 1 — host compressed cache
    host_hits: int            # gets served without issuing a backend fetch
    host_misses: int          # backend fetches issued (by get OR prefetch)
    host_evictions: int       # watermark evictions (budget pressure)
    host_released: int        # consumed-window releases (stream_windows)
    host_bytes: int           # resident compressed bytes (gauge)
    host_entries: int
    # tier 2 — backend
    backend_fetches: int      # completed backend reads
    backend_bytes_fetched: int
    inflight_fetches: int     # gauge
    bytes_in_flight: int      # gauge (backend.size of keys being fetched)
    # tier 0 — decoded cache of the attached DecompressionService
    decoded_hits: int = 0
    decoded_misses: int = 0
    decoded_bytes: int = 0

    @property
    def host_hit_rate(self) -> float:
        return self.host_hits / max(1, self.host_hits + self.host_misses)


# --------------------------------------------------------------------------
# the tiered store
# --------------------------------------------------------------------------


def _default_loads(data: bytes) -> Any:
    try:
        return pickle.loads(data)
    except Exception as e:
        raise StoreError(f"corrupt blob payload: {e}") from e


class TieredBlobStore:
    """Demand-paging compressed-blob store with async prefetch; see module
    docstring for the tier layout.

    Parameters
    ----------
    backend:            the tier-2 :class:`BlobBackend`.
    host_budget_bytes:  tier-1 high byte-mark.  Admitting past it evicts
                        LRU entries down to ``low_watermark * budget``.
    low_watermark:      eviction hysteresis target as a fraction of the
                        budget (0 < low <= 1).
    prefetch_workers:   thread-pool width for async paging; also the
                        fan-out of one window's parallel fetches.
    loads / dumps:      (de)serializers between payload bytes and blob
                        objects.  Defaults: pickle (what a checkpoint
                        writes); ``loads`` failures surface as
                        :class:`StoreError`.

    Sizes are accounted in PAYLOAD bytes (what the backend stores), so the
    budget bounds resident compressed bytes regardless of the deserialized
    object's layout.
    """

    def __init__(self, backend: BlobBackend, *,
                 host_budget_bytes: int = 256 << 20,
                 low_watermark: float = 0.8,
                 prefetch_workers: int = 4,
                 loads: Callable[[bytes], Any] = _default_loads,
                 dumps: Callable[[Any], bytes] = pickle.dumps):
        if not 0.0 < low_watermark <= 1.0:
            raise ValueError("low_watermark must be in (0, 1]")
        self.backend = backend
        self.host_budget_bytes = int(host_budget_bytes)
        self.low_watermark = float(low_watermark)
        self._loads = loads
        self._dumps = dumps
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(prefetch_workers)),
            thread_name_prefix="codag-store-prefetch")
        self._lock = threading.Lock()
        # key -> (obj, payload_bytes); OrderedDict = LRU order
        self._entries: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._inflight: Dict[str, Future] = {}
        self._inflight_bytes: Dict[str, int] = {}
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._released = 0
        self._fetches = 0
        self._fetched_bytes = 0
        self._tier0 = None            # attached DecompressionService
        self._closed = False

    # ------------------------------------------------------------ tier 0

    def attach_tier0(self, service) -> None:
        """Register the ``DecompressionService`` whose decoded-blob LRU is
        this store's tier 0 (``DecompressionService(store=)`` calls this);
        its cache counters then appear in :meth:`stats`."""
        self._tier0 = service

    # ------------------------------------------------------------- paging

    def get(self, key: str) -> Any:
        """Blocking demand-page: tier-1 hit, join of an in-flight fetch, or
        a synchronous backend read (counted as a miss)."""
        fut = self._lookup_or_fetch(key)
        if fut is None:
            with self._lock:
                obj, _ = self._entries[key]
            return obj
        return fut.result()

    def fetch_async(self, key: str) -> Future:
        """Future of the demand-paged object; resolves immediately on a
        tier-1 hit.  The service's ``submit_key`` chains decode onto it."""
        fut = self._lookup_or_fetch(key)
        if fut is not None:
            return fut
        done: Future = Future()
        with self._lock:
            obj, _ = self._entries[key]
        done.set_result(obj)
        return done

    def prefetch(self, keys: Sequence[str]) -> None:
        """Schedule async fetches for every key not already resident or in
        flight.  Never blocks; failures surface when ``get`` joins the
        fetch (or are dropped if nobody ever asks)."""
        for key in keys:
            self._lookup_or_fetch(key, sync=False)

    def _lookup_or_fetch(self, key: str,
                         sync: bool = True) -> Optional[Future]:
        """Resolve ``key`` against tier 1 / the in-flight table, issuing a
        backend fetch on a true miss.  Returns None on a resident hit, a
        Future otherwise.  ``sync=False`` (prefetch) never counts hits."""
        with self._lock:
            if self._closed:
                raise StoreError("TieredBlobStore is closed")
            if key in self._entries:
                if sync:
                    self._entries.move_to_end(key)
                    self._hits += 1
                return None
            fut = self._inflight.get(key)
            if fut is not None:
                if sync:
                    self._hits += 1   # no new fetch issued — the page is
                return fut            # already on its way in
            self._misses += 1
            fut = Future()
            self._inflight[key] = fut
            size = None
        try:
            size = self.backend.size(key)
        except Exception:
            size = None
        with self._lock:
            self._inflight_bytes[key] = int(size or 0)
        self._pool.submit(self._fetch_into, key, fut)
        return fut

    def _fetch_into(self, key: str, fut: Future) -> None:
        try:
            data = self.backend.get(key)
            obj = self._loads(data)
        except BaseException as e:
            with self._lock:
                self._inflight.pop(key, None)
                self._inflight_bytes.pop(key, None)
            fut.set_exception(e)
            return
        with self._lock:
            self._inflight.pop(key, None)
            self._inflight_bytes.pop(key, None)
            self._fetches += 1
            self._fetched_bytes += len(data)
            self._admit(key, obj, len(data))
        fut.set_result(obj)

    def _admit(self, key: str, obj: Any, nbytes: int) -> None:
        """Insert under the watermark policy (caller holds the lock).

        Every fetched page is admitted — a blob the consumer is about to
        use must be resident whatever its size, so the budget is enforced
        by evicting OLDER entries down to the low mark (never the entry
        just inserted).  A single entry larger than the whole budget is
        therefore the one case resident bytes can exceed it."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        self._entries[key] = (obj, nbytes)
        self._bytes += nbytes
        if self._bytes <= self.host_budget_bytes:
            return
        low = int(self.low_watermark * self.host_budget_bytes)
        while self._bytes > low and len(self._entries) > 1:
            old_key, (_, old_bytes) = self._entries.popitem(last=False)
            self._bytes -= old_bytes
            self._evictions += 1

    def release(self, keys: Sequence[str]) -> None:
        """Drop consumed entries from tier 1 (cheaper than waiting for the
        watermark to push them out; counted separately from evictions)."""
        with self._lock:
            for key in keys:
                ent = self._entries.pop(key, None)
                if ent is not None:
                    self._bytes -= ent[1]
                    self._released += 1

    def put(self, key: str, obj: Any, *, admit: bool = False) -> int:
        """Serialize ``obj`` and write it through to the backend.  Returns
        the payload size.  ``admit=True`` also caches it in tier 1 (off by
        default so a build/spill pass doesn't flush the read cache)."""
        data = self._dumps(obj)
        self.backend.put(key, data)
        if admit:
            with self._lock:
                self._admit(key, obj, len(data))
        return len(data)

    def resident(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    # ------------------------------------------------ the overlap loop

    def stream_windows(self, keys: Sequence[str], *, window: int,
                       lookahead: int = 1,
                       release: bool = True) -> Iterator[List[Any]]:
        """Yield ``keys`` in windows of ``window`` objects, overlapping the
        NEXT ``lookahead`` windows' backend I/O with the consumer's work on
        the current one:

            prime:   prefetch windows 0..lookahead-1
            yield i: window i's objects (hits — their fetches were issued
                     one iteration ago), after scheduling window
                     i+lookahead's prefetch; that prefetch streams in
                     while the consumer works on the yielded window
            resume:  release window i's entries (the consumer is done with
                     them — the generator only resumes when it asks for
                     window i+1), keeping resident bytes ~(1 + lookahead)
                     windows

        Window i's ``get``s run BEFORE window i+lookahead's prefetch is
        scheduled, so a budget too small for (1+lookahead) windows never
        double-fetches: the yielded objects hold their own references and
        survive any cache eviction the lookahead's admits cause.  Each key
        is fetched exactly once as long as the budget fits the pipeline's
        resident set — (1 + ``lookahead``) windows' payload bytes (below
        that, admits can evict prefetched-but-unconsumed entries — a
        refetch, never an error).  ``lookahead=0`` disables the overlap
        (each window's I/O is paid synchronously inside its ``get``s), the
        serial baseline.  Nothing beyond window
        ``i + lookahead`` is ever touched, so decode of window i never
        waits on window i+2's I/O (with the default lookahead).
        """
        if window < 1:
            raise ValueError("window must be >= 1")
        wins = [list(keys[i:i + window])
                for i in range(0, len(keys), window)]
        for w in wins[:max(0, lookahead)]:
            self.prefetch(w)
        for i, w in enumerate(wins):
            objs = [self.get(k) for k in w]
            nxt = i + max(0, lookahead)
            if lookahead and nxt < len(wins):
                self.prefetch(wins[nxt])
            yield objs
            if release:
                self.release(w)

    # ----------------------------------------------------------- lifecycle

    def stats(self) -> StoreStats:
        with self._lock:
            snap = dict(
                host_hits=self._hits, host_misses=self._misses,
                host_evictions=self._evictions,
                host_released=self._released,
                host_bytes=self._bytes, host_entries=len(self._entries),
                backend_fetches=self._fetches,
                backend_bytes_fetched=self._fetched_bytes,
                inflight_fetches=len(self._inflight),
                bytes_in_flight=sum(self._inflight_bytes.values()))
        if self._tier0 is not None:
            s = self._tier0.stats()
            snap.update(decoded_hits=s.cache_hits,
                        decoded_misses=s.cache_misses,
                        decoded_bytes=s.cache_bytes)
        return StoreStats(**snap)

    def close(self, wait: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=wait)

    def __enter__(self) -> "TieredBlobStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def filesystem_store(root, *, host_budget_bytes: int = 256 << 20,
                     read_delay_s: float = 0.0,
                     **kw) -> TieredBlobStore:
    """Convenience: a :class:`TieredBlobStore` over a directory (a
    checkpoint's, say), which then demand-pages its ``step_N/<leaf>.blob``
    files window by window."""
    return TieredBlobStore(FilesystemBackend(root, read_delay_s=read_delay_s),
                           host_budget_bytes=host_budget_bytes, **kw)
