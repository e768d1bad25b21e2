"""Async decompression service with adaptive micro-batching.

The counterpart of ``repro/core/server.py``.  Producers submit blobs from
any thread and get a ``concurrent.futures.Future`` back; one worker thread
coalesces everything that arrives inside an adaptive micro-batching window

  * flush when the window holds ``max_batch_blobs`` blobs, or
  * flush when ``max_delay_ms`` has elapsed since the window opened, or
  * flush early when the queue goes idle for ``idle_ms`` (a burst is fused
    whole, a lone straggler is not held back),

builds ONE fused chunk table per ``(codec, width, chunk_elems, bits)``
group per window (a one-group ``DecodePlan``), and resolves each request's
future from the scattered rows.  Concurrent same-group requests therefore
share one kernel launch: dispatch amplification < 1.0 against per-blob
decode.

In front of the dispatch path sits a decoded-blob LRU keyed by a content
digest of the compressed payload (``blob_digest``) and bounded by a byte
budget; identical blobs inside one window are decoded once as well.

    svc = DecompressionService(max_batch_blobs=64, max_delay_ms=2.0)
    fut = svc.submit(blob)           # any thread
    out = fut.result()               # decoded ndarray, bit-exact
    svc.stats()                      # blobs/window, dispatches/window,
                                     # cache hit rate, p50/p99 latency
    svc.close()                      # graceful: drains, then joins

Threads and streams.  The worker decodes on its own thread, on each
device's default stream (it never sets a stream).  After a window's group
is decoded, and after its cache hits for the device are staged, the worker
waits for that work by an event (not a stream synchronisation) before it
resolves the futures, so a ``device_out`` tensor is complete when its
future resolves and may be read on any stream; a consumer that keeps it on another stream calls
``Tensor.record_stream`` as for any tensor.  A host result crosses through
``transfers.to_host``, which waits by an event as well, so the worker's
decodes go on while another thread holds ``transfers.no_host_transfers()``.

``api.decompress_many`` routes engine-less host decodes through a
process-wide default service per device (``default_service()``).
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.core import plan as plan_mod
from repro_torch.core import transfers
from repro_torch.core.engine import CodagEngine, EngineConfig, resolve_device

_CLOSE = object()          # queue sentinel; nothing is enqueued after it

# defined in core/format.py, re-exported as in the reference
blob_digest = fmt.blob_digest
pad_table_to_bucket = fmt.pad_table_to_bucket


def _wait(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream, by an event
    (not a stream synchronisation, which another thread's
    ``no_host_transfers()`` forbids)."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


class _LRUCache:
    """Byte-budgeted LRU of decoded ndarrays.  Not thread-safe on its own:
    the service touches it from the worker thread only."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._entries: "collections.OrderedDict[str, np.ndarray]" = \
            collections.OrderedDict()
        self.bytes = 0

    def get(self, key: str) -> Optional[np.ndarray]:
        arr = self._entries.get(key)
        if arr is not None:
            self._entries.move_to_end(key)
        return arr

    def put(self, key: str, arr: np.ndarray) -> None:
        if arr.nbytes > self.max_bytes:
            return
        if key in self._entries:
            # content-keyed: the stored value is identical, but a re-put is
            # a use, so refresh its recency
            self._entries.move_to_end(key)
            return
        stored = arr.copy()          # private copy: callers may mutate theirs
        stored.flags.writeable = False
        self._entries[key] = stored
        self.bytes += stored.nbytes
        while self.bytes > self.max_bytes and self._entries:
            _, evicted = self._entries.popitem(last=False)
            self.bytes -= evicted.nbytes

    def __len__(self) -> int:
        return len(self._entries)


@dataclasses.dataclass
class _Request:
    blob: fmt.CompressedBlob
    future: Future
    t_submit: float
    # content digest, computed on the producer thread when the cache is on;
    # None without the cache (the worker then dedupes by blob identity)
    digest: Optional[str] = None
    # resolve with a tensor on the engine's device instead of an ndarray
    device: bool = False


@dataclasses.dataclass(frozen=True)
class ServiceStats:
    """Cumulative snapshot; rates and percentiles derived at snapshot time."""

    windows: int
    blobs: int
    dispatches: int
    cache_hits: int
    cache_misses: int
    errors: int
    cache_bytes: int
    blobs_per_window: float
    dispatches_per_window: float
    cache_hit_rate: float
    latency_p50_ms: float
    latency_p99_ms: float
    # device string -> fused dispatches the round robin assigned to it
    # (services with ``devices=`` only)
    device_dispatches: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def dispatch_amplification(self) -> float:
        """Kernel dispatches per submitted blob; < 1.0 means coalescing wins
        over one dispatch per blob."""
        return self.dispatches / max(1, self.blobs)


class DecompressionService:
    """Micro-batching decode front end; see the module docstring.

    Parameters
    ----------
    engine:           the ``CodagEngine`` every fused dispatch runs on
                      (default: the card, ``EngineConfig()``).
    max_batch_blobs:  flush the window once it holds this many blobs.  An
                      atomic ``submit_many`` larger than this stays whole.
    max_delay_ms:     flush this long after the window's first blob arrived.
    idle_ms:          flush early once the queue has been idle this long
                      (<= max_delay_ms; default 0.5).
    cache_bytes:      decoded-blob LRU budget; 0 disables the cache.
    bucket_shapes:    pad fused tables to power-of-two buckets
                      (``pad_table_to_bucket``), as the reference does to
                      bound its jit cache.  Here no kernel compiles per
                      shape, so it only shapes the table (up to 2x zero
                      rows); kept for parity.  The default service turns
                      it and the cache off.
    bucket_cols_floor: the minimum pow2 column bucket (None: 128).
    compile_cache:    the reference's persistent jit cache; no counterpart
                      until the tuning layer is ported (a truthy value
                      raises).
    devices:          optional list of devices: each window's fused group
                      dispatches go round robin across them (group i ->
                      device (rr + i) mod N), counted per device in
                      ``ServiceStats.device_dispatches``.
    store:            optional ``core.store.TieredBlobStore`` whose lower
                      tiers sit behind this service's decoded-blob LRU
                      (its tier 0); ``submit_key(key)`` pages a blob in
                      through it and decodes it on arrival.
    latency_window:   how many recent request latencies feed p50/p99.
    """

    def __init__(self, engine: Optional[CodagEngine] = None, *,
                 max_batch_blobs: int = 64, max_delay_ms: float = 2.0,
                 idle_ms: Optional[float] = None,
                 cache_bytes: int = 32 << 20,
                 bucket_shapes: bool = True,
                 bucket_cols_floor: Optional[int] = None,
                 compile_cache=None,
                 devices: Optional[Sequence] = None,
                 store=None,
                 latency_window: int = 4096):
        if max_batch_blobs < 1:
            raise ValueError("max_batch_blobs must be >= 1")
        if compile_cache:
            raise NotImplementedError(
                "compile_cache= has no counterpart until the tuning layer "
                "is ported (ROADMAP.md Queue 1 item 9)")
        self.engine = engine or CodagEngine(EngineConfig())
        self.max_batch_blobs = int(max_batch_blobs)
        self.max_delay_ms = float(max_delay_ms)
        self.idle_ms = min(float(idle_ms if idle_ms is not None else 0.5),
                           self.max_delay_ms) if max_delay_ms > 0 else 0.0
        self.bucket_shapes = bool(bucket_shapes)
        self.bucket_cols_floor = bucket_cols_floor
        self._devices = [resolve_device(d) for d in devices or ()]
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self._cache = _LRUCache(cache_bytes) if cache_bytes > 0 else None
        self._latencies: "collections.deque[float]" = collections.deque(
            maxlen=latency_window)
        self.store = store
        if store is not None:
            store.attach_tier0(self)   # store.stats() shows the tier-0 LRU
        self._rr = 0                   # round-robin device cursor
        self._device_dispatches: Dict[str, int] = {}
        self._windows = 0
        self._blobs = 0
        self._dispatches = 0
        self._cache_hits = 0
        self._cache_misses = 0
        self._errors = 0
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="codag-decomp-service",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- submit

    def submit(self, blob: fmt.CompressedBlob,
               device_out: bool = False) -> Future:
        """Enqueue one blob; returns a Future of the decoded array
        (``device_out=True``: a tensor on the engine's device)."""
        return self.submit_many([blob], device_out=device_out)[0]

    def submit_many(self, blobs: Sequence[fmt.CompressedBlob],
                    device_out: bool = False) -> List[Future]:
        """Enqueue blobs ATOMICALLY: they enter the same window together
        (a window may grow past ``max_batch_blobs`` to keep a batch whole)."""
        if not blobs:
            return []
        now = time.perf_counter()
        reqs = [_Request(b, Future(), now,
                         blob_digest(b) if self._cache is not None else None,
                         device=device_out)
                for b in blobs]
        with self._lock:
            if self._closed:
                raise RuntimeError("DecompressionService is closed")
            # under the lock, so close() cannot put its sentinel first
            self._q.put(reqs)
        return [r.future for r in reqs]

    def submit_array(self, ca, device_out: bool = False) -> Future:
        """Enqueue an ``api.CompressedArray``; the future resolves to the
        recombined array (lo/hi planes joined for 8-byte dtypes)."""
        futs = self.submit_many(list(ca.blobs), device_out=device_out)
        out: Future = Future()
        pending = [len(futs)]
        lk = threading.Lock()
        combine = (fmt.combine_planes_device if device_out
                   else fmt.combine_planes)

        def _done(_):
            with lk:
                pending[0] -= 1
                if pending[0]:
                    return
            try:
                outs = [f.result() for f in futs]
                joined = combine(outs, ca.orig_dtype, ca.orig_shape)
                if device_out:
                    _wait(joined.device)   # joined on this (worker) thread
                out.set_result(joined)
            except BaseException as e:  # any blob's failure is the array's
                out.set_exception(e)

        for f in futs:
            f.add_done_callback(_done)
        return out

    def submit_key(self, key: str, device_out: bool = False) -> Future:
        """Enqueue a blob BY STORE KEY: the attached store pages the
        compressed payload in (its host cache, else a backend fetch on its
        pool) and the decode is submitted when it lands.  The payload is a
        ``CompressedBlob`` or an ``api.CompressedArray``.  Requires
        ``store=``."""
        if self.store is None:
            raise RuntimeError("submit_key requires DecompressionService"
                               "(store=...): no lower tiers to page from")
        out: Future = Future()

        def _paged(fut: Future) -> None:
            try:
                obj = fut.result()
            except BaseException as e:     # missing key, corrupt payload
                out.set_exception(e)
                return
            try:
                inner = (self.submit_array(obj, device_out=device_out)
                         if hasattr(obj, "blobs")
                         else self.submit(obj, device_out=device_out))
            except BaseException as e:     # service closed, bad payload
                out.set_exception(e)
                return

            def _done(f: Future) -> None:
                try:
                    out.set_result(f.result())
                except BaseException as e:
                    out.set_exception(e)

            inner.add_done_callback(_done)

        self.store.fetch_async(key).add_done_callback(_paged)
        return out

    def decode(self, blob: fmt.CompressedBlob, device_out: bool = False):
        """Blocking single-blob convenience."""
        return self.submit(blob, device_out=device_out).result()

    def decode_arrays(self, cas: Sequence,
                      device_out: bool = False) -> List:
        """Blocking batch decode of ``CompressedArray``s.  All plane blobs of
        all arrays enter one window atomically, so the call costs exactly one
        dispatch per group key."""
        flat = [b for ca in cas for b in ca.blobs]
        futs = self.submit_many(flat, device_out=device_out)
        outs = [f.result() for f in futs]
        combine = (fmt.combine_planes_device if device_out
                   else fmt.combine_planes)
        result, i = [], 0
        for ca in cas:
            n = len(ca.blobs)
            result.append(combine(outs[i:i + n], ca.orig_dtype,
                                  ca.orig_shape))
            i += n
        return result

    # ----------------------------------------------------------- lifecycle

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: refuse new submits, drain every queued request
        (all outstanding futures resolve), then join the worker.

        Returns True once the worker has exited; False if the drain was
        still running when ``timeout`` elapsed (it goes on in the
        background; call again to keep waiting)."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(_CLOSE)
        self._worker.join(timeout)
        return not self._worker.is_alive()

    def __enter__(self) -> "DecompressionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------------- stats

    def stats(self) -> ServiceStats:
        with self._lock:
            lats = sorted(self._latencies)
            windows, blobs = self._windows, self._blobs
            dispatches = self._dispatches
            hits, misses = self._cache_hits, self._cache_misses
            errors = self._errors
            cache_bytes = self._cache.bytes if self._cache else 0
            device_dispatches = dict(self._device_dispatches)

        def pct(p: float) -> float:
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1, int(p * (len(lats) - 1)))] * 1e3

        return ServiceStats(
            windows=windows, blobs=blobs, dispatches=dispatches,
            cache_hits=hits, cache_misses=misses, errors=errors,
            cache_bytes=cache_bytes,
            blobs_per_window=blobs / max(1, windows),
            dispatches_per_window=dispatches / max(1, windows),
            cache_hit_rate=hits / max(1, hits + misses),
            latency_p50_ms=pct(0.50), latency_p99_ms=pct(0.99),
            device_dispatches=device_dispatches)

    # -------------------------------------------------------------- worker

    def _worker_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _CLOSE:
                break
            window: List[_Request] = list(item)
            deadline = time.perf_counter() + self.max_delay_ms / 1e3
            closing = False
            while len(window) < self.max_batch_blobs:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=min(remaining,
                                                  self.idle_ms / 1e3))
                except queue.Empty:
                    break                        # queue idle: flush early
                if nxt is _CLOSE:
                    closing = True
                    break
                window.extend(nxt)
            try:
                self._process_window(window)
            except BaseException as e:   # the worker must survive anything:
                # a dead worker would hang every outstanding request
                for req in window:
                    if not req.future.done():
                        self._fail(req, e)
            if closing:
                break

    def _resolve(self, req: _Request, value) -> None:
        with self._lock:
            self._latencies.append(time.perf_counter() - req.t_submit)
        try:
            req.future.set_result(value)
        except BaseException:            # future cancelled by the caller
            pass

    def _fail(self, req: _Request, exc: BaseException) -> None:
        with self._lock:
            self._errors += 1
            self._latencies.append(time.perf_counter() - req.t_submit)
        try:
            req.future.set_exception(exc)
        except BaseException:            # future cancelled by the caller
            pass

    def _process_window(self, window: List[_Request]) -> None:
        """One micro-batch: a cache/dedupe pass, then one ``DecodePlan`` per
        group key (parse/group -> stage -> dispatch -> reassemble, with the
        service's bucketing at plan build).  A plan per group keeps a
        failure to the request (bad metadata) or the group (an unlowerable
        table, a decode error) that caused it.

        With ``devices`` the groups go round robin across them; each
        group's table is staged on and decoded by its device.  Results take
        the form each request asked for: ndarrays, or tensors on the
        decoding device (``device_out``).  The host matrix is materialized
        at most once a group, and only when a requester or the cache needs
        host bytes."""
        hits = misses = dispatches = 0
        device_dispatches: Dict[str, int] = {}
        staged_hits = []      # (request, tensor) cache hits for the device
        # dedupe identical payloads in the window (by digest with the cache
        # on, by blob identity without), in first-occurrence order
        unique: "collections.OrderedDict[object, List[_Request]]" = \
            collections.OrderedDict()
        for req in window:
            try:
                fmt.group_key(req.blob)   # metadata sanity (bad codec etc.)
            except Exception as e:
                self._fail(req, e)
                continue
            dedupe_key = req.digest if req.digest is not None \
                else id(req.blob)
            cached = (self._cache.get(req.digest)
                      if self._cache is not None else None)
            if cached is not None:
                hits += 1
                # the cache keeps host bytes; a device requester gets them
                # staged on the engine's device, resolved once the copies
                # have landed
                if req.device:
                    staged_hits.append((req, transfers.to_device(
                        cached, self.engine.device)))
                else:
                    self._resolve(req, cached.copy())
                continue
            misses += 1
            unique.setdefault(dedupe_key, []).append(req)
        if staged_hits:
            _wait(self.engine.device)   # complete before the futures resolve
            for req, out_dev in staged_hits:
                self._resolve(req, out_dev)

        by_key: "Dict[tuple, List[List[_Request]]]" = {}
        for reqs in unique.values():
            by_key.setdefault(fmt.group_key(reqs[0].blob), []).append(reqs)
        for group_reqs in by_key.values():
            device = self.engine.device
            if self._devices:
                device = self._devices[self._rr % len(self._devices)]
                self._rr += 1
            need_host = self._cache is not None or any(
                not r.device for reqs in group_reqs for r in reqs)
            try:
                plan = plan_mod.DecodePlan.build(
                    [reqs[0].blob for reqs in group_reqs],
                    bucket=self.bucket_shapes,
                    bucket_floor=self.bucket_cols_floor)
                (g,) = plan.groups          # one key -> one fused group
                table_dev = plan.decode_group_device(0, self.engine,
                                                     device=device)
                table = (transfers.to_host(table_dev) if need_host
                         else None)
                dispatches += 1
                if self._devices:
                    k = str(device)
                    device_dispatches[k] = device_dispatches.get(k, 0) + 1
            except Exception as e:
                for reqs in group_reqs:
                    for req in reqs:
                        self._fail(req, e)
                continue
            results = []
            for bid, row0, idx in zip(g.blob_ids, g.row_offsets, g.scatter):
                reqs = group_reqs[bid]
                blob = reqs[0].blob
                out = out_dev = None
                try:
                    if need_host:
                        out = fmt.reassemble(
                            blob, table[row0:row0 + blob.num_chunks].copy())
                    if any(r.device for r in reqs):
                        out_dev = fmt.reassemble_rows_device(
                            table_dev, row0=row0, num_chunks=blob.num_chunks,
                            total_elems=blob.total_elems,
                            orig_dtype=blob.orig_dtype,
                            orig_shape=tuple(blob.orig_shape),
                            indices=None if idx is None
                            else transfers.to_device(idx, device))
                except Exception as e:   # bad per-blob metadata fails alone
                    for req in reqs:
                        self._fail(req, e)
                    continue
                if self._cache is not None and reqs[0].digest is not None:
                    self._cache.put(reqs[0].digest, out)   # put() copies
                results.append((reqs, out, out_dev))
            if any(out_dev is not None for _, _, out_dev in results):
                _wait(device)   # complete before the futures resolve
            for reqs, out, out_dev in results:
                first_host = True
                for req in reqs:
                    if req.device:
                        # duplicates share one tensor, as the reference
                        # shares its immutable array
                        self._resolve(req, out_dev)
                    else:
                        self._resolve(req, out if first_host else out.copy())
                        first_host = False

        with self._lock:
            self._windows += 1
            self._blobs += len(window)
            self._dispatches += dispatches
            self._cache_hits += hits
            self._cache_misses += misses
            for k, v in device_dispatches.items():
                self._device_dispatches[k] = \
                    self._device_dispatches.get(k, 0) + v


# Process-wide default services, one per device (``api.decompress_many``
# routes engine-less host decodes through them).
_default_services: Dict[torch.device, DecompressionService] = {}
_default_lock = threading.Lock()


def default_service(device=None) -> DecompressionService:
    """The lazily created shared service of ``device`` (default the card;
    without one this raises ``RuntimeError`` in the caller's thread).
    Recreated if a previous one was closed.  ``bucket_shapes`` and the
    cache stay off, so one-shot ``api.decompress_many`` batches keep exact,
    call-local dispatch accounting (one dispatch per group, every time);
    long-lived serving paths construct their own service with both on."""
    dev = resolve_device(device or "cuda")
    with _default_lock:
        svc = _default_services.get(dev)
        if svc is None or svc.closed:
            svc = DecompressionService(
                CodagEngine(EngineConfig(device=str(dev))),
                bucket_shapes=False, cache_bytes=0)
            _default_services[dev] = svc
        return svc
