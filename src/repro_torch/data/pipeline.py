"""Compressed token store + input pipeline.

The counterpart of ``repro/data/pipeline.py``.  Token shards are stored
codec-compressed (RLE v2 by default: token streams from natural corpora
repeat and keep locality) and decompressed on the card by the CODAG
engine before each train step: the paper's data-analytics pattern (§I:
read compressed data into GPU memory, run a decompression kernel, then the
query) on the training input path.

Shards yield int32: numpy arrays on the host path, tensors on the engine's
device with ``device_out``.  The loader's batches are tensors, and its
slicing and ``% vocab`` run on the shard's device.  The loader overlaps the
decode of the next shards with the consumer through a prefetch thread
(engine mode) or a ``DecompressionService``'s in-flight requests (service
mode).  With ``mesh=`` (engine mode) every shard's chunk rows split over
the mesh's decode axis and token shards are born placed under
``sharding.decode_out_sharding(mesh)`` (``sharding.ShardedTensor``), and
the loader's batches too, over their batch dimension.  On a mesh over a
world's ranks (one process a member) each process decodes its block of
every window's rows and keeps its own block of each shard and batch.
"""
from __future__ import annotations

import collections
import concurrent.futures
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core import plan as plan_mod
from repro_torch.core import store as blobstore
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.core.server import DecompressionService
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd


def synthetic_corpus(n_tokens: int, vocab: int, seed: int = 0,
                     run_bias: float = 0.3) -> np.ndarray:
    """Zipf-distributed tokens with run/locality structure (compressible,
    like real BPE streams: frequent tokens + repeated n-grams); the
    reference's array for the same arguments."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.3, size=n_tokens)
    tokens = np.minimum(base - 1, vocab - 1).astype(np.uint32)
    # inject runs (repeated tokens / copied spans) for realism
    n_runs = int(n_tokens * run_bias / 8)
    starts = rng.integers(0, max(1, n_tokens - 16), n_runs)
    for s in starts:
        l = int(rng.integers(2, 9))
        tokens[s:s + l] = tokens[s]
    return tokens


def _int32(shard):
    """A decoded shard as int32: uint32 tokens keep their bits, as the
    reference's ``astype`` does."""
    if isinstance(shard, shd.ShardedTensor):
        return shard.map(_int32)
    if isinstance(shard, torch.Tensor):
        return shard.view(torch.int32) if shard.dtype == torch.uint32 \
            else shard.to(torch.int32)
    return shard.astype(np.int32)


class CompressedTokenStore:
    """Store of codec-compressed token shards: in-memory, or spilled to a
    ``core.store.TieredBlobStore`` (``build(spill_dir=...)``) and
    demand-paged back with lookahead prefetch: a corpus larger than host
    RAM streams through a bounded compressed-shard cache."""

    def __init__(self, blobs: List[fmt.CompressedBlob], vocab: int, *,
                 store: Optional[blobstore.TieredBlobStore] = None,
                 keys: Optional[List[str]] = None,
                 shard_meta: Optional[List[tuple]] = None):
        self.blobs = blobs
        self.vocab = vocab
        self._store = store
        self._keys = list(keys or [])
        # (compressed_bytes, uncompressed_bytes) per spilled shard, so
        # ratio/accounting never page anything back in
        self._meta = list(shard_meta or [])

    @classmethod
    def build(cls, tokens: np.ndarray, vocab: int,
              shard_tokens: int = 1 << 20,
              codec: str = fmt.RLE_V2,
              chunk_bytes: int = 64 * 1024,
              spill_dir: Optional[str] = None,
              host_budget_bytes: int = 64 << 20,
              prefetch_workers: int = 4) -> "CompressedTokenStore":
        """``spill_dir=None`` keeps every compressed shard in host RAM.
        With a ``spill_dir``, shards are written through a
        ``TieredBlobStore`` (atomic, one file a shard) and demand-paged back
        on access, keeping at most ``host_budget_bytes`` of compressed
        shards resident."""
        shard_arrays = (tokens[i:i + shard_tokens].astype(np.uint32)
                        for i in range(0, len(tokens), shard_tokens))
        if spill_dir is None:
            return cls([enc.compress(s, codec, chunk_bytes)
                        for s in shard_arrays], vocab)
        st = blobstore.filesystem_store(
            spill_dir, host_budget_bytes=host_budget_bytes,
            prefetch_workers=prefetch_workers)
        keys, meta = [], []
        for si, s in enumerate(shard_arrays):
            b = enc.compress(s, codec, chunk_bytes)
            key = f"shard_{si:06d}.blob"
            st.put(key, b)               # write-through; admitted on the
            keys.append(key)             # first read
            meta.append((b.compressed_bytes, b.uncompressed_bytes))
        return cls([], vocab, store=st, keys=keys, shard_meta=meta)

    @property
    def spilled(self) -> bool:
        return self._store is not None

    @property
    def store(self) -> Optional[blobstore.TieredBlobStore]:
        """The backing ``TieredBlobStore`` (spilled mode only)."""
        return self._store

    @property
    def num_shards(self) -> int:
        return len(self._keys) if self.spilled else len(self.blobs)

    def blob(self, i: int) -> fmt.CompressedBlob:
        """Shard ``i``'s compressed blob; demand-paged in spilled mode."""
        if self.spilled:
            return self._store.get(self._keys[i])
        return self.blobs[i]

    def prefetch_shards(self, lo: int, hi: int) -> None:
        """Async lookahead: schedule shards ``[lo, hi)`` for paging in
        (no-op for the in-memory store)."""
        if self.spilled:
            self._store.prefetch(self._keys[max(0, lo):hi])

    def _blob_windows(self, window: int,
                      lookahead: int = 1) -> Iterator[List[fmt.CompressedBlob]]:
        """Shard blobs in windows; spilled mode overlaps the next window's
        paging with the consumer's decode of the current one
        (``TieredBlobStore.stream_windows``) and releases consumed windows
        back under the host budget."""
        if not self.spilled:
            for i in range(0, len(self.blobs), window):
                yield self.blobs[i:i + window]
            return
        yield from self._store.stream_windows(self._keys, window=window,
                                              lookahead=lookahead)

    @property
    def ratio(self) -> float:
        if self.spilled:
            c = sum(m[0] for m in self._meta)
            u = sum(m[1] for m in self._meta)
        else:
            c = sum(b.compressed_bytes for b in self.blobs)
            u = sum(b.uncompressed_bytes for b in self.blobs)
        return c / max(1, u)

    def decoded_shards(self, engine: CodagEngine, window: int = 1,
                       device_out: bool = False, mesh=None) -> Iterator:
        """Decode shards; ``window`` > 1 fuses that many shards' chunks into
        one batched launch per codec group (CODAG provisioning) while
        bounding peak host memory to ~window uncompressed shards.
        ``device_out=True`` yields int32 tensors on the engine's device:
        decode, reassembly and the int32 view never visit the host.
        ``mesh`` (implies device out; the engine's device must be the
        mesh's) splits each window's chunk rows over the mesh's decode axis
        and yields token shards born under ``decode_out_sharding(mesh)``
        (``sharding.ShardedTensor``; on a mesh over a world's ranks this
        rank's block, each process decoding its block of every window's
        rows); a ragged tail shard that cannot be placed is yielded as a
        whole tensor."""
        yield from self._decoded(engine, window, device_out, mesh,
                                 None if mesh is None
                                 else shd.decode_out_sharding(mesh))

    def _decoded(self, engine, window: int, device_out: bool, mesh,
                 out_sh) -> Iterator:
        for blobs in self._blob_windows(max(1, window)):
            for out in plan_mod.decompress_blobs(
                    blobs, engine, device_out=device_out or mesh is not None,
                    mesh=mesh, out_shardings=out_sh):
                yield _int32(out)

    def decoded_shards_async(self, service: DecompressionService,
                             lookahead: int = 4,
                             device_out: bool = False) -> Iterator:
        """Decode shards through a ``DecompressionService``: keep up to
        ``lookahead`` shard requests in flight and yield results in order.
        The service worker overlaps the decode of shards i+1..i+lookahead
        with the consumer's use of shard i (and fuses the in-flight shards
        into shared launches).  ``device_out=True`` serves shards on the
        service's device."""
        n = self.num_shards
        look = max(1, lookahead)
        futs: "collections.deque" = collections.deque()
        idx = 0
        try:
            self.prefetch_shards(0, look)      # prime the paging pipeline
            while idx < n and len(futs) < look:
                self.prefetch_shards(idx + 1, idx + 1 + look)
                futs.append(service.submit(self.blob(idx),
                                           device_out=device_out))
                idx += 1
            while futs:
                out = futs.popleft().result()
                if idx < n:
                    # shard idx pages in (a hit: its fetch was issued a
                    # step ago) while idx+1..idx+look stream in behind it
                    self.prefetch_shards(idx + 1, idx + 1 + look)
                    futs.append(service.submit(self.blob(idx),
                                               device_out=device_out))
                    idx += 1
                yield _int32(out)
        finally:
            # closed early (or failed): the lookahead requests still in
            # flight settle before this returns, so the service holds no
            # work of a consumer that has gone
            concurrent.futures.wait(futs)


class _Failed:
    """An exception raised in the prefetch thread, on its way to the
    consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class CompressedLoader:
    """Batches ``{"tokens", "labels"}`` (int32 tensors of ``(batch, seq)``)
    from a ``CompressedTokenStore``, decoded by the CODAG engine, with async
    prefetch.

    Peak decoded-shard buffering is ``decode_window`` (shards fused into one
    batched launch, materialized together) plus the prefetch queue's 2.
    ``decode_window=1`` decodes one shard a launch.

    ``engine``: the ``CodagEngine`` shards decode on (default the card's).
    ``service``: decode through a shared ``DecompressionService`` instead of
    a private engine and prefetch thread.  The loader keeps
    ``decode_window`` shard requests in flight (``decoded_shards_async``):
    the service worker owns the decode concurrency, fuses the in-flight
    shards into shared launches, and its decoded-blob cache makes repeat
    epochs over the same shards launch-free.

    ``device_out``: shards decode to tensors on the device and the batch
    slicing and vocab clamp run there, so token data crosses host->device
    once (the compressed upload) and never comes back.  Without it the
    batches are CPU tensors.

    ``mesh`` (engine mode; implies ``device_out``): shards decode across
    the mesh's decode axis (``decoded_shards(mesh=)``), on the mesh's
    device unless ``engine`` says otherwise, and each batch's ``tokens``
    and ``labels`` are placed under ``decode_out_sharding(mesh, 2)`` (the
    batch dimension over the decode axis) where it divides, else left
    whole.  On a mesh over a world's ranks every process builds a loader
    over the same store: each decodes its block of every window's rows,
    the decoded rows are all-gathered, and it yields its own block of each
    batch (plain tensors); the prefetch thread's collectives travel on
    process groups of the loader's own (``spmd.Member.join``), so they
    never interleave with the caller's.
    """

    def __init__(self, store: CompressedTokenStore, batch: int, seq: int,
                 engine: Optional[CodagEngine] = None, prefetch: bool = True,
                 decode_window: int = 4,
                 service: Optional[DecompressionService] = None,
                 device_out: bool = False, mesh=None):
        if service is not None and mesh is not None:
            raise ValueError("mesh= is not supported with service=: the "
                             "service decodes on its own single-engine "
                             "worker; use the engine path for sharded "
                             "token shards")
        if mesh is not None:
            mesh.member_device()     # a mesh over distinct devices raises
        # a ranked mesh's prefetch thread gathers on groups of its own
        self._member = None
        if mesh is not None and mesh.rank is not None:
            self._member = spmd.Member.join(mesh) if prefetch and \
                service is None else spmd.member_of(mesh)
        self.store = store
        self.batch = batch
        self.seq = seq
        if engine is None and service is None:
            engine = CodagEngine() if mesh is None else CodagEngine(
                EngineConfig(device=str(mesh.member_device())))
        self.engine = engine
        self.prefetch = prefetch
        # shards fused into one batched decode launch (engine mode) or
        # kept in flight on the service (service mode)
        self.decode_window = decode_window
        self.service = service
        # mesh: every shard's rows split over the mesh's decode axis; the
        # batches are placed over their batch dimension
        self.mesh = mesh
        self.device_out = device_out or mesh is not None

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        need = self.batch * self.seq + 1

        def shard_iter():
            while True:  # loop over shards forever
                if self.service is not None:
                    shards = self.store.decoded_shards_async(
                        self.service, lookahead=self.decode_window,
                        device_out=self.device_out)
                elif self._member is not None:   # whole shards, decoded
                    shards = self.store._decoded(   # a block a member
                        self.engine, self.decode_window, True, self.mesh,
                        None)
                else:
                    shards = self.store.decoded_shards(
                        self.engine, window=self.decode_window,
                        device_out=self.device_out, mesh=self.mesh)
                try:
                    for s in shards:
                        if isinstance(s, shd.ShardedTensor):
                            s = s.full()
                        yield s if isinstance(s, torch.Tensor) \
                            else torch.from_numpy(s)
                finally:
                    shards.close()

        whole = shard_iter()

        def shards():           # each on the loader's member, if ranked
            while True:
                with spmd.use(self._member):
                    s = next(whole, None)
                if s is None:
                    return
                yield s

        src = shards() if self._member is not None else whole
        t = None
        stop = threading.Event()
        if self.prefetch and self.service is None:
            q: "queue.Queue" = queue.Queue(maxsize=2)

            def worker():
                # Bounded-timeout puts + a stop flag: when the consumer
                # drops the iterator, the worker exits within one timeout
                # instead of blocking on q.put forever holding a decoded
                # shard.  Stop is also checked before each decode, so
                # shutdown never waits on another shard's launch.  A decode
                # error goes on the queue, and the consumer raises it.
                while not stop.is_set():
                    try:
                        s = next(src)
                    except StopIteration:
                        return
                    except BaseException as e:
                        s = _Failed(e)
                    while not stop.is_set():
                        try:
                            q.put(s, timeout=0.05)
                            break
                        except queue.Full:
                            continue
                    if isinstance(s, _Failed):
                        return

            t = threading.Thread(target=worker, daemon=True,
                                 name="codag-loader-prefetch")
            t.start()

            def get():
                s = q.get()
                if isinstance(s, _Failed):
                    raise s.error
                return s
        else:
            # service mode: the service worker already decodes ahead of the
            # consumer, so no prefetch thread
            get = lambda: next(src)

        place = lambda t: t
        if self.mesh is not None:
            batch_sh = shd.decode_out_sharding(self.mesh, 2)
            if shd.placeable((self.batch, self.seq), batch_sh):
                place = lambda t: shd.place(t, batch_sh)
        try:
            buf = get()
            while True:
                while len(buf) < need:
                    buf = torch.cat([buf, get()])
                flat = buf[:need]
                buf = buf[need - 1:]
                yield {"tokens": place(flat[:-1].reshape(self.batch, self.seq)
                                       % self.store.vocab),
                       "labels": place(flat[1:].reshape(self.batch, self.seq)
                                       % self.store.vocab)}
        finally:
            # runs on generator close/GC as well as break/throw: shut the
            # prefetch worker down so no thread outlives its iterator
            if t is not None:
                stop.set()
                try:
                    while True:
                        q.get_nowait()       # unblock a mid-put worker
                except queue.Empty:
                    pass
                t.join(timeout=5.0)
            if t is None or not t.is_alive():
                src.close()
                whole.close()
