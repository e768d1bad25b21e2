"""A configuration's table: columns held compressed, made from the seed, and
the queries an operation reads.

A configuration (``bench/configs/<name>.json``) lists its columns, each one
Table IV dataset (``bench/data/table4.py``) under one codec, with equal
decoded shares of ``table_chunks`` chunks of ``chunk_bytes``.  Every column
has a base of ``base_chunks`` chunks of distinct data from the seed (its own
stream of the seed's generator), encoded by the frozen codec, and lists the
base's rows again up to its share; every listed row is a copy of its own
(``blobs.take_rows``).  A 64-bit column under a plane-splitting codec has
rows of two chunks (one a plane), so its share is rounded to whole rows and
the one-chunk columns at the end take up the difference.

:class:`Build` makes and encodes the columns on worker processes while the
caller goes on.  Numpy only: nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import functools
import multiprocessing
import os
import threading
import time
from typing import List, Optional

import numpy as np

from bench import blobs
from bench.data import table4


def seed_stream(seed: int, *key: int) -> np.random.Generator:
    """A generator for one part of a run's data: any whole ``seed`` (also
    negative or past 64 bits) and a key of small numbers."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), seed >> 64 & 0xFFFF, *key]))


@dataclasses.dataclass
class Column:
    """One column under one codec.  A row is one chunk of every stored
    blob, so it decodes to ``row_elems`` of the column's elements."""

    name: str
    dataset: str
    codec: str
    base: np.ndarray          # the base's data, in the column's dtype
    base_blobs: List[dict]    # its stored arrays, ``base_rows`` rows each
    rows: int                 # rows the table holds

    @property
    def dtype(self) -> str:
        return str(self.base.dtype)

    @property
    def base_rows(self) -> int:
        return int(self.base_blobs[0]["comp"].shape[0])

    @property
    def row_elems(self) -> int:
        return self.base.shape[0] // self.base_rows

    @functools.cached_property
    def row_payload(self) -> np.ndarray:
        """Compressed bytes each base row reads, over its stored arrays."""
        per = np.zeros(self.base_rows, np.int64)
        for b in self.base_blobs:
            per += np.asarray(b["comp_lens"], np.int64)
            for k, v in b["extras"].items():
                if k.startswith("hdr_"):
                    per += v[0].nbytes
        return per

    def blobs(self, idx: np.ndarray) -> List[dict]:
        """The stored arrays of the rows ``idx`` (base row numbers)."""
        return [blobs.take_rows(b, idx) for b in self.base_blobs]

    def table_rows(self) -> np.ndarray:
        """The base rows of the whole column, in table order."""
        return np.arange(self.rows) % self.base_rows


@dataclasses.dataclass
class Query:
    """One operation's columns and rows: (column, base row indices)."""

    parts: List[tuple]

    @functools.cached_property
    def user_bytes(self) -> int:
        """Decoded bytes the caller receives."""
        return sum(len(idx) * c.row_elems * c.base.dtype.itemsize
                   for c, idx in self.parts)

    @functools.cached_property
    def payload_bytes(self) -> int:
        """Compressed bytes the decode reads, each once."""
        return sum(int(c.row_payload[idx].sum()) for c, idx in self.parts)


def shares(config: dict, chunks_per_row: list) -> list:
    """Rows per column, so that the table holds exactly ``table_chunks``
    chunks and each column about an equal share."""
    total = int(config["table_chunks"])
    each = total / len(chunks_per_row)
    rows = [max(1, round(each / c)) for c in chunks_per_row]
    diff = total - sum(r * c for r, c in zip(rows, chunks_per_row))
    singles = [i for i, c in enumerate(chunks_per_row) if c == 1]
    k = 0
    while diff and singles:
        i = singles[-1 - k % len(singles)]
        step = 1 if diff > 0 else -1
        rows[i] += step
        diff -= step
        k += 1
    if diff:
        raise ValueError(f"cannot split {total} chunks over "
                         f"{chunks_per_row} chunks a row")
    return rows


def _make(job):
    """A column's base: (its number, its data)."""
    ci, dataset, seed, n_bytes = job
    return ci, table4.make(dataset, seed_stream(seed, ci), n_bytes)


class Build:
    """A configuration's columns, made from ``seed`` and encoded at once:
    on ``workers`` spawned processes (default: the cores less one, at most
    8; 0 works in the calling thread), each column's chunks queued for
    encoding as soon as the column is made.  :meth:`result` waits and ends
    the pool; :meth:`close` ends it early.  Either has to be called."""

    def __init__(self, config: dict, seed: int,
                 workers: Optional[int] = None):
        self.config = config
        self.t0 = time.perf_counter()
        self.make_s = self.encode_s = None
        n_bytes = int(config["base_chunks"]) * int(config["chunk_bytes"])
        self._jobs = [(ci, c["dataset"], seed, n_bytes)
                      for ci, c in enumerate(config["columns"])]
        self.bases: list = [None] * len(self._jobs)
        self._stored: list = [[] for _ in self._jobs]
        self._error: Optional[BaseException] = None
        if workers is None:
            workers = max(1, min(8, (os.cpu_count() or 2) - 1))
        self._pool = self._thread = None
        if workers:
            ctx = multiprocessing.get_context("spawn")
            self._pool = ctx.Pool(workers)
            self._thread = threading.Thread(target=self._drive, daemon=True)
            self._thread.start()
        else:
            self._drive()

    def _drive(self) -> None:
        pool = self._pool
        cb = int(self.config["chunk_bytes"])
        try:
            made = (pool.imap_unordered(_make, self._jobs) if pool
                    else map(_make, self._jobs))
            for ci, arr in made:
                self.bases[ci] = arr
                codec = self.config["columns"][ci]["codec"]
                for a in blobs.planes(arr, codec):
                    head, chunks = blobs.chunk_jobs(a, codec, cb)
                    jobs = [(codec, head["width"], c) for c in chunks]
                    done = (pool.map_async(blobs.encode_job, jobs, chunksize=1)
                            if pool else [blobs.encode_job(j) for j in jobs])
                    self._stored[ci].append((head, done))
            self.make_s = time.perf_counter() - self.t0
        except BaseException as e:      # raised again by result()
            self._error = e

    def result(self) -> List[Column]:
        """The columns, each with its share of the table's rows."""
        try:
            if self._thread is not None:
                self._thread.join()
            if self._error is not None:
                raise self._error
            stored = [[blobs.assemble(head, done if isinstance(done, list)
                                      else done.get())
                       for head, done in per] for per in self._stored]
            self.encode_s = time.perf_counter() - self.t0
        finally:
            self.close()
        rows = shares(self.config, [len(s) for s in stored])
        return [Column(name=f"{c['dataset']}.{c['codec']}",
                       dataset=c["dataset"], codec=c["codec"], base=arr,
                       base_blobs=s, rows=r)
                for c, arr, s, r in zip(self.config["columns"], self.bases,
                                        stored, rows)]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        if self._thread is not None:
            # a thread left waiting on the ended pool is a daemon's
            self._thread.join(timeout=5)
