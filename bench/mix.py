"""The one generator of traffic: a mix is a data file,
``bench/traffic/<name>.json``, and this module runs it.

Every operation decodes the whole table of the cell's configuration (the
paper's throughput setting: every chunk of every column in flight at once).
A mix's keys:

  path      how an operation reaches the program:
              resident   every query's plan is built (``DecodePlan.build``)
                         and staged (``DecodePlan.stage``) in set-up, so the
                         compressed columns are held in device memory; an
                         operation is ``DecodePlan.execute_device`` and, for
                         a 64-bit column stored as two planes,
                         ``format.combine_planes_device``.
              from_host  an operation is ``api.decompress_many(device_out=
                         True)`` on the host blobs: plan build, staging,
                         decode and join, each time.
  inflight  operations queued at once: a closed loop queues the next one
            as soon as fewer are outstanding.
  check     which operations' outputs are compared: the first, and
            ``drawn`` drawn by the seed from the next ``drawn_from``; the
            last ``inflight`` always.

This and the harness's set-up are the only parts of the benchmark that
call into ``repro_torch``.  Blobs reach the program as plain fields through
``format.blob_from_reference``; an operation returns one tensor a column.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from bench.table import Query


def queries(columns: list) -> List[Query]:
    """The operations' queries: one, every row of every column."""
    return [Query([(c, c.table_rows()) for c in columns])]


def keep_set(traffic: dict, n_queries: int, rng) -> set:
    """Operations whose outputs are compared: the first round of queries
    (every query once, each on memory no earlier answer has used), and
    ``drawn`` more from the next ``drawn_from`` operations."""
    chk = traffic["check"]
    drawn = rng.choice(np.arange(n_queries, n_queries + int(chk["drawn_from"])),
                       int(chk["drawn"]), replace=False)
    return set(range(n_queries)) | {int(d) for d in drawn}


def _arrays(query: Query) -> list:
    """The query's columns as the program's ``CompressedArray``s."""
    from repro_torch.core import api
    from repro_torch.core import format as fmt
    out = []
    for col, idx in query.parts:
        stored = [fmt.blob_from_reference(b) for b in col.blobs(idx)]
        out.append(api.CompressedArray(
            blobs=stored, orig_dtype=col.dtype,
            orig_shape=(len(idx) * col.row_elems,)))
    return out


class Resident:
    """Plans built and staged in set-up; ``build_s`` and ``stage_s`` are
    their host seconds, the staging ending in a synchronize."""

    def __init__(self, queries, engine, sync):
        from repro_torch.core import plan as plan_mod
        self.engine, self.plans, self.layouts = engine, [], []
        arrays = [_arrays(q) for q in queries]
        t0 = time.perf_counter()
        for cas in arrays:
            flat, spans = [], []
            for ca in cas:
                spans.append((len(flat), len(ca.blobs), ca.orig_dtype,
                              ca.orig_shape))
                flat.extend(ca.blobs)
            self.plans.append(plan_mod.DecodePlan.build(flat))
            self.layouts.append(spans)
        t1 = time.perf_counter()
        for p in self.plans:
            p.stage(engine.device)
        sync()
        self.build_s, self.stage_s = t1 - t0, time.perf_counter() - t1

    def run(self, j: int) -> list:
        from repro_torch.core import format as fmt
        outs = self.plans[j].execute_device(self.engine)
        return [fmt.combine_planes_device(outs[s:s + n], dtype, shape)
                for s, n, dtype, shape in self.layouts[j]]


class FromHost:
    """Host blobs only; every operation builds, stages and decodes."""

    build_s = stage_s = None

    def __init__(self, queries, engine, sync):
        self.engine = engine
        self.arrays = [_arrays(q) for q in queries]

    def run(self, j: int) -> list:
        from repro_torch.core import api
        return api.decompress_many(self.arrays[j], self.engine,
                                   device_out=True)


PATHS = {"resident": Resident, "from_host": FromHost}


@dataclasses.dataclass
class Record:
    """One operation: its query, host seconds when queueing began and
    ended, and the card's finish on the host's time line."""

    query: int
    start: float
    queued: float
    mark: Any = None
    end: float = 0.0


def closed_loop(run_op: Callable, n_queries: int, n_ops: Optional[int],
                seconds: Optional[float], inflight: int, clock,
                keep: set = frozenset()):
    """Queue operations (operation i asks query i mod ``n_queries``) with
    at most ``inflight`` outstanding, for ``n_ops`` operations or until
    ``seconds`` have passed; wait for all.  Returns (records, kept outputs
    by operation, failure text or None, t0).  An operation's outputs are
    held until it has finished, and kept after where its number is in
    ``keep``; the last ``inflight`` are kept too."""
    clock.sync()
    t0 = time.perf_counter()
    m0 = clock.mark()
    deadline = None if seconds is None else t0 + seconds
    pending: collections.deque = collections.deque()
    recs: List[Record] = []
    kept: Dict[int, list] = {}
    failure = None
    i = 0
    while n_ops is None or i < n_ops:
        if len(pending) >= inflight:
            rec, outs = pending.popleft()
            clock.wait(rec.mark)
        if deadline is not None and time.perf_counter() >= deadline:
            break
        j = i % n_queries
        start = time.perf_counter()
        try:
            outs = run_op(j)
        except Exception:      # a fault of the program: stop, report
            failure = traceback.format_exc()
            break
        rec = Record(j, start, time.perf_counter(), clock.mark())
        recs.append(rec)
        pending.append((rec, outs))
        if i in keep:
            kept[i] = outs
        i += 1
    for n, (rec, outs) in enumerate(pending):
        clock.wait(rec.mark)
        kept[len(recs) - len(pending) + n] = outs
    for rec in recs:
        rec.end = t0 + clock.seconds(m0, rec.mark)
        rec.mark = None
    return recs, kept, failure, t0
