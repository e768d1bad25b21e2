"""DecodePlan — the decode-pipeline IR every entry path lowers to.

The counterpart of ``repro/core/plan.py``:

    parse/group  — partition blobs by ``(codec, width, chunk_elems, bits)``
                   and fuse each group's chunk tables into one flat stream
                   table (``format.concat_blobs``); precompute every blob's
                   scatter (``format.reassemble_indices``).
    stage        — upload fused tables, scatter indices and epilogue
                   operands through the ``transfers.to_device`` funnel, once
                   per device; a staged plan re-executes transfer-free.
    dispatch     — ONE ``ops.decode`` call site (:func:`dispatch`), for both
                   the warp (CODAG) and block (RAPIDS-ablation) units.
    reassemble   — per-blob row-range scatter on the device
                   (``format.reassemble_rows_device``).
    epilogue     — optional consumer transform (``harness.Epilogue``).
    place        — each output under its requested ``NamedSharding``
                   (``distributed.sharding.place``: a ``ShardedTensor``, one
                   tensor a member, or on a mesh over a world's ranks this
                   rank's block); a shape that cannot be placed stays as it
                   is.

    plan = DecodePlan.build(blobs)
    outs = plan.execute(engine)                     # host ndarrays
    devs = plan.execute_device(engine)              # tensors on engine.device
    shds = plan.execute_sharded(mesh, out_shardings=decode_out_sharding(mesh))

``DecodePlan.build(bucket=True)`` pads each merged table to pow2 row and
column buckets (the service's window loop builds its plans so), and
:meth:`DecodePlan.decode_group_device` stages and decodes one group on a
chosen device.  :func:`gather_member_tables` fuses the wire tables of a
mesh's members into one table for one dispatch (the collective plane):
the members' list in one process, or, in a member's process, its own
table all-gathered over a mesh axis (the reference's form).

:meth:`DecodePlan.execute_sharded` is the mesh executor: each group's table
is padded with zero-length rows to a multiple of the mesh axis, so every
member owns an equal block of rows, member after member, which is
:func:`gather_member_tables`' layout.  Where the members share one device,
one dispatch decodes every member's rows (one launch a group), and the
outputs are scattered and placed into member shards.  On a mesh over a
world's ranks (one process a member, ``launch.mesh.spawn``) each process
stages and decodes only its own block of rows (one launch a group on its
own device), the decoded group tables are all-gathered over the axis
(``distributed.spmd.all_gather``: each member's decoded rows, the bytes
counted in ``Member.transfer_bytes``), and each process keeps its own
block of every output.  A mesh over distinct devices without a rank
raises, pointing to ``launch.mesh.spawn``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.core import transfers
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import decode_axis, placeable
from repro_torch.kernels import ops
from repro_torch.roofline import count

# Bounded content-keyed LRU slots for staged epilogue operands.
OPERAND_CACHE_SLOTS = 8


def _default_engine(engine):
    if engine is not None:
        return engine
    from repro_torch.core.engine import CodagEngine
    return CodagEngine()


# --------------------------------------------------------------------------
# dispatch — the ONE ops.decode call site in the package
# --------------------------------------------------------------------------

# Lowering observers (``count_lowered``): the discipline of
# ``ops.count_dispatches``, a list of lists under one lock.
_lowered: list = []
_lowered_lock = threading.Lock()


@contextlib.contextmanager
def count_lowered():
    """Observe :func:`dispatch` calls (the lowering funnel).  Yields a list
    that grows one entry per call: the table's chunk count, the group key
    and the engine's ``unit`` and ``backend``.

    Paired with ``ops.count_dispatches``, equal counts show that every
    kernel launch of a warp-unit engine was lowered through the plan (a
    block-unit dispatch issues one ``ops.decode`` a batch of rows).
    """
    calls: list = []
    with _lowered_lock:
        _lowered.append(calls)
    try:
        yield calls
    finally:
        with _lowered_lock:
            for i, obs in enumerate(_lowered):
                if obs is calls:
                    del _lowered[i]
                    break


def dispatch(dev: Dict[str, Any], *, config, codec: str, width: int,
             chunk_elems: int, bits: int = 0, epilogue=None,
             tune=None) -> torch.Tensor:
    """Lower one fused chunk table to ``ops.decode``.

    ``config`` (an ``engine.EngineConfig``) selects the provisioning unit:
    ``warp`` issues the whole table as one launch of independent streams
    (CODAG); ``block`` reproduces the fixed-pool RAPIDS baseline with one
    launch per serial batch of ``n_units`` rows.  ``all_thread=False``
    decodes through the ``scalar`` backend (the §V-E ablation).

    ``tune``: the kernel-knob tuple (``core.tuning.kernel_tune``); None
    resolves the tuned defaults merged with ``config.tune`` (explicit wins).
    """
    if tune is None:
        from repro_torch.core import tuning
        tune = tuning.kernel_tune(codec, width, getattr(config, "tune", ()))
    n_chunks = dev["comp"].shape[0]
    with _lowered_lock:
        if _lowered:
            rec = {"num_chunks": int(n_chunks), "codec": codec,
                   "width": width, "chunk_elems": chunk_elems, "bits": bits,
                   "unit": config.unit, "backend": config.backend}
            for calls in _lowered:
                calls.append(dict(rec))
    backend = config.backend if config.all_thread else "scalar"
    if config.unit == "warp":
        batches = [(0, n_chunks)]
    elif config.unit == "block":
        nu = max(1, min(config.n_units, n_chunks))
        if nu < n_chunks and epilogue is not None and \
                getattr(epilogue.fn, "n_members", None):
            raise ValueError("a member-reducing epilogue needs the whole "
                             "gathered table in one launch (unit='warp')")
        batches = [(s, min(s + nu, n_chunks)) for s in range(0, n_chunks, nu)]
    else:
        raise ValueError(f"unknown unit {config.unit!r}")
    outs = []
    for s, e in batches:
        # per-chunk tables are sliced; shared tables and scalar epilogue
        # operands replicate to every batch
        batch = {k: v[s:e] if v.dim() and v.shape[0] == n_chunks else v
                 for k, v in dev.items()}
        outs.append(ops.decode(batch, codec=codec, width=width,
                               chunk_elems=chunk_elems, backend=backend,
                               bits=bits, epilogue=epilogue, tune=tune))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def gather_member_tables(dev, axis_name: Optional[str] = None, *,
                         codec: Optional[str] = None,
                         shared: Sequence[str] = (),
                         row_counts=None) -> Dict[str, Any]:
    """Collective-plane stage: the members' chunk tables as ONE fused
    table, which one :func:`dispatch` decodes.

    Every per-chunk entry is laid member after member, member m's rows at
    ``[m * n_chunks, (m + 1) * n_chunks)``: what the reference's all-gather
    over the member axis gives.  Shared tables (the codec's
    ``shared_extras``, e.g. ``bitpack_bits``) and scalar operands are kept
    once, this (or member 0's): they are the same for every member by the
    wire format's construction.  Two forms:

    * ``dev`` a sequence: member m's device-built wire table (the dict a
      :func:`dispatch` call consumes), each of the same height, all on the
      one device the members share; the gather is a ``torch.cat`` and
      nothing crosses a link.  Tables on distinct devices raise.
    * ``dev`` a dict: this member's own table, in a member's program (a
      ``distributed.spmd.Member`` installed with ``spmd.use``, one process
      a member): every per-chunk entry is all-gathered over ``axis_name``
      (``spmd.all_gather``; ``comp_words``, a view of ``comp``, is viewed
      again on the gathered bytes), the reference's signature.  Every
      member's table must have the same shape.

    ``row_counts``: for ragged members that padded their tables to a
    common height, each member's count of valid rows (a sequence in the
    list form, this member's count in the dict form, all-gathered): the
    padding rows' ``out_lens`` and ``comp_lens`` are zeroed, so
    length-honouring bodies treat them as absent.
    """
    shared = set(shared)
    if codec is not None:
        from repro_torch.core import registry
        shared |= set(registry.get(codec).shared_extras)
    if isinstance(dev, dict):
        out, counts, n_members = _gather_own_table(dev, axis_name, shared,
                                                   row_counts)
    else:
        out, counts, n_members = _gather_table_list(list(dev), shared,
                                                    row_counts)
    if counts is not None:
        n_chunks = out["out_lens"].shape[0] // n_members
        lens = out["out_lens"]
        flat = torch.arange(n_members * n_chunks, device=lens.device)
        valid = (flat % n_chunks) < counts[flat // n_chunks]
        out["out_lens"] = torch.where(valid, lens, 0).to(lens.dtype)
        out["comp_lens"] = torch.where(valid, out["comp_lens"],
                                       0).to(out["comp_lens"].dtype)
    return out


def _per_chunk(k: str, v, shared: set, n_chunks: int) -> bool:
    return (k not in shared and isinstance(v, torch.Tensor) and v.dim() >= 1
            and v.shape[0] == n_chunks)


def _gather_table_list(devs: list, shared: set, row_counts):
    """:func:`gather_member_tables`' one-process form: ``(table, counts,
    members)``."""
    if not devs:
        raise ValueError("no member tables to gather")
    n_chunks = devs[0]["out_lens"].shape[0]
    devices = {v.device for d in devs for v in d.values()
               if isinstance(v, torch.Tensor)}
    if len(devices) > 1:
        raise NotImplementedError(
            f"member tables on {sorted(map(str, devices))}: one process "
            "gathers the tables of members that share one device; run one "
            "process a member (launch.mesh.spawn) and gather each member's "
            "own table over a mesh axis")
    if any(d["out_lens"].shape[0] != n_chunks for d in devs):
        raise ValueError("member tables of different heights: pad them to "
                         "one height and pass row_counts")
    out = {}
    for k, v in devs[0].items():
        out[k] = torch.cat([d[k] for d in devs]) \
            if _per_chunk(k, v, shared, n_chunks) else v
    count.collective("all-gather", sum(
        out[k].numel() * out[k].element_size() for k in out
        if k not in shared and isinstance(out[k], torch.Tensor)
        and out[k] is not devs[0][k]), out["out_lens"].device)
    counts = None
    if row_counts is not None:
        counts = torch.as_tensor(row_counts, dtype=torch.int64,
                                 device=out["out_lens"].device).reshape(-1)
        if counts.shape[0] != len(devs):
            raise ValueError(f"{counts.shape[0]} row counts for "
                             f"{len(devs)} members")
    return out, counts, len(devs)


def _gather_own_table(dev: dict, axis_name: Optional[str], shared: set,
                      row_counts):
    """:func:`gather_member_tables`' member form: ``(table, counts,
    members)``."""
    from repro_torch.distributed import spmd
    m = spmd.current()
    if m is None or m.transport != "group" or axis_name is None:
        raise ValueError("one member's table is gathered over a mesh axis "
                         "in a member's program (axis_name, and "
                         "distributed.spmd.use of a Member of a world); one "
                         "process gathers the members' list")
    n_chunks = dev["out_lens"].shape[0]
    words = dev.get("comp_words")
    comp = dev.get("comp")
    view = (words is not None and comp is not None
            and words.data_ptr() == comp.data_ptr())
    out = {}
    for k, v in dev.items():
        if k == "comp_words" and view:
            continue
        out[k] = spmd.all_gather(v, axis_name) \
            if _per_chunk(k, v, shared, n_chunks) else v
    if view:
        out["comp_words"] = out["comp"].view(words.dtype)
        out = {k: out[k] for k in dev}           # the table's own order
    counts = None
    if row_counts is not None:
        own = torch.as_tensor(row_counts, dtype=torch.int64,
                              device=dev["out_lens"].device).reshape(1)
        counts = spmd.all_gather(own, axis_name)
    return out, counts, m.size(axis_name)


def as_shard_list(out_shardings, n: int, what: str = "items"):
    """An ``out_shardings`` argument (None, one sharding, or one per item
    with None holes) as a list of ``n``, or None."""
    if out_shardings is None:
        return None
    if isinstance(out_shardings, (list, tuple)):
        if len(out_shardings) != n:
            raise ValueError(
                f"{len(out_shardings)} out_shardings for {n} {what}")
        return list(out_shardings)
    return [out_shardings] * n


def _scatter_place(table: torch.Tensor, scatter, meta) -> List[Any]:
    """Reassemble every blob of one decoded group table from its rows,
    then place it under its requested sharding (if any, and if its shape
    can be placed)."""
    outs = []
    for (row0, nc, total, odt, oshape, transformed, place), idx in zip(
            meta, scatter):
        out = fmt.reassemble_rows_device(
            table, row0=row0, num_chunks=nc, total_elems=total,
            orig_dtype=odt, orig_shape=oshape, indices=idx,
            transformed=transformed)
        if place is not None and placeable(out.shape, place):
            out = shd.place(out, place)
        outs.append(out)
    return outs


def _operand_cache_key(operands: Dict[str, Any]) -> tuple:
    """Staging-cache key for an epilogue-operand dict: host values by
    content digest, tensors by identity (hashing a device tensor would copy
    it to the host)."""
    parts = []
    for k in sorted(operands):
        v = operands[k]
        if isinstance(v, torch.Tensor):
            parts.append((k, "dev", id(v)))
        else:
            a = np.asarray(v)
            h = hashlib.blake2b(digest_size=16)
            h.update(f"{a.dtype}|{a.shape}".encode())
            h.update(a.tobytes())
            parts.append((k, "host", h.hexdigest()))
    return tuple(parts)


# --------------------------------------------------------------------------
# the IR
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanGroup:
    """One fused dispatch: the merged chunk table for one group key."""

    key: tuple                    # (codec, width, chunk_elems, bits)
    blob_ids: Tuple[int, ...]     # positions in the input blob list
    row_offsets: Tuple[int, ...]  # first chunk row of each blob in `merged`
    merged: fmt.CompressedBlob
    members: Tuple[fmt.CompressedBlob, ...] = dataclasses.field(
        default=(), repr=False, compare=False)
    # pow2 (rows, cols) the table is padded to as it is staged, or None
    bucket: Optional[Tuple[int, int]] = None

    @property
    def scatter(self) -> Tuple[Optional[np.ndarray], ...]:
        """Per-blob device scatter (aligned with blob_ids), or None where
        the blob's rows are contiguous."""
        return tuple(fmt.reassemble_indices(b) for b in self.members)

    @property
    def num_chunks(self) -> int:
        """Rows of the staged (and decoded) table, bucket padding
        included."""
        return self.bucket[0] if self.bucket else self.merged.num_chunks

    def stage(self, device) -> Dict[str, torch.Tensor]:
        """The group's device table (``ops.table_inputs``), padded to its
        bucket as it is copied."""
        rows, cols = self.bucket or (None, None)
        return ops.table_inputs(self.merged, device, rows=rows,
                                pad_comp_to=cols)[0]


@dataclasses.dataclass
class DecodePlan:
    """The lowered decode pipeline for one list of blobs."""

    blobs: List[fmt.CompressedBlob]
    groups: List[PlanGroup]
    # staged inputs per device: device -> {group index -> device dict}, and
    # device -> {group index -> per-blob scatter tensors}
    _staged: Dict[Any, Dict[int, Any]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _staged_scatter: Dict[Any, Dict[int, Any]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # content-keyed bounded LRU of staged epilogue-operand dicts, entries
    # (staged dict, strong ref to the originals)
    _staged_operands: "collections.OrderedDict[tuple, tuple]" = \
        dataclasses.field(default_factory=collections.OrderedDict,
                          repr=False, compare=False)

    @classmethod
    def build(cls, blobs: Sequence[fmt.CompressedBlob], *,
              bucket: bool = False,
              bucket_floor: Optional[int] = None) -> "DecodePlan":
        """Parse/group stage: one ``PlanGroup`` per distinct group key, in
        order of first occurrence.

        ``bucket=True`` pads each merged table to pow2 row/column buckets
        (the shape of ``format.pad_table_to_bucket``, recorded as
        ``PlanGroup.bucket`` and padded as the table is staged, with no
        host copy); padding rows trail the real rows, so per-blob row
        ranges are unaffected.  ``bucket_floor`` overrides the minimum
        column bucket (None: the tuned-defaults table's floor for the
        group, else 128).
        """
        blobs = list(blobs)
        by_key: Dict[tuple, List[int]] = {}
        for i, b in enumerate(blobs):
            by_key.setdefault(fmt.group_key(b), []).append(i)
        groups = []
        for key, ids in by_key.items():
            offsets, row = [], 0
            for i in ids:
                offsets.append(row)
                row += blobs[i].num_chunks
            merged = fmt.concat_blobs([blobs[i] for i in ids])
            groups.append(PlanGroup(
                key=key, blob_ids=tuple(ids), row_offsets=tuple(offsets),
                merged=merged, members=tuple(blobs[i] for i in ids),
                bucket=fmt.bucket_shape(merged, bucket_floor) if bucket
                else None))
        return cls(blobs=blobs, groups=groups)

    @property
    def num_dispatches(self) -> int:
        return len(self.groups)

    @property
    def num_chunks(self) -> int:
        return sum(g.num_chunks for g in self.groups)

    def stage(self, device) -> "DecodePlan":
        """Upload every group's fused table and scatter indices to
        ``device``, once.  After staging, :meth:`execute_device` performs no
        host→device transfer and can run under
        ``transfers.no_host_transfers()``."""
        device = torch.device(device)
        staged = self._staged.setdefault(device, {})
        scat = self._staged_scatter.setdefault(device, {})
        for gi, g in enumerate(self.groups):
            if gi not in staged:
                staged[gi] = g.stage(device)
            if gi not in scat:
                scat[gi] = tuple(
                    None if s is None else transfers.to_device(s, device)
                    for s in g.scatter)
        return self

    def stage_sharded(self, mesh, axis: str) -> "DecodePlan":
        """Stage for the mesh executor: each group's table padded with
        zero-length rows (``format.pad_table_rows``' rows, written as it is
        copied) to a multiple of ``mesh.shape[axis]``, so member m owns
        rows ``[m * r, (m + 1) * r)``; shared tables and scatter indices
        once.  Where the members share one device every member's rows are
        staged there; on a mesh over a world's ranks only this member's
        block (``format.table_rows``), on its own device."""
        device = mesh.member_device()
        key = (mesh, axis)
        staged = self._staged.setdefault(key, {})
        scat = self._staged_scatter.setdefault(key, {})
        ndev = int(mesh.shape[axis])
        for gi, g in enumerate(self.groups):
            if gi in staged:
                continue
            rows = -(-g.num_chunks // ndev) * ndev
            cols = g.bucket[1] if g.bucket else None
            if mesh.rank is None:
                staged[gi] = ops.table_inputs(g.merged, device, rows=rows,
                                              pad_comp_to=cols)[0]
            else:
                lo = mesh.coord(axis) * (rows // ndev)
                own = fmt.table_rows(g.merged, lo, lo + rows // ndev)
                staged[gi] = ops.table_inputs(own, device,
                                              pad_comp_to=cols)[0]
            scat[gi] = tuple(
                None if s is None else transfers.to_device(s, device)
                for s in g.scatter)
        return self

    def _stage_operands(self, operands: Optional[Dict[str, Any]],
                        device) -> Dict[str, Any]:
        """Bounded content-keyed staging cache for epilogue operands."""
        if not operands:
            return {}
        key = (_operand_cache_key(operands), device)
        cached = self._staged_operands.get(key)
        if cached is not None:
            self._staged_operands.move_to_end(key)
            return cached[0]
        staged = {k: transfers.to_device(v, device)
                  for k, v in operands.items()}
        # keep the originals alive: identity keys must not recycle ids
        self._staged_operands[key] = (staged, dict(operands))
        while len(self._staged_operands) > OPERAND_CACHE_SLOTS:
            self._staged_operands.popitem(last=False)
        return staged

    def decode_group_device(self, gi: int, engine=None, *, device=None,
                            epilogue=None) -> torch.Tensor:
        """Stage and dispatch one group; returns its raw decoded
        ``(num_chunks, chunk_elems)`` matrix on the device (no reassembly).

        ``device``: where to stage and decode (default ``engine.device``);
        the service's round-robin group->device assignment passes it.
        Callers owning the blob->row mapping (the service's window loop)
        scatter the result themselves.
        """
        engine = _default_engine(engine)
        device = engine.device if device is None else torch.device(device)
        staged = self._staged.setdefault(device, {})
        if gi not in staged:
            staged[gi] = self.groups[gi].stage(device)
        codec, width, chunk_elems, bits = self.groups[gi].key
        return dispatch(staged[gi], config=engine.config, codec=codec,
                        width=width, chunk_elems=chunk_elems, bits=bits,
                        epilogue=epilogue)

    def execute(self, engine=None) -> List[np.ndarray]:
        """Host executor: one dispatch per group, one sanctioned d2h
        materialization per group table, scatter back in input order."""
        engine = _default_engine(engine)
        outs: List[Optional[np.ndarray]] = [None] * len(self.blobs)
        for g in self.groups:
            table = engine.decompress_table(g.merged)
            for bid, row0 in zip(g.blob_ids, g.row_offsets):
                blob = self.blobs[bid]
                # copy: a slice would pin the whole group table
                rows = table[row0:row0 + blob.num_chunks].copy()
                outs[bid] = fmt.reassemble(blob, rows)
        return outs  # type: ignore[return-value]

    def _blob_meta(self, g: PlanGroup, transformed: bool,
                   places: Optional[List]) -> tuple:
        return tuple(
            (row0, self.blobs[bid].num_chunks, self.blobs[bid].total_elems,
             self.blobs[bid].orig_dtype, tuple(self.blobs[bid].orig_shape),
             transformed, None if places is None else places[bid])
            for bid, row0 in zip(g.blob_ids, g.row_offsets))

    def _run(self, key, engine, epilogue, ops_extra, places,
             member=None, axis: Optional[str] = None) -> List[Any]:
        """One dispatch a group of the tables staged under ``key``, then
        every blob's scatter and placement.  With ``member`` (a
        ``distributed.spmd.Member``), each decoded table is this member's
        block of rows, all-gathered over ``axis`` before the scatter."""
        outs: List[Any] = [None] * len(self.blobs)
        for gi, g in enumerate(self.groups):
            dev = self._staged[key][gi]
            if ops_extra:
                dev = {**dev, **ops_extra}
            codec, width, chunk_elems, bits = g.key
            table = dispatch(dev, config=engine.config, codec=codec,
                             width=width, chunk_elems=chunk_elems, bits=bits,
                             epilogue=epilogue)
            if member is not None:
                from repro_torch.distributed import spmd
                with spmd.use(member):
                    table = spmd.all_gather(table, axis)
            group_outs = _scatter_place(
                table, self._staged_scatter[key][gi],
                self._blob_meta(g, epilogue is not None, places))
            for bid, out in zip(g.blob_ids, group_outs):
                outs[bid] = out
        return outs

    def execute_device(self, engine=None, *, epilogue=None,
                       epilogue_operands: Optional[Dict[str, Any]] = None,
                       out_shardings=None) -> List[Any]:
        """Device executor: one dispatch per group, then per-blob scatter,
        the optional ``epilogue`` and placement on ``engine.device``.
        Returns tensors in input order; a blob whose rows are contiguous
        gets a view of its group's decoded table (no copy).  With the plan
        staged (and the operands seen before) there are no host transfers.

        ``out_shardings``: one ``NamedSharding`` (or one a blob, None
        allowed) each output is placed under (``sharding.place``).
        """
        engine = _default_engine(engine)
        device = engine.device
        self.stage(device)
        return self._run(device, engine, epilogue,
                         self._stage_operands(epilogue_operands, device),
                         as_shard_list(out_shardings, len(self.blobs),
                                       what="blobs"))

    def execute_sharded(self, mesh, *, axis: Optional[str] = None,
                        engine=None, epilogue=None,
                        epilogue_operands: Optional[Dict[str, Any]] = None,
                        out_shardings=None) -> List[Any]:
        """Mesh executor: every group's rows split evenly over ``mesh``'s
        ``axis`` (default ``sharding.decode_axis``), each member owning a
        block (:meth:`stage_sharded`), and each blob's output placed under
        its requested ``NamedSharding``.  Where the members share one
        device, one dispatch a group decodes every member's block.  On a
        mesh over a world's ranks this process decodes its own block of
        every group (one dispatch a group on its device), the decoded
        blocks are all-gathered over ``axis`` (``spmd.member_of(mesh)``'s
        group), and it returns its own block of each output as a plain
        tensor (``sharding.block``; a whole output where it is not placed):
        the members along other axes decode and keep the same block, as
        ``shard_map`` replicates it.  Equal to :meth:`execute_device` bit
        for bit; a staged plan re-executes with no host transfer.
        ``engine``: its device must be the member's (default an engine
        there); epilogue operands are staged once, for every member.  A
        mesh over distinct devices without a rank raises, pointing to
        ``launch.mesh.spawn``.
        """
        device = mesh.member_device()
        if engine is None:
            from repro_torch.core.engine import CodagEngine, EngineConfig
            engine = CodagEngine(EngineConfig(device=str(device)))
        if engine.device != device:
            raise ValueError(f"the engine decodes on {engine.device}, the "
                             f"mesh's members on {device}")
        axis = decode_axis(mesh) if axis is None else axis
        if axis not in mesh.axis_names:
            raise ValueError(f"{axis!r} is not an axis of {mesh}")
        self.stage_sharded(mesh, axis)
        member = None
        if mesh.rank is not None:
            from repro_torch.distributed import spmd
            member = spmd.member_of(mesh)
        return self._run((mesh, axis), engine, epilogue,
                         self._stage_operands(epilogue_operands, device),
                         as_shard_list(out_shardings, len(self.blobs),
                                       what="blobs"), member, axis)


def decompress_blobs(blobs: Sequence[fmt.CompressedBlob], engine=None,
                     device_out: bool = False, epilogue=None, *,
                     mesh=None, axis: Optional[str] = None,
                     out_shardings=None) -> List:
    """Batched decompress over many blobs through one :class:`DecodePlan`:
    one dispatch per (codec, width, chunk_elems, bits) group, outputs in
    input order.  ``device_out=True`` keeps every output on the engine's
    device; ``mesh`` splits each group's rows over the mesh's ``axis``
    (:meth:`DecodePlan.execute_sharded`); ``out_shardings`` places the
    outputs (device paths only)."""
    if not blobs:
        return []
    plan = DecodePlan.build(blobs)
    if mesh is not None:
        return plan.execute_sharded(mesh, axis=axis, engine=engine,
                                    epilogue=epilogue,
                                    out_shardings=out_shardings)
    if device_out:
        return plan.execute_device(engine, epilogue=epilogue,
                                   out_shardings=out_shardings)
    if epilogue is not None:
        raise ValueError("epilogue requires device_out=True: a fused "
                         "epilogue's output has no host reassembly path")
    return plan.execute(engine)
