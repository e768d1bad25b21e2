"""DecodePlan — the decode-pipeline IR every entry path lowers to.

The counterpart of ``repro/core/plan.py`` (single-device executors):

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

    plan = DecodePlan.build(blobs)
    outs = plan.execute(engine)                     # host ndarrays
    devs = plan.execute_device(engine)              # tensors on engine.device

``DecodePlan.build(bucket=True)`` pads each merged table to pow2 row and
column buckets (the service's window loop builds its plans so), and
:meth:`DecodePlan.decode_group_device` stages and decodes one group on a
chosen device.  The sharded executor is not ported yet (ROADMAP.md Queue 1
item 11).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.core import transfers
from repro_torch.kernels import ops

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


def dispatch(dev: Dict[str, Any], *, config, codec: str, width: int,
             chunk_elems: int, bits: int = 0, epilogue=None) -> torch.Tensor:
    """Lower one fused chunk table to ``ops.decode``.

    ``config`` (an ``engine.EngineConfig``) selects the provisioning unit:
    ``warp`` issues the whole table as one launch of independent streams
    (CODAG); ``block`` reproduces the fixed-pool RAPIDS baseline with one
    launch per serial batch of ``n_units`` rows.
    """
    backend = config.backend if config.all_thread else "scalar"
    n_chunks = dev["comp"].shape[0]
    if config.unit == "warp":
        batches = [(0, n_chunks)]
    elif config.unit == "block":
        nu = max(1, min(config.n_units, n_chunks))
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
                               bits=bits, epilogue=epilogue))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


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
        column bucket (default 128).
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

    def execute_device(self, engine=None, *, epilogue=None,
                       epilogue_operands: Optional[Dict[str, Any]] = None
                       ) -> List[torch.Tensor]:
        """Device executor: one dispatch per group, then per-blob scatter
        and the optional ``epilogue`` on ``engine.device``.  Returns tensors
        in input order; a blob whose rows are contiguous gets a view of its
        group's decoded table (no copy).  With the plan staged (and the
        operands seen before) there are no host transfers.
        """
        engine = _default_engine(engine)
        device = engine.device
        self.stage(device)
        ops_extra = self._stage_operands(epilogue_operands, device)
        outs: List[Any] = [None] * len(self.blobs)
        for gi, g in enumerate(self.groups):
            dev = self._staged[device][gi]
            if ops_extra:
                dev = {**dev, **ops_extra}
            codec, width, chunk_elems, bits = g.key
            table = dispatch(dev, config=engine.config, codec=codec,
                             width=width, chunk_elems=chunk_elems, bits=bits,
                             epilogue=epilogue)
            for bid, row0, idx in zip(g.blob_ids, g.row_offsets,
                                      self._staged_scatter[device][gi]):
                blob = self.blobs[bid]
                outs[bid] = fmt.reassemble_rows_device(
                    table, row0=row0, num_chunks=blob.num_chunks,
                    total_elems=blob.total_elems, orig_dtype=blob.orig_dtype,
                    orig_shape=tuple(blob.orig_shape), indices=idx,
                    transformed=epilogue is not None)
        return outs


def decompress_blobs(blobs: Sequence[fmt.CompressedBlob], engine=None,
                     device_out: bool = False, epilogue=None) -> List:
    """Batched decompress over many blobs through one :class:`DecodePlan`:
    one dispatch per (codec, width, chunk_elems, bits) group, outputs in
    input order.  ``device_out=True`` keeps every output on the engine's
    device."""
    if not blobs:
        return []
    plan = DecodePlan.build(blobs)
    if device_out:
        return plan.execute_device(engine, epilogue=epilogue)
    if epilogue is not None:
        raise ValueError("epilogue requires device_out=True: a fused "
                         "epilogue's output has no host reassembly path")
    return plan.execute(engine)
