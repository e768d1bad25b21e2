"""Two-phase decode harness — the shared machinery of every codec kernel.

The counterpart of ``repro/kernels/harness.py``.  A group-structured codec
(rle_v1, rle_v2, dbp) supplies a :class:`TwoPhaseSpec` — a header parse and
a value expression — and gets every backend:

  * ``torch``  — :func:`two_phase_chunk`, the plain all-thread two-phase
    body (counterpart of ``xla``).  It is also the plain version that the
    CUDA kernel is held against.
  * ``cuda``   — the hand-written Hopper kernel the codec registers
    (counterpart of ``pallas``; ``kernels/cuda_rle.py``).
  * ``oracle`` — :func:`group_serial_chunk`, serial across groups and
    vector-parallel within each (the paper-faithful reference).
  * ``scalar`` — :func:`scalar_chunk`, one element per step (§V-E ablation).

Codecs whose decode is not lane-independent (tdeflate's LZ copies) or that
need no Phase 1 (bitpack) register their own bodies in the same
:class:`DecodeSpec`, with their own chunk inputs and broadcast tables.

The reference bodies decode one chunk and are ``vmap``-ed across chunks;
here the chunk axis is written out: every body takes the per-chunk tables
and the ``(n,)`` ``out_lens`` and returns ``(n, chunk_elems)`` in
``DEV_DTYPE[width]``.  Rows advance in lockstep; a row that has finished
keeps its state, as a vmapped ``while_loop`` does.  Values are computed in
int64 and truncated to the width type at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import transfers
from repro_torch.core.format import torch_dtype

DEV_DTYPE = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32}


def truncate(vals: torch.Tensor, width: int) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the width type, as ``.astype(dt)``."""
    return (vals & ((1 << (8 * width)) - 1)).to(DEV_DTYPE[width])


# --------------------------------------------------------------------------
# TwoPhaseSpec: what a group-structured codec author writes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Field:
    """One per-group table column (beyond the harness-owned ``start``)."""

    name: str
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class TwoPhaseSpec:
    """Header parse + value expression; the harness supplies the rest.

    ``parse(comp, pos, width)`` reads one group header per row at byte
    ``pos`` (shape ``(n,)``) and returns ``"length"``, ``"advance"`` and one
    entry per declared field, each ``(n,)``.  ``express(comp, fields, k,
    width)`` computes element ``k`` of a group from its fields; fields and
    ``k`` broadcast against each other with the row on the leading axis,
    and the result is int64 in [0, 2^32).
    """

    fields: Tuple[Field, ...]
    parse: Callable[..., Dict[str, torch.Tensor]]
    express: Callable[..., torch.Tensor]
    max_groups: Callable[[int], int]
    max_group_len: int          # lane-window bound (>= longest group)


def two_phase_chunk(spec: TwoPhaseSpec, comp: torch.Tensor,
                    out_lens: torch.Tensor, out_len_max: int,
                    width: int) -> torch.Tensor:
    """Decode every row with the all-thread two-phase scheme (§IV-D)."""
    n, dev = comp.shape[0], comp.device
    mg = spec.max_groups(out_len_max)
    out_len = out_lens.to(torch.int64)

    # ---- Phase 1: sequential group parse -> group tables ------------------
    # Column mg is a dump slot: rows that have stopped write there.
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    g = torch.zeros_like(pos)
    cnt = torch.zeros_like(pos)
    starts = torch.full((n, mg + 1), out_len_max, dtype=torch.int64,
                        device=dev)
    tabs = {f.name: torch.zeros((n, mg + 1), dtype=f.dtype, device=dev)
            for f in spec.fields}
    while True:
        active = (cnt < out_len) & (g < mg)
        if not bool(active.any()):
            break
        p = spec.parse(comp, pos, width)
        slot = torch.where(active, g, mg)[:, None]
        starts.scatter_(1, slot, cnt[:, None])
        for name, t in tabs.items():
            t.scatter_(1, slot, p[name].to(t.dtype)[:, None])
        pos = torch.where(active, pos + p["advance"], pos)
        cnt = torch.where(active, cnt + p["length"], cnt)
        g = g + active.to(torch.int64)
    starts = starts[:, :mg]

    # ---- Phase 2: all-lane expansion --------------------------------------
    # lane->group map: scatter a 1 at every group start, prefix-sum.
    marker = torch.zeros((n, out_len_max + 1), dtype=torch.int64, device=dev)
    marker.scatter_add_(1, starts.clamp(max=out_len_max),
                        torch.ones_like(starts))
    grp = (marker[:, :out_len_max].cumsum(1) - 1).clamp(0, mg - 1)
    del marker
    idx = torch.arange(out_len_max, dtype=torch.int64, device=dev)
    k = idx - torch.gather(starts, 1, grp)
    fields = {name: torch.gather(t[:, :mg], 1, grp)
              for name, t in tabs.items()}
    out = spec.express(comp, fields, k, width)
    out = torch.where(idx < out_len[:, None], out, 0)
    return truncate(out, width)


def scalar_chunk(spec: TwoPhaseSpec, comp: torch.Tensor,
                 out_lens: torch.Tensor, out_len_max: int,
                 width: int) -> torch.Tensor:
    """§V-E baseline: a single decode 'thread' per row emits one element per
    step — the serial-latency ablation, generic over any TwoPhaseSpec."""
    n, dev = comp.shape[0], comp.device
    out_len = out_lens.to(torch.int64)
    buf = torch.zeros((n, out_len_max), dtype=torch.int64, device=dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    cnt, k, rem = (torch.zeros_like(pos) for _ in range(3))
    cur = {f.name: torch.zeros(n, dtype=f.dtype, device=dev)
           for f in spec.fields}
    while True:
        active = cnt < out_len
        if not bool(active.any()):
            break
        need = active & (rem == 0)
        p = spec.parse(comp, pos, width)
        cur = {name: torch.where(need, p[name].to(v.dtype), v)
               for name, v in cur.items()}
        rem = torch.where(need, p["length"], rem)
        k = torch.where(need, 0, k)
        pos = torch.where(need, pos + p["advance"], pos)
        v = spec.express(comp, cur, k, width)
        at = cnt.clamp(max=out_len_max - 1)[:, None]
        buf.scatter_(1, at, torch.where(active[:, None], v[:, None],
                                        torch.gather(buf, 1, at)))
        step = active.to(torch.int64)
        cnt, k, rem = cnt + step, k + step, rem - step
    return truncate(buf, width)


def group_serial_chunk(spec: TwoPhaseSpec, comp: torch.Tensor,
                       out_lens: torch.Tensor, out_len_max: int,
                       width: int) -> torch.Tensor:
    """Paper-faithful sequential reference: serial across groups, vector-
    parallel within each (the warp's collaborative write, §II-B)."""
    n, dev = comp.shape[0], comp.device
    w = spec.max_group_len
    out_len = out_lens.to(torch.int64)
    lanes = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    buf = torch.zeros((n, out_len_max + w), dtype=torch.int64, device=dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    cnt = torch.zeros_like(pos)
    while True:
        active = cnt < out_len
        if not bool(active.any()):
            break
        p = spec.parse(comp, pos, width)
        fields = {f.name: p[f.name][:, None] for f in spec.fields}
        vals = spec.express(comp, fields, lanes, width)
        at = (cnt[:, None] + lanes).clamp(max=out_len_max + w - 1)
        keep = active[:, None] & (lanes < p["length"][:, None])
        buf.scatter_(1, at, torch.where(keep, vals, torch.gather(buf, 1, at)))
        pos = torch.where(active, pos + p["advance"], pos)
        cnt = torch.where(active, cnt + p["length"], cnt)
    return truncate(buf[:, :out_len_max], width)


# --------------------------------------------------------------------------
# Epilogue: a consumer transform applied to the decode dispatch's output
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Post-decode transform of the raw ``(num_chunks, chunk_elems)`` matrix.

    Array operands ride the device dict under the caller-chosen
    ``scale_key`` / ``zero_key`` entries (scalars or anything broadcastable
    to the chunk matrix).  Application order, as in the reference:

      1. ``view_dtype``  — bitcast reinterpretation, same itemsize
      2. ``out_dtype``   — value cast; with scale/zero set this is also the
                           compute dtype of the dequant affine (default
                           float32)
      3. zero/scale      — ``(x - zero) * scale`` (dequantization)
      4. ``fn``          — escape hatch: ``fn(out, dev) -> out``
    """

    view_dtype: Optional[str] = None
    out_dtype: Optional[str] = None
    scale_key: Optional[str] = None
    zero_key: Optional[str] = None
    fn: Optional[Callable[..., torch.Tensor]] = None

    def apply(self, out: torch.Tensor, dev: Dict[str, Any]) -> torch.Tensor:
        if self.view_dtype is not None:
            out = out.view(torch_dtype(self.view_dtype))
        if self.scale_key is not None or self.zero_key is not None:
            out = out.to(torch_dtype(self.out_dtype or "float32"))
            if self.zero_key is not None:
                out = out - dev[self.zero_key].to(out.dtype)
            if self.scale_key is not None:
                out = out * dev[self.scale_key].to(out.dtype)
        elif self.out_dtype is not None:
            out = out.to(torch_dtype(self.out_dtype))
        if self.fn is not None:
            out = self.fn(out, dev)
        return out


# --------------------------------------------------------------------------
# DecodeSpec: the backend-complete decode contract a codec registers
# --------------------------------------------------------------------------

# (inputs, consts, out_lens, *, chunk_elems, width, bits) -> (n, chunk_elems)
BodyFn = Callable[..., torch.Tensor]


def comp_inputs(dev: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
    """Default chunk inputs: the byte table."""
    return (dev["comp"],)


def words_inputs(dev: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
    """Chunk inputs of a bit codec: the uint32 word view of each row, which
    ``format.to_device`` stages as ``comp_words``."""
    return (dev["comp_words"],)


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Per-backend bodies over the whole chunk table, plus its operands.

    Every body, and the ``cuda`` kernel wrapper, maps ``(inputs, consts,
    out_lens, *, chunk_elems, width, bits)`` to ``(n, chunk_elems)`` in
    ``DEV_DTYPE[width]``.  ``chunk_inputs(dev)`` pulls the per-chunk operands
    (row on the leading axis) out of the staged table; ``consts()`` gives
    the broadcast tables (host arrays, staged once per device).
    """

    body: BodyFn                # torch: the plain body, the kernel's twin
    body_scalar: BodyFn         # §V-E single-thread driver
    body_oracle: BodyFn         # sequential reference
    cuda: BodyFn                # the hand-written kernel's wrapper
    chunk_inputs: Callable[[Dict[str, Any]], Tuple[torch.Tensor, ...]] = \
        comp_inputs
    consts: Callable[[], Tuple[Any, ...]] = tuple
    two_phase: Optional[TwoPhaseSpec] = None

    @classmethod
    def from_two_phase(cls, spec: TwoPhaseSpec,
                       cuda: Callable[..., torch.Tensor]) -> "DecodeSpec":
        """Every backend from a parse + express pair and the kernel wrapper
        ``cuda(comp, out_lens, *, chunk_elems, width)``."""
        def body(inputs, consts, out_lens, *, chunk_elems, width, bits):
            return two_phase_chunk(spec, inputs[0], out_lens, chunk_elems,
                                   width)

        def body_scalar(inputs, consts, out_lens, *, chunk_elems, width,
                        bits):
            return scalar_chunk(spec, inputs[0], out_lens, chunk_elems, width)

        def body_oracle(inputs, consts, out_lens, *, chunk_elems, width,
                        bits):
            return group_serial_chunk(spec, inputs[0], out_lens, chunk_elems,
                                      width)

        def kernel(inputs, consts, out_lens, *, chunk_elems, width, bits):
            return cuda(inputs[0], out_lens, chunk_elems=chunk_elems,
                        width=width)

        return cls(body=body, body_scalar=body_scalar,
                   body_oracle=body_oracle, cuda=kernel, two_phase=spec)


# broadcast tables staged per (consts hook, device), once (a staged decode
# then runs transfer-free)
_STAGED_CONSTS: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def consts_on(spec: DecodeSpec, device) -> Tuple[torch.Tensor, ...]:
    """The spec's broadcast tables on ``device``."""
    key = (spec.consts, device)
    staged = _STAGED_CONSTS.get(key)
    if staged is None:
        staged = tuple(transfers.to_device(c, device) for c in spec.consts())
        _STAGED_CONSTS[key] = staged
    return staged


def run(spec: DecodeSpec, dev: Dict[str, Any], *, width: int,
        chunk_elems: int, backend: str, bits: int,
        epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """Decode every chunk of a device table through one backend, then apply
    the ``epilogue``, if any."""
    inputs = spec.chunk_inputs(dev)
    out_lens = dev["out_lens"]
    if backend == "scalar" and inputs[0].device.type != "cpu":
        raise NotImplementedError(
            "the single-thread (all_thread=False) decode has no CUDA "
            "kernel yet (ROADMAP.md Queue 1 item 6a); run it on "
            "CPU tensors")
    fn = {"cuda": spec.cuda, "torch": spec.body, "scalar": spec.body_scalar,
          "oracle": spec.body_oracle}[backend]
    out = fn(inputs, consts_on(spec, out_lens.device), out_lens,
             chunk_elems=chunk_elems, width=width, bits=bits)
    return epilogue.apply(out, dev) if epilogue is not None else out
