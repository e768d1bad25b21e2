"""Two-phase decode harness — the shared machinery of every codec kernel.

The counterpart of ``repro/kernels/harness.py``.  A group-structured codec
(rle_v1, rle_v2) supplies a :class:`TwoPhaseSpec` — a header parse and a
value expression — and gets every backend:

  * ``torch``  — :func:`two_phase_chunk`, the plain all-thread two-phase
    body (counterpart of ``xla``).  It is also the plain version that the
    CUDA kernel is held against.
  * ``cuda``   — the hand-written Hopper kernel the codec registers
    (counterpart of ``pallas``; ``kernels/cuda_rle.py``).
  * ``oracle`` — :func:`group_serial_chunk`, serial across groups and
    vector-parallel within each (the paper-faithful reference).
  * ``scalar`` — :func:`scalar_chunk`, one element per step (§V-E ablation).

The reference bodies decode one chunk and are ``vmap``-ed across chunks;
here the chunk axis is written out: every body takes the ``(n, C)`` uint8
table and the ``(n,)`` ``out_lens`` and returns ``(n, chunk_elems)`` in
``DEV_DTYPE[width]``.  Rows advance in lockstep; a row that has finished
keeps its state, as a vmapped ``while_loop`` does.  Values are computed in
int64 and truncated to the width type at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.format import torch_dtype

DEV_DTYPE = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32}


def _truncate(vals: torch.Tensor, width: int) -> torch.Tensor:
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
    return _truncate(out, width)


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
    return _truncate(buf, width)


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
    return _truncate(buf[:, :out_len_max], width)


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

# (comp, out_lens, *, chunk_elems, width, bits) -> (n, chunk_elems)
BodyFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Per-backend bodies over the whole chunk table."""

    body: BodyFn                # torch: the plain two-phase body
    body_scalar: BodyFn         # §V-E single-thread driver
    body_oracle: BodyFn         # group-serial reference
    # the hand-written kernel's wrapper: (comp, out_lens, *, chunk_elems,
    # width) -> (n, chunk_elems)
    cuda: Callable[..., torch.Tensor]
    two_phase: TwoPhaseSpec

    @classmethod
    def from_two_phase(cls, spec: TwoPhaseSpec,
                       cuda: Callable[..., torch.Tensor]) -> "DecodeSpec":
        """Every backend from a parse + express pair and the kernel."""
        def body(comp, out_lens, *, chunk_elems, width, bits):
            return two_phase_chunk(spec, comp, out_lens, chunk_elems, width)

        def body_scalar(comp, out_lens, *, chunk_elems, width, bits):
            return scalar_chunk(spec, comp, out_lens, chunk_elems, width)

        def body_oracle(comp, out_lens, *, chunk_elems, width, bits):
            return group_serial_chunk(spec, comp, out_lens, chunk_elems,
                                      width)

        return cls(body=body, body_scalar=body_scalar,
                   body_oracle=body_oracle, cuda=cuda, two_phase=spec)


def run(spec: DecodeSpec, dev: Dict[str, Any], *, width: int,
        chunk_elems: int, backend: str, bits: int,
        epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """Decode every chunk of a device table through one backend, then apply
    the ``epilogue``, if any."""
    comp, out_lens = dev["comp"], dev["out_lens"]
    if backend == "cuda":
        out = spec.cuda(comp, out_lens, chunk_elems=chunk_elems, width=width)
    else:
        if backend == "scalar" and comp.device.type != "cpu":
            raise NotImplementedError(
                "the single-thread (all_thread=False) decode has no CUDA "
                "kernel yet (ROADMAP.md Queue 1 item 6a); run it on "
                "CPU tensors")
        body = {"torch": spec.body, "scalar": spec.body_scalar,
                "oracle": spec.body_oracle}[backend]
        out = body(comp, out_lens, chunk_elems=chunk_elems, width=width,
                   bits=bits)
    return epilogue.apply(out, dev) if epilogue is not None else out
