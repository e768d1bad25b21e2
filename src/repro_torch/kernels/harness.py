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
  * ``scalar`` — :func:`scalar_chunk`, one element per step (§V-E
    ablation); on a card the codec's ``scalar`` wrapper launches
    ``csrc/scalar_decode.cu`` (``kernels/scalar.py``), one thread a chunk.

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
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import streams as st
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
    names = [f.name for f in spec.fields]

    def emit(state):
        pos, cnt, k, rem, *vals = state
        active = cnt < out_len
        need = active & (rem == 0)
        p = spec.parse(comp, pos, width)
        cur = {name: torch.where(need, p[name].to(v.dtype), v)
               for name, v in zip(names, vals)}
        rem = torch.where(need, p["length"], rem)
        k = torch.where(need, 0, k)
        pos = torch.where(need, pos + p["advance"], pos)
        v = spec.express(comp, cur, k, width)
        at = cnt.clamp(max=out_len_max - 1)[:, None]
        buf.scatter_(1, at, torch.where(active[:, None], v[:, None],
                                        torch.gather(buf, 1, at)))
        step = active.to(torch.int64)
        return (pos, cnt + step, k + step, rem - step,
                *(cur[name] for name in names)), active

    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    st.lockstep(emit, (zeros,) * 4 + tuple(
        torch.zeros(n, dtype=f.dtype, device=dev) for f in spec.fields))
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

    Where it runs: on the ``cuda`` backend, every codec's kernel applies
    an epilogue that :func:`fused_epilogue` accepts in its stores, so no
    uint matrix is materialized (``EPILOGUE_FUSED`` counts those decodes;
    tdeflate and lzss keep their raw output, which their matches read, in
    a scratch matrix of the launch).  Every other epilogue, and every
    epilogue after a plain body, runs as torch ops on the decoded matrix by
    :meth:`apply` (``EPILOGUE_UNFUSED``).
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


@dataclasses.dataclass(frozen=True)
class MemberReduce:
    """Epilogue ``fn`` of the collective plane: fold a gathered table's
    member axis.  The table's rows are ``n_members`` members' rows laid one
    member after another (``plan.gather_member_tables``); the result is
    ``sum_m out[m * nb + r]``, divided by ``n_members`` when ``mean``: an
    ``(nb, chunk_elems)`` matrix.  Hashable and compared by value, so an
    epilogue that carries it keys a cache like any other.

    Calling it is the plain version: torch ops that add the members in
    order, one at a time, from member 0's rows, then a true division (by a
    tensor, so that the card divides rather than multiplying by a
    reciprocal).  A kernel that declares ``DecodeSpec.reduce_bits`` applies
    the same in its stores (``csrc/bitpack_unpack.cu``,
    ``codag_bitpack_reduce``), with the same roundings."""

    n_members: int
    mean: bool = False

    def __call__(self, out: torch.Tensor, dev=None) -> torch.Tensor:
        return self.fold(out.reshape((self.n_members, -1)
                                     + tuple(out.shape[1:])))

    def fold(self, parts: torch.Tensor) -> torch.Tensor:
        """The sum (or mean) over ``parts``' leading member axis."""
        acc = parts[0].clone()
        for m in range(1, self.n_members):
            acc = acc + parts[m]
        if self.mean:
            acc = acc / torch.full((), self.n_members, dtype=acc.dtype,
                                   device=acc.device)
        return acc


# Epilogues applied as torch ops after a decode (:func:`run`), and decodes
# whose kernel applied the epilogue in its stores.
EPILOGUE_UNFUSED = 0
EPILOGUE_FUSED = 0

# dtype codes of ``csrc/epilogue.cuh`` (``epi::Code``)
DTYPE_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2,
               torch.int16: 3, torch.uint32: 4, torch.int32: 5,
               torch.float32: 6, torch.bfloat16: 7, torch.float16: 8,
               torch.int64: 9, torch.float64: 10, torch.bool: 11}
# decoded values a kernel can read as (view dtypes), and the out dtypes it
# casts and computes in
FUSED_SOURCES = (torch.uint8, torch.int8, torch.uint16, torch.int16,
                 torch.uint32, torch.int32, torch.float32, torch.bfloat16,
                 torch.float16)
FUSED_OUTS = (torch.uint8, torch.int8, torch.int16, torch.int32,
              torch.float32, torch.bfloat16, torch.float16)
_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


@dataclasses.dataclass(frozen=True, eq=False)
class FusedEpilogue:
    """An epilogue a kernel applies in its stores (``csrc/epilogue.cuh``):
    ``src`` is the dtype the decoded value is read as, ``dtype`` the output
    dtype, ``zero`` / ``scale`` the operands (or None): single-element, or
    ``(n_chunks, 1)``, one a chunk row, for a spec with ``row_operands``;
    ``reduce`` the member reduce of a spec with ``reduce_bits`` (its output
    has ``n_chunks / reduce.n_members`` rows)."""

    epilogue: Epilogue
    src: torch.dtype
    dtype: torch.dtype
    zero: Optional[torch.Tensor]
    scale: Optional[torch.Tensor]
    # the member reduce the kernel applies after the affine (the
    # epilogue's ``fn``), or None
    reduce: Optional[MemberReduce] = None

    def kernel_args(self) -> tuple:
        """``(out_code, src_code, zero, zero_code, scale, scale_code)`` of
        the C entry points (an absent operand is a null pointer)."""
        ops = []
        for t in (self.zero, self.scale):
            ops += [None, 0] if t is None else [t.data_ptr(),
                                                DTYPE_CODES[t.dtype]]
        return (DTYPE_CODES[self.dtype], DTYPE_CODES[self.src], *ops)

    def row_strides(self) -> tuple:
        """``(zero_stride, scale_stride)`` in elements from one chunk row's
        operand to the next: 0 for a single value (or none), 1 for one a
        row."""
        return tuple(int(t is not None and t.numel() > 1)
                     for t in (self.zero, self.scale))

    def apply_plain(self, out: torch.Tensor) -> torch.Tensor:
        """The plain version: :meth:`Epilogue.apply` on the decoded matrix."""
        e = self.epilogue
        return e.apply(out, {e.zero_key: self.zero, e.scale_key: self.scale})

    @property
    def bits_only(self) -> bool:
        """Whether the output's bits are the decoded bits (a view, or an
        integer cast of the same size, with no operands): a kernel then
        stores as it does without an epilogue, and the wrapper views its
        output as :attr:`dtype`."""
        return (self.zero is None and self.scale is None
                and self.reduce is None
                and self.dtype.itemsize == self.src.itemsize
                and (self.dtype == self.src
                     or not (self.dtype in _FLOATS or self.src in _FLOATS)))


def launch_store(epilogue: Optional[FusedEpilogue], raw: torch.dtype):
    """(epilogue the kernel applies, or None for its plain store; output
    dtype; the C entry points' epilogue arguments) of a decode kernel that
    decodes ``raw`` values.  Every decode wrapper launches through it.  An
    epilogue whose output bits are the decoded bits takes the plain store:
    the caller views the output as ``epilogue.dtype``
    (:func:`finish_store`)."""
    if epilogue is None or epilogue.bits_only:
        code = DTYPE_CODES[raw]
        return None, raw, (code, code, None, 0, None, 0)
    return epilogue, epilogue.dtype, epilogue.kernel_args()


def finish_store(out: torch.Tensor,
                 epilogue: Optional[FusedEpilogue]) -> torch.Tensor:
    """A kernel's output as the epilogue's dtype (a view where the kernel
    took its plain store for a bits-only epilogue)."""
    if epilogue is None or out.dtype == epilogue.dtype:
        return out
    return out.view(epilogue.dtype)


@functools.lru_cache(maxsize=256)
def _fused_dtypes(epilogue: Epilogue, width: int):
    """(source, output) dtypes of an epilogue a kernel can apply, or None:
    the part of :func:`fused_epilogue` that depends on the epilogue alone
    (a serving step decides it once a projection, so it is kept)."""
    if epilogue.fn is not None and not isinstance(epilogue.fn,
                                                  MemberReduce):
        return None
    src = DEV_DTYPE[width]
    if epilogue.view_dtype is not None:
        src = torch_dtype(epilogue.view_dtype)
        if src not in FUSED_SOURCES or src.itemsize != width:
            return None
    out = src
    if (epilogue.zero_key is not None or epilogue.scale_key is not None
            or epilogue.out_dtype is not None):
        out = torch_dtype(epilogue.out_dtype or "float32")
        if out not in FUSED_OUTS or (src in _FLOATS and out not in _FLOATS):
            return None
    return src, out


def fused_epilogue(epilogue: Epilogue, dev: Dict[str, Any], width: int,
                   row_operands: bool = False, reduce_bits=(),
                   bits: int = 0) -> Optional[FusedEpilogue]:
    """The epilogue as a kernel applies it in its stores, or None where it
    must run as torch ops after the decode.  It fuses when it has no ``fn``;
    ``view_dtype`` keeps the itemsize; the output dtype is one of
    :data:`FUSED_OUTS` (a float is never cast to an integer); and ``zero``
    and ``scale`` are tensors on the table's device that are single-element
    (at most 2-d, so they broadcast to the chunk matrix without growing it)
    or, where the kernel reads one a row (``row_operands``, the spec's
    :attr:`DecodeSpec.row_operands`), contiguous ``(n_chunks, 1)``: one value
    a chunk row, as :meth:`Epilogue.apply` broadcasts it.  An ``fn`` fuses
    only where it is a :class:`MemberReduce`, the kernel reduces members at
    these ``bits`` (the spec's :attr:`DecodeSpec.reduce_bits`), the output
    is float32 and the table's rows are whole members.  The choice depends
    on the epilogue, its operands and the table's shape alone."""
    dtypes = _fused_dtypes(epilogue, width)
    if dtypes is None:
        return None
    src, out = dtypes
    device = dev["out_lens"].device
    rows = tuple(dev["out_lens"].shape[:1]) + (1,)
    reduce = epilogue.fn
    if reduce is not None and (bits not in reduce_bits
                               or out != torch.float32
                               or rows[0] % reduce.n_members):
        return None
    operands = []
    for key in (epilogue.zero_key, epilogue.scale_key):
        t = None if key is None else dev[key]
        if t is not None and not (
                isinstance(t, torch.Tensor)
                and ((t.numel() == 1 and t.dim() <= 2)
                     or (row_operands and tuple(t.shape) == rows
                         and t.is_contiguous()))
                and t.device == device and t.dtype in DTYPE_CODES
                and (out in _FLOATS or t.dtype not in _FLOATS)):
            return None
        operands.append(t)
    return FusedEpilogue(epilogue, src, out, *operands, reduce=reduce)


# --------------------------------------------------------------------------
# DecodeSpec: the backend-complete decode contract a codec registers
# --------------------------------------------------------------------------

# (inputs, consts, out_lens, *, chunk_elems, width, bits) -> (n, chunk_elems)
BodyFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Tunable:
    """One launch-time knob of a codec's ``cuda`` wrapper (``core.tuning``).

    ``name`` must not collide with ``core.tuning.KNOWN_KNOBS``;
    ``candidates`` is the grid ``tuning.autotune`` searches on a card;
    ``default`` what the wrapper uses when neither the table nor the caller
    gives a value (None: the wrapper's own choice for each launch).  A
    codec declares a knob only where its wrapper passes the value to the
    kernel at launch time: a value the kernel fixes at build time would
    need an ``nvcc`` build per value.
    """

    name: str
    candidates: Tuple[Any, ...]
    default: Any = None


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
    the broadcast tables (host arrays, staged once per device).  A spec with
    ``fuses_epilogue`` has a ``cuda`` wrapper that also takes
    ``epilogue=`` (a :class:`FusedEpilogue`), applied in the kernel's stores
    on a card and by :meth:`FusedEpilogue.apply_plain` on the CPU.  The
    ``cuda`` wrapper also takes each of ``tunables`` by name.  A spec with
    ``row_operands`` also fuses a zero or scale of one value a chunk row
    (``(n_chunks, 1)``; :func:`fused_epilogue`), and one with
    ``reduce_bits`` a :class:`MemberReduce` at those field widths.  ``scalar``
    is the single-thread kernel's wrapper: it launches
    ``csrc/scalar_decode.cu`` on a card and runs ``body_scalar`` on the CPU.
    """

    body: BodyFn                # torch: the plain body, the kernel's twin
    body_scalar: BodyFn         # §V-E single-thread driver, the plain twin
    body_oracle: BodyFn         # sequential reference
    cuda: BodyFn                # the hand-written kernel's wrapper
    chunk_inputs: Callable[[Dict[str, Any]], Tuple[torch.Tensor, ...]] = \
        comp_inputs
    consts: Callable[[], Tuple[Any, ...]] = tuple
    two_phase: Optional[TwoPhaseSpec] = None
    # ``cuda`` takes ``epilogue=`` (a :class:`FusedEpilogue`) and applies it
    # in the kernel's stores
    fuses_epilogue: bool = False
    # the kernel also reads a zero / scale of one value a chunk row
    row_operands: bool = False
    # field widths at which the kernel also folds a gathered table's member
    # axis in its stores (an epilogue ``fn`` that is a :class:`MemberReduce`)
    reduce_bits: Tuple[int, ...] = ()
    scalar: Optional[BodyFn] = None  # the single-thread kernel's wrapper
    tunables: Tuple[Tunable, ...] = ()

    @classmethod
    def from_two_phase(cls, spec: TwoPhaseSpec,
                       cuda: Callable[..., torch.Tensor],
                       scalar: Optional[Callable[..., torch.Tensor]] = None
                       ) -> "DecodeSpec":
        """Every backend from a parse + express pair, the kernel wrapper
        ``cuda(comp, out_lens, *, chunk_elems, width, epilogue)``, which
        applies a fused epilogue in its stores, and the single-thread
        kernel's wrapper ``scalar(comp, out_lens, *, chunk_elems, width)``."""
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

        def kernel(inputs, consts, out_lens, *, chunk_elems, width, bits,
                   epilogue=None):
            return cuda(inputs[0], out_lens, chunk_elems=chunk_elems,
                        width=width, epilogue=epilogue)

        def scalar_kernel(inputs, consts, out_lens, *, chunk_elems, width,
                          bits):
            return scalar(inputs[0], out_lens, chunk_elems=chunk_elems,
                          width=width)

        return cls(body=body, body_scalar=body_scalar,
                   body_oracle=body_oracle, cuda=kernel, two_phase=spec,
                   fuses_epilogue=True,
                   scalar=None if scalar is None else scalar_kernel)


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
        epilogue: Optional[Epilogue] = None,
        tune: Tuple[Tuple[str, Any], ...] = ()) -> torch.Tensor:
    """Decode every chunk of a device table through one backend, then apply
    the ``epilogue``, if any: in the kernel's stores where the ``cuda``
    backend's kernel fuses it (:func:`fused_epilogue`), else as torch ops
    on the decoded matrix.

    ``tune``: ``((knob, value), ...)`` of the spec's ``tunables``, passed to
    the ``cuda`` wrapper (the other backends have no launch to shape).  The
    ``scalar`` backend runs the spec's single-thread kernel wrapper.
    """
    global EPILOGUE_FUSED, EPILOGUE_UNFUSED
    inputs = spec.chunk_inputs(dev)
    out_lens = dev["out_lens"]
    knobs = dict(tune)
    unknown = set(knobs) - {t.name for t in spec.tunables}
    if unknown:
        raise ValueError(f"unknown kernel knobs {sorted(unknown)}; this codec "
                         f"takes {[t.name for t in spec.tunables]}")
    fn = {"cuda": spec.cuda, "torch": spec.body, "scalar": spec.scalar,
          "oracle": spec.body_oracle}[backend]
    if fn is None:
        raise ValueError("this codec registers no single-thread kernel "
                         "wrapper (DecodeSpec.scalar)")
    kw = dict(chunk_elems=chunk_elems, width=width, bits=bits)
    if backend == "cuda":
        kw.update(knobs)
    fused = None
    if epilogue is not None and backend == "cuda" and spec.fuses_epilogue:
        fused = fused_epilogue(epilogue, dev, width, spec.row_operands,
                               spec.reduce_bits, bits)
    if fused is not None:
        EPILOGUE_FUSED += 1
        kw["epilogue"] = fused
    out = fn(inputs, consts_on(spec, out_lens.device), out_lens, **kw)
    if epilogue is None or fused is not None:
        return out
    EPILOGUE_UNFUSED += 1
    return epilogue.apply(out, dev)
