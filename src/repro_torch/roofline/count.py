"""Counting a program's costs from the aten ops it runs: :func:`count_costs`.

The port's counterpart of ``compiled.cost_analysis()`` and
``memory_analysis()``: where the reference asks XLA's compiler what a
lowered program costs, the port runs its program eagerly under a
``TorchDispatchMode`` and counts every aten op it dispatches, on whatever
device the program runs: a card, the CPU, or ``meta`` tensors, whose ops
allocate nothing and compute nothing but carry every shape and dtype (the
dry-run's device).  The counts depend on shapes alone, so the count of a
program on ``meta`` is the count of the same program on the card.

Per device (the device of an op's first output, else of its first input):

* **FLOPs.** ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` by
  ``torch.utils.flop_counter``'s formulas (2·M·N·K); an op tagged
  ``pointwise`` or ``reduction`` one FLOP an output element, as XLA's cost
  analysis counts elementwise work; every other op none.
* **Bytes.** Each op's input and output tensor bytes: the traffic of the
  eager program, each op reading its inputs and writing its outputs once.
  Views and metadata-only ops (an output sharing an input's storage, not
  written in place) count nothing; ``empty``-like factories write nothing
  and count nothing.
* **Peak live bytes beyond the arguments.**  Every storage an op creates
  is live from its creation until it dies (a finalizer on the storage);
  storages that existed before the counter started (the arguments) are
  not counted.  The peak of the sum is the counterpart of
  ``memory_analysis().temp_size_in_bytes``.
* **Collective bytes, by kind.**  The port's collectives are explicit
  code (``distributed/spmd.py``'s, which a member's program runs on a
  process group or on ``meta``; ``launch/steps.py``'s gathers on a shared
  device, ``plan.gather_member_tables``, ``compressed_psum``,
  ``topk_psum``), which call :func:`collective` with the result bytes one
  member receives: the unit the reference's HLO parser counts.  ``spmd``
  runs the transfer itself outside the counter (:func:`uncounted`); a
  ``torch.distributed`` collective dispatched anywhere else under the
  counter raises, naming the op, rather than being left out.

The port's hand-written kernels are bound with ``ctypes``
(``kernels/cuda_build.py``), below the dispatcher, so a dispatch mode
cannot see them: a kernel launched while a counter is active raises
(:func:`refuse_kernel`) rather than being left out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_ACTIVE: List["CostCounter"] = []

_EMPTY = ("empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided")
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


@dataclasses.dataclass
class Costs:
    """One device's counts: ``flops``, ``bytes`` (read and written by its
    ops), ``coll`` (result bytes a member by collective kind), ``peak``
    (the most bytes of storages made under the counter alive at once),
    ``live`` (those alive now) and ``ops`` (aten ops that computed or
    allocated: views are not counted)."""
    flops: int = 0
    bytes: int = 0
    coll: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak: int = 0
    live: int = 0
    ops: int = 0

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll": dict(self.coll), "peak": self.peak, "ops": self.ops}


class CostCounter:
    """What :func:`count_costs` records: ``by_device[str(device)]`` a
    :class:`Costs` for each device an op ran on."""

    def __init__(self):
        self.by_device: Dict[str, Costs] = {}

    def at(self, device) -> Costs:
        key = str(torch.device(device))
        if key not in self.by_device:
            self.by_device[key] = Costs()
        return self.by_device[key]

    def only(self) -> Costs:
        """The one device's counts; a program that ran on more than one
        device raises."""
        if len(self.by_device) != 1:
            raise ValueError(f"counts on {sorted(self.by_device)}: name "
                             "the device")
        return next(iter(self.by_device.values()))


def _matmul_flops():
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    return {p: flop_registry[p] for p in (aten.mm, aten.bmm, aten.addmm,
                                          aten.baddbmm)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(items) -> List[torch.Tensor]:
    """The tensors among ``items``, and in lists and tuples among them
    (an aten op's arguments and results nest no deeper)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


class _Mode(TorchDispatchMode):
    def __init__(self, counter: CostCounter):
        super().__init__()
        self.counter = counter
        self.matmul = _matmul_flops()
        self.kinds = {}             # op -> (written, empty, elementwise)
        self.tracked = set()        # ids of storages made under the counter

    def _kind(self, func):
        kind = self.kinds.get(func)
        if kind is None:
            kind = self.kinds[func] = (
                any(r.alias_info is not None and r.alias_info.is_write
                    for r in func._schema.returns),
                func.overloadpacket.__name__ in _EMPTY,
                torch.Tag.pointwise in func.tags
                or torch.Tag.reduction in func.tags)
        return kind

    def _free(self, costs: Costs, key: int, nbytes: int) -> None:
        self.tracked.discard(key)
        costs.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in _COLLECTIVE_NAMESPACES:
            raise RuntimeError(
                f"collective {func} under count_costs outside "
                "distributed.spmd: its bytes would not be counted")
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not outs and not ins:
            return out
        written, empty, elementwise = self._kind(func)
        in_st = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_st]
        if not fresh and not written:
            return out              # a view or a metadata-only op
        costs = self.counter.at((outs or ins)[0].device)
        costs.ops += 1
        for t in fresh:
            st = t.untyped_storage()
            key = id(st)
            if key in self.tracked:
                continue
            n = st.nbytes()
            self.tracked.add(key)
            costs.live += n
            costs.peak = max(costs.peak, costs.live)
            weakref.finalize(st, self._free, costs, key, n)
        if empty:
            return out
        costs.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        matmul = self.matmul.get(func.overloadpacket)
        if matmul is not None:
            costs.flops += int(matmul(*args, **kwargs, out_val=out))
        elif elementwise and outs:
            costs.flops += outs[0].numel()
        return out


@contextlib.contextmanager
def count_costs() -> Iterator[CostCounter]:
    """Count every aten op run inside the block, and every collective the
    port's collective sites report (:func:`collective`); yields the
    :class:`CostCounter`.  A hand-written kernel launched inside raises."""
    counter = CostCounter()
    _ACTIVE.append(counter)
    try:
        with _Mode(counter):
            yield counter
    finally:
        _ACTIVE.remove(counter)


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Run the block outside every active counter's dispatch mode: a
    collective's transfer, whose result bytes the caller has recorded with
    :func:`collective`."""
    from torch.utils._python_dispatch import _disable_current_modes
    if not _ACTIVE:
        yield
        return
    with _disable_current_modes():
        yield


def collective(kind: str, nbytes: int, device) -> None:
    """Record a collective of ``kind`` ("all-gather", "reduce-scatter",
    "all-reduce", ...) whose result is ``nbytes`` bytes a member, on
    ``device``, with every active counter (none: nothing)."""
    for counter in _ACTIVE:
        coll = counter.at(device).coll
        coll[kind] = coll.get(kind, 0) + int(nbytes)


def refuse_kernel(entry: str) -> None:
    """Raise where a counter is active: a ``ctypes``-bound kernel runs
    below the dispatcher, where :func:`count_costs` cannot see it."""
    if _ACTIVE:
        raise RuntimeError(
            f"kernel {entry!r} launched under count_costs: the port's "
            "hand-written kernels are bound with ctypes, below the "
            "dispatcher, so their FLOPs, bytes and memory cannot be "
            "counted; count a program that launches none (a train step "
            "without a gradient compressor)")
