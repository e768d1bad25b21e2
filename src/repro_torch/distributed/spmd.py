"""One mesh member's program: its context and its collectives.

The reference's sharded steps are single programs that XLA partitions over
a mesh; PyTorch gives each device a process of its own.  A
:class:`Member` is what one such process knows of the mesh: the mesh's
axes and sizes, its own coordinates, the sharding policy, and how its
collectives travel (``transport``):

* ``"group"``: a ``torch.distributed`` process group a mesh axis, built
  by :meth:`Member.join` in every process of a world
  (``launch.mesh.spawn``).  The backend is handed the tensors where they
  lie (``probe_backend`` checks that it takes every kind on a device).
  Each transfer is timed between two synchronisations of its device and
  added, with its result's bytes, to ``Member.transfer_s`` and
  ``Member.transfer_bytes`` by kind.
* ``"meta"``: the dry-run's member (:meth:`Member.counting`): a collective
  returns a tensor of its result's shape and does nothing else.

Every collective reports its result's bytes to ``roofline.count`` (the
unit the reference's HLO parser counts), whatever the transport, and a
collective over an axis of size 1 is no collective.  Both transports
dispatch the same aten ops around the transfer (the transfer itself runs
outside ``count.count_costs``), so a program counted on ``meta`` counts
what it counts on a device.

The model code reads the member through :func:`current` (installed with
:func:`use` in the calling thread; the autograd engine's device threads,
which Python did not start, read the main thread's; a thread started in
Python reads only its own), as it reads the mesh through
``sharding.constrain``; the decode path finds a ranked mesh's member with
:func:`member_of`:

* :func:`tp` / :func:`tp_rank`: the ``model`` axis's size and this
  member's place on it under the ``tp`` policy (1 and 0 under ``dp``, or
  with no member);
* autograd-aware collectives over ``model`` for tensor parallelism:
  :func:`copy_to` (identity; the gradient all-reduced), :func:`reduce_from`
  (all-reduce; the gradient as it is), :func:`psum` (all-reduce both
  ways), :func:`gather_from` (all-gather; the gradient's own block),
  :func:`gather_split` (all-gather; the gradient reduce-scattered) and
  :func:`all_max` (no gradient).  A replicated tensor carries the whole
  gradient on every member; one that enters a member's own share of the
  work passes through :func:`copy_to` (or :func:`gather_split`) first;
* plain collectives over any axis: :func:`all_reduce`, :func:`all_gather`,
  :func:`reduce_scatter`, and :func:`relayout`, which moves a block from
  one ``PartitionSpec`` to another (gathers, then slices).

A dtype the ``gloo`` backend has no collectives for (the unsigned words
and ``int16``) is gathered through its bytes (``uint8``).

Only calls that torch 2.11 has are used: ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` (2.13 marks them deprecated, but 2.11 has no
replacement).
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.roofline import count

KINDS = ("all_reduce", "all_gather", "reduce_scatter")
# what gloo reduces and gathers; any other dtype is gathered as its bytes
GLOO_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
               torch.int8, torch.uint8, torch.int32, torch.int64)
_STACKS: Dict[int, list] = {}       # thread ident -> members it installed
_JOINED: dict = {}                  # a ranked mesh's member, by mesh


class Member:
    """One member of a mesh: ``shape`` (axis -> size, in the mesh's
    order), ``index`` (its place in ``mesh.devices.flat`` order),
    ``policy`` ("tp" or "dp"), ``transport`` ("group" or "meta"),
    ``groups`` (axis -> process group, for "group") and ``batch_axes`` (the data-parallel axes the step's batch is split over,
    set by ``launch.steps.member_step``)."""

    def __init__(self, shape: Dict[str, int], index: int, *,
                 policy: str = "tp", transport: str = "meta", groups=None,
                 batch_axes: Tuple[str, ...] = ()):
        if policy not in ("tp", "dp"):
            raise ValueError(f"policy {policy!r}: 'tp' or 'dp'")
        if transport not in ("group", "meta"):
            raise ValueError(f"transport {transport!r}: 'group' or 'meta'")
        self.shape = dict(shape)
        self.axes = tuple(self.shape)
        self.index = int(index)
        coords = np.unravel_index(self.index, tuple(self.shape.values()))
        self.coords = {a: int(c) for a, c in zip(self.axes, coords)}
        self.policy = policy
        self.transport = transport
        self.groups = dict(groups or {})
        self.batch_axes = tuple(batch_axes)
        self.transfer_s = {k: 0.0 for k in KINDS}
        self.transfer_bytes = {k: 0 for k in KINDS}

    # -- construction ----------------------------------------------------

    @classmethod
    def counting(cls, mesh, index: int = 0, policy: str = "tp") -> "Member":
        """Member ``index`` of ``mesh`` (a ``launch.mesh.Mesh``) on the
        ``meta`` transport: the dry-run's member."""
        return cls(dict(mesh.shape), index, policy=policy, transport="meta")

    @classmethod
    def join(cls, mesh, policy: str = "tp") -> "Member":
        """This process's member of ``mesh``, a mesh over the ranks of the
        current ``torch.distributed`` world (``mesh.rank`` is this rank;
        ``launch.mesh.world_mesh``): one process group an axis of size >
        1, built by ``new_group`` in the same order in every process, so
        every process of the world must join the same meshes in the same
        order."""
        import torch.distributed as dist
        if mesh.size != dist.get_world_size():
            raise ValueError(f"{mesh} has {mesh.size} members; the world "
                             f"has {dist.get_world_size()} ranks")
        rank = dist.get_rank()
        if mesh.rank != rank:
            raise ValueError(f"{mesh} is rank {mesh.rank}'s, not {rank}'s")
        sizes = tuple(mesh.shape.values())
        flat = np.arange(mesh.size).reshape(sizes)
        groups = {}
        for d, axis in enumerate(mesh.axis_names):
            if sizes[d] == 1:
                continue
            lines = np.moveaxis(flat, d, -1).reshape(-1, sizes[d])
            for line in lines:          # every rank builds every group
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[axis] = g
        return cls(dict(mesh.shape), rank, policy=policy, transport="group",
                   groups=groups)

    def with_batch(self, batch_axes: Tuple[str, ...]) -> "Member":
        """The same member with ``batch_axes`` set (its transfer counters
        shared)."""
        out = Member.__new__(Member)
        out.__dict__.update(self.__dict__)
        out.batch_axes = tuple(batch_axes)
        return out

    # -- reading -----------------------------------------------------------

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def tp(self) -> int:
        """The ``model`` axis's size under the ``tp`` policy, else 1."""
        return self.size("model") if self.policy == "tp" else 1

    def reset_transfers(self) -> None:
        """Zero ``transfer_s`` and ``transfer_bytes`` (in place: a
        :meth:`with_batch` copy shares them)."""
        for k in KINDS:
            self.transfer_s[k], self.transfer_bytes[k] = 0.0, 0

    def __repr__(self) -> str:
        where = ", ".join(f"{a}={self.coords[a]}/{n}"
                          for a, n in self.shape.items())
        return f"Member({where}; {self.policy}, {self.transport})"


@contextlib.contextmanager
def use(member: Optional[Member]) -> Iterator[Optional[Member]]:
    """Install ``member`` as the calling thread's current member (None:
    none)."""
    stack = _STACKS.setdefault(threading.get_ident(), [])
    stack.append(member)
    try:
        yield member
    finally:
        stack.pop()


def current() -> Optional[Member]:
    """The calling thread's member.  A thread that Python did not start
    and that installed none (the autograd engine's device threads, which
    run a backward and its activation recompute) reads the main thread's;
    a thread started in Python (a loader's prefetch, a DiLoCo sync) reads
    only what it installed itself, so it never runs collectives on another
    thread's groups."""
    stack = _STACKS.get(threading.get_ident())
    if not stack and isinstance(threading.current_thread(),
                                threading._DummyThread):
        stack = _STACKS.get(threading.main_thread().ident)
    return stack[-1] if stack else None


def member_of(mesh) -> Member:
    """This process's member of ``mesh``, a mesh over a world's ranks
    (``mesh.rank`` set): the current member where it is one of ``mesh``
    (same axes and sizes, same place), else the member :meth:`Member.join`
    gave the first time a mesh of that shape was asked for in this world
    (so every process must ask in the same order, as for ``join``)."""
    import torch.distributed as dist
    if mesh.rank is None:
        raise ValueError(f"{mesh} has no rank: not a mesh over a world's "
                         "ranks (launch.mesh.world_mesh)")
    m = current()
    if (m is not None and m.transport == "group" and m.index == mesh.rank
            and m.shape == dict(mesh.shape)):
        return m
    key = (tuple(mesh.shape.items()), mesh.rank,
           id(dist.distributed_c10d._get_default_group()))
    if key not in _JOINED:
        _JOINED[key] = Member.join(mesh)
    return _JOINED[key]


def _need() -> Member:
    m = current()
    if m is None:
        raise RuntimeError("a split tensor outside a mesh member's program "
                           "(distributed.spmd.use)")
    return m


def tp() -> int:
    """The ``model`` axis's size under ``tp`` (1 with no member)."""
    m = current()
    return 1 if m is None else m.tp


def tp_rank() -> int:
    m = current()
    return 0 if m is None or m.tp == 1 else m.coord("model")


def block(n: int) -> slice:
    """This member's block of a dimension of ``n`` split over ``model``."""
    m = _need()
    k, i = m.size("model"), m.coord("model")
    if n % k:
        raise ValueError(f"{n} does not split over model={k}")
    return slice(i * n // k, (i + 1) * n // k)


# --------------------------------------------------------------------------
# plain collectives
# --------------------------------------------------------------------------


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def _transfer(m: Member, kind: str, out: torch.Tensor, x: torch.Tensor,
              axis: str, op: str) -> None:
    """The collective itself, outside any ``count_costs``: ``out`` filled
    from ``x`` over ``axis``'s group, timed from a synchronised device to
    a synchronised device (``Member.transfer_s``)."""
    if m.transport == "meta":
        return
    import torch.distributed as dist
    group = m.groups[axis]
    with count.uncounted(), warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*is deprecated.*")
        _sync(x)
        t0 = time.perf_counter()
        if kind == "all_reduce":
            out.copy_(x)
            dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.SUM, group=group)
        elif kind == "all_gather":
            dist.all_gather_into_tensor(out, x, group=group)
        else:
            dist.reduce_scatter_tensor(out, x, group=group)
        _sync(out)
        m.transfer_s[kind] += time.perf_counter() - t0
        m.transfer_bytes[kind] += _nbytes(out.shape, out.dtype)


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _moved(x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """``x.movedim(src, dst)`` in a storage of its own, copied whatever
    the shape (``contiguous`` would skip the copy where size-1 dimensions
    make the view contiguous, so a count would depend on them)."""
    if src == dst:
        return x.contiguous()
    return x.movedim(src, dst).clone(memory_format=torch.contiguous_format)


def all_reduce(x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
    """``x`` summed (or its maximum, ``op="max"``) over ``axis``'s
    members: a new tensor; ``x`` itself where the axis has one member."""
    m = current()
    if m is None or m.size(axis) == 1:
        return x
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    count.collective("all-reduce", _nbytes(x.shape, x.dtype), x.device)
    _transfer(m, "all_reduce", out, x.contiguous(), axis, op)
    return out


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The members' blocks of ``x`` over ``axis`` concatenated along
    ``dim`` in member order."""
    m = current()
    if m is None or m.size(axis) == 1:
        return x
    n = m.size(axis)
    if x.dim() == 0:
        return all_gather(x.reshape(1), axis)
    dim = dim % x.dim()
    xs = _moved(x, dim, 0)
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=x.dtype, device=x.device)
    count.collective("all-gather", _nbytes(out.shape, x.dtype), x.device)
    if x.dtype in GLOO_DTYPES:
        _transfer(m, "all_gather", out, xs, axis, "sum")
    else:                       # the same bytes, as gloo's uint8
        _transfer(m, "all_gather", out.view(torch.uint8),
                  xs.view(torch.uint8), axis, "sum")
    return _moved(out, 0, dim)


def reduce_scatter(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``axis``'s members, this member's block along
    ``dim`` (which must split into equal blocks)."""
    m = current()
    if m is None or m.size(axis) == 1:
        return x
    n = m.size(axis)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {axis}={n}")
    xs = _moved(x, dim, 0)
    out = torch.empty((xs.shape[0] // n,) + tuple(xs.shape[1:]),
                      dtype=x.dtype, device=x.device)
    count.collective("reduce-scatter", _nbytes(out.shape, x.dtype),
                     x.device)
    _transfer(m, "reduce_scatter", out, xs, axis, "sum")
    return _moved(out, 0, dim)


def axes_of(part) -> Tuple[str, ...]:
    """A ``PartitionSpec`` entry's mesh axes, in order."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def relayout(x: torch.Tensor, have, want) -> torch.Tensor:
    """This member's block under the ``PartitionSpec`` ``want`` from its
    block ``x`` under ``have`` (of one global tensor): on each dimension,
    the axes past the two specs' common prefix are all-gathered (the minor
    first) and the block ``want`` names is sliced out.  No gradient."""
    m = _need()
    for d in range(x.dim()):
        h = axes_of(have[d] if d < len(have) else None)
        w = axes_of(want[d] if d < len(want) else None)
        c = 0
        while c < min(len(h), len(w)) and h[c] == w[c]:
            c += 1
        for a in reversed(h[c:]):
            x = all_gather(x, a, d)
        for a in w[c:]:
            size = x.shape[d] // m.size(a)
            x = x.narrow(d, m.coord(a) * size, size)
    return x.contiguous()


def blocks(tree, shardings, index: int):
    """Member ``index``'s blocks of a tree of whole tensors under a tree
    like it of ``NamedSharding`` s (other leaves, as the cache's ``pos``,
    as they are): what that member's process holds."""
    if isinstance(tree, dict):
        return {k: blocks(v, shardings[k], index) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return tree[shardings.member_indices(tree.shape)[index]].contiguous()


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The whole batch from this member's block of its leading dimension
    (over ``batch_axes``); ``x`` where the member has none.  No
    gradient."""
    m = current()
    if m is None or not m.batch_axes:
        return x
    return relayout(x, (m.batch_axes,), ())


def batch_block(x: torch.Tensor) -> torch.Tensor:
    """This member's block of a whole batch (:func:`gather_batch`'s
    inverse)."""
    m = current()
    if m is None or not m.batch_axes:
        return x
    return relayout(x, (), (m.batch_axes,))


# --------------------------------------------------------------------------
# autograd-aware collectives over ``model`` (tensor parallelism)
# --------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "model")


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "model")


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return all_gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        own = tp_rank() * ctx.n
        return g.narrow(ctx.dim, own, ctx.n).contiguous(), None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return all_gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, "model", ctx.dim), None


def copy_to(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor entering this member's share of the work: the
    same values; the members' gradients summed."""
    return x if tp() == 1 else _CopyTo.apply(x)


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    """The members' partial sums added into a replicated tensor; the
    gradient reaches every member whole."""
    return x if tp() == 1 else _ReduceFrom.apply(x)


def psum(x: torch.Tensor) -> torch.Tensor:
    """The members' partial sums added into a tensor each member uses for
    its own share: the gradient summed too."""
    return x if tp() == 1 else _Psum.apply(x)


def gather_from(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The members' blocks along ``dim`` joined into a replicated tensor;
    each member's gradient is its block of the whole one."""
    return x if tp() == 1 else _GatherFrom.apply(x, dim % x.dim())


def gather_split(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The members' blocks along ``dim`` joined into a tensor each member
    uses for its own share: the gradient reduce-scattered back."""
    return x if tp() == 1 else _GatherSplit.apply(x, dim % x.dim())


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The maximum over ``model``'s members, without a gradient."""
    return x if tp() == 1 else all_reduce(x.detach(), "model", op="max")


# --------------------------------------------------------------------------
# the backend's CUDA collectives
# --------------------------------------------------------------------------


# what the member programs send: each kind of the model's floats, and the
# decode path's all-gathers (bytes and every other dtype's bytes, int8
# blocks, int32 lengths, int64 row counts, float16 top-k values; float32
# scales above)
PROBES = tuple((k, dt) for k in KINDS
               for dt in (torch.float32, torch.bfloat16)) + tuple(
    ("all_gather", dt) for dt in (torch.uint8, torch.int8, torch.int32,
                                  torch.int64, torch.float16))


def probe_backend(device, backend: str = "gloo") -> Dict[str, str]:
    """Which collective kinds ``backend`` takes for each dtype of
    :data:`PROBES` on ``device``: ``"kind/dtype"`` -> "device", "wrong
    values", or the error it raised (the member program has no other path:
    such a kind fails it).  Runs a world of this one process, rendezvous
    through a ``FileStore`` in a temporary directory."""
    import os
    import tempfile
    import torch.distributed as dist
    dev = torch.device(device)
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        try:
            for kind, dt in PROBES:
                x = (torch.arange(4, device=dev) % 2).to(dt)
                out = torch.empty(4, dtype=dt, device=dev)
                key = f"{kind}/{str(dt).split('.')[-1]}"
                try:
                    with warnings.catch_warnings():
                        warnings.filterwarnings("ignore",
                                                category=FutureWarning)
                        if kind == "all_reduce":
                            dist.all_reduce(out.copy_(x))
                        elif kind == "all_gather":
                            dist.all_gather_into_tensor(out, x)
                        else:
                            dist.reduce_scatter_tensor(out, x)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    ok = torch.equal(out.cpu(), x.cpu())
                    got[key] = "device" if ok else "wrong values"
                except (RuntimeError, ValueError) as e:
                    got[key] = f"{type(e).__name__}: {str(e)[:160]}"
        finally:
            dist.destroy_process_group()
    return got
