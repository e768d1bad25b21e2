"""Meshes: named grids of devices.

The counterpart of ``repro/launch/mesh.py``.  The reference's meshes are
single-controller JAX meshes; here a :class:`Mesh` is a numpy grid of
``torch.device`` s with named axes, and ``shape`` maps each axis name to
its size, as JAX's does.  A mesh of one process has members that share
one device: the collective plane (``distributed/collectives.py``) and
DiLoCo (``distributed/diloco.py``) run on it with a leaf "sharded over
``pod``" one tensor with a leading member axis on that device, and the
sharded decode executor and its consumers place their outputs as one
tensor a member (``distributed.sharding.ShardedTensor``).  A mesh over
distinct devices takes one process a member.

A mesh over the ranks of a ``torch.distributed`` world
(:func:`world_mesh`) knows its process's ``rank``: ``member_device`` gives
that rank's device, and ``distributed.spmd.Member.join`` (or
``spmd.member_of``) gives the rank's program its process groups.  On such
a mesh every entry of the decode path (the sharded executor, the
compressed collectives, the elastic restore, the loader, DiLoCo) takes and
returns this member's own blocks.  :func:`spawn` starts one process a
member (``gloo`` by default, rendezvous through a ``FileStore`` in a
temporary directory; a world ``torchrun`` set up is joined as it is) and
fails when any rank fails.  A mesh over distinct devices without a rank
raises, pointing to :func:`spawn` and :func:`world_mesh`.

Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

import collections
import os
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


class Mesh:
    """``devices``: an array of ``torch.device`` (one a member), one axis a
    name of ``axis_names``; ``rank``: this process's member, where the
    members are the ranks of a world (:func:`world_mesh`)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 rank: Optional[int] = None):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            grid[idx] = torch.device(given[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names,
                                                 grid.shape))
        if rank is not None and not 0 <= rank < grid.size:
            raise ValueError(f"rank {rank} of a {grid.size}-member mesh")
        self.rank = rank

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shared_device(self) -> Optional[torch.device]:
        """The one device every member holds, or None where members hold
        distinct devices."""
        found = set(self.devices.flat)
        return found.pop() if len(found) == 1 else None

    def member_device(self) -> torch.device:
        """This rank's device on a mesh over a world's ranks; else the
        device the members share, and a mesh over distinct devices raises
        (one process holds one device's members)."""
        if self.rank is not None:
            return self.devices.flat[self.rank]
        return self._one_device()

    def _one_device(self) -> torch.device:
        dev = self.shared_device
        if dev is None:
            raise NotImplementedError(
                f"{self} spans distinct devices in one process: run one "
                "process a member (launch.mesh.spawn, and in each process "
                "launch.mesh.world_mesh), or give the members one device")
        return dev

    def members(self, axis: str, n: Optional[int] = None) -> int:
        """``shape[axis]``, equal to ``n`` where given; the members share
        one device unless the mesh is over a world's ranks."""
        if self.rank is None:
            self._one_device()
        size = int(self.shape[axis])
        if n is not None and n != size:
            raise ValueError(f"{n} members for mesh axis {axis!r} of {size}")
        return size

    def coord(self, axis: str) -> int:
        """This rank's place on ``axis`` (members in ``devices.flat``
        order, as ``spmd.Member.coords``)."""
        if self.rank is None:
            raise ValueError(f"{self} has no rank (launch.mesh.world_mesh)")
        where = np.unravel_index(self.rank, self.devices.shape)
        return int(where[self.axis_names.index(axis)])

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devices = sorted(map(str, set(self.devices.flat)))
        rank = "" if self.rank is None else f"; rank {self.rank}"
        return f"Mesh({axes}; devices {devices}{rank})"


def _members_on(device, n: int) -> list:
    return [resolve_device(device)] * n


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> Mesh:
    """The reference's 16 x 16 (data, model) mesh, or 2 x 16 x 16 (pod,
    data, model) with ``multi_pod``, over distinct devices of ``device``'s
    type; raises where there are fewer, naming the count found."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devices = _distinct_devices(device)
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices for mesh {shape}, have "
                           f"{len(devices)}")
    return Mesh(np.asarray(devices[:n], dtype=object).reshape(shape), axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device: str = "cuda") -> Mesh:
    """A small mesh whose members all hold ``device`` (the counterpart of
    the reference's test mesh over virtual CPU devices)."""
    n = int(np.prod(shape))
    return Mesh(np.asarray(_members_on(device, n),
                           dtype=object).reshape(shape), axes)


MESH_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(text: str, *, device: str = "cuda") -> Mesh:
    """``make_test_mesh`` of a shape written ``"4x2"``: one size an axis,
    the axes ``data``; ``data, model``; or ``pod, data, model``."""
    shape = tuple(int(n) for n in text.lower().split("x"))
    if len(shape) not in MESH_AXES or min(shape) < 1:
        raise ValueError(f"mesh {text!r}: 1 to 3 positive sizes, as 4x2")
    return make_test_mesh(shape, MESH_AXES[len(shape)], device=device)


def make_decode_mesh(ndev: Optional[int] = None, axis: str = "data", *,
                     device: str = "cuda") -> Mesh:
    """1-D mesh over the first ``ndev`` distinct devices of ``device``'s
    type (default: all of them): ``torch.cuda.device_count()`` cards, or
    the CPU's one device when ``device`` is the CPU."""
    devices = _distinct_devices(device)
    n = len(devices) if ndev is None else int(ndev)
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n], dtype=object), (axis,))


def _distinct_devices(device) -> list:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


# --------------------------------------------------------------------------
# one process a member
# --------------------------------------------------------------------------


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device of ``device``'s type: the cards taken in
    turn (every rank on the one card of a one-card machine); the CPU's
    one device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(dev.type)


def world_mesh(shape, axes: Sequence[str], *, device: str = "cuda"
               ) -> Mesh:
    """A mesh over the ranks of the current ``torch.distributed`` world
    (``prod(shape)`` of them, member r rank r), its ``rank`` this
    process's, each member on its :func:`rank_device`."""
    import torch.distributed as dist
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape))
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    grid = np.empty(n, dtype=object)
    for r in range(n):
        grid[r] = rank_device(device, r)
    return Mesh(grid.reshape(shape), axes, rank=dist.get_rank())


def _rank_main(rank: int, world: int, store_path: str, backend: str,
               device: str, threads: int, fn: Callable, args: tuple,
               out_dir: str) -> None:
    """One spawned rank: join the world, run ``fn(*args)``, save what it
    returns for the launcher."""
    import torch.distributed as dist
    torch.set_num_threads(threads)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(fn: Callable, world: int, args: tuple = (), *,
          device: str = "cuda", backend: str = "gloo",
          threads: Optional[int] = None,
          timeout: Optional[float] = None) -> list:
    """Run ``fn(*args)`` in ``world`` processes, one a member, each in a
    ``torch.distributed`` world of ``backend`` (rank r on
    :func:`rank_device`; ``device`` must exist: nothing falls back to the
    CPU), and return what each rank's ``fn`` returned, in rank order
    (saved with ``torch.save``).  ``fn`` must be importable by name (a
    module's function), since the processes start afresh (``spawn``).  A
    rank that raises, or a run past ``timeout`` seconds, ends every rank
    and raises here.  ``threads``: torch's threads a rank (default: the
    CPUs over the ranks).

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set, a world of
    ``world`` ranks) nothing is started: this process joins the world
    torchrun set up (``env://``), runs ``fn`` and returns its one result
    in a list."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    resolve_device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if size != world:
            raise ValueError(f"torchrun started {size} ranks; the mesh has "
                             f"{world} members")
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=size)
        try:
            return [fn(*args)]
        finally:
            dist.destroy_process_group()
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(world, os.path.join(tmp, "store"), backend,
                              device, threads, fn, args, tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            # ``join`` returns as each rank ends, True once all have
            while not ctx.join(None if deadline is None else
                               max(0.0, deadline - time.monotonic())):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} "
                                       f"ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
