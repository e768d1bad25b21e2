"""Meshes: named grids of devices.

The counterpart of ``repro/launch/mesh.py``.  The reference's meshes are
single-controller JAX meshes; here a :class:`Mesh` is a numpy grid of
``torch.device`` s with named axes, and ``shape`` maps each axis name to
its size, as JAX's does.  Several members may hold the same device: the
collective plane (``distributed/collectives.py``) and DiLoCo
(``distributed/diloco.py``) run on a mesh whose members share one device,
a leaf "sharded over ``pod``" being one tensor with a leading member axis
on that device; the sharded decode executor and its consumers place their
outputs as one tensor a member (``distributed.sharding.ShardedTensor``).
A mesh over distinct devices can be built and named, but nothing moves
tensors across one yet (ROADMAP.md Queue 1 item 11c).

Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


class Mesh:
    """``devices``: an array of ``torch.device`` (one a member), one axis a
    name of ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str]):
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
        """The device the members share; a mesh over distinct devices
        raises (the port moves nothing across devices yet, ROADMAP.md
        Queue 1 item 11c)."""
        dev = self.shared_device
        if dev is None:
            raise NotImplementedError(
                f"{self} spans distinct devices: collectives and placement "
                "across devices are not ported yet (ROADMAP.md Queue 1 item "
                "11c); the members must share one device")
        return dev

    def members(self, axis: str, n: Optional[int] = None) -> int:
        """``shape[axis]``, the members sharing one device
        (:meth:`member_device`), and equal to ``n`` where given."""
        self.member_device()
        size = int(self.shape[axis])
        if n is not None and n != size:
            raise ValueError(f"{n} members for mesh axis {axis!r} of {size}")
        return size

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devices = sorted(map(str, set(self.devices.flat)))
        return f"Mesh({axes}; devices {devices})"


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
