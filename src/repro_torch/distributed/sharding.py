"""Sharding context: the mesh-free half of ``repro/distributed/sharding.py``
and its member half.

Model code annotates activations with logical axes through ``constrain``,
a no-op without a mesh (``sharding.py:83-89`` of the reference), so one
device runs the exact code a mesh would.  The collective plane's helpers
(``dp_axes``, ``decode_axis``, ``member_sharding``) read a
``launch.mesh.Mesh``.  Installing a mesh for the model's steps, and the
parameter / optimizer / batch / cache specs derived from one, are not
ported yet (ROADMAP.md Queue 1 item 11b): ``use_mesh`` with a mesh raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Tuple

import torch

_MESH = ("a mesh for the model's steps is not ported yet (ROADMAP.md Queue "
         "1 item 11b): the port trains and serves on one device")

_CTX: dict = {"mesh": None, "policy": "tp"}


@contextlib.contextmanager
def use_mesh(mesh, policy: str = "tp") -> Iterator[None]:
    """The reference's context manager; only ``mesh=None`` (one device)."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    prev = (_CTX["mesh"], _CTX["policy"])
    _CTX["mesh"], _CTX["policy"] = None, policy
    try:
        yield
    finally:
        _CTX["mesh"], _CTX["policy"] = prev


def current_mesh() -> Optional[object]:
    return _CTX["mesh"]


def current_policy() -> str:
    return _CTX["policy"]


def dp_groups(batch: int) -> int:
    """Number of DP shards dividing ``batch``: 1 without a mesh."""
    return 1


def constrain(x, *axes):
    """A sharding constraint on logical axes: a no-op without a mesh."""
    return x


# --------------------------------------------------------------------------
# the member half: what the collective plane reads of a mesh
# --------------------------------------------------------------------------


def dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes: ``pod`` and ``data`` where present,
    and ``model`` too under the ``dp`` policy."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if _CTX["policy"] == "dp" and "model" in mesh.axis_names:
        axes = axes + ("model",)
    return axes


def decode_axis(mesh) -> str:
    """The mesh axis decompression work partitions over: ``data`` where
    present, then ``pod``, else the mesh's first axis."""
    for a in ("data", "pod"):
        if a in mesh.axis_names:
            return a
    return mesh.axis_names[0]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a member-stacked tree lies: ``spec`` names the mesh axis of
    each leaf dimension (None: not split).  On a mesh whose members share
    one device a leaf so placed is one tensor on that device, its member
    axis leading."""

    mesh: object
    spec: Tuple[Optional[str], ...]

    @property
    def device(self) -> torch.device:
        return self.mesh.member_device()


def member_sharding(mesh, axis: str = "pod",
                    ndim: int = 1) -> NamedSharding:
    """The placement of per-member trees on the collective plane: the
    leading member axis over ``axis``, the trailing dimensions whole (DiLoCo
    pod replicas, error-feedback residuals, gathered wire tables)."""
    return NamedSharding(mesh, (axis,) + (None,) * (ndim - 1))
