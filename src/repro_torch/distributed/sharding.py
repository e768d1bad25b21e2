"""Sharding context: the mesh-free half of ``repro/distributed/sharding.py``.

Model code annotates activations with logical axes through ``constrain``,
a no-op without a mesh (``sharding.py:83-89`` of the reference), so one
device runs the exact code a mesh would.  Installing a mesh, and the
parameter / optimizer / batch / cache specs derived from one, are not
ported yet (ROADMAP.md Queue 1 item 11): ``use_mesh`` with a mesh raises.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

_MESH = ("meshes are not ported yet (ROADMAP.md Queue 1 item 11): the port "
         "runs on one device")

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
