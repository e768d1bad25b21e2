"""Sharding: the logical-axis context, the placement vocabulary, and the
parameter, optimizer, batch and cache specs.

The counterpart of ``repro/distributed/sharding.py``.  Model code
annotates activations with logical axes through ``constrain``, so one
device runs the exact code a mesh would.  ``use_mesh(mesh, policy)``
installs a mesh whose members share one device, or a mesh over a world's
ranks (``launch.mesh.Mesh``; a mesh over distinct devices without a rank
raises through ``Mesh.member_device``) and the policy the specs read;
``use_mesh(None,
policy=...)`` sets the policy alone.  Under a mesh, ``constrain`` resolves
its logical axes against it and leaves the values as they are (what
``with_sharding_constraint`` does to values), and ``dp_groups`` counts the
data-parallel groups the MoE routes in, as the reference does.  The steps
run under the mesh through ``launch.steps.sharded_step``.

Placement has JAX's names, kept small:

* :class:`PartitionSpec` (``P``): one entry a dimension, an axis name,
  ``None`` (not split) or a tuple of names (split over their product, the
  first name major); trailing ``None`` s do not count when two specs are
  compared.
* :class:`NamedSharding`: a spec over a ``launch.mesh.Mesh``;
  :meth:`NamedSharding.member_indices` gives each member's block, members
  in ``mesh.devices.flat`` order, as JAX's ``devices_indices_map`` does.
* :class:`ShardedTensor`: one tensor a member on that member's device.  A
  dimension not split gives each member its own copy, as on distinct
  devices: the members never share a storage, so the placement is what a
  run over distinct devices would do, on a mesh whose members share one.
* On a mesh over a world's ranks (``launch.mesh.world_mesh``) a process
  holds only its own blocks, as plain tensors: :func:`place` gives this
  rank's block (:func:`block`) and :func:`gather` all-gathers the blocks
  through ``distributed.spmd``; no ``ShardedTensor`` is made there.

The specs (``_RULES``, :func:`param_specs`, :func:`opt_specs` with ZeRO-1,
:func:`batch_spec`, :func:`cache_spec`) read the port's dict trees and give
the reference's spec trees.
"""
from __future__ import annotations

import contextlib
import re
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import map_tree

_CTX: dict = {"mesh": None, "policy": "tp"}


@contextlib.contextmanager
def use_mesh(mesh, policy: str = "tp") -> Iterator[None]:
    """The reference's context manager.  ``mesh``: a ``launch.mesh.Mesh``
    whose members share one device, or None.  ``policy``: "tp" (the model
    axis splits heads, hidden and experts) or "dp" (the model axis joins
    data parallelism, weights replicated), read by the specs below."""
    if policy not in ("tp", "dp"):
        raise ValueError(f"policy {policy!r}: 'tp' or 'dp'")
    if mesh is not None:
        mesh.member_device()
    prev = (_CTX["mesh"], _CTX["policy"])
    _CTX["mesh"], _CTX["policy"] = mesh, policy
    try:
        yield
    finally:
        _CTX["mesh"], _CTX["policy"] = prev


def current_mesh() -> Optional[object]:
    return _CTX["mesh"]


def current_policy() -> str:
    return _CTX["policy"]


def dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes: ``pod`` and ``data`` where present,
    and ``model`` too under the ``dp`` policy."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if _CTX["policy"] == "dp" and "model" in mesh.axis_names:
        axes = axes + ("model",)
    return axes


def _resolve(mesh, axis):
    """A logical axis on ``mesh``: "dp" is every data-parallel axis (one
    name, a tuple, or None where the mesh has none); another name stays
    where the mesh has it, else None."""
    if axis is None:
        return None
    if axis == "dp":
        ax = dp_axes(mesh)
        return ax if len(ax) > 1 else (ax[0] if ax else None)
    return axis if axis in mesh.axis_names else None


def dp_groups(batch: int) -> int:
    """The data-parallel groups dividing ``batch`` (1 without a mesh): the
    product of the DP axes :func:`batch_spec` splits ``batch`` over.  The
    MoE dispatches each group on its own."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return 1
    g = 1
    for a in dp_axes(mesh):
        if batch % (g * mesh.shape[a]) == 0:
            g *= mesh.shape[a]
    return g


def constrain(x, *axes):
    """A sharding constraint on logical axes: without a mesh a no-op;
    under one, the axes resolve against it (a spec naming a mesh axis
    twice, or longer than ``x`` has dimensions, raises) and ``x`` is
    returned as it is: the values a constraint leaves, on the members'
    one device."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    if len(axes) > x.dim():
        raise ValueError(f"{len(axes)} axes for a {x.dim()}-d tensor")
    NamedSharding(mesh, P(*(_resolve(mesh, a) for a in axes)))
    return x


def decode_axis(mesh) -> str:
    """The mesh axis decompression work partitions over: ``data`` where
    present, then ``pod``, else the mesh's first axis."""
    for a in ("data", "pod"):
        if a in mesh.axis_names:
            return a
    return mesh.axis_names[0]


# --------------------------------------------------------------------------
# the placement vocabulary
# --------------------------------------------------------------------------


def _entry(part):
    if part is None or isinstance(part, str):
        return part
    part = tuple(part)
    if not all(isinstance(a, str) for a in part):
        raise TypeError(f"a spec entry names mesh axes: {part!r}")
    return part


def _axes_of(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


class PartitionSpec(tuple):
    """The mesh axes each dimension splits over (JAX's ``PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_entry(p) for p in parts))

    def __reduce__(self):
        return (PartitionSpec, tuple(self))

    def _key(self) -> tuple:
        parts = [p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in self]
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def __eq__(self, other) -> bool:
        if not isinstance(other, tuple):
            return NotImplemented
        if not isinstance(other, PartitionSpec):
            other = PartitionSpec(*other)
        return self._key() == other._key()

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """``spec`` over ``mesh``: where each member's block of a tensor lies."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        named = [a for part in self.spec for a in _axes_of(part)]
        if len(named) != len(set(named)):
            raise ValueError(f"spec {self.spec} maps a mesh axis to more "
                             "than one dimension")

    @property
    def device(self) -> torch.device:
        """The device the members share (``Mesh.member_device``)."""
        return self.mesh.member_device()

    def _splits(self, ndim: int) -> List[int]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than a "
                             f"{ndim}-d shape")
        out = []
        for d in range(ndim):
            k = 1
            for a in _axes_of(self.spec[d] if d < len(self.spec) else None):
                k *= int(self.mesh.shape[a])
            out.append(k)
        return out

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """Each member's block shape; the shape must be placeable."""
        if not placeable(global_shape, self):
            raise ValueError(f"shape {tuple(global_shape)} cannot be placed "
                             f"under {self.spec} on {self.mesh}")
        return tuple(int(n) // k for n, k in
                     zip(global_shape, self._splits(len(global_shape))))

    def member_indices(self, global_shape) -> List[Tuple[slice, ...]]:
        """Each member's block of a tensor of ``global_shape``, members in
        ``mesh.devices.flat`` order."""
        block = self.shard_shape(global_shape)
        names = list(self.mesh.axis_names)
        out = []
        for pos in np.ndindex(*self.mesh.devices.shape):
            idx = []
            for d, size in enumerate(block):
                part = self.spec[d] if d < len(self.spec) else None
                i = 0
                for a in _axes_of(part):
                    i = i * int(self.mesh.shape[a]) + pos[names.index(a)]
                idx.append(slice(i * size, (i + 1) * size))
            out.append(tuple(idx))
        return out

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.spec})"


def placeable(shape, sharding) -> bool:
    """Whether ``shape`` can be placed under ``sharding``: every split
    dimension divides by the product of its axes' sizes.  The executors
    leave an output they cannot place where it is (a ragged tail shard),
    as the reference does.  A spec naming an axis the mesh lacks raises."""
    spec = getattr(sharding, "spec", None)
    if spec is None:
        return True
    if len(spec) > len(shape):
        return False
    for dim, part in zip(shape, spec):
        k = 1
        for a in _axes_of(part):
            if a not in sharding.mesh.shape:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"{sharding.mesh}")
            k *= int(sharding.mesh.shape[a])
        if int(dim) % k:
            return False
    return True


class ShardedTensor:
    """A tensor of ``shape`` placed under ``sharding``: ``shards[m]`` is
    member m's block (``sharding.member_indices``), its own tensor on that
    member's device."""

    def __init__(self, shards: List[torch.Tensor], sharding: NamedSharding,
                 shape, dtype: torch.dtype):
        self.shards = list(shards)
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        if len(self.shards) != sharding.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for "
                             f"{sharding.mesh.size} members")

    @classmethod
    def place(cls, x: torch.Tensor, sharding: NamedSharding
              ) -> "ShardedTensor":
        """``x`` laid out under ``sharding``: each member's block copied to
        the member's device, in a storage of its own.  A mesh over distinct
        devices raises (``Mesh.member_device``), and so does a mesh over a
        world's ranks, whose process holds only its own block: there
        :func:`place` (or :func:`block`) gives it."""
        if sharding.mesh.rank is not None:
            raise ValueError(
                f"{sharding.mesh} is a mesh over a world's ranks: this "
                "process holds only its own block, a plain tensor "
                "(sharding.place or sharding.block), not a ShardedTensor")
        sharding.mesh.member_device()
        shards = []
        for dev, idx in zip(sharding.mesh.devices.flat,
                            sharding.member_indices(x.shape)):
            block = x[idx]
            shards.append(torch.empty(block.shape, dtype=x.dtype,
                                      device=dev).copy_(block))
        return cls(shards, sharding, x.shape, x.dtype)

    @property
    def device(self) -> torch.device:
        return self.sharding.mesh.member_device()

    def map(self, fn) -> "ShardedTensor":
        """``fn`` (an elementwise op, a view or a cast) applied to every
        shard, under the same sharding."""
        shards = [fn(s) for s in self.shards]
        return ShardedTensor(shards, self.sharding, self.shape,
                             shards[0].dtype)

    def full(self) -> torch.Tensor:
        """The global tensor, assembled on the mesh's device."""
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        seen = set()
        for idx, shard in zip(self.sharding.member_indices(self.shape),
                              self.shards):
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:
                seen.add(key)
                out[idx] = shard
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding})")


def block(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``sharding``, on a
    mesh over a world's ranks: copied to the rank's device, in a storage
    of its own (a block never pins the tensor it was cut from)."""
    mesh = sharding.mesh
    if mesh.rank is None:
        raise ValueError(f"{mesh} has no rank: ShardedTensor.place lays "
                         "out every member's block in one process")
    part = x[sharding.member_indices(x.shape)[mesh.rank]]
    return torch.empty(part.shape, dtype=x.dtype,
                       device=mesh.member_device()).copy_(part)


def place(tree, shardings):
    """``tree`` laid out under ``shardings`` (a tree like it of
    ``NamedSharding`` s; a None sharding leaves its subtree as it is): a
    tensor is placed (``ShardedTensor.place``, or this rank's :func:`block`
    on a mesh over a world's ranks; a shape it cannot split raises), a
    ``ShardedTensor`` under an equal sharding stays, one under another is
    gathered and placed anew; other leaves (the cache's ``pos``) stay."""
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings))
    if isinstance(tree, ShardedTensor):
        if tree.sharding == shardings:
            return tree
        tree = tree.full()
    if isinstance(tree, torch.Tensor):
        if shardings.mesh.rank is not None:
            return block(tree, shardings)
        return ShardedTensor.place(tree, shardings)
    return tree


def gather(tree, shardings=None):
    """Each ``ShardedTensor`` leaf's global tensor (the members' blocks
    all-gathered, ``ShardedTensor.full``); other leaves as they are.  With
    ``shardings`` (a tree like ``tree``) a tensor leaf under a sharding
    over a world's ranks is this rank's block, and its whole tensor is
    all-gathered through ``distributed.spmd`` (every process of the mesh
    must gather the same tree)."""
    if isinstance(tree, dict):
        return {k: gather(v, None if shardings is None else shardings[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        shs = [None] * len(tree) if shardings is None else shardings
        return type(tree)(gather(v, s) for v, s in zip(tree, shs))
    if isinstance(tree, ShardedTensor):
        return tree.full()
    if (isinstance(tree, torch.Tensor) and shardings is not None
            and shardings.mesh.rank is not None):
        from repro_torch.distributed import spmd
        with spmd.use(spmd.member_of(shardings.mesh)):
            return spmd.relayout(tree, shardings.spec, P())
    return tree


def gather_to(x: torch.Tensor, sharding: NamedSharding,
              dst: int = 0) -> Optional[torch.Tensor]:
    """The whole tensor of which ``x`` is this rank's block under
    ``sharding`` (a mesh over a world's ranks), as a host tensor on rank
    ``dst`` alone (None on the others): the lowest rank holding each
    distinct block sends its bytes to ``dst`` (replicas send nothing), and
    only ``dst`` holds the whole tensor.  Every process of the world must
    call it for the same leaves in the same order."""
    import torch.distributed as dist
    mesh = sharding.mesh
    if mesh.rank is None:
        raise ValueError(f"{mesh} has no rank: ShardedTensor.full gathers "
                         "the members of one process")
    if mesh.size != dist.get_world_size():
        raise ValueError(f"{mesh} has {mesh.size} members; the world has "
                         f"{dist.get_world_size()} ranks")
    blk = x.detach().to("cpu").contiguous()
    whole = tuple(n * k for n, k in zip(blk.shape,
                                        sharding._splits(blk.dim())))
    idx = sharding.member_indices(whole)
    holder = {}
    for r, ix in enumerate(idx):
        holder.setdefault(tuple((i.start, i.stop) for i in ix), r)
    senders = sorted(set(holder.values()))
    sent = blk.reshape(-1).view(torch.uint8)
    if mesh.rank != dst:
        if mesh.rank in senders and sent.numel():
            dist.send(sent, dst=dst)
        return None
    out = torch.empty(whole, dtype=blk.dtype)
    for r in senders:
        got = sent
        if r != dst and sent.numel():
            got = torch.empty_like(sent)
            dist.recv(got, src=r)
        out[idx[r]] = got.view(blk.dtype).reshape(blk.shape)
    return out


def member_sharding(mesh, axis: str = "pod",
                    ndim: int = 1) -> NamedSharding:
    """The placement of per-member trees on the collective plane: the
    leading member axis over ``axis``, the trailing dimensions whole (DiLoCo
    pod replicas, error-feedback residuals, gathered wire tables)."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def decode_out_sharding(mesh, ndim: int = 1) -> NamedSharding:
    """A decoded array's leading dimension over :func:`decode_axis`, the
    rest whole: where decoded token shards and other row-major outputs are
    placed."""
    return NamedSharding(mesh, P(decode_axis(mesh), *([None] * (ndim - 1))))


# --------------------------------------------------------------------------
# parameter, optimizer, batch and cache specs
# --------------------------------------------------------------------------

# (path regex, the kind of spec of the unstacked parameter); a stacked
# block parameter's leading layer axis is not split.
_RULES = [
    (r"embed$",              ("model_last",)),        # (V, D): D over model
    (r"lm_head$",            ("model_last",)),        # (D, V): V over model
    (r"attn/w[qkv]$",        ("model_last",)),
    (r"attn/wo$",            ("model_first",)),
    (r"(mlp|shared|cmix)/w_(up|gate|ck)$",  ("model_last",)),
    (r"(mlp|shared|cmix)/w_(down|cv)$",     ("model_first",)),
    (r"cmix/w_cr$",          ("model_last",)),
    (r"moe/router$",         ("replicate",)),
    (r"moe/w_(up|gate|down)$", ("expert",)),          # (E, ., .): E over model
    (r"rwkv/w_(r|k|v|g|decay)$", ("model_last",)),
    (r"rwkv/w_o$",           ("model_first",)),
    (r"mamba/in_proj$",      ("model_last",)),
    (r"mamba/out_proj$",     ("model_first",)),
    (r"mamba/conv_w$",       ("model_last",)),
]


def _spec_for(path: str, ndim: int, shape, mesh) -> PartitionSpec:
    if _CTX["policy"] == "dp":
        return P()          # pure DP: weights replicated everywhere
    msize = mesh.shape.get("model", 1)

    def div(dim_size) -> bool:
        return dim_size % msize == 0

    for pat, (kind,) in _RULES:
        if re.search(pat, path):
            if kind == "replicate":
                return P()
            if kind == "model_last":
                ax = ndim - 1
                if not div(shape[ax]):
                    return P()
                return P(*([None] * ax + ["model"]))
            if kind == "model_first":
                # the first matrix dimension: -2, past a stacked layer axis
                ax = ndim - 2
                if ax < 0 or not div(shape[ax]):
                    return P()
                return P(*([None] * ax + ["model", None]))
            if kind == "expert":
                ax = ndim - 3  # (..., E, a, b)
                if ax < 0 or not div(shape[ax]):
                    return P()
                return P(*([None] * ax + ["model", None, None]))
    return P()  # norms, scalars, mixing vectors: replicated


def _map_with_path(fn, tree, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def _shardings(specs, mesh):
    if isinstance(specs, dict):
        return {k: _shardings(v, mesh) for k, v in specs.items()}
    return NamedSharding(mesh, specs)


def param_specs(params, mesh):
    """A ``PartitionSpec`` tree mirroring ``params`` (tensors or anything
    with ``shape``; the keys' ``/``-joined path picks the rule)."""
    return _map_with_path(
        lambda path, leaf: _spec_for(path, len(leaf.shape), tuple(leaf.shape),
                                     mesh), params)


def param_shardings(params, mesh):
    return _shardings(param_specs(params, mesh), mesh)


def _zero1_augment(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """ZeRO-1: optimizer state also split over ``data``, on the first
    dimension not split yet that it divides."""
    if "data" not in mesh.axis_names:
        return spec
    dsize = mesh.shape["data"]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, s) in enumerate(zip(parts, shape)):
        if p is None and s % dsize == 0:
            parts[i] = "data"
            return P(*parts)
    return spec


def opt_specs(opt_state, params, mesh):
    """Specs of the AdamW state: each moment its parameter's spec with
    ZeRO-1's ``data`` split, and an int8 moment's ``{"q", "s"}`` over
    ``data`` on the block dimension."""
    pspecs = param_specs(params, mesh)
    dsize = mesh.shape.get("data", 1)

    def moment_spec(pspec, leaf):
        if isinstance(leaf, dict):  # int8: {"q": (nb, 128), "s": (nb, 1)}
            return {k: (P("data", None) if v.shape[0] % dsize == 0 else P())
                    for k, v in leaf.items()}
        return _zero1_augment(pspec, tuple(leaf.shape), mesh)

    return {"step": P(),
            "m": map_tree(moment_spec, pspecs, opt_state["m"]),
            "v": map_tree(moment_spec, pspecs, opt_state["v"])}


def opt_shardings(opt_state, params, mesh):
    return _shardings(opt_specs(opt_state, params, mesh), mesh)


def batch_spec(mesh, global_batch: int) -> PartitionSpec:
    """The batch over as many DP axes as divide it; else not split."""
    axes = []
    prod = 1
    for a in dp_axes(mesh):
        if global_batch % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
    if not axes:
        return P(None)
    return P(tuple(axes) if len(axes) > 1 else axes[0])


def cache_spec(mesh, cfg, batch: int) -> dict:
    """Specs of the decode cache (``models.model.init_cache``'s keys)."""
    msize = mesh.shape.get("model", 1)
    b = batch_spec(mesh, batch)
    bax = b[0] if len(b) else None
    # (L, B, S, n_kv, hd): K/V heads over model where they divide, else the
    # sequence
    if cfg.n_kv % msize == 0:
        kvspec = P(None, bax, None, "model", None)
    else:
        kvspec = P(None, bax, "model", None, None)
    specs = {"pos": P()}
    if cfg.mixer == "attn":
        specs["k"] = kvspec
        specs["v"] = kvspec
    elif cfg.mixer == "rwkv6":
        specs["wkv"] = P(None, bax, "model", None, None)   # heads over model
        specs["x_att"] = P(None, bax, "model")
        specs["x_ffn"] = P(None, bax, "model")
    elif cfg.mixer == "mamba2":
        specs["ssm"] = P(None, bax, "model", None, None)
        specs["conv"] = P(None, bax, None, "model")
        if cfg.attn_every:
            specs["k"] = kvspec
            specs["v"] = kvspec
    return specs
