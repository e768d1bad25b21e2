"""Checkpointing: atomic, async, codec-compressed.

The counterpart of ``repro/checkpoint/checkpoint.py``, over nested dicts,
lists and tuples of tensors (numpy arrays and Python numbers are leaves
too).  The directory format is the reference's, byte for byte: the same
leaf keys, leaf order, file names, ``manifest.json`` text and compressed
blobs for the same state, so each package restores what the other wrote.

* atomic     — write to ``step_N.tmp/`` then rename; a crash mid-save never
               corrupts the latest checkpoint.
* async      — the host copy is taken synchronously (consistent snapshot),
               serialization runs on a background thread; ``join`` it.
* compressed — leaves of 1 KiB or more are stored through a registry codec
               (tdeflate for raw bytes, rle_v2 for integer state, bitpack
               for int8 moments) and decoded on restore through one batched
               ``DecodePlan`` per window, on the card's decode kernels.

Layout of ``step_N/``: ``manifest.json`` (``{"step", "codec", "leaves":
{key: {"file", "dtype", "shape", "codec"[, "ratio"]}}}``), one ``.npy`` per
uncompressed leaf and one ``.npy.blob`` (a pickled ``api.CompressedArray``)
per compressed leaf.  A key is the ``/``-joined path of dict keys and
sequence indices, dict keys sorted (``jax.tree_util``'s order), and a file
name is the key with ``/`` replaced by ``__`` plus ``.npy``.

bfloat16 has no numpy type here: a bf16 leaf is written as its 16-bit
patterns under the manifest dtype ``"bfloat16"`` (an uncompressed one with
the reference's ``<V2`` ``.npy`` header; a compressed one with
``orig_dtype="bfloat16"`` where its codec reads 2-byte elements), and every
leaf is rebuilt from its bytes with ``format.device_view``.

Blob files are read through ``core.store.BlobUnpickler``, which admits the
compressed-blob classes (the reference package's names map onto the
port's) and numpy arrays only.  ``restore(shardings=)`` is the elastic,
mesh-sharded restore: each leaf comes back as a
``distributed.sharding.ShardedTensor`` on the shardings' mesh, whatever
mesh saved it, or, on a mesh over a world's ranks (one process a member),
as this rank's block, each process decoding its block of every window's
rows.  ``save(shardings=)`` takes such a member's blocks: leaf by leaf
they are gathered to rank 0 alone, which writes the directory a save of
the whole state writes.
"""
from __future__ import annotations

import dataclasses
import json
import pickle
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import api as codec_api
from repro_torch.core import format as fmt
from repro_torch.core import registry, transfers
from repro_torch.core import store as blobstore
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding, ShardedTensor

MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"step_(\d+)")
BF16 = "bfloat16"


def _flatten(tree) -> Dict[str, Any]:
    """Leaves by key, in ``jax.tree_util.tree_flatten_with_path``'s order:
    dict keys sorted, sequences by index, ``None`` an empty subtree."""
    flat: Dict[str, Any] = {}

    def walk(node, path: Tuple[str, ...]) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif node is not None:
            flat["/".join(path)] = node

    walk(tree, ())
    return flat


def _rebuild(like, leaves: Dict[str, Any], path: Tuple[str, ...] = ()):
    """``like``'s structure with each leaf replaced by ``leaves[key]``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = [_rebuild(v, leaves, path + (str(i),))
                 for i, v in enumerate(like)]
        if isinstance(like, list):
            return items
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    if like is None:
        return None
    return leaves["/".join(path)]


def _snapshot(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` and its manifest dtype; a bf16 leaf becomes
    its uint16 bit patterns, and a ``ShardedTensor`` its global tensor
    (what the reference's save reads of a sharded array), so a state saved
    under a mesh is the same directory as the same state saved whole.
    None (a ranked save's leaf on a rank that does not write) stays None."""
    if leaf is None:
        return None
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    if arr.dtype.name == BF16:               # an ml_dtypes array
        return arr.view(np.uint16), BF16
    return arr, str(arr.dtype)


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    # the header numpy writes for an ml_dtypes bfloat16 array
    header = {"descr": "<V2", "fortran_order": False, "shape": arr.shape}
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(arr).tobytes())


def _compress(arr: np.ndarray, dtype: str, codec: str):
    """The reference's encode of one leaf: byte-stream codecs take any
    dtype as raw bytes.  A bf16 leaf's bits keep the reference's
    ``orig_dtype``."""
    byte_stream = registry.get(codec).byte_stream
    ca = codec_api.compress(arr.reshape(-1).view(np.uint8) if byte_stream
                            else arr, codec)
    if dtype == BF16 and not byte_stream:
        ca = dataclasses.replace(
            ca, orig_dtype=BF16,
            blobs=[dataclasses.replace(b, orig_dtype=BF16) for b in ca.blobs])
    return ca


def _ranked_mesh(shardings):
    """The mesh over a world's ranks that ``shardings`` (a tree of
    ``NamedSharding`` s, None holes) lies on, or None."""
    if shardings is None:
        return None
    mesh = next((s.mesh for s in _flatten(shardings).values()
                 if isinstance(s, NamedSharding)), None)
    return mesh if mesh is not None and mesh.rank is not None else None


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def save(ckpt_dir: str, step: int, state, *, codec: str = "none",
         async_: bool = False, keep: int = 3,
         shardings=None) -> Optional[threading.Thread]:
    """Snapshot ``state`` (nested dicts, lists and tuples of tensors).
    Returns the writer thread if async.

    ``shardings``: a tree like ``state`` of ``NamedSharding`` s over a
    mesh over a world's ranks, whose blocks ``state`` holds (one process a
    member): every process of the world calls ``save``, and leaf by leaf
    each rank sends its block to rank 0 (``sharding.gather_to``), which
    alone holds that leaf whole, on the host, while it writes it; rank 0
    writes the directory the whole state gives, byte for byte, and every
    process returns once it is published (``async_`` is not taken
    there)."""
    root = Path(ckpt_dir)
    mesh = _ranked_mesh(shardings)
    if mesh is not None:
        flat_sh = _flatten(shardings)
        whole = ((key, _snapshot(_whole_on_rank0(leaf, flat_sh.get(key),
                                                 mesh.rank)))
                 for key, leaf in _flatten(state).items())
        if mesh.rank == 0:
            root.mkdir(parents=True, exist_ok=True)
            _write(root, step, codec, keep, whole)
        else:
            for _ in whole:             # send this rank's blocks
                pass
        _barrier()
        return None
    root.mkdir(parents=True, exist_ok=True)
    # consistent snapshot: the device->host copy happens NOW, writing may
    # defer
    host = {key: _snapshot(leaf) for key, leaf in _flatten(state).items()}
    if async_:
        t = threading.Thread(target=_write, daemon=True,
                             args=(root, step, codec, keep, host.items()))
        t.start()
        return t
    _write(root, step, codec, keep, host.items())
    return None


def _whole_on_rank0(leaf, sharding, rank: int):
    """A ranked save's leaf: whole on rank 0 (its blocks gathered there
    where it lies under a sharding of the world's ranks), None on the
    other ranks."""
    if isinstance(sharding, NamedSharding) and sharding.mesh.rank is not None \
            and isinstance(leaf, torch.Tensor):
        return shd.gather_to(leaf, sharding, dst=0)
    return leaf if rank == 0 else None


def _write(root: Path, step: int, codec: str, keep: int, leaves) -> None:
    """Write ``leaves`` (``(key, (host array, manifest dtype))`` pairs, in
    order) as ``step``'s directory under ``root``, published atomically,
    then prune the steps beyond ``keep``."""
    tmp = root / f"step_{step}.tmp"
    final = root / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "codec": codec, "leaves": {}}
    for key, (arr, dtype) in leaves:
        fn = key.replace("/", "__") + ".npy"
        entry = {"file": fn, "dtype": dtype,
                 "shape": list(arr.shape), "codec": "none"}
        if codec != "none" and arr.nbytes >= 1024:
            ca = _compress(arr, dtype, codec)
            with open(tmp / (fn + ".blob"), "wb") as f:
                pickle.dump(ca, f)
            entry["codec"] = codec
            entry["ratio"] = ca.ratio
        else:
            _save_npy(tmp / fn, arr, dtype)
        manifest["leaves"][key] = entry
    (tmp / MANIFEST).write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish
    # retention: only prune steps STRICTLY OLDER than the one just
    # published, so two overlapping async saves cannot delete each
    # other's newer checkpoint, whichever writer finishes last
    steps = sorted(all_steps(str(root)))
    for s in steps[:-keep]:
        if s < step:
            shutil.rmtree(root / f"step_{s}", ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    """Published step numbers.  Only exact ``step_<int>`` directories count;
    foreign names that merely share the prefix (``step_final``, a stray
    ``step_7.tmp``, files) are skipped."""
    root = Path(ckpt_dir)
    if not root.exists():
        return []
    steps = []
    for p in root.glob("step_*"):
        m = _STEP_RE.fullmatch(p.name)
        if m and p.is_dir():
            steps.append(int(m.group(1)))
    return steps


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _load_blob(path):
    """Load one compressed leaf (a pickled ``api.CompressedArray``, the
    port's or the reference's) through ``store.BlobUnpickler``.
    Module-level so tests can instrument load-vs-decode ordering."""
    with open(path, "rb") as f:
        return blobstore.load_blob(f)


def _as_bits(ca):
    """A bf16 leaf's array decodes as its uint16 bits (numpy has no bf16
    type here); ``device_view`` then bitcasts to the manifest dtype."""
    if ca.orig_dtype != BF16 and all(b.orig_dtype != BF16 for b in ca.blobs):
        return ca
    fix = lambda d: "uint16" if d == BF16 else d
    return dataclasses.replace(
        ca, orig_dtype=fix(ca.orig_dtype),
        blobs=[dataclasses.replace(b, orig_dtype=fix(b.orig_dtype))
               for b in ca.blobs])


def _bytes_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array's bytes as a 1-D uint8 CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)
                            .view(np.uint8))


def restore(ckpt_dir: str, step: int, like, *, shardings=None,
            engine: Optional[CodagEngine] = None,
            decode_window: Optional[int] = None,
            service=None, device_out: bool = False,
            store=None, prefetch_windows: int = 1):
    """Restore into the structure of ``like`` (nested dicts, lists and
    tuples; only its structure is read).  Returns CPU tensors, or with
    ``device_out=True`` tensors on the engine's (or the service's) device.

    ``decode_window``: by default all compressed leaves decode through ONE
    batched plan (one launch per codec group).  A window decodes that many
    leaves a plan instead: bounded host memory, proportionally more
    launches.  Blob files are loaded lazily a window at a time either way.

    ``engine``: the ``CodagEngine`` compressed leaves decode on (default
    the card's, made only when a leaf is compressed or ``device_out``).
    ``service``: a ``core.server.DecompressionService`` to decode through
    instead, sharing its micro-batch windows and decoded-blob cache; not
    with ``engine``.

    ``device_out``: compressed leaves decode, reassemble and bitcast to
    their manifest dtype on the device, with no round trip through the
    host; uncompressed leaves upload once.

    ``store``: a ``core.store.TieredBlobStore`` over ``ckpt_dir`` (e.g.
    ``store.filesystem_store(ckpt_dir)``) to demand-page compressed leaves
    through: the STREAMING restore.  While window i decodes, the store
    prefetches the next ``prefetch_windows`` windows' blobs, and consumed
    windows are released under its host byte budget, so a checkpoint
    larger than host memory restores with ~(1 + ``prefetch_windows``)
    windows of compressed bytes resident (``decode_window`` defaults to 8
    on this path).

    ``shardings``: a tree like ``like`` of ``sharding.NamedSharding`` s
    (None: a leaf not placed), the ELASTIC restore: state saved on one mesh
    comes back laid out on the mesh of the restarted job, each leaf a
    ``sharding.ShardedTensor`` (on a mesh over a world's ranks, this
    rank's block, a plain tensor: ``sharding.place``).  With ``device_out``
    and no service the compressed leaves decode through
    ``DecodePlan.execute_sharded`` on the shardings' mesh (each member
    decoding its block of every group's rows, in its own process on a mesh
    over a world's ranks; with no ``engine``, on the member's device),
    with no device->host transfer; otherwise the restored leaves are
    placed.  A leaf whose shape cannot be placed under its sharding
    raises.
    """
    if engine is not None and service is not None:
        raise ValueError("pass engine= OR service=, not both: the service "
                         "decodes on its own engine")
    if store is not None and decode_window is None:
        decode_window = 8
    root = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((root / MANIFEST).read_text())
    keys = list(_flatten(like).keys())
    entries = [manifest["leaves"][key] for key in keys]
    places = {}
    mesh = None
    if shardings is not None:
        places = _flatten(shardings)
        if device_out and service is None:
            mesh = next((s.mesh for s in places.values()
                         if isinstance(s, NamedSharding)), None)
        if mesh is not None and engine is None:
            engine = CodagEngine(EngineConfig(
                device=str(mesh.member_device())))

    # uncompressed leaves load now; compressed ones window by window below
    leaves: List[Any] = [None] * len(keys)
    comp_idx: List[int] = []
    comp_files: List[str] = []
    for i, entry in enumerate(entries):
        if entry["codec"] != "none":
            comp_idx.append(i)
            comp_files.append(entry["file"] + ".blob")
        else:
            leaves[i] = _bytes_tensor(np.load(root / entry["file"]))
    if service is None and engine is None and (comp_idx or device_out):
        engine = CodagEngine()
    device = (service.engine if service is not None else engine).device \
        if device_out else None

    w = decode_window or max(1, len(comp_files))
    if store is not None:
        prefix = f"step_{step}/"
        window_iter = store.stream_windows(
            [prefix + f for f in comp_files], window=w,
            lookahead=max(0, prefetch_windows))
    else:
        def _lazy_windows():
            for j in range(0, len(comp_files), w):
                yield [_load_blob(root / f) for f in comp_files[j:j + w]]
        window_iter = _lazy_windows()
    # Each window's blobs are decoded through one batched plan per codec
    # group and committed into ``leaves`` before the next window's blobs
    # materialize: peak extra host memory is ~one window of compressed +
    # decoded bytes, not the whole checkpoint.
    pos = 0
    for cas in window_iter:
        idxs = comp_idx[pos:pos + len(cas)]
        pos += len(cas)
        cas = [_as_bits(ca) for ca in cas]
        if service is not None:
            decoded = service.decode_arrays(cas, device_out=device_out)
        else:
            decoded = codec_api.decompress_many(cas, engine,
                                                device_out=device_out,
                                                mesh=mesh)
        for i, arr in zip(idxs, decoded):
            leaves[i] = arr.reshape(-1) if device_out else _bytes_tensor(arr)
    out = {}
    for key, entry, leaf in zip(keys, entries, leaves):
        if device_out and leaf.device != device:
            leaf = transfers.to_device(leaf.numpy(), device)
        out[key] = fmt.device_view(leaf, entry["dtype"],
                                   tuple(entry["shape"]))
        sh = places.get(key)
        if sh is not None:
            out[key] = shd.place(out[key], sh)
    return _rebuild(like, out)
