"""Public compress/decompress API.

    from repro_torch.core import api
    ca   = api.compress(arr, "rle_v2")              # host-side encode
    out  = api.decompress(ca)                       # decode on cuda, == arr

    cas  = api.compress_many(arrs, "rle_v2")        # list in, list out
    outs = api.decompress_many(cas, device_out=True)  # ONE launch per group

Decoding runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"`` or an engine configured for the CPU.  8-byte dtypes are
plane-decomposed (lo/hi uint32 planes compressed as two blobs) so RLE runs
survive.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core import plan as plan_mod
from repro_torch.core import registry
from repro_torch.core.engine import CodagEngine, EngineConfig, resolve_device


@dataclasses.dataclass
class CompressedArray:
    """One logical array; 1 blob normally, 2 plane blobs for 8-byte dtypes."""
    blobs: list
    orig_dtype: str
    orig_shape: tuple

    @property
    def ratio(self) -> float:
        comp = sum(b.compressed_bytes for b in self.blobs)
        unc = sum(b.uncompressed_bytes for b in self.blobs)
        return comp / max(1, unc)

    @property
    def compressed_bytes(self) -> int:
        return sum(b.compressed_bytes for b in self.blobs)


def compress(arr: np.ndarray, codec: str,
             chunk_bytes: Optional[int] = None,
             bits: Optional[int] = None) -> CompressedArray:
    """Compress one array (``chunk_bytes=None``: the default 128 KiB)."""
    if arr.dtype.itemsize == 8 and registry.get(codec).plane_decompose_64:
        # plane decomposition: lo/hi u32 planes keep runs intact
        as_u64 = arr.reshape(-1).view(np.uint64)
        lo = (as_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (as_u64 >> np.uint64(32)).astype(np.uint32)
        return CompressedArray(
            blobs=[enc.compress(lo, codec, chunk_bytes),
                   enc.compress(hi, codec, chunk_bytes)],
            orig_dtype=str(arr.dtype), orig_shape=tuple(arr.shape))
    return CompressedArray(blobs=[enc.compress(arr, codec, chunk_bytes, bits=bits)],
                           orig_dtype=str(arr.dtype), orig_shape=tuple(arr.shape))


def _combine(ca: CompressedArray, outs: List[np.ndarray]) -> np.ndarray:
    return fmt.combine_planes(outs, ca.orig_dtype, ca.orig_shape)


def _combine_device(ca: CompressedArray, outs: List,
                    transformed: bool) -> torch.Tensor:
    if transformed:
        # epilogue output: plane recombination over transformed values is
        # undefined — refuse rather than silently drop the hi plane
        if len(outs) != 1:
            raise ValueError(
                f"epilogue cannot be applied to a plane-decomposed "
                f"{ca.orig_dtype} array ({len(outs)} plane blobs): the "
                "transform runs per uint32 plane, so the 64-bit value "
                "cannot be recombined afterwards")
        return outs[0]
    return fmt.combine_planes_device(outs, ca.orig_dtype, ca.orig_shape)


def _engine(engine: Optional[CodagEngine], device) -> CodagEngine:
    if engine is None:
        return CodagEngine(EngineConfig(device=device or "cuda"))
    if device is not None and resolve_device(device) != engine.device:
        raise ValueError(f"device={device!r} but the engine decodes on "
                         f"{engine.device}")
    return engine


def decompress(ca: CompressedArray,
               engine: Optional[CodagEngine] = None,
               device_out: bool = False, *, device=None):
    """Decode one array: a numpy array, or a tensor with ``device_out``."""
    engine = _engine(engine, device)
    if device_out:
        return _combine_device(ca, [engine.decompress_device(b)
                                    for b in ca.blobs], transformed=False)
    return _combine(ca, [engine.decompress(b) for b in ca.blobs])


def compress_many(arrays: Sequence[np.ndarray],
                  codec: Union[str, Sequence[str]],
                  chunk_bytes: Optional[int] = None,
                  bits: Optional[int] = None) -> List[CompressedArray]:
    """Compress a list of arrays; ``codec`` may be one name or one per array."""
    codecs = [codec] * len(arrays) if isinstance(codec, str) else list(codec)
    if len(codecs) != len(arrays):
        raise ValueError(f"{len(codecs)} codecs for {len(arrays)} arrays")
    return [compress(a, c, chunk_bytes, bits=bits)
            for a, c in zip(arrays, codecs)]


def decompress_many(cas: Sequence[CompressedArray],
                    engine: Optional[CodagEngine] = None,
                    service=None, *, device_out: bool = False,
                    epilogue=None, epilogue_operands=None,
                    mesh=None, mesh_axis: Optional[str] = None,
                    out_shardings=None, device=None) -> List:
    """Batched decompress: every chunk of every array in one launch per
    (codec, width, chunk_elems, bits) group — the CODAG provisioning move —
    through one ``core.plan.DecodePlan``.

    ``device_out=True`` returns tensors on the engine's device: decode,
    per-blob scatter, 64-bit plane recombination and the optional
    ``epilogue`` (a ``kernels.harness.Epilogue``) all run there.  Without
    it, each group's table is copied to the host once and numpy arrays come
    back.  ``device`` picks the device when no ``engine`` is given
    (default ``"cuda"``).

    The decode service (``service=``) and the mesh executor (``mesh=``,
    ``out_shardings=``) are not ported yet.  Outputs follow input order.
    """
    if service is not None:
        raise NotImplementedError(
            "service= is not ported yet (ROADMAP.md Queue 1 item 8); "
            "pass engine= or device=")
    if mesh is not None or mesh_axis is not None or out_shardings is not None:
        raise NotImplementedError(
            "mesh=/mesh_axis=/out_shardings= are not ported yet (ROADMAP.md "
            "Queue 1 item 11)")
    if epilogue is not None and not device_out:
        raise ValueError("epilogue requires device_out=True: a fused "
                         "epilogue's output has no host reassembly path")
    engine = _engine(engine, device)
    if not cas:
        return []
    flat: List[fmt.CompressedBlob] = []
    spans: List[tuple] = []   # (start, count) into flat, per array
    for ca in cas:
        spans.append((len(flat), len(ca.blobs)))
        flat.extend(ca.blobs)
    plan = plan_mod.DecodePlan.build(flat)
    if device_out:
        outs = plan.execute_device(engine, epilogue=epilogue,
                                   epilogue_operands=epilogue_operands)
        return [_combine_device(ca, outs[s:s + n], epilogue is not None)
                for ca, (s, n) in zip(cas, spans)]
    outs = plan.execute(engine)
    return [_combine(ca, outs[s:s + n]) for ca, (s, n) in zip(cas, spans)]
