"""Public compress/decompress API.

    from repro_torch.core import api
    ca   = api.compress(arr, "rle_v2")              # host-side encode
    out  = api.decompress(ca)                       # decode on cuda, == arr

    cas  = api.compress_many(arrs, "rle_v2")        # list in, list out
    outs = api.decompress_many(cas, device_out=True)  # ONE launch per group
    outs = api.decompress_many(cas)                 # host arrays, through
                                                    # server.default_service()

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
    (codec, width, chunk_elems, bits) group — the CODAG provisioning move.

    With no ``engine`` and host output (``device_out=False``), or with an
    explicit ``service=``, the arrays go through ``service.decode_arrays``
    (default ``server.default_service(device)``): all blobs enter one
    micro-batch window atomically, the same one dispatch per group as the
    direct plan, plus coalescing with any other requests in flight.
    Otherwise one ``core.plan.DecodePlan`` runs on ``engine`` (or an engine
    on ``device``, default ``"cuda"``).

    ``device_out=True`` returns tensors on the engine's device: decode,
    per-blob scatter, 64-bit plane recombination and the optional
    ``epilogue`` (a ``kernels.harness.Epilogue``, plan path only) all run
    there.  The mesh executor (``mesh=``, ``out_shardings=``) is not ported
    yet.  Outputs follow input order.
    """
    if engine is not None and service is not None:
        raise ValueError("pass engine= OR service=, not both: the service "
                         "decodes on its own engine")
    if epilogue is not None and not device_out:
        raise ValueError("epilogue requires device_out=True: a fused "
                         "epilogue's output has no host reassembly path")
    if service is not None or (engine is None and not device_out):
        if epilogue is not None:
            raise ValueError("epilogue is not supported on the service "
                             "path; pass engine= (or no engine) with "
                             "device_out=True")
        if mesh is not None or out_shardings is not None:
            raise ValueError("mesh/out_shardings are not supported on the "
                             "service path; pass engine= (or no engine) "
                             "for the direct plan executors")
        if service is None:
            from repro_torch.core import server as server_mod
            service = server_mod.default_service(device)
        if not cas:
            return []
        return service.decode_arrays(cas, device_out=device_out)
    if mesh is not None or mesh_axis is not None or out_shardings is not None:
        raise NotImplementedError(
            "mesh=/mesh_axis=/out_shardings= are not ported yet (ROADMAP.md "
            "Queue 1 item 11)")
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
