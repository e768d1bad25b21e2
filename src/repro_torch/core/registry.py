"""Codec plugin registry (paper §IV-A's framework claim).

A codec declares everything the rest of the system needs in one
:class:`Codec`: its host encoder, its ``kernels.harness.DecodeSpec`` (the
decode backends), and the layout facts the format and the plan consult.
Nothing else in the package names a codec.

``_PLUGINS`` lists the reference package's seven codecs; a plugin module
registers its ``Codec`` on import.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


def _no_bits(blob: Any) -> int:
    return 0


@dataclasses.dataclass(frozen=True)
class Codec:
    """Everything one codec contributes to the framework."""

    name: str
    # (arr, chunk_bytes, *, bits=None) -> format.CompressedBlob
    encode: Callable[..., Any]
    # kernels.harness.DecodeSpec (opaque here: core must not import kernels)
    decode: Any
    needs_words: bool = False       # device layout carries a u32 word view
    # extras keys shared across a batch group (others stack row-wise)
    shared_extras: Tuple[str, ...] = ()
    # consumes raw bytes: a caller may view any dtype as uint8 to encode it
    byte_stream: bool = False
    plane_decompose_64: bool = False  # split 8-byte dtypes into u32 planes
    static_bits: Callable[[Any], int] = _no_bits   # part of the group key
    # (n_elems, rng) -> np.ndarray of compressible data the codec is made
    # for (the autotuner's workload)
    demo_data: Optional[Callable[[int, Any], np.ndarray]] = None


_REGISTRY: Dict[str, Codec] = {}

# Built-in plugin modules; each registers its Codec on import.
_PLUGINS: Dict[str, str] = {
    "rle_v1": "repro_torch.kernels.rle_v1",
    "rle_v2": "repro_torch.kernels.rle_v2",
    "tdeflate": "repro_torch.kernels.tdeflate",
    "bitpack": "repro_torch.kernels.bitpack",
    "dbp": "repro_torch.kernels.dbp",
    "huffman": "repro_torch.kernels.huffman",
    "lzss": "repro_torch.kernels.lzss",
}


def register(codec: Codec) -> Codec:
    """Register (or replace) a codec. Returns it, so plugins can keep a ref."""
    _REGISTRY[codec.name] = codec
    return codec


def get(name: str) -> Codec:
    """Look up a codec, lazily importing its built-in plugin module."""
    codec = _REGISTRY.get(name)
    if codec is None and name in _PLUGINS:
        importlib.import_module(_PLUGINS[name])
        codec = _REGISTRY.get(name)
    if codec is None:
        raise ValueError(
            f"unknown codec {name!r}; registered: "
            f"{sorted(set(_REGISTRY) | set(_PLUGINS))}")
    return codec


def names() -> Tuple[str, ...]:
    """Every registered codec name (the built-in plugins loaded first)."""
    for name in _PLUGINS:
        if name not in _REGISTRY:
            importlib.import_module(_PLUGINS[name])
    return tuple(_REGISTRY)
