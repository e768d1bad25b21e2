"""Codec plugin registry (paper §IV-A's framework claim).

A codec declares everything the rest of the system needs in one
:class:`Codec`: its host encoder, its ``kernels.harness.DecodeSpec`` (the
decode backends), and the layout facts the format and the plan consult.
Nothing else in the package names a codec.

Only the codecs whose decode kernels have been ported are listed in
``_PLUGINS``; the others of the reference package raise with the ROADMAP
item that ports them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Tuple


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
    plane_decompose_64: bool = False  # split 8-byte dtypes into u32 planes
    static_bits: Callable[[Any], int] = _no_bits   # part of the group key


_REGISTRY: Dict[str, Codec] = {}

# Built-in plugin modules; each registers its Codec on import.
_PLUGINS: Dict[str, str] = {
    "rle_v1": "repro_torch.kernels.rle_v1",
    "rle_v2": "repro_torch.kernels.rle_v2",
}

# Codecs of the reference package whose kernels are not ported yet.
_NOT_PORTED = ("tdeflate", "bitpack", "dbp", "huffman", "lzss")


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
        where = (" (not ported yet: ROADMAP.md Queue 1 item 6 and Queue 2)"
                 if name in _NOT_PORTED else "")
        raise ValueError(
            f"unknown codec {name!r}{where}; registered: "
            f"{sorted(set(_REGISTRY) | set(_PLUGINS))}")
    return codec
