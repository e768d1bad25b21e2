"""Dispatch layer over the decode kernels.

Backends:
  "torch"  — the plain PyTorch bodies, the kernels' twins (counterpart of
             ``xla``).
  "cuda"   — the hand-written Hopper kernels (counterpart of ``pallas``).
  "oracle" — the sequential reference decoders.
  "scalar" — the single-thread-decoding §V-E ablation: one thread a chunk
             (``kernels/scalar.py``, ``csrc/scalar_decode.cu``).

Dispatch is pure registry lookup: ``registry.get(codec).decode`` is a
``kernels.harness.DecodeSpec``, so this module names no codec.  PyTorch runs
eagerly, so there is no ``jit`` layer: every :func:`decode` call is one
dispatch, and one launch on the ``cuda`` backend.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict

import torch

from repro_torch.core import format as fmt
from repro_torch.core import registry
from repro_torch.kernels import harness

BACKENDS = ("torch", "cuda", "oracle", "scalar")

# Dispatch observers (``count_dispatches``): nested/overlapping contexts each
# see every dispatch; registration and fan-out happen under one lock.
_observers: list = []
_observers_lock = threading.Lock()


def decode(dev: Dict[str, Any], *, codec: str, width: int, chunk_elems: int,
           backend: str = "cuda", bits: int = 0,
           epilogue=None, tune=None) -> torch.Tensor:
    """Decode every chunk; returns ``(num_chunks, chunk_elems)`` on the
    table's device.  ``epilogue`` overrides the codec's default one.

    ``tune``: sorted kernel-knob tuple (``core.tuning``); None resolves the
    tuned defaults for ``(codec, width)`` on the current device kind.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if tune is None:
        from repro_torch.core import tuning
        tune = tuning.kernel_tune(codec, width)
    with _observers_lock:
        if _observers:
            rec = {"num_chunks": int(dev["comp"].shape[0]), "codec": codec,
                   "width": width, "chunk_elems": chunk_elems,
                   "backend": backend, "bits": bits}
            for calls in _observers:
                calls.append(dict(rec))
    return harness.run(registry.get(codec).decode, dev, width=width,
                       chunk_elems=chunk_elems, backend=backend, bits=bits,
                       epilogue=epilogue, tune=tune)


@contextlib.contextmanager
def count_dispatches():
    """Observe :func:`decode` dispatches.  Yields a list that grows one
    entry per call, with the decode kwargs plus the table's chunk count."""
    calls: list = []
    with _observers_lock:
        _observers.append(calls)
    try:
        yield calls
    finally:
        with _observers_lock:
            for i, obs in enumerate(_observers):
                if obs is calls:
                    del _observers[i]
                    break


def table_inputs(table: fmt.CompressedBlob, device, *, rows=None,
                 pad_comp_to=None):
    """(device dict, static decode bits) for a blob / merged chunk table,
    staged on ``device`` through the ``transfers.to_device`` funnel
    (``rows`` / ``pad_comp_to``: ``format.to_device``'s padding)."""
    return (fmt.to_device(table, device, pad_comp_to=pad_comp_to, rows=rows),
            registry.get(table.codec).static_bits(table))
