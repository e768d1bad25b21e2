"""Host-transfer accounting: the device→host funnel and its guard.

Decompression throughput is gated by moving the uncompressed output; a
decode path that round-trips through the host pays that twice.  Every
intentional device→host materialization in the package goes through
:func:`to_host`, and every host→device staging through :func:`to_device`,
so both can be counted (:func:`count_host_transfers`) and the first one
forbidden (:func:`no_host_transfers`).

:func:`no_host_transfers` also sets ``torch.cuda.set_sync_debug_mode("error")``
while a card is present, so any operation that would synchronise the host
with the card (``.item()``, ``.cpu()``, a pageable copy) raises even where it
bypasses the funnel.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator

import numpy as np
import torch

_tls = threading.local()          # per-thread disallow depth
_counters: list = []              # active counter dicts (all threads)
_counters_lock = threading.Lock()


def _count(**incs: int) -> None:
    with _counters_lock:
        for c in _counters:
            for k, v in incs.items():
                c[k] += v


def to_host(x) -> np.ndarray:
    """Materialize a tensor on the host (the ONE sanctioned d2h path).

    Raises ``RuntimeError`` inside :func:`no_host_transfers` on this thread.
    """
    if getattr(_tls, "disallow", 0):
        raise RuntimeError(
            "device->host transfer inside no_host_transfers(): a "
            "device-resident decode path materialized on the host. "
            "Use device_out=True end to end or move this call outside the "
            "guard.")
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    _count(d2h=1, bytes=x.numel() * x.element_size())
    return x.detach().cpu().numpy()


def to_device(x, device) -> torch.Tensor:
    """Stage a host array (or numpy scalar) on ``device`` (the ONE
    sanctioned h2d path).  Counted, never forbidden: staging is how data
    legitimately reaches the device.  Tensors pass through, moved to
    ``device`` if they live elsewhere."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    _count(h2d=1, h2d_bytes=int(a.nbytes))
    return torch.from_numpy(a).to(device)


@contextlib.contextmanager
def no_host_transfers() -> Iterator[None]:
    """Forbid host materialization on this thread for the duration.

    Reentrant and thread-local for the funnel.  With a card present the
    CUDA sync-debug mode is ``"error"`` inside the guard (a process-wide
    setting, restored on exit).
    """
    prev = getattr(_tls, "disallow", 0)
    _tls.disallow = prev + 1
    cuda = torch.cuda.is_available()
    mode = torch.cuda.get_sync_debug_mode() if cuda else 0
    try:
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        yield
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(mode)
        _tls.disallow = prev


@contextlib.contextmanager
def count_host_transfers() -> Iterator[Dict[str, int]]:
    """Count funnel crossings (all threads) while the context is open.
    Yields ``{"d2h": calls, "bytes": d2h bytes, "h2d": stagings,
    "h2d_bytes": staged bytes}``."""
    c = {"d2h": 0, "bytes": 0, "h2d": 0, "h2d_bytes": 0}
    with _counters_lock:
        _counters.append(c)
    try:
        yield c
    finally:
        # remove by identity: two open contexts may hold equal-valued dicts
        with _counters_lock:
            for i, cur in enumerate(_counters):
                if cur is c:
                    del _counters[i]
                    break
