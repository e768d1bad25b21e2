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
from typing import Dict, Iterator, Optional

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
    From a card the copy is queued on the tensor's current stream and waited
    for by an event, not by a stream synchronisation, so a decode thread
    (the service's worker) may materialize while another thread holds
    :func:`no_host_transfers`, whose sync-debug mode catches only
    synchronising calls.
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
    x = x.detach()
    if x.device.type != "cuda":
        return x.cpu().numpy()
    out = torch.empty(x.shape, dtype=x.dtype)
    out.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(x.device))
    done.synchronize()
    return out.numpy()


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def to_device(x, device, rows: Optional[int] = None,
              cols: Optional[int] = None) -> torch.Tensor:
    """Stage a host array (or numpy scalar) on ``device`` (the ONE
    sanctioned h2d path).  Counted, never forbidden: staging is how data
    legitimately reaches the device.  Tensors pass through, moved to
    ``device`` if they live elsewhere.

    ``rows`` / ``cols``: stage the array zero-padded at the end of its
    first axis to ``rows`` and (2-D only) on the right to ``cols``; the
    array is copied once, straight into the staging buffer, and only the
    padding is zeroed.  To a card the array goes through pinned host memory
    (torch's caching host allocator) and a ``non_blocking`` copy on the
    device's current stream; the allocator records the copy on the buffer
    and reuses it only once the copy has completed, so the buffer may be
    dropped at once.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    device = torch.device(device)
    if cols is not None and (a.ndim != 2 or cols < a.shape[1]):
        raise ValueError(f"cannot pad a {a.shape} array to {cols} columns")
    if rows is not None and (a.ndim == 0 or rows < a.shape[0]):
        raise ValueError(f"cannot pad a {a.shape} array to {rows} rows")
    shape = list(a.shape)
    if rows is not None:
        shape[0] = int(rows)
    if cols is not None:
        shape[1] = int(cols)
    shape = tuple(shape)
    _count(h2d=1, h2d_bytes=int(np.prod(shape)) * a.itemsize)
    if device.type == "cuda":
        buf = torch.empty(shape, dtype=_torch_dtype(a.dtype),
                          pin_memory=True)
        host = buf.numpy()
    elif shape != a.shape or not (a.flags.c_contiguous
                                  and a.flags.writeable):
        host = np.empty(shape, a.dtype)
        buf = torch.from_numpy(host)
    else:
        return torch.from_numpy(a).to(device)
    if shape == a.shape:
        np.copyto(host, a)
    else:
        n = a.shape[0]
        np.copyto(host[:n, :a.shape[1]] if cols is not None else host[:n], a)
        host[n:] = 0
        if cols is not None:
            host[:n, a.shape[1]:] = 0
    return buf.to(device, non_blocking=True)


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
