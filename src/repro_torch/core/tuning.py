"""Per-(codec, width, device kind) tuned defaults, the kernels' compile
cache, and the offline autotuner.

The counterpart of ``repro/core/tuning.py``, with its names:

  * a committed tuned-defaults table (``tuned_defaults.json`` next to this
    module) keyed ``codec -> w<width> -> device_kind -> {knob: value}``.
    ``encoders.compress`` / ``api.compress`` (chunk geometry),
    ``format.bucket_shape`` / ``pad_table_to_bucket`` and the service
    (bucket floor), and ``plan.dispatch`` (kernel knobs) consult it
    whenever the caller did not pass the knob: explicit values always win,
    and a device kind with no row falls back to the hand-picked constants.
    The port's table holds the reference's ``cpu`` rows, copied, so a CPU
    caller writes the reference's blobs; a card has no row yet and keeps
    the 128 KiB chunk, as the reference's accelerator does.
  * :func:`enable_compile_cache` — where the CUDA kernels' libraries are
    built and found (``kernels/cuda_build.py`` names each by a hash of its
    sources and flags), the counterpart of jax's persistent compilation
    cache: a second process on the same directory runs no ``nvcc``.
  * :func:`autotune` — the offline search that writes a table for the
    current device kind from each codec's registry ``demo_data``.

Knobs (:data:`KNOWN_KNOBS`):

  chunk_bytes        encode time: uncompressed bytes a chunk (= a stream).
  bucket_cols_floor  serving time: the least pow2 column bucket of a fused
                     window table.
  <codec tunables>   launch-time values a codec's kernel wrapper takes
                     (``harness.Tunable`` on its ``DecodeSpec``).

Keys starting with ``_`` are provenance, never knobs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_TABLE_PATH = Path(__file__).with_name("tuned_defaults.json")

TABLE_VERSION = 1

# Knobs the framework owns; codecs add theirs through
# ``DecodeSpec.tunables``.  Both are resolved on host paths; every other
# knob is a kernel knob, passed to the dispatch as a ``tune`` tuple.
KNOWN_KNOBS = ("chunk_bytes", "bucket_cols_floor")
_HOST_KNOBS = frozenset(KNOWN_KNOBS)

# The compile cache's default directory: this env var, else
# ``~/.cache/repro-codag-torch`` (not the reference's variable: both
# packages may run in one process).
CACHE_DIR_ENV = "REPRO_TORCH_COMPILE_CACHE_DIR"

_lock = threading.Lock()
_table: Optional[Dict[str, Any]] = None
_table_path: Optional[Path] = None
_cache_enabled_at: Optional[Path] = None


# --------------------------------------------------------------------------
# device identity
# --------------------------------------------------------------------------


def normalize_kind(kind: str) -> str:
    """A device name as a table key (``NVIDIA H100 80GB HBM3`` ->
    ``nvidia-h100-80gb-hbm3``)."""
    return "-".join(str(kind).strip().lower().split())


@functools.lru_cache(maxsize=1)
def device_kind() -> str:
    """The normalized kind of the port's default device: the current card's
    name, or ``cpu`` without one."""
    if torch.cuda.is_available():
        return normalize_kind(torch.cuda.get_device_name())
    return "cpu"


# --------------------------------------------------------------------------
# table load / lookup
# --------------------------------------------------------------------------


def empty_table() -> Dict[str, Any]:
    return {"version": TABLE_VERSION, "codecs": {}}


def load_table(path: Optional[Path] = None) -> Dict[str, Any]:
    """Load a tuned-defaults table (a missing file is an empty table)."""
    p = Path(path) if path is not None else DEFAULT_TABLE_PATH
    if not p.exists():
        return empty_table()
    table = json.loads(p.read_text())
    if table.get("version") != TABLE_VERSION:
        raise ValueError(
            f"tuned-defaults table {p} has version {table.get('version')!r}, "
            f"expected {TABLE_VERSION}")
    return table


def save_table(table: Dict[str, Any], path: Optional[Path] = None) -> Path:
    """Write a table in the committed form (sorted keys, 2-space indent)."""
    p = Path(path) if path is not None else DEFAULT_TABLE_PATH
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n")
    return p


def _current_table() -> Dict[str, Any]:
    global _table
    with _lock:
        if _table is None:
            _table = load_table(_table_path)
        return _table


def _clear_caches() -> None:
    _lookup.cache_clear()
    _kernel_tune.cache_clear()


def set_table(table: Optional[Dict[str, Any]],
              path: Optional[Path] = None) -> None:
    """Install ``table`` as the active tuned defaults (None: load ``path``,
    or the committed file, at the next lookup)."""
    global _table, _table_path
    with _lock:
        _table = table
        _table_path = Path(path) if path is not None else None
    _clear_caches()


@contextlib.contextmanager
def override(table: Optional[Dict[str, Any]]):
    """Install a table for the block (None: no table at all)."""
    global _table, _table_path
    with _lock:
        prev, prev_path = _table, _table_path
    set_table(table if table is not None else empty_table())
    try:
        yield
    finally:
        with _lock:
            _table, _table_path = prev, prev_path
        _clear_caches()


@functools.lru_cache(maxsize=None)
def _lookup(codec: str, width: int, kind: str) -> Tuple[Tuple[str, Any], ...]:
    entry = (_current_table().get("codecs", {})
             .get(codec, {})
             .get(f"w{width}", {})
             .get(kind, {}))
    return tuple((k, v) for k, v in entry.items() if not k.startswith("_"))


def lookup(codec: str, width: int, kind: Optional[str] = None) -> dict:
    """Tuned knobs for ``(codec, width, kind)`` (default: :func:`device_kind`).

    ``{}`` — the hand-picked constants — wherever a level of the table is
    missing: the codec, an empty codec section, the width, or the kind.
    Provenance keys are left out.
    """
    kind = device_kind() if kind is None else kind
    return dict(_lookup(codec, int(width), normalize_kind(kind)))


def chunk_bytes_for(codec: str, width: int,
                    kind: Optional[str] = None) -> Optional[int]:
    """Tuned encode chunk size, or None (``format.DEFAULT_CHUNK_BYTES``)."""
    v = lookup(codec, width, kind).get("chunk_bytes")
    return int(v) if v is not None else None


def encode_width(codec_name: str, dtype) -> int:
    """The blob width a codec writes for arrays of ``dtype`` (the table's
    width key): a byte-stream codec always writes width 1; an 8-byte dtype
    is viewed or split into planes of width 4."""
    from repro_torch.core import registry
    if registry.get(codec_name).byte_stream:
        return 1
    w = np.dtype(dtype).itemsize
    return 4 if w == 8 else w


def bucket_cols_floor(codec: str, width: int,
                      kind: Optional[str] = None) -> Optional[int]:
    """Tuned pow2 column floor, or None (128)."""
    v = lookup(codec, width, kind).get("bucket_cols_floor")
    return int(v) if v is not None else None


@functools.lru_cache(maxsize=None)
def _kernel_tune(codec: str, width: int, explicit: Tuple[Tuple[str, Any], ...],
                 kind: str) -> Tuple[Tuple[str, Any], ...]:
    merged = {k: v for k, v in _lookup(codec, width, kind)
              if k not in _HOST_KNOBS}
    merged.update(dict(explicit))
    return tuple(sorted(merged.items()))


def kernel_tune(codec: str, width: int,
                explicit: Tuple[Tuple[str, Any], ...] = (),
                kind: Optional[str] = None) -> tuple:
    """The ``tune`` tuple of one decode dispatch: the table's kernel knobs
    (every knob that is not a host knob) with ``explicit``
    (``EngineConfig.tune``, or an ``ops.decode(tune=)`` caller) winning per
    knob; sorted ``((name, value), ...)``."""
    kind = device_kind() if kind is None else kind
    return _kernel_tune(codec, int(width), tuple(explicit),
                        normalize_kind(kind))


def merge_tables(base: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """``new`` merged into ``base`` at (codec, width, kind) granularity: a
    run on one device never overwrites another device's rows."""
    out = {"version": TABLE_VERSION,
           "codecs": {c: {w: dict(kinds) for w, kinds in ws.items()}
                      for c, ws in base.get("codecs", {}).items()}}
    for c, ws in new.get("codecs", {}).items():
        for w, kinds in ws.items():
            out["codecs"].setdefault(c, {}).setdefault(w, {}).update(kinds)
    return out


# --------------------------------------------------------------------------
# the kernels' compile cache
# --------------------------------------------------------------------------


def enable_compile_cache(path: Optional[os.PathLike] = None) -> Path:
    """Build and load every CUDA library from ``path`` from now on (default:
    the ``REPRO_TORCH_COMPILE_CACHE_DIR`` env var, else
    ``~/.cache/repro-codag-torch``).

    A library's file is named by a hash of its source, the headers it
    includes and its flags (``cuda_build.KernelLibrary.path``), so a second
    process that enables the same directory finds every build and runs no
    ``nvcc``.  A library already loaded in this process stays loaded.
    Idempotent; returns the directory.
    """
    global _cache_enabled_at
    from repro_torch.kernels import cuda_build
    if path is None:
        path = (os.environ.get(CACHE_DIR_ENV)
                or Path.home() / ".cache" / "repro-codag-torch")
    p = Path(path).expanduser().resolve()
    p.mkdir(parents=True, exist_ok=True)
    with _lock:
        if _cache_enabled_at != p:
            cuda_build.BUILD_DIR = p
            _cache_enabled_at = p
    return p


def compile_cache_dir() -> Optional[Path]:
    """The directory :func:`enable_compile_cache` installed, or None."""
    with _lock:
        return _cache_enabled_at


# --------------------------------------------------------------------------
# the offline autotuner
# --------------------------------------------------------------------------

# Candidate chunk sizes; the hand-picked default is always searched too.
SMOKE_CHUNK_BYTES = (4 * 1024, 16 * 1024, 64 * 1024)
FULL_CHUNK_BYTES = (4 * 1024, 16 * 1024, 64 * 1024, 256 * 1024)


def _median_seconds(fn, device: torch.device, iters: int,
                    warmup: int = 1) -> float:
    """Median seconds of ``fn()``: CUDA events on a card, the host clock
    on the CPU."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _measure(blob, engine, tune: Tuple[Tuple[str, Any], ...],
             iters: int) -> float:
    """Decoded MB/s of one blob's staged plan under one knob point."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.engine import CodagEngine
    plan = plan_mod.DecodePlan.build([blob]).stage(engine.device)
    if tune:
        cfg = engine.config
        engine = CodagEngine(dataclasses.replace(
            cfg, tune=tuple(sorted({**dict(cfg.tune), **dict(tune)}.items()))))
    t = _median_seconds(lambda: plan.execute_device(engine), engine.device,
                        iters)
    return blob.uncompressed_bytes / max(t, 1e-9) / 1e6


def _kernel_knob_space(codec, engine) -> Iterable[Tuple[Tuple[str, Any], ...]]:
    """The knob points of one codec: the launch's own choice ``()`` first,
    then every combination of the codec's ``DecodeSpec.tunables``.  The
    tunables are searched only where the kernels run (the ``cuda`` backend,
    all-thread, on a card): elsewhere they change nothing."""
    yield ()
    cfg = engine.config
    if not (cfg.backend == "cuda" and cfg.all_thread
            and engine.device.type == "cuda"):
        return
    axes = [[(t.name, c) for c in t.candidates]
            for t in getattr(codec.decode, "tunables", ())]
    if axes:
        yield from itertools.product(*axes)


def autotune(codecs: Optional[Sequence[str]] = None, *,
             size_mb: float = 0.25, smoke: bool = False,
             engine=None, iters: int = 3, seed: int = 0,
             chunk_bytes_candidates: Optional[Sequence[int]] = None,
             ) -> Tuple[Dict[str, Any], list]:
    """Search the knob space of each codec on the engine's device (default
    ``CodagEngine()``, the card).

    Returns ``(table, rows)``: a tuned-defaults table for this device kind
    (merge and save it with :func:`merge_tables` / :func:`save_table`) and
    ``(name, value, derived)`` rows of tuned against hand-picked MB/s.
    The hand-picked point is the default chunk size with the launch's own
    choice of every kernel knob.
    """
    from repro_torch.core import api, format as fmt, registry
    from repro_torch.core.engine import CodagEngine, EngineConfig

    engine = engine or CodagEngine(EngineConfig())
    kind = (device_kind() if engine.device.type == "cuda" else "cpu")
    if smoke:
        size_mb = min(size_mb, 0.05)
    cands = tuple(chunk_bytes_candidates
                  or (SMOKE_CHUNK_BYTES if smoke else FULL_CHUNK_BYTES))
    if fmt.DEFAULT_CHUNK_BYTES not in cands:
        cands = cands + (fmt.DEFAULT_CHUNK_BYTES,)

    table = empty_table()
    rows: list = []
    rng = np.random.default_rng(seed)
    names = list(codecs) if codecs else list(registry.names())
    for name in names:
        codec = registry.get(name)
        if codec.demo_data is None:
            continue
        n_elems = max(1024, int(size_mb * (1 << 20))
                      // (1 if codec.byte_stream else 4))
        arr = codec.demo_data(n_elems, rng)
        width = encode_width(name, arr.dtype)

        best: Dict[str, Any] = {}
        best_mbps = 0.0
        default_mbps = 0.0
        # explicit knobs only: the table must not leak into its own baseline
        with override(empty_table()):
            for cb in cands:
                blob = api.compress(arr, name, chunk_bytes=cb).blobs[0]
                for ktune in _kernel_knob_space(codec, engine):
                    mbps = _measure(blob, engine, ktune, iters)
                    if cb == fmt.DEFAULT_CHUNK_BYTES and not ktune:
                        default_mbps = mbps
                    if mbps > best_mbps:
                        best_mbps = mbps
                        best = {"chunk_bytes": int(cb), **dict(ktune)}
        entry = dict(best)
        entry["_tuned_MBps"] = round(best_mbps, 3)
        entry["_default_MBps"] = round(default_mbps, 3)
        entry["_size_mb"] = size_mb
        table["codecs"].setdefault(name, {})[f"w{width}"] = {kind: entry}
        speedup = best_mbps / max(default_mbps, 1e-9)
        rows += [
            (f"autotune/{name}/tuned_MBps", round(best_mbps, 3),
             f"knobs={best}"),
            (f"autotune/{name}/default_MBps", round(default_mbps, 3),
             f"chunk_bytes={fmt.DEFAULT_CHUNK_BYTES}"),
            (f"autotune/{name}/speedup", round(speedup, 3),
             "tuned vs hand-picked"),
            (f"autotune/{name}/chunk_bytes", int(best.get(
                "chunk_bytes", fmt.DEFAULT_CHUNK_BYTES)), ""),
        ]
    n_better = sum(1 for n, v, _ in rows
                   if n.endswith("/speedup") and v > 1.0)
    rows.append(("autotune/codecs_improved", n_better,
                 "codecs where tuned beats hand-picked"))
    return table, rows
