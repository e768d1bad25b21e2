"""Build and bind the port's CUDA sources (``csrc/*.cu``).

Every source is compiled the same way: ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, at first use, into
``build/repro_torch/`` of the checkout (:data:`BUILD_DIR`;
``core.tuning.enable_compile_cache`` points it elsewhere), named by a hash
of the source, the headers it includes from ``csrc/`` and the flags (an
edited source or header rebuilds), then bound with ``ctypes``.  A source
may add flags of its own to :data:`NVCC_FLAGS` (``-lcuda`` for one that
calls into libcuda) and export more than one entry point
(:meth:`KernelLibrary.entry_point`).  Nothing here runs ``nvcc`` or
touches CUDA at import time, so the package imports on CPU-only torch.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all
of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.roofline import count

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc processes this process has started (a build found in BUILD_DIR
# starts none)
NVCC_RUNS = 0

# ctypes argument kinds: "p" pointer (or stream), "i" int, "l" int64
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


class KernelEntry:
    """One C entry point of a :class:`KernelLibrary`: ``fn()`` binds it
    (building the library first if needed)."""

    def __init__(self, lib: "KernelLibrary", entry: str, argtypes: str):
        self.lib, self.source, self.entry = lib, lib.source, entry
        self.argtypes = [_CTYPES[k] for k in argtypes]
        self._fn = None

    @property
    def loaded(self) -> bool:
        return self._fn is not None

    def fn(self):
        if self._fn is not None:
            return self._fn
        with self.lib._lock:
            if self._fn is None:
                if self.lib._dll is None:
                    self.lib._dll = ctypes.CDLL(str(self.lib.build()))
                fn = getattr(self.lib._dll, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn


class KernelLibrary:
    """One ``csrc`` source, its build and its (first) C entry point;
    ``flags`` are added to :data:`NVCC_FLAGS` for this source alone."""

    def __init__(self, source: str, entry: str, argtypes: str,
                 flags: Sequence[str] = ()):
        self.source = CSRC / source
        self.flags = tuple(flags)
        self.build_log = ""        # ptxas report of this process's build
        self.build_seconds = 0.0   # its nvcc's wall time (``build_all``)
        self._dll = None
        self._lock = threading.Lock()
        self._main = KernelEntry(self, entry, argtypes)
        self.entry, self.argtypes = entry, self._main.argtypes

    def entry_point(self, entry: str, argtypes: str) -> KernelEntry:
        """Another C entry point of the same build."""
        return KernelEntry(self, entry, argtypes)

    @property
    def path(self) -> Path:
        text = self.source.read_bytes()
        headers = re.findall(rb'#include "([^"]+)"', text)
        tag = hashlib.blake2b(b"".join([text] + [(CSRC / h.decode())
                                                 .read_bytes()
                                                 for h in headers])
                              + " ".join(NVCC_FLAGS + self.flags).encode(),
                              digest_size=8).hexdigest()
        return BUILD_DIR / f"{self.source.stem}_{tag}.so"

    @property
    def loaded(self) -> bool:
        return self._dll is not None

    def _start(self) -> Optional[subprocess.Popen]:
        """Start nvcc unless this build exists; None if it does."""
        global NVCC_RUNS
        path = self.path
        if path.exists():
            return None
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source),
             *self.flags],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        NVCC_RUNS += 1
        return proc

    def _finish(self, proc: Optional[subprocess.Popen]) -> Path:
        if proc is None:
            return self.path
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{err}")
        self.build_log = out + err
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        path = tmp.with_name(tmp.name.rsplit(".", 2)[0])
        os.replace(tmp, path)
        return path

    def build(self) -> Path:
        """Compile the library if this source and flags have no build yet;
        returns its path."""
        return self._finish(self._start())

    def fn(self):
        """The bound C entry point (building the library first if needed)."""
        return self._main.fn()


def build_all(libs: Sequence[KernelLibrary]) -> List[Path]:
    """Build several libraries with one nvcc each, all started together;
    every nvcc has ended when this returns or raises the first failure.
    Each library's ``build_seconds`` is then its own nvcc's wall time (0
    for one already built)."""
    t0 = time.perf_counter()
    procs = [lib._start() for lib in libs]
    results: list = [None] * len(libs)

    def finish(i: int) -> None:
        try:
            results[i] = libs[i]._finish(procs[i])
        except RuntimeError as e:
            results[i] = e
        libs[i].build_seconds = (time.perf_counter() - t0
                                 if procs[i] is not None else 0.0)

    waiters = [threading.Thread(target=finish, args=(i,))
               for i in range(len(libs))]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for r in results:
        if isinstance(r, RuntimeError):
            raise r
    return results


def launch_on(device, lib, *args) -> None:
    """:func:`launch` on ``device`` (a CUDA ``torch.device``) and its current
    stream, which is passed as the last argument.  A decode or a serving
    step calls a wrapper per table or projection, so the device is switched
    only when it is not the current one and the stream is looked up without
    a ``Stream`` object (each costs microseconds of host time)."""
    import torch
    dev = device.index if device.index is not None else \
        torch.cuda.current_device()
    if dev == torch.cuda.current_device():
        launch(lib, *args, torch._C._cuda_getCurrentRawStream(dev))
        return
    with torch.cuda.device(dev):
        launch(lib, *args, torch._C._cuda_getCurrentRawStream(dev))


def launch(lib, *args) -> None:
    """Call a library's (or a :class:`KernelEntry`'s) entry point; raise on
    the CUDA error it returns.  Under ``roofline.count.count_costs`` it
    raises before the launch: the counter cannot see a ``ctypes`` call."""
    count.refuse_kernel(lib.entry)
    err = lib.fn()(*args)
    if err:
        raise RuntimeError(f"{lib.entry} launch failed: CUDA error {err}")
