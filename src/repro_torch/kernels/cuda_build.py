"""Build and bind the port's CUDA sources (``csrc/*.cu``).

Every source is compiled the same way: ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, at first use, into
``build/repro_torch/`` of the checkout, named by a hash of the source and
the flags (an edited source rebuilds), then bound with ``ctypes``.  A source
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
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
        self._dll = None
        self._lock = threading.Lock()
        self._main = KernelEntry(self, entry, argtypes)
        self.entry, self.argtypes = entry, self._main.argtypes

    def entry_point(self, entry: str, argtypes: str) -> KernelEntry:
        """Another C entry point of the same build."""
        return KernelEntry(self, entry, argtypes)

    @property
    def path(self) -> Path:
        tag = hashlib.blake2b(self.source.read_bytes()
                              + " ".join(NVCC_FLAGS + self.flags).encode(),
                              digest_size=8).hexdigest()
        return BUILD_DIR / f"{self.source.stem}_{tag}.so"

    @property
    def loaded(self) -> bool:
        return self._dll is not None

    def _start(self) -> Optional[subprocess.Popen]:
        """Start nvcc unless this build exists; None if it does."""
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(f"{self.path.name}.{os.getpid()}.tmp")
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source),
             *self.flags],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def _finish(self, proc: Optional[subprocess.Popen]) -> Path:
        if proc is not None:
            out, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {self.source.name}:\n"
                                   f"{err}")
            self.build_log = out + err
            os.replace(proc.args[proc.args.index("-o") + 1], self.path)
        return self.path

    def build(self) -> Path:
        """Compile the library if this source and flags have no build yet;
        returns its path."""
        return self._finish(self._start())

    def fn(self):
        """The bound C entry point (building the library first if needed)."""
        return self._main.fn()


def build_all(libs: Sequence[KernelLibrary]) -> List[Path]:
    """Build several libraries with one nvcc each, all started together."""
    procs = [lib._start() for lib in libs]
    return [lib._finish(p) for lib, p in zip(libs, procs)]


def launch(lib, *args) -> None:
    """Call a library's (or a :class:`KernelEntry`'s) entry point; raise on
    the CUDA error it returns."""
    err = lib.fn()(*args)
    if err:
        raise RuntimeError(f"{lib.entry} launch failed: CUDA error {err}")
