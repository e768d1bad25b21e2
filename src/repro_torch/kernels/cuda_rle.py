"""The Hopper kernel for RLE v1 / v2: build, binding, launch count, plain twin.

``csrc/two_phase_rle.cu`` replaces the TPU kernel ``harness._generic_pallas``
with the ``two_phase_chunk`` body and the rle SPECs (see the note at the top
of the source).  It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point, at first use, into ``build/repro_torch/``
of the checkout (named by a hash of the source and flags, so an edited
source rebuilds), and bound with ``ctypes``.  Nothing here runs ``nvcc`` or
touches CUDA at import time, so the package imports on CPU-only torch.

:func:`decode` is the wrapper: on a CUDA tensor it launches the kernel on
the current stream (or raises); on a CPU tensor it runs :func:`plain`, the
harness's ``torch`` two-phase body, which is also what the kernel is held
against on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.core import registry
from repro_torch.kernels import harness

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "two_phase_rle.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CODEC_IDS = {"rle_v1": 0, "rle_v2": 1}

# Kernel launches (one per call that reached the card), in total and by codec.
LAUNCHES = 0
CODEC_LAUNCHES = {name: 0 for name in CODEC_IDS}
# the compiler's report of the last build (ptxas registers / spills)
BUILD_LOG = ""

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernel is built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def build() -> Path:
    """Compile the kernel library if this source and flags have no build
    yet; returns its path."""
    global BUILD_LOG
    tag = hashlib.blake2b(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode(),
                          digest_size=8).hexdigest()
    lib = BUILD_DIR / f"two_phase_rle_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
    BUILD_LOG = proc.stdout + proc.stderr
    os.replace(tmp, lib)
    return lib


def _entry():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.codag_two_phase_rle
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib.codag_two_phase_rle


def _check(codec: str, comp: torch.Tensor, out_lens: torch.Tensor,
           chunk_elems: int, width: int) -> None:
    if codec not in CODEC_IDS:
        raise ValueError(f"no RLE kernel for codec {codec!r}")
    if width not in harness.DEV_DTYPE:
        raise ValueError(f"unsupported width {width}")
    if chunk_elems < 1:
        raise ValueError(f"chunk_elems must be positive, got {chunk_elems}")
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
        raise ValueError(f"comp must be a (n, C>=1) uint8 table, got "
                         f"{tuple(comp.shape)} {comp.dtype}")
    if out_lens.dtype != torch.int32 or out_lens.shape != (comp.shape[0],):
        raise ValueError(f"out_lens must be ({comp.shape[0]},) int32, got "
                         f"{tuple(out_lens.shape)} {out_lens.dtype}")
    if not (comp.is_contiguous() and out_lens.is_contiguous()):
        raise ValueError("comp and out_lens must be contiguous")
    if comp.device != out_lens.device:
        raise ValueError(f"comp on {comp.device}, out_lens on "
                         f"{out_lens.device}")


def plain(codec: str, comp: torch.Tensor, out_lens: torch.Tensor, *,
          chunk_elems: int, width: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: the two-phase torch body."""
    spec = registry.get(codec).decode.two_phase
    return harness.two_phase_chunk(spec, comp, out_lens, chunk_elems, width)


def decode(codec: str, comp: torch.Tensor, out_lens: torch.Tensor, *,
           chunk_elems: int, width: int) -> torch.Tensor:
    """Decode every row of a chunk table; ``(n, chunk_elems)`` in the width
    type, on the tables' device."""
    global LAUNCHES
    _check(codec, comp, out_lens, chunk_elems, width)
    if comp.device.type == "cpu":
        return plain(codec, comp, out_lens, chunk_elems=chunk_elems,
                     width=width)
    if comp.device.type != "cuda":
        raise ValueError(f"no kernel for device {comp.device}")
    n = comp.shape[0]
    out = torch.empty((n, chunk_elems), dtype=harness.DEV_DTYPE[width],
                      device=comp.device)
    if n == 0:
        return out
    fn = _entry()
    spec = registry.get(codec).decode.two_phase
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(CODEC_IDS[codec], width, comp.data_ptr(), comp.shape[1],
                 out_lens.data_ptr(), n, chunk_elems,
                 spec.max_groups(chunk_elems), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"two_phase_rle launch failed: CUDA error {err}")
    LAUNCHES += 1
    CODEC_LAUNCHES[codec] += 1
    return out
