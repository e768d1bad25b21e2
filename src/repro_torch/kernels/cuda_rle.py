"""The Hopper kernel for RLE v1 / v2 and dbp: binding, launches, plain twin.

``csrc/two_phase_rle.cu`` replaces the TPU kernel ``harness._generic_pallas``
with the ``two_phase_chunk`` body and the rle_v1, rle_v2 and dbp SPECs (see
the note at the top of the source).  It runs the reference's two phases at
warp scale: one warp a chunk stages its compressed row through a 4 KiB
shared-memory ring, parses 32 group headers a batch (lane t keeps group t),
then expands the batch with all 32 lanes, each element finding its group
among the batch's 32 starts.  The last group the ``max_groups`` cap admits
covers every lane up to ``out_len``, as the reference's lane->group map
does; every byte read clips to the row's last byte.  ``cuda_build``
compiles it at first use and binds it with ``ctypes``.

:func:`decode` is the wrapper: on a CUDA tensor it launches the kernel on
the current stream (or raises); on a CPU tensor it runs :func:`plain`, the
harness's ``torch`` two-phase body, which is also what the kernel is held
against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import registry
from repro_torch.kernels import cuda_build, harness

# (codec id, width, comp, C, out_lens, n, chunk_elems, max_groups, out,
#  groups, stream)
LIB = cuda_build.KernelLibrary(
    "two_phase_rle.cu", "codag_two_phase_rle", "iiplplllppp")
CODEC_IDS = {"rle_v1": 0, "rle_v2": 1, "dbp": 2}

# Kernel launches (one per call that reached the card), in total and by codec.
LAUNCHES = 0
CODEC_LAUNCHES = {name: 0 for name in CODEC_IDS}


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
           chunk_elems: int, width: int,
           groups: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode every row of a chunk table; ``(n, chunk_elems)`` in the width
    type, on the tables' device.  On a CUDA tensor, ``groups`` (an ``(n,)``
    int32 tensor), if given, receives each row's group count."""
    global LAUNCHES
    _check(codec, comp, out_lens, chunk_elems, width)
    if comp.device.type == "cpu":
        return plain(codec, comp, out_lens, chunk_elems=chunk_elems,
                     width=width)
    if comp.device.type != "cuda":
        raise ValueError(f"no kernel for device {comp.device}")
    n = comp.shape[0]
    if groups is not None and (groups.dtype != torch.int32
                               or tuple(groups.shape) != (n,)
                               or groups.device != comp.device):
        raise ValueError(f"groups must be ({n},) int32 on {comp.device}")
    out = torch.empty((n, chunk_elems), dtype=harness.DEV_DTYPE[width],
                      device=comp.device)
    if n == 0:
        return out
    spec = registry.get(codec).decode.two_phase
    with torch.cuda.device(comp.device):
        cuda_build.launch(LIB, CODEC_IDS[codec], width, comp.data_ptr(),
                          comp.shape[1], out_lens.data_ptr(), n, chunk_elems,
                          spec.max_groups(chunk_elems), out.data_ptr(),
                          None if groups is None else groups.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    CODEC_LAUNCHES[codec] += 1
    return out
