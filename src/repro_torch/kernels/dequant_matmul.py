"""Fused int8-dequant matmul and its device-resident consumer.

The counterpart of ``repro/kernels/dequant_matmul.py``: ``y = x @ (q * s)``
with int8 weights ``q`` (K, N) and per-output-channel float32 scales ``s``
(1, N), the compute hot spot of quantized serving.  Fusing the dequant into
the matmul means the memory system reads one byte per weight.

  * :func:`ref_dequant_matmul` — the plain version, in float32;
  * :func:`dequant_matmul` — launches ``csrc/dequant_matmul.cu`` on CUDA
    tensors (or raises) and runs :func:`ref_dequant_matmul` on CPU ones.
    bf16 activations whose strides TMA can describe take the tensor-core
    entry (``wgmma``), everything else the SIMT one; :func:`_launch_plan`
    chooses by dtype and shape alone;
  * :func:`compress_weights` / :func:`weight_epilogue` /
    :func:`decompress_dequant_matmul` — weights arrive compressed, are
    decoded and zero-point-corrected to int8 on the device (a fused decode
    ``Epilogue``), and feed the matmul with no host round trip; the staged
    plan is cached on the ``CompressedArray``, so the steady state runs
    under ``transfers.no_host_transfers()``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels import cuda_build

# SIMT entry: (dtype, x, q, s, y, M, N, K, stream); the tensor-core path
# builds its tensor maps with libcuda's cuTensorMapEncodeTiled, hence -lcuda
LIB = cuda_build.KernelLibrary(
    "dequant_matmul.cu", "codag_dequant_matmul", "ipppplllp",
    flags=("-lcuda",))
# tensor-core entry: (x, q, s, y, ws, M, N, K, bm, splits, stream)
WGMMA = LIB.entry_point("codag_dequant_matmul_wgmma", "pppppllliip")

# Kernel launches (one per call that reached the card), in all and by path.
LAUNCHES = 0
LAUNCHES_BY_PATH = {"wgmma": 0, "simt": 0}

SMS = 132                 # streaming multiprocessors of an H100 SXM
WG_BN, WG_BK = 128, 64    # weight columns and K of a tensor-core CTA's tile
WG_BMS = (8, 16, 32, 64)  # token tiles below 64 tokens; 128 above

_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}


def ref_dequant_matmul(x: torch.Tensor, q: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """Plain version: x (M,K) @ dequant(q (K,N), s (1,N)) -> (M,N) in
    x.dtype, computed in float32."""
    w = q.to(torch.float32) * s.to(torch.float32)
    return (x.to(torch.float32) @ w).to(x.dtype)


def _check(x, q, s) -> None:
    if x.dtype not in _DTYPE_ID or x.dim() != 2:
        raise ValueError(f"x must be (M, K) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[0] != x.shape[1]:
        raise ValueError(f"q must be ({x.shape[1]}, N) int8, got "
                         f"{tuple(q.shape)} {q.dtype}")
    if s.dtype != torch.float32 or tuple(s.shape) != (1, q.shape[1]):
        raise ValueError(f"s must be (1, {q.shape[1]}) float32, got "
                         f"{tuple(s.shape)} {s.dtype}")
    if not all(t.is_contiguous() for t in (x, q, s)):
        raise ValueError("dequant_matmul operands must be contiguous")
    if q.device != x.device or s.device != x.device:
        raise ValueError("dequant_matmul operands must share one device")


def _launch_plan(M: int, N: int, K: int, dtype) -> tuple:
    """``(path, bm, splits)`` of one call, from dtype and shape alone.

    ``"wgmma"`` for bf16 activations with ``K % 8 == 0`` and ``N % 16 ==
    0`` (TMA needs 16-byte row strides), else ``"simt"`` (``bm`` 0,
    ``splits`` 1).  ``bm`` is the tokens a CTA covers, the MMA's N: the
    least of 8/16/32/64 that holds M, else 128.  When the output tiles
    leave half the SMs or more idle (a decode batch), K is split until
    there are at least :data:`SMS` CTAs, or one K tile a split."""
    if dtype != torch.bfloat16 or K % 8 or N % 16:
        return "simt", 0, 1
    bm = next((b for b in WG_BMS if M <= b), 128)
    tiles = -(-N // WG_BN) * -(-M // bm)
    splits = 1
    if 2 * tiles <= SMS:
        splits = min(-(-K // WG_BK), -(-SMS // tiles))
    return "wgmma", bm, splits


_WORKSPACES: dict = {}


def _workspace(dev: int, stream: int, numel: int) -> torch.Tensor:
    """The split-K partial sums' float32 buffer of one (device, stream),
    kept and grown as needed: calls on one stream run in order, so each may
    reuse it."""
    ws = _WORKSPACES.get((dev, stream))
    if ws is None or ws.numel() < numel:
        ws = torch.empty(numel, dtype=torch.float32, device=f"cuda:{dev}")
        _WORKSPACES[dev, stream] = ws
    return ws


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                   bm: int = 128, bn: int = 128,
                   bk: int = 128) -> torch.Tensor:
    """x: (M,K) bf16/f32, q: (K,N) int8, s: (1,N) f32 -> (M,N) x.dtype.

    ``bm``/``bn``/``bk`` keep the reference's tiling contract: each
    dimension must divide by its tile (or be smaller than it).  The kernels
    tile as :func:`_launch_plan` says and mask any edge."""
    global LAUNCHES
    M, K = x.shape
    N = q.shape[1]
    bm_, bn_, bk_ = min(bm, M), min(bn, N), min(bk, K)
    if not (M % bm_ == 0 and N % bn_ == 0 and K % bk_ == 0):
        raise AssertionError((M, N, K))
    _check(x, q, s)
    if x.device.type == "cpu":
        return ref_dequant_matmul(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    path, bm_, splits = _launch_plan(M, N, K, x.dtype)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    # a serving step calls this per projection: the device switch and the
    # stream are looked up the cheap way (a Stream object costs microseconds)
    dev = x.device.index
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev)
        if path == "wgmma":
            ws = _workspace(dev, stream, splits * M * N) if splits > 1 \
                else None
            cuda_build.launch(WGMMA, x.data_ptr(), q.data_ptr(),
                              s.data_ptr(), y.data_ptr(),
                              None if ws is None else ws.data_ptr(), M, N, K,
                              bm_, splits, stream)
        else:
            cuda_build.launch(LIB, _DTYPE_ID[x.dtype], x.data_ptr(),
                              q.data_ptr(), s.data_ptr(), y.data_ptr(), M, N,
                              K, stream)
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    return y


# --------------------------------------------------------------------------
# Device-resident consumer: compressed weights in, activations out
# --------------------------------------------------------------------------


def compress_weights(q: np.ndarray, codec: str = "bitpack",
                     zero_point: int = 0, chunk_bytes: int = 64 * 1024):
    """Pack int8 weights for the device-resident matmul path: stores
    ``q + zero_point`` as uint8 (low-magnitude weights then pack at few bits
    with bitpack).  Returns the ``api.CompressedArray``; decode with the
    epilogue of :func:`weight_epilogue`."""
    from repro_torch.core import api
    if q.dtype != np.int8:
        raise ValueError(f"expected int8 weights, got {q.dtype}")
    stored = (q.astype(np.int16) + int(zero_point)).astype(np.uint8)
    return api.compress(stored, codec, chunk_bytes)


def weight_epilogue(zero_point: int = 0):
    """The fused decode epilogue matching :func:`compress_weights`: the
    stored uint8 back through the zero-point shift to int8, inside the decode
    dispatch (epilogue operand key ``"epi_zero"``)."""
    from repro_torch.kernels.harness import Epilogue
    return (Epilogue(out_dtype="int8", zero_key="epi_zero"),
            {"epi_zero": np.uint8(zero_point)})


def decode_weights(ca, *, zero_point: int = 0, engine=None) -> torch.Tensor:
    """The (K, N) int8 weights of ``ca`` on the engine's device, decoded
    through the plan staged and cached on ``ca`` (keyed by ``zero_point``):
    after the first call this performs no host transfer."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.engine import CodagEngine
    engine = engine or CodagEngine()
    cached = getattr(ca, "_dqm_plan", None)
    if cached is None or cached[2] != zero_point:
        plan = plan_mod.DecodePlan.build(list(ca.blobs)).stage(engine.device)
        cached = (plan, weight_epilogue(zero_point), zero_point)
        ca._dqm_plan = cached
    plan, (epi, operands), _ = cached
    [q] = plan.execute_device(engine, epilogue=epi,
                              epilogue_operands=operands)
    return q


def decompress_dequant_matmul(x: torch.Tensor, ca, s: torch.Tensor, *,
                              zero_point: int = 0, engine=None,
                              bm: int = 128, bn: int = 128,
                              bk: int = 128) -> torch.Tensor:
    """Compressed (K, N) int8 weights ``ca`` (from :func:`compress_weights`)
    decoded on the device, zero-point-corrected in the decode's epilogue,
    then consumed by :func:`dequant_matmul`: no uint intermediate and no
    host round trip.  Repeat calls over the same ``ca`` — the serving steady
    state — perform no host transfers."""
    q = decode_weights(ca, zero_point=zero_point, engine=engine)
    return dequant_matmul(x, q, s, bm=bm, bn=bn, bk=bk)

