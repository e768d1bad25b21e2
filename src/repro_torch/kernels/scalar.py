"""The single-thread decode kernel (§V-E ablation): binding, launches, twins.

``EngineConfig(all_thread=False)`` dispatches through the ``scalar``
backend: in the reference, ``jax.vmap`` of each codec's ``body_scalar``
(``src/repro/kernels/harness.py:345-355``), one chunk a vector lane and one
element a loop step.  On a card this module launches
``csrc/scalar_decode.cu``, one thread a chunk writing one element of its
row a step (see the note at the top of the source); on a CPU tensor, and
only there, each wrapper runs the codec's plain scalar body, which is also
what the kernel is held against on the card:

  * :func:`decode_rle` — rle_v1, rle_v2, dbp (``harness.scalar_chunk``);
  * :func:`decode_tdeflate` — ``tdeflate.decode_scalar``;
  * :func:`decode_lzss` — ``lzss.decode_scalar``;
  * :func:`decode_huffman` — ``huffman.decode_scalar``;
  * :func:`decode_bitpack` — ``bitpack.unpack_scalar``.

The kernel stores the raw elements; an epilogue follows as
``Epilogue.apply`` (``harness.run``), as the reference applies it after its
``vmap``.  ``cuda_build`` compiles the source at first use; importing this
module builds nothing.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import registry
from repro_torch.kernels import cuda_build, harness

LIB = cuda_build.KernelLibrary(
    "scalar_decode.cu", "codag_scalar_rle",
    # (codec id, width, comp, C, out_lens, n, chunk_elems, out, threads,
    #  stream)
    "iiplpllpip")
# (words, n, W, lsym, lbits, dsym, dbits, len_extra, len_base, dist_extra,
#  dist_base, out_lens, chunk_elems, out, threads, stream)
TDEFLATE = LIB.entry_point("codag_scalar_tdeflate", "pllppppppppplpip")
# (width, comp, n, C, out_lens, chunk_elems, out, threads, stream)
LZSS = LIB.entry_point("codag_scalar_lzss", "ipllplpip")
# (comp, n, C, words, W, hsym, hbits, out_lens, chunk_elems, out, threads,
#  stream)
HUFFMAN = LIB.entry_point("codag_scalar_huffman", "pllplppplpip")
# (width, words, n, W, out_lens, chunk_elems, bits, out, threads, stream)
BITPACK = LIB.entry_point("codag_scalar_bitpack", "ipllplipip")

RLE_IDS = {"rle_v1": 0, "rle_v2": 1, "dbp": 2}
MAX_THREADS = 32       # chunks (threads) a CTA, at most

# Kernel launches (one per call that reached the card), in total and by codec.
LAUNCHES = 0
CODEC_LAUNCHES = {name: 0 for name in (*RLE_IDS, "tdeflate", "lzss",
                                        "huffman", "bitpack")}


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def block_threads(n: int, sms: int) -> int:
    """Threads (chunks) a CTA for ``n`` chunks on ``sms`` SMs: enough CTAs
    to reach every SM, ceil(n / sms) rounded up to a power of two, at most
    :data:`MAX_THREADS` (2,048 chunks on 132 SMs: 128 CTAs of 16)."""
    per = max(1, -(-n // max(1, sms)))
    return min(MAX_THREADS, 1 << (per - 1).bit_length())


def _check_table(name: str, t: torch.Tensor, dtype, n: int) -> None:
    if t.dtype != dtype or t.dim() != 2 or t.shape[0] != n or t.shape[1] < 1:
        raise ValueError(f"{name} must be an ({n}, >=1) {dtype} table, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _check(out_lens: torch.Tensor, n: int, chunk_elems: int, operands,
           device) -> None:
    if chunk_elems < 1:
        raise ValueError(f"chunk_elems must be positive, got {chunk_elems}")
    if out_lens.dtype != torch.int32 or tuple(out_lens.shape) != (n,):
        raise ValueError(f"out_lens must be ({n},) int32, got "
                         f"{tuple(out_lens.shape)} {out_lens.dtype}")
    if not all(t.is_contiguous() for t in (*operands, out_lens)):
        raise ValueError("the scalar kernel's operands must be contiguous")
    if any(t.device != device for t in (*operands, out_lens)):
        raise ValueError("the scalar kernel's operands must share one device")


def _launch(codec: str, entry, device, n: int, chunk_elems: int, dtype,
            args) -> torch.Tensor:
    """Allocate the output, launch one entry over ``n`` rows on the
    device's current stream (``cuda_build.launch_on`` raises where the
    device is not a card), count it."""
    global LAUNCHES
    out = torch.empty((n, chunk_elems), dtype=dtype, device=device)
    if n == 0:
        return out
    threads = block_threads(n, _sms(device))
    cuda_build.launch_on(device, entry, *args(out), threads)
    LAUNCHES += 1
    CODEC_LAUNCHES[codec] += 1
    return out


def decode_rle(codec: str, comp: torch.Tensor, out_lens: torch.Tensor, *,
               chunk_elems: int, width: int) -> torch.Tensor:
    """rle_v1 / rle_v2 / dbp, one thread a row: ``(n, chunk_elems)`` in the
    width type."""
    if codec not in RLE_IDS:
        raise ValueError(f"no single-thread RLE kernel for codec {codec!r}")
    if width not in harness.DEV_DTYPE:
        raise ValueError(f"unsupported width {width}")
    n = comp.shape[0] if comp.dim() == 2 else -1
    _check_table("comp", comp, torch.uint8, n)
    _check(out_lens, n, chunk_elems, (comp,), comp.device)
    if comp.device.type == "cpu":
        return harness.scalar_chunk(registry.get(codec).decode.two_phase,
                                    comp, out_lens, chunk_elems, width)
    return _launch(codec, LIB, comp.device, n, chunk_elems,
                   harness.DEV_DTYPE[width], lambda out: (
                       RLE_IDS[codec], width, comp.data_ptr(), comp.shape[1],
                       out_lens.data_ptr(), n, chunk_elems, out.data_ptr()))


def decode_tdeflate(words: torch.Tensor, luts, tables,
                    out_lens: torch.Tensor, *,
                    chunk_elems: int) -> torch.Tensor:
    """tdeflate, one thread a row: ``(n, chunk_elems)`` uint8.  ``luts``
    are the four staged LUTs, ``tables`` the four int32 deflate tables."""
    from repro_torch.kernels import tdeflate
    luts, tables = tuple(luts), tuple(tables)
    tdeflate._check(words, luts, tables, out_lens, chunk_elems, 1)
    if words.device.type == "cpu":
        return tdeflate.decode_scalar(words, luts, out_lens, chunk_elems,
                                      tables)
    n = words.shape[0]
    return _launch("tdeflate", TDEFLATE, words.device, n, chunk_elems,
                   torch.uint8, lambda out: (
                       words.data_ptr(), n, words.shape[1],
                       *(t.data_ptr() for t in luts),
                       *(t.data_ptr() for t in tables), out_lens.data_ptr(),
                       chunk_elems, out.data_ptr()))


def decode_lzss(comp: torch.Tensor, out_lens: torch.Tensor, *,
                chunk_elems: int, width: int) -> torch.Tensor:
    """lzss, one thread a row: ``(n, chunk_elems)`` in the width type."""
    from repro_torch.kernels import lzss
    if width not in harness.DEV_DTYPE:
        raise ValueError(f"unsupported width {width}")
    n = comp.shape[0] if comp.dim() == 2 else -1
    _check_table("comp", comp, torch.uint8, n)
    _check(out_lens, n, chunk_elems, (comp,), comp.device)
    if comp.device.type == "cpu":
        return lzss.decode_scalar(comp, out_lens, chunk_elems=chunk_elems,
                                  width=width)
    return _launch("lzss", LZSS, comp.device, n, chunk_elems,
                   harness.DEV_DTYPE[width], lambda out: (
                       width, comp.data_ptr(), n, comp.shape[1],
                       out_lens.data_ptr(), chunk_elems, out.data_ptr()))


def decode_huffman(comp: torch.Tensor, words: torch.Tensor,
                   lut_sym: torch.Tensor, lut_bits: torch.Tensor,
                   out_lens: torch.Tensor, *,
                   chunk_elems: int) -> torch.Tensor:
    """huffman, one thread a row: ``(n, chunk_elems)`` uint8."""
    from repro_torch.core import encoders as enc
    from repro_torch.kernels import huffman
    n = comp.shape[0] if comp.dim() == 2 else -1
    _check_table("comp", comp, torch.uint8, n)
    _check_table("words", words, torch.uint32, n)
    for name, t, dt in (("lut_hsym", lut_sym, torch.int16),
                        ("lut_hbits", lut_bits, torch.int8)):
        if t.dtype != dt or tuple(t.shape) != (n, enc.LUT_SIZE):
            raise ValueError(f"{name} must be ({n}, {enc.LUT_SIZE}) {dt}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    _check(out_lens, n, chunk_elems, (comp, words, lut_sym, lut_bits),
           comp.device)
    if comp.device.type == "cpu":
        return huffman.decode_scalar(comp, words, lut_sym, lut_bits,
                                     out_lens, chunk_elems=chunk_elems)
    return _launch("huffman", HUFFMAN, comp.device, n, chunk_elems,
                   torch.uint8, lambda out: (
                       comp.data_ptr(), n, comp.shape[1], words.data_ptr(),
                       words.shape[1], lut_sym.data_ptr(),
                       lut_bits.data_ptr(), out_lens.data_ptr(), chunk_elems,
                       out.data_ptr()))


def decode_bitpack(words: torch.Tensor, out_lens: torch.Tensor, *,
                   chunk_elems: int, width: int, bits: int) -> torch.Tensor:
    """bitpack, one thread a row: ``(n, chunk_elems)`` in the width type,
    zero at or past ``out_len``."""
    from repro_torch.kernels import bitpack
    bitpack._check(words, chunk_elems, width, bits)
    n = words.shape[0]
    _check(out_lens, n, chunk_elems, (words,), words.device)
    if words.device.type == "cpu":
        return bitpack.unpack_scalar(words, out_lens, chunk_elems=chunk_elems,
                                     width=width, bits=bits)
    return _launch("bitpack", BITPACK, words.device, n, chunk_elems,
                   harness.DEV_DTYPE[width], lambda out: (
                       width, words.data_ptr(), n, words.shape[1],
                       out_lens.data_ptr(), chunk_elems, bits,
                       out.data_ptr()))
