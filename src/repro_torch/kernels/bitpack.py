"""bitpack codec plugin and its Hopper kernel's wrapper.

The counterpart of ``repro/kernels/bitpack.py``.  Element ``i`` sits at bit
``i*bits``, LSB first, in uint32 words, so every output element unpacks on
its own: a funnel of words ``w`` and ``w+1`` (each clipped to the row's last
word), then a mask.  ``bits`` (1..32) is static and part of the group key.

Backends (every body maps the word table to ``(n, chunk_elems)`` in the
width type):

  * ``torch``  — :func:`unpack`, the reference's ``unpack_tile`` over the
    whole table; the plain twin of the kernel;
  * ``oracle`` — :func:`unpack_oracle`, the counterpart of
    ``ref.unpack_bits`` (uint32 out, then cast);
  * ``scalar`` — one element per step (§V-E ablation, CPU tensors only);
  * ``cuda``   — :func:`decode`, which launches ``csrc/bitpack_unpack.cu``
    on a CUDA tensor (or raises) and runs :func:`unpack` on a CPU tensor.

As in the reference, lanes at or past ``out_len`` are not zeroed: they
unpack whatever bits lie there, which are the row's zero padding.
"""
from __future__ import annotations

import torch

from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core import registry
from repro_torch.core import streams as st
from repro_torch.kernels import cuda_build, harness

# (width, words, n, W, chunk_elems, bits, out, stream)
LIB = cuda_build.KernelLibrary(
    "bitpack_unpack.cu", "codag_bitpack_unpack", "iplllipp")

# Kernel launches (one per call that reached the card).
LAUNCHES = 0


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 32:
        raise ValueError(f"bitpack bits must be in 1..32, got {bits}")


def unpack_tile(words: torch.Tensor, start, n: int, bits: int) -> torch.Tensor:
    """Elements ``[start, start+n)`` of every row, as int64 in [0, 2^32);
    ``words`` is the int64 word table (``streams.words_int64``)."""
    idx = start + torch.arange(n, dtype=torch.int64, device=words.device)
    return st.peek_bits(words, (idx * bits).expand(words.shape[0], n), bits)


def unpack(words: torch.Tensor, *, chunk_elems: int, width: int,
           bits: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``unpack_tile`` over the whole
    table, cast to the width type."""
    _check_bits(bits)
    return harness.truncate(
        unpack_tile(st.words_int64(words), 0, chunk_elems, bits), width)


def unpack_oracle(words: torch.Tensor, *, chunk_elems: int, width: int,
                  bits: int) -> torch.Tensor:
    """Counterpart of ``ref.unpack_bits``: uint32 per element, then cast;
    here a tile of 4096 elements at a time."""
    _check_bits(bits)
    w64 = st.words_int64(words)
    return torch.cat(
        [harness.truncate(unpack_tile(w64, i, min(4096, chunk_elems - i),
                                       bits), width)
         for i in range(0, chunk_elems, 4096)], dim=1)


def unpack_scalar(words: torch.Tensor, out_lens: torch.Tensor, *,
                  chunk_elems: int, width: int, bits: int) -> torch.Tensor:
    """§V-E single-thread baseline: one element unpacked per step, up to
    ``out_len`` (the rest stay zero)."""
    _check_bits(bits)
    w64 = st.words_int64(words)
    n = words.shape[0]
    buf = torch.zeros((n, chunk_elems), dtype=torch.int64, device=words.device)
    out_len = out_lens.to(torch.int64)
    for i in range(int(out_len.max()) if n else 0):
        v = unpack_tile(w64, i, 1, bits)[:, 0]
        buf[:, i] = torch.where(out_len > i, v, buf[:, i])
    return harness.truncate(buf, width)


def _check(words: torch.Tensor, chunk_elems: int, width: int,
           bits: int) -> None:
    _check_bits(bits)
    if width not in harness.DEV_DTYPE:
        raise ValueError(f"unsupported width {width}")
    if chunk_elems < 1:
        raise ValueError(f"chunk_elems must be positive, got {chunk_elems}")
    if words.dtype != torch.uint32 or words.dim() != 2 or words.shape[1] < 1:
        raise ValueError(f"words must be a (n, W>=1) uint32 table, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")


def decode(words: torch.Tensor, *, chunk_elems: int, width: int,
           bits: int) -> torch.Tensor:
    """Unpack every row of a word table; ``(n, chunk_elems)`` in the width
    type, on the table's device."""
    global LAUNCHES
    _check(words, chunk_elems, width, bits)
    if words.device.type == "cpu":
        return unpack(words, chunk_elems=chunk_elems, width=width, bits=bits)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    n = words.shape[0]
    out = torch.empty((n, chunk_elems), dtype=harness.DEV_DTYPE[width],
                      device=words.device)
    if n == 0:
        return out
    with torch.cuda.device(words.device):
        cuda_build.launch(LIB, width, words.data_ptr(), n, words.shape[1],
                          chunk_elems, bits, out.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return out


# --------------------------------------------------------------------------
# registry plumbing
# --------------------------------------------------------------------------


def _body(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return unpack(inputs[0], chunk_elems=chunk_elems, width=width, bits=bits)


def _body_oracle(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return unpack_oracle(inputs[0], chunk_elems=chunk_elems, width=width,
                         bits=bits)


def _body_scalar(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return unpack_scalar(inputs[0], out_lens, chunk_elems=chunk_elems,
                         width=width, bits=bits)


def _kernel(inputs, consts, out_lens, *, chunk_elems, width, bits):
    return decode(inputs[0], chunk_elems=chunk_elems, width=width, bits=bits)


CODEC = registry.register(registry.Codec(
    name=fmt.BITPACK,
    encode=enc.compress_bitpack,
    decode=harness.DecodeSpec(
        body=_body, body_scalar=_body_scalar, body_oracle=_body_oracle,
        cuda=_kernel, chunk_inputs=harness.words_inputs),
    needs_words=True,
    shared_extras=("bitpack_bits",),
    static_bits=lambda blob: int(blob.extras["bitpack_bits"][0]),
))
