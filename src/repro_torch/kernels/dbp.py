"""dbp codec plugin — frame-of-reference delta + bitpack.

The counterpart of ``repro/kernels/dbp.py``: its encoder, a Phase-1 header
parse and a Phase-2 value expression; the harness and the CUDA kernel
(``csrc/two_phase_rle.cu``, codec id 2) supply the rest.

Format: the chunk is split into groups of up to 256 elements; each group
stores its minimum (the frame of reference) and LSB-first bitpacks every
element's offset from it.  Per-group byte-aligned layout:

  byte 0            bit width b (0..32; 0 = all elements equal the ref)
  byte 1            count-1 (group length 1..256)
  bytes 2..2+w-1    ref, little-endian, w = element width
  payload           ceil(count*b/8) bytes, LSB-first packed (val - ref)
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core import registry
from repro_torch.core import streams as st
from repro_torch.kernels import cuda_rle, harness, scalar

GROUP = 128            # encoder group size (any count in 1..256 decodes)
MAX_GROUP_LEN = 256


def max_groups(out_len: int) -> int:
    return out_len + 4   # any stream of >=1-element groups is decodable


# --------------------------------------------------------------------------
# host encoder
# --------------------------------------------------------------------------


def encode_dbp_chunk(x: np.ndarray, width: int) -> bytes:
    """Encode one chunk: per-group (bits, count-1, ref, packed offsets)."""
    out = bytearray()
    xs = np.ascontiguousarray(x).astype(np.uint32)
    for i in range(0, xs.shape[0], GROUP):
        g = xs[i:i + GROUP]
        ref_v = int(g.min())
        deltas = (g - np.uint32(ref_v)).astype(np.uint64)
        bits = int(deltas.max()).bit_length()
        out.append(bits)
        out.append(len(g) - 1)
        out.extend(int(ref_v).to_bytes(4, "little")[:width])
        if bits:
            payload = enc.pack_bits(deltas, bits).tobytes()
            out.extend(payload[: (len(g) * bits + 7) // 8])
    return bytes(out)


def compress_dbp(arr: np.ndarray, chunk_bytes: int = fmt.DEFAULT_CHUNK_BYTES,
                 bits=None) -> fmt.CompressedBlob:
    """Host encoder entry point (``bits`` is unused: widths are per-group)."""
    chunks, chunk_elems, width, _ = fmt.chunk_array(arr, chunk_bytes)
    encoded = [encode_dbp_chunk(c, width) for c in chunks]
    return fmt.build_blob(fmt.DBP, arr, encoded, chunk_elems, width)


# --------------------------------------------------------------------------
# decode: header parse + value expression
# --------------------------------------------------------------------------


def _parse(comp, pos, width: int):
    bits = st.read_byte_at(comp, pos)
    count = st.read_byte_at(comp, pos + 1) + 1
    return {
        "length": count,
        "advance": 2 + width + ((count * bits + 7) >> 3),
        "ref": st.read_value_at(comp, pos + 2, width),
        "bits": bits,
        "payoff": pos + 2 + width,
    }


def _express(comp, f, k, width: int):
    """Lane k funnel-shifts its b-bit offset out of the 40-bit window (an
    unaligned uint32 + one spill byte) and adds ref, mod 2^32.  The mask
    shift is capped at 31; a header byte of 32 or more keeps all 32 bits."""
    bits = f["bits"]
    bitpos = f["payoff"] * 8 + k * bits
    byte = bitpos >> 3
    off = bitpos & 7
    lo = st.gather_values(comp, byte, 4) >> off
    hi = torch.where(off > 0, (st.read_byte_at(comp, byte + 4)
                               << ((32 - off) & 31)) & st.MASK32, 0)
    mask = torch.where(bits >= 32, st.MASK32,
                       (1 << bits.clamp(max=31)) - 1)
    return (f["ref"] + ((lo | hi) & mask)) & st.MASK32


SPEC = harness.TwoPhaseSpec(
    fields=(harness.Field("ref", torch.int64),
            harness.Field("bits", torch.int64),
            harness.Field("payoff", torch.int64)),
    parse=_parse,
    express=_express,
    max_groups=max_groups,
    max_group_len=MAX_GROUP_LEN,
)


def count_groups(row, width: int) -> int:
    """Host walk: the number of compressed groups in one chunk row."""
    pos, groups = 0, 0
    while pos < len(row):
        bits, count = int(row[pos]), int(row[pos + 1]) + 1
        pos += 2 + width + (count * bits + 7) // 8
        groups += 1
    return groups


def _demo_data(n: int, rng) -> np.ndarray:
    """Sorted-id / timestamp-like uint32s: small per-group value ranges."""
    return np.cumsum(rng.integers(0, 16, n)).astype(np.uint32)


CODEC = registry.register(registry.Codec(
    name=fmt.DBP,
    encode=compress_dbp,
    decode=harness.DecodeSpec.from_two_phase(
        SPEC, cuda=functools.partial(cuda_rle.decode, fmt.DBP),
        scalar=functools.partial(scalar.decode_rle, fmt.DBP)),
    plane_decompose_64=True,
    demo_data=_demo_data,
))
