"""RLE v1 codec plugin (byte-aligned runs + literals; ORC RLE v1 structure).

The counterpart of ``repro/kernels/rle_v1.py``: a Phase-1 header parse and
a Phase-2 value expression; the harness and the CUDA kernel
(``csrc/two_phase_rle.cu``) supply the rest.

Group structure:
  control c in [0,127]   -> run of length c+3 (3..130), one value follows
  control c in [128,255] -> 256-c literals (1..128), values follow
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core import registry
from repro_torch.core import streams as st
from repro_torch.kernels import cuda_rle, harness

MAX_GROUP_LEN = 132          # >= 130, the longest run


def max_groups(out_len: int) -> int:
    # worst case: [run(3), lit(1)] repeating = 2 groups / 4 elements
    return out_len // 2 + 4


def _parse(comp, pos, width: int):
    """Control byte -> (length, advance, kind, value, literal offset)."""
    c = st.read_byte_at(comp, pos)
    is_run = c < 128
    length = torch.where(is_run, c + 3, 256 - c)
    return {
        "length": length,
        "advance": 1 + torch.where(is_run, width, length * width),
        "is_run": is_run,
        "value": st.read_value_at(comp, pos + 1, width),
        "litoff": pos + 1,
    }


def _express(comp, f, k, width: int):
    """Element k of a group: the run value, or the k-th gathered literal."""
    lit = st.gather_values(comp, f["litoff"] + k * width, width)
    return torch.where(f["is_run"], f["value"], lit)


SPEC = harness.TwoPhaseSpec(
    fields=(harness.Field("is_run", torch.bool),
            harness.Field("value", torch.int64),
            harness.Field("litoff", torch.int64)),
    parse=_parse,
    express=_express,
    max_groups=max_groups,
    max_group_len=MAX_GROUP_LEN,
)


CODEC = registry.register(registry.Codec(
    name=fmt.RLE_V1,
    encode=enc.compress_rle_v1,
    decode=harness.DecodeSpec.from_two_phase(
        SPEC, cuda=functools.partial(cuda_rle.decode, fmt.RLE_V1)),
    plane_decompose_64=True,
))
