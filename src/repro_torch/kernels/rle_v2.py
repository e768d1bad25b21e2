"""RLE v2 codec plugin (run / delta / literal / long-run; ORC RLE v2 spirit).

The counterpart of ``repro/kernels/rle_v2.py``.  Phase 2 is Table II's
``write_run(init, len, delta)`` for every lane at once: ``base + delta*k``
in wraparound uint32 arithmetic (computed in int64 and masked), literals via
the shared multi-byte gather.

Group structure: header h; mode = h >> 6, f = h & 63
  mode 0 -> run,      len = f+3  (3..66),   value follows
  mode 1 -> delta,    len = f+3  (3..66),   base + delta values follow
  mode 2 -> literal,  len = f+1  (1..64),   values follow
  mode 3 -> long run, len = (f<<8 | next)+3 (3..16386), value follows
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

MAX_GROUP_LEN = enc.RLE2_MAX_LONG + 2


def max_groups(out_len: int) -> int:
    return out_len // 2 + 4


def _parse(comp, pos, width: int):
    h = st.read_byte_at(comp, pos)
    mode = h >> 6
    f = h & 63
    nxt = st.read_byte_at(comp, pos + 1)
    is_lit = mode == 2
    is_delta = mode == 1
    is_long = mode == 3
    length = torch.where(is_lit, f + 1,
                         torch.where(is_long, ((f << 8) | nxt) + 3, f + 3))
    val_off = pos + 1 + is_long.to(torch.int64)
    return {
        "length": length,
        "advance": torch.where(is_lit, 1 + length * width,
                   torch.where(is_delta, 1 + 2 * width,
                   torch.where(is_long, 2 + width, 1 + width))),
        "is_lit": is_lit,
        "base": st.read_value_at(comp, val_off, width),
        "delta": torch.where(is_delta,
                             st.read_value_at(comp, val_off + width, width),
                             0),
        "litoff": pos + 1,
    }


def _express(comp, f, k, width: int):
    """write_run for every lane: base + delta*k mod 2^32, or the k-th
    literal."""
    run_v = (f["base"] + f["delta"] * k) & st.MASK32
    lit = st.gather_values(comp, f["litoff"] + k * width, width)
    return torch.where(f["is_lit"], lit, run_v)


SPEC = harness.TwoPhaseSpec(
    fields=(harness.Field("is_lit", torch.bool),
            harness.Field("base", torch.int64),
            harness.Field("delta", torch.int64),
            harness.Field("litoff", torch.int64)),
    parse=_parse,
    express=_express,
    max_groups=max_groups,
    max_group_len=MAX_GROUP_LEN,
)


def _demo_data(n: int, rng) -> np.ndarray:
    """Runs + arithmetic ramps (exercises run, delta, and literal modes)."""
    parts, total = [], 0
    while total < n:
        if rng.random() < 0.5:
            v = np.uint32(rng.integers(0, 1000))
            parts.append(np.full(int(rng.integers(3, 120)), v, np.uint32))
        else:
            base = rng.integers(0, 1 << 20)
            step = rng.integers(1, 64)
            m = int(rng.integers(4, 80))
            parts.append((base + step * np.arange(m, dtype=np.uint32))
                         .astype(np.uint32))
        total += len(parts[-1])
    return np.concatenate(parts)[:n]


CODEC = registry.register(registry.Codec(
    name=fmt.RLE_V2,
    encode=enc.compress_rle_v2,
    decode=harness.DecodeSpec.from_two_phase(
        SPEC, cuda=functools.partial(cuda_rle.decode, fmt.RLE_V2),
        scalar=functools.partial(scalar.decode_rle, fmt.RLE_V2)),
    plane_decompose_64=True,
    demo_data=_demo_data,
))
