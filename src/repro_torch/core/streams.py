"""Byte-granular input_stream reads (the paper's Table I), on tensors.

The counterpart of ``read_byte_at`` / ``read_value_at`` / ``gather_values``
in ``repro/core/streams.py``, batched over chunk rows: ``data`` is one row
``(C,)`` or a table ``(n, C)`` of uint8, and ``pos`` holds byte offsets with
the row on its leading axis.  Reads reproduce ``jnp.take(..., mode="clip")``:
an offset past the row reads its last byte, which is zero padding in the
device layout (``format.to_device``).

Values are computed in int64 and masked to 32 bits: CPU torch has no
shifts, sums or comparisons on uint32.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def _take(data: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``data[row, clip(pos)]`` as int64; ``pos`` is (n, ...) for an (n, C)
    table, any shape for a single row."""
    pos = pos.clamp(0, data.shape[-1] - 1)
    if data.dim() == 1:
        return data[pos].to(torch.int64)
    flat = pos.reshape(pos.shape[0], -1)
    return torch.gather(data, 1, flat).to(torch.int64).reshape(pos.shape)


def read_byte_at(data: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return _take(data, pos)


def read_value_at(data: torch.Tensor, pos: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Assemble a little-endian fixed-width value (width in {1,2,4})."""
    return gather_values(data, pos, width)


def gather_values(data: torch.Tensor, byte_offs: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Assemble little-endian ``width``-byte values at byte offsets; every
    lane reads its own value (the shared literal gather of Phase 2)."""
    v = _take(data, byte_offs)
    for i in range(1, width):
        v = v | (_take(data, byte_offs + i) << (8 * i))
    return v & MASK32
