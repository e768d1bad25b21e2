"""The plain reference, and the comparison that decides ``correct``.

The benchmark makes every column itself, so the right answer to a decode
is known without the program: each row decodes to the base rows it lists,
in the column's dtype, bit for bit (the configuration's guarantee,
lossless).  :func:`expected` lays those rows out on the device in plain
PyTorch; :func:`compare` counts, for one output of the program, the
elements whose bits differ.  Nothing here imports the program or reads
what it made: the data come from the benchmark's generator.

The codecs' plain decoders (``bench/codecs/*.decode_chunk``) are the
reference for the frozen encoders; the tests hold each to the other.
"""
from __future__ import annotations

import numpy as np
import torch

INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}
NP_INT_OF_WIDTH = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


class Expected:
    """Each column's base on the device, as integers of its width, uploaded
    once."""

    def __init__(self, device):
        self.device, self._bases = device, {}

    def base(self, col) -> torch.Tensor:
        if col.name not in self._bases:
            w = col.base.dtype.itemsize
            host = np.ascontiguousarray(col.base).view(NP_INT_OF_WIDTH[w])
            self._bases[col.name] = torch.from_numpy(host).to(
                self.device).view(col.base_rows, col.row_elems)
        return self._bases[col.name]

    def rows(self, col, idx) -> torch.Tensor:
        """The column's right answer for the base rows ``idx``: 1-D."""
        at = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        return self.base(col).index_select(0, at).reshape(-1)

    def lossy(self, col, idx) -> torch.Tensor:
        """The control: the right answer carried at the next precision
        below the column's, as a lossy store would keep it (float32
        columns in bfloat16); other columns as they are.  In the column's
        dtype."""
        dt = getattr(torch, col.dtype)
        out = self.rows(col, idx).view(dt)
        if dt == torch.float32:
            out = out.to(torch.bfloat16).to(torch.float32)
        return out


def compare(out, col, idx, expected: Expected):
    """(wrong, mismatched): whether the output is missing or has another
    type or size than the column's rows, and how many elements differ from
    the right answer (all of them where it is wrong)."""
    n = len(idx) * col.row_elems
    w = col.base.dtype.itemsize
    if (not isinstance(out, torch.Tensor) or out.numel() != n
            or out.element_size() != w
            or str(out.dtype).removeprefix("torch.") != col.dtype):
        return True, n
    got = out.reshape(-1).view(INT_OF_WIDTH[w])
    want = expected.rows(col, idx)
    return False, int((got != want).sum())
