"""CodagEngine — the paper's provisioning strategies, as configuration.

  unit="warp"   (CODAG) one chunk per independent stream: one launch over
                every chunk of a group, one warp per chunk.
  unit="block"  (RAPIDS baseline, Fig. 1a) a fixed pool of ``n_units``
                streams: one launch per serial batch of ``n_units`` chunks.

  all_thread=True   (§IV-D) every lane decodes and writes.
  all_thread=False  (§V-E ablation) one element per step; runs on CPU
                tensors only until its kernel is ported.

  backend="cuda"    the Hopper kernels (plain torch bodies on CPU tensors);
  backend="torch"   the plain two-phase bodies; also "oracle".

  device="cuda"     where tables are staged and decoded.  With no card the
                engine raises rather than run on the CPU; pass
                ``device="cpu"`` to ask for the CPU.

Every decode the engine issues lowers through ``core.plan`` (``plan.dispatch``
is the one ``ops.decode`` call site).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.core import plan as plan_mod
from repro_torch.core import transfers
from repro_torch.kernels import ops


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                "available; pass device='cpu' to decode on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    unit: str = "warp"          # "warp" (CODAG) | "block" (RAPIDS-like)
    n_units: int = 8            # decompression-unit pool size for "block"
    all_thread: bool = True     # False = §V-E single-thread decoding
    backend: str = "cuda"       # "cuda" | "torch" | "oracle"
    device: str = "cuda"


class CodagEngine:
    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)

    def decompress_chunks(self, dev: Dict[str, Any], *, codec: str,
                          width: int, chunk_elems: int, bits: int = 0,
                          epilogue=None) -> torch.Tensor:
        """Decode a staged table to ``(num_chunks, chunk_elems)``."""
        return plan_mod.dispatch(dev, config=self.config, codec=codec,
                                 width=width, chunk_elems=chunk_elems,
                                 bits=bits, epilogue=epilogue)

    def decompress_table_device(self, table: fmt.CompressedBlob,
                                epilogue=None) -> torch.Tensor:
        """Stage and decode a flat chunk table with one dispatch; the raw
        ``(num_chunks, chunk_elems)`` matrix stays on the device."""
        dev, bits = ops.table_inputs(table, self.device)
        return self.decompress_chunks(dev, codec=table.codec,
                                      width=table.width,
                                      chunk_elems=table.chunk_elems,
                                      bits=bits, epilogue=epilogue)

    def decompress_table(self, table: fmt.CompressedBlob) -> np.ndarray:
        """Host variant of :meth:`decompress_table_device`."""
        return transfers.to_host(self.decompress_table_device(table))

    def decompress(self, blob: fmt.CompressedBlob) -> np.ndarray:
        """Host round trip: a one-blob plan on the host executor."""
        return plan_mod.DecodePlan.build([blob]).execute(self)[0]

    def decompress_device(self, blob: fmt.CompressedBlob,
                          epilogue=None) -> torch.Tensor:
        """Device round trip: a one-blob plan on the device executor."""
        return plan_mod.DecodePlan.build([blob]).execute_device(
            self, epilogue=epilogue)[0]
