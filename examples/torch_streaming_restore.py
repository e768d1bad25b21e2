"""Streaming checkpoint restore through the tiered blob store, on the
PyTorch port.

A compressed checkpoint BIGGER than the host budget restores window by
window: while window i's leaves decode on the card (DecodePlan stage +
dispatch), the store's prefetch pool is already pulling window i+1's blobs
off the backend, and consumed windows are released back under the byte
budget.  The same checkpoint is then restored serially (no lookahead) to
show the I/O bill the overlap hides.

    PYTHONPATH=src python examples/torch_streaming_restore.py [--device cpu]

The counterpart of ``examples/streaming_restore.py``; ``--device``
defaults to ``cuda``, which must exist.
"""
import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import format as fmt
from repro_torch.core import store as bs
from repro_torch.core.engine import CodagEngine, EngineConfig


def make_state() -> dict:
    rng = np.random.default_rng(0)
    return {f"layer{i:02d}/moments": np.repeat(
                rng.integers(0, 30, 4000).astype(np.int32), 12)
            for i in range(12)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    engine = CodagEngine(EngineConfig(device=args.device))
    state = make_state()
    nbytes = sum(v.nbytes for v in state.values())

    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, state, codec=fmt.RLE_V2)
        comp_bytes = sum(p.stat().st_size
                         for p in Path(d, "step_1").glob("*"))

        # warm the decode path so neither timed restore pays first-call
        # costs (a kernel's binding, the allocator)
        ckpt.restore(d, 1, state, engine=engine, decode_window=3)

        # A host budget HALF the checkpoint's compressed size: the whole
        # thing can never be resident — restore must demand-page, decode,
        # release.  read_delay_s stands in for an object store's per-read
        # RTT.
        budget = comp_bytes // 2
        with bs.filesystem_store(d, host_budget_bytes=budget,
                                 read_delay_s=0.005) as store:
            t0 = time.perf_counter()
            got = ckpt.restore(d, 1, state, engine=engine, store=store,
                               decode_window=3, prefetch_windows=1,
                               device_out=True)
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
            t_stream = time.perf_counter() - t0
            s = store.stats()

        for k, v in state.items():
            assert torch.equal(got[k].cpu(), torch.from_numpy(v)), k

        # the serial baseline: same delayed backend, no lookahead
        with bs.filesystem_store(d, host_budget_bytes=budget,
                                 read_delay_s=0.005) as store:
            t0 = time.perf_counter()
            ckpt.restore(d, 1, state, engine=engine, store=store,
                         decode_window=3, prefetch_windows=0,
                         device_out=True)
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
            t_serial = time.perf_counter() - t0

    print(f"checkpoint: {nbytes / 1e6:.2f} MB raw, {comp_bytes / 1e3:.0f} KB "
          f"compressed; host budget {budget / 1e3:.0f} KB (over budget: "
          f"{comp_bytes > budget})")
    print(f"paging:     {s.backend_fetches} backend fetches "
          f"({s.backend_bytes_fetched / 1e3:.0f} KB), "
          f"{s.host_released} released + {s.host_evictions} evicted, "
          f"{s.host_bytes} B resident at the end")
    print(f"restore:    {t_stream * 1e3:.0f} ms overlapped vs "
          f"{t_serial * 1e3:.0f} ms serial "
          f"({(t_serial - t_stream) * 1e3:.0f} ms of I/O hidden behind "
          f"decode)")
    print("OK")
    return {"backend_fetches": s.backend_fetches,
            "backend_bytes_fetched": s.backend_bytes_fetched,
            "comp_bytes": comp_bytes}


if __name__ == "__main__":
    main()
