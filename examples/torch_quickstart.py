"""Quickstart on the PyTorch port: compress on the host, decompress on the
card with the CODAG engine.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py``; ``--device`` defaults to
``cuda``, which must exist.  On a card every decode runs a hand-written
kernel (the single-thread strategy ``csrc/scalar_decode.cu``); with
``--device cpu`` the kernels' plain PyTorch twins run instead.
"""
import argparse

import numpy as np

from repro_torch.core import api, format as fmt
from repro_torch.core.engine import CodagEngine, EngineConfig

CODECS = (fmt.RLE_V1, fmt.RLE_V2, fmt.TDEFLATE)


def make_column() -> np.ndarray:
    """A run-heavy integer column (think: ORC analytics data, Table IV)."""
    rng = np.random.default_rng(0)
    return np.repeat(rng.integers(0, 100, 2000).astype(np.uint32),
                     rng.integers(1, 64, 2000))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    column = make_column()
    engine = CodagEngine(EngineConfig(device=args.device))

    sizes = {}
    for codec in CODECS:
        ca = api.compress(column, codec)
        out = api.decompress(ca, engine)          # decode on the device
        assert np.array_equal(out, column)
        sizes[codec] = ca.compressed_bytes
        print(f"{codec:9s}: {column.nbytes/1e6:6.2f} MB -> "
              f"{ca.compressed_bytes/1e6:6.3f} MB  (ratio {ca.ratio:.4f})")

    # provisioning strategies (the paper's core subject):
    for name, cfg in {
        "CODAG  warp-unit, all-thread  ": EngineConfig(unit="warp",
                                                       device=args.device),
        "RAPIDS block-unit, single-thr.": EngineConfig(
            unit="block", n_units=8, all_thread=False, device=args.device),
    }.items():
        eng = CodagEngine(cfg)
        out = api.decompress(api.compress(column, fmt.RLE_V2), eng)
        assert np.array_equal(out, column)
        print(f"engine [{name}] decode OK")

    # the hand-written kernel on a card; its plain twin on the CPU
    on_card = engine.device.type == "cuda"
    backend = "cuda" if on_card else "torch"
    eng = CodagEngine(EngineConfig(backend=backend, device=args.device))
    out = api.decompress(api.compress(column, fmt.RLE_V2), eng)
    assert np.array_equal(out, column)
    print("hand-written CUDA kernel (backend='cuda') decode OK" if on_card
          else "plain PyTorch twin (backend='torch', CPU) decode OK")
    print("OK")
    return {"sizes": sizes}


if __name__ == "__main__":
    main()
