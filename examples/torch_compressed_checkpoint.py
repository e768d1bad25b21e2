"""Codec-compressed, atomic, async checkpointing on the PyTorch port.

Saves a model's training state through the paper's codecs and restores it
bit-exact, decoding on the card — the decompression engine in the
checkpoint data plane.

    PYTHONPATH=src python examples/torch_compressed_checkpoint.py \\
        [--device cpu]

The counterpart of ``examples/compressed_checkpoint.py``; ``--device``
defaults to ``cuda``, which must exist.
"""
import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.core import format as fmt
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.core.tree import leaves
from repro_torch.models import model
from repro_torch.optim import adamw


def make_state(params) -> dict:
    """The training state: parameters and int8-moment AdamW state."""
    opt = adamw.init(params, adamw.AdamWConfig(compress_moments=True))
    return {"params": params, "opt": opt}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def save_and_restore(state, ckpt_dir: str, engine: CodagEngine) -> dict:
    """Save ``state`` asynchronously with rle_v2, restore it on ``engine``'s
    device, check it bit for bit; returns the manifest."""
    nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
    t0 = time.time()
    thread = ckpt.save(ckpt_dir, 100, state, codec=fmt.RLE_V2, async_=True)
    print(f"async save dispatched in {time.time()-t0:.3f}s "
          f"(snapshot taken; writer on background thread)")
    thread.join()
    print(f"written in {time.time()-t0:.2f}s, state={nbytes/1e6:.1f} MB")

    got = ckpt.restore(ckpt_dir, 100, state, engine=engine, device_out=True)
    for a, b in zip(leaves(state), leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b.to(a.device)))
    print("restore bit-exact OK")

    # int8 moments are where compression bites (quantized state + rle)
    man = json.loads((Path(ckpt_dir) / "step_100" / "manifest.json")
                     .read_text())
    ratios = [e["ratio"] for e in man["leaves"].values() if "ratio" in e]
    print(f"{len(ratios)} leaves codec-compressed, "
          f"mean stored ratio {np.mean(ratios):.3f}")
    return man


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    engine = CodagEngine(EngineConfig(device=args.device))
    cfg = reduced(get_arch("qwen3-1.7b"))
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device=engine.device)
    with tempfile.TemporaryDirectory() as d:
        man = save_and_restore(make_state(params), d, engine)
    print("OK")
    return man


if __name__ == "__main__":
    main()
