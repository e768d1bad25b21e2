"""Mesh-sharded compressed restore on the PyTorch port, one process a mesh
member.

A checkpoint saved through the paper's codecs is restored onto a mesh over
the ranks of a ``gloo`` world: each member decodes its block of every
compressed leaf's chunk rows (``DecodePlan.execute_sharded``), the decoded
rows are all-gathered, and each member keeps only its own block of each
leaf under the requested ``NamedSharding``.  The port itself copies
nothing from a device to the host on the decode path (the count printed);
the all-gather travels through ``gloo``, which stages it in host memory.

    PYTHONPATH=src python examples/torch_sharded_restore.py \\
        [--device cpu] [--mesh 4x2]

The counterpart of ``examples/sharded_restore.py``; ``--device`` defaults to
``cuda`` (every member on the card, or the cards taken in turn).
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import transfers
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch import mesh as mesh_lib

SPECS = {"embed": P("data", "model"), "w_up": P("model", None),
         "moments_q": P("data", None)}


def make_state() -> dict:
    rng = np.random.default_rng(0)
    return {
        "embed": rng.normal(size=(512, 128)).astype(np.float32),
        "w_up": rng.normal(size=(128, 256)).astype(np.float32),
        "moments_q": rng.integers(-8, 8, (1024, 128)).astype(np.int8),
    }


def member(ckpt_dir: str, shape: tuple, device: str) -> dict:
    """One member's process: restore its blocks, check them against its
    blocks of the saved state."""
    mesh = mesh_lib.world_mesh(shape, ("data", "model"), device=device)
    shardings = {k: NamedSharding(mesh, spec) for k, spec in SPECS.items()}
    state = make_state()
    engine = CodagEngine(EngineConfig(device=str(mesh.member_device())))
    with transfers.count_host_transfers() as c:
        got = ckpt.restore(ckpt_dir, 1, state, shardings=shardings,
                           engine=engine, device_out=True)
    rows = []
    for name, leaf in sorted(got.items()):
        want = sharding.block(torch.from_numpy(state[name]), shardings[name])
        assert torch.equal(leaf, want), (mesh.rank, name)
        rows.append((name, str(leaf.dtype).replace("torch.", ""),
                     tuple(state[name].shape), tuple(leaf.shape),
                     shardings[name].spec))
    return {"rows": rows, "d2h": c["d2h"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="4x2", help="data x model, as 4x2")
    args = ap.parse_args()
    shape = tuple(int(n) for n in args.mesh.split("x"))
    state = make_state()
    nbytes = sum(v.nbytes for v in state.values())
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, {k: torch.from_numpy(v) for k, v in state.items()},
                  codec="rle_v2")
        ranks = mesh_lib.spawn(member, int(np.prod(shape)),
                               (d, shape, args.device), device=args.device)
    for name, dtype, whole, block, spec in ranks[0]["rows"]:
        print(f"{name:12s} {dtype:8s} {str(whole):12s} block {str(block):11s}"
              f" born under {spec}")
    print(f"restored {nbytes / 1e6:.1f} MB across {len(ranks)} members, one "
          f"process each, with {sum(r['d2h'] for r in ranks)} device->host "
          "crossings of the port's own (the decoded rows' all-gather goes "
          "through gloo, in host memory)")
    print("OK")


if __name__ == "__main__":
    main()
