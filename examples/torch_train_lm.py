"""End-to-end training on the PyTorch port: a small model, a few hundred
steps, compressed data pipeline + fault-tolerant checkpointed loop.

    PYTHONPATH=src python examples/torch_train_lm.py            # small
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 2 \\
        --device cpu

The counterpart of ``examples/train_lm.py``, a thin veneer over the driver
(``repro_torch.launch.train``) with the reference's flags; ``--device``
(default ``cuda``, which must exist) and ``--compile-cache`` pass through,
and the veneer exits with the driver's code.  Checkpoints go to a fresh
temporary directory, removed afterwards (the driver resumes from whatever
its directory already holds).
"""
import argparse
import subprocess
import sys
import tempfile

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--preset", default="small")
ap.add_argument("--steps", default="120")
ap.add_argument("--arch", default="olmo-1b")
ap.add_argument("--device", default="cuda")
ap.add_argument("--compile-cache", nargs="?", const=True, default=None)
args = ap.parse_args()

with tempfile.TemporaryDirectory(prefix="torch_train_lm_") as ckpt_dir:
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", args.arch, "--preset", args.preset,
           "--steps", args.steps, "--batch", "4", "--seq", "256",
           "--ckpt-dir", ckpt_dir, "--codec", "rle_v2",
           "--device", args.device]
    if args.compile_cache is not None:
        cmd += ["--compile-cache"] + ([] if args.compile_cache is True
                                      else [args.compile_cache])
    print("+", " ".join(cmd), flush=True)
    rc = subprocess.call(cmd)
raise SystemExit(rc)
