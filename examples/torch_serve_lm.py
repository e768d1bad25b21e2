"""Batched serving on the PyTorch port: prefill + cached greedy decode.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu] \\
        [--compile-cache [DIR]]

The counterpart of ``examples/serve_lm.py``, a thin veneer over the
driver (``repro_torch.launch.serve``) with the reference's flags;
``--device`` (default ``cuda``, which must exist) and ``--compile-cache``
pass through, and the veneer exits with the driver's code.
"""
import argparse
import subprocess
import sys

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
ap.add_argument("--compile-cache", nargs="?", const=True, default=None)
args = ap.parse_args()

cmd = [sys.executable, "-m", "repro_torch.launch.serve",
       "--arch", "zamba2-2.7b", "--preset", "tiny",
       "--batch", "4", "--prompt-len", "32", "--gen", "16",
       "--device", args.device]
if args.compile_cache is not None:
    cmd += ["--compile-cache"] + ([] if args.compile_cache is True
                                  else [args.compile_cache])
print("+", " ".join(cmd), flush=True)
raise SystemExit(subprocess.call(cmd))
