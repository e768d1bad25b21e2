#!/usr/bin/env python3
"""Run one cell of the benchmark once, on this machine's card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
those numbers are also the last lines of standard error.  Exits non-zero
with no result where there is no CUDA card, fewer cards than the cell
asks for, no program beside the benchmark (``src/repro_torch``), or where
JAX or the JAX package was loaded.  The cells are in ``BENCHMARK.json``;
``bench/harness.py`` says how a run goes.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder: the benchmark is the package
# ``bench``, the program ``src/repro_torch``
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def caches() -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (the program builds its kernels into ``build/repro_torch``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("no program beside the benchmark: src/repro_torch is missing",
              file=sys.stderr)
        return 2
    caches()
    from bench import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    except harness.NoCard as e:
        print(e, file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
