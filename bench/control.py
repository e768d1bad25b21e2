#!/usr/bin/env python3
"""The checks on the check: runs of a cell with something other than the
program's right answer in the window, each of which must come out not
correct.  The benchmark's own runs never run this.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> --what control,unwritten,half,altered

  control    the plain reference put in the program's place, at the next
             precision below the column's (float32 columns carried in
             bfloat16): the configuration's guarantee, lossless, broken
  unwritten  every decode returns its output buffer unwritten (a step that
             returns its state unchanged)
  half       every decode leaves the second half of its chunks undecoded
             (half of the batch left out)
  altered    every decode's output has one element altered where it is
             produced

Prints one JSON line a run: the cell, seed, what, ``correct`` and the
numbers compared with their limits.  The faults patch
``repro_torch.core.plan.dispatch``, the one call site of the decode
kernels.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

WHAT = ("control", "unwritten", "half", "altered")


@contextlib.contextmanager
def fault(what: str):
    """``plan.dispatch`` broken as ``what`` says, for the ``with`` body."""
    import torch
    from repro_torch.core import plan as plan_mod
    real = plan_mod.dispatch
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}

    def broken(dev, *, width, chunk_elems, **kw):
        if what == "unwritten":
            comp = dev["comp"]
            out = torch.empty((comp.shape[0], chunk_elems),
                              dtype=ints[width], device=comp.device)
            if out.device.type == "cpu":   # the card's poisoned memory
                out.fill_(0x25)
            return out.view({1: torch.uint8, 2: torch.uint16,
                             4: torch.uint32}[width])
        out = real(dev, width=width, chunk_elems=chunk_elems, **kw)
        flat = out.view(ints[width])
        if what == "half":
            flat[out.shape[0] // 2:] = 0
        elif what == "altered":
            flat.view(-1)[flat.numel() // 3] ^= 1
        return out

    plan_mod.dispatch = broken
    try:
        yield
    finally:
        plan_mod.dispatch = real


def run(cell: str, seed: int, seconds: float, what: str, *,
        device: str = "cuda", root: Path = ROOT, **over) -> dict:
    """One run of ``cell`` with ``what`` in the program's place; the
    harness's result."""
    from bench import harness, reference
    if what == "control":
        expected = {}

        def op(query):
            import torch
            dev = torch.device(device)
            if dev not in expected:
                expected[dev] = reference.Expected(dev)
            return [expected[dev].lossy(col, idx) for col, idx in query.parts]

        return harness.run_cell(cell, seed, seconds, False, device=device,
                                root=root, op_over=op, **over)
    with fault(what):
        return harness.run_cell(cell, seed, seconds, False, device=device,
                                root=root, **over)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--what", default="control")
    args = ap.parse_args(argv)
    status = 0
    for what in args.what.split(","):
        if what not in WHAT:
            raise SystemExit(f"--what: one of {WHAT}")
        for seed in (int(s) for s in args.seeds.split(",")):
            res = run(args.workload, seed, args.seconds, what)
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "what": what, "correct": res["correct"],
                              "attempted": res["attempted"],
                              "checks": res["checks"]}), flush=True)
            status |= int(res["correct"])
    return status


if __name__ == "__main__":
    sys.exit(main())
