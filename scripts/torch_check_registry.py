"""Registry-completeness gate of the PyTorch port.

The counterpart of ``scripts/check_registry.py``.  Fails (exit 1) if any
codec in ``repro_torch.core.registry`` is missing from:
  * the port's fast-tier test matrix (``ALL_CODECS``, a module-level tuple
    of ``tests/test_torch_codecs.py``, read from the file's source, so the
    gate imports no test module and nothing of the reference), or
  * the golden conformance vectors (``tests/vectors/<codec>.json``, at
    least 5 each: the byte contract the port shares with the reference), or
  * the port's tuned-defaults table (``src/repro_torch/core/
    tuned_defaults.json``: every codec needs an entry, possibly an explicit
    ``{}``, and every knob must be one ``core.tuning`` or the codec's
    ``DecodeSpec`` tunables know).

Every built-in codec must be registered, and every codec's decode must
LOWER THROUGH THE PLAN: a ``demo_data`` round trip through
``api.compress(..., chunk_bytes=512)`` / ``api.decompress`` is bit-exact,
and every ``ops.decode`` dispatch it issues came from ``plan.dispatch``
(``plan.count_lowered`` equals ``ops.count_dispatches``).  The round trips
run on ``--device`` (default ``cuda``: the hand-written kernels, one launch
a codec); with no card the gate raises unless given ``--device cpu``.

The reference's bench-smoke matrices (``benchmarks/{batched,ablations}.py``)
have no counterpart on the port yet, so neither has their check.

    PYTHONPATH=src python scripts/torch_check_registry.py [--device cpu]
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT / "src") not in sys.path:
    sys.path.insert(0, str(_ROOT / "src"))

# the port's built-in codecs; ``format`` names each, and a test pins this
# list to those names
BUILTINS = ("rle_v1", "rle_v2", "tdeflate", "bitpack", "dbp", "huffman",
            "lzss")
MATRIX_FILE = _ROOT / "tests" / "test_torch_codecs.py"
MATRIX_NAME = "ALL_CODECS"
VEC_DIR = _ROOT / "tests" / "vectors"
MIN_VECTORS = 5


def matrix_codecs(path: Path = MATRIX_FILE, name: str = MATRIX_NAME) -> tuple:
    """The literal tuple a module-level ``name = (...)`` assigns in the
    source at ``path``."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return tuple(ast.literal_eval(node.value))
    raise LookupError(f"no module-level {name} in {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the round trips decode (default cuda, "
                    "which must exist)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.core import api, plan as plan_mod, registry, tuning
    from repro_torch.core.engine import CodagEngine, EngineConfig
    from repro_torch.kernels import ops

    # first, so a missing card raises before any check
    engine = CodagEngine(EngineConfig(device=args.device))
    problems: list[str] = []
    names = set(registry.names())

    # every built-in must be registered; other codecs are fine as long as
    # they appear in the matrices below
    if not set(BUILTINS) <= names:
        problems.append(
            f"built-ins {sorted(set(BUILTINS) - names)} missing from registry")

    # fast-tier test matrix
    matrix = set(matrix_codecs())
    missing, extra = names - matrix, matrix - names
    where = f"{MATRIX_FILE.relative_to(_ROOT)} {MATRIX_NAME}"
    if missing:
        problems.append(f"{where}: missing codec(s) {sorted(missing)} "
                        f"(add them to the tuple)")
    if extra:
        problems.append(f"{where}: unregistered codec(s) {sorted(extra)} "
                        f"(register them or drop them from the matrix)")

    # golden conformance vectors: every codec must have committed fixtures
    for name in sorted(names):
        vec_file = VEC_DIR / f"{name}.json"
        if not vec_file.exists():
            problems.append(
                f"{name}: no golden vectors at {vec_file} "
                f"(scripts/torch_make_vectors.py writes the port's)")
            continue
        n_vec = len(json.loads(vec_file.read_text())["vectors"])
        if n_vec < MIN_VECTORS:
            problems.append(
                f"{name}: only {n_vec} golden vectors (full matrix expected)")

    # tuned-defaults coverage: an empty {} entry is the explicit "nothing
    # tuned yet"; every knob must be one the engine understands, so a
    # misspelt knob cannot silently become a no-op
    tuned = tuning.load_table().get("codecs", {})
    for name in sorted(names):
        if name not in tuned:
            problems.append(
                f"{name}: missing from tuned-defaults table "
                f"({tuning.DEFAULT_TABLE_PATH.name}; an explicit {{}} entry "
                f"counts — tuning.autotune writes one)")
            continue
        spec = registry.get(name).decode
        allowed = set(tuning.KNOWN_KNOBS) | {
            t.name for t in getattr(spec, "tunables", ())}
        for width_key, kinds in tuned[name].items():
            for kind, knobs in kinds.items():
                unknown = {k for k in knobs if not k.startswith("_")} - allowed
                if unknown:
                    problems.append(
                        f"{name}: unknown tuned knobs {sorted(unknown)} "
                        f"({width_key}/{kind}); allowed: {sorted(allowed)}")

    # plugin surface + a small round trip a codec with the plan-lowering
    # gate armed: every dispatch must have been lowered by plan.dispatch
    rng = np.random.default_rng(0)
    for name in sorted(names):
        codec = registry.get(name)
        if codec.demo_data is None:
            problems.append(f"{name}: no demo_data (the matrices need it)")
            continue
        arr = codec.demo_data(256, rng)
        ca = api.compress(arr, name, chunk_bytes=512)
        with plan_mod.count_lowered() as lowered, \
                ops.count_dispatches() as dispatched:
            out = api.decompress(ca, engine)
        if not np.array_equal(out, arr):
            problems.append(f"{name}: demo round trip is not bit-exact")
        if not dispatched:
            problems.append(f"{name}: round trip issued no kernel dispatch")
        elif len(lowered) != len(dispatched):
            problems.append(
                f"{name}: decode bypasses plan lowering "
                f"({len(dispatched)} ops.decode dispatches, only "
                f"{len(lowered)} lowered through plan.dispatch)")

    if problems:
        for p in problems:
            print(f"REGISTRY CHECK FAILED: {p}", file=sys.stderr)
        return 1
    print(f"registry complete: {sorted(names)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
