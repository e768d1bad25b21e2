"""Write the golden conformance vectors through the PyTorch port's encoders.

The counterpart of ``scripts/make_vectors.py``: one JSON file per codec in
``repro_torch.core.registry.names()``, each a list of small vectors (raw
input, deterministic parameters and the content digest of the blob the
port's encoder writes), in the reference's schema and byte layout.  The
reference package owns the committed vectors in ``tests/vectors/``; the
port reproduces that contract and never rewrites it, so ``--out`` is
required and may not name that directory:

    PYTHONPATH=src python scripts/torch_make_vectors.py --out build/vectors
    diff -r build/vectors tests/vectors      # silent: the same bytes
"""
from __future__ import annotations

import argparse
import base64
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT / "src") not in sys.path:
    sys.path.insert(0, str(_ROOT / "src"))

VEC_DIR = _ROOT / "tests" / "vectors"


def vector_inputs(name: str, codec, rng):
    """Deterministic per-codec vector matrix: generic payloads every codec
    must handle (runs, incompressible, odd tails, single/empty chunks,
    max-width values) plus the codec's own demo distribution."""
    import numpy as np

    cases = [
        # multi-chunk run-heavy u32 (the RLE sweet spot; every codec must
        # still round-trip it)
        ("runs_u32", np.repeat(rng.integers(0, 60, 24).astype(np.uint32),
                               rng.integers(1, 50, 24))[:600], 512, None),
        # incompressible bytes, odd total length
        ("random_u8", rng.integers(0, 256, 397).astype(np.uint8), 256, None),
        # odd tail: last chunk shorter than chunk_elems
        ("odd_tail_u16", (rng.integers(0, 1 << 16, 333)
                          .astype(np.uint16)), 256, None),
        # single element / empty input (chunk-table edge cases)
        ("single_u32", np.asarray([2 ** 31 + 11], np.uint32), 512, None),
        ("empty_u32", np.zeros(0, np.uint32), 512, None),
        # max-width values (full 32-bit range)
        ("maxval_u32", np.concatenate(
            [np.full(40, 2 ** 32 - 1, np.uint32),
             rng.integers(0, 2 ** 32, 60, dtype=np.uint64)
                .astype(np.uint32)]), 256, None),
        # the codec's own representative distribution
        ("demo", codec.demo_data(320, rng), 512, None),
    ]
    if name == "bitpack":
        cases.append(("bits7", (rng.integers(0, 128, 500)
                                .astype(np.uint32)), 512, 7))
    return cases


def refuses(out: Path) -> bool:
    """Whether ``out`` is the reference's committed vector directory."""
    out = out.resolve()
    return out == VEC_DIR.resolve() or (
        out.exists() and VEC_DIR.exists() and out.samefile(VEC_DIR))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, required=True,
                    help="directory to write <codec>.json into (not "
                    "tests/vectors, which the reference owns)")
    args = ap.parse_args(argv)
    if refuses(args.out):
        print(f"refusing to write into {VEC_DIR}: the reference package "
              "owns the committed vectors; pass another --out and compare",
              file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch.core import encoders as enc, registry
    from repro_torch.core.format import blob_digest

    args.out.mkdir(parents=True, exist_ok=True)
    for name in sorted(registry.names()):
        codec = registry.get(name)
        rng = np.random.default_rng(sum(name.encode()))
        vectors = []
        for case, arr, chunk_bytes, bits in vector_inputs(name, codec, rng):
            blob = enc.compress(arr, name, chunk_bytes, bits=bits)
            vectors.append({
                "name": case,
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
                "chunk_bytes": chunk_bytes,
                "bits": bits,
                "data_b64": base64.b64encode(arr.tobytes()).decode(),
                "blob_digest": blob_digest(blob),
                "num_chunks": blob.num_chunks,
            })
        out = args.out / f"{name}.json"
        out.write_text(json.dumps(
            {"codec": name, "vectors": vectors}, indent=1))
        print(f"wrote {out} ({len(vectors)} vectors)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
