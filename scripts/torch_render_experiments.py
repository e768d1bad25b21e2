"""Regenerate the generated sections of a markdown document from the port's
dry-run records.  Keeps the narrative sections; replaces the marked blocks.

The counterpart of ``scripts/render_experiments.py``, with the same tables
and blocks (``ROOFLINE_SINGLE``: the single-pod cells' roofline;
``MEM_TABLE``: every ``ok`` cell's memory; ``PERF_VARIANTS``: the perf
variants' roofline), rendered from the records of ``python -m
repro_torch.launch.dryrun`` (``dryrun.RESULTS``) and the port's variants
file.  The document must exist, as the reference's must:

    PYTHONPATH=src python scripts/torch_render_experiments.py
    PYTHONPATH=src python scripts/torch_render_experiments.py \\
        --results R.json --variants V.json --doc DOC.md
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT / "src") not in sys.path:
    sys.path.insert(0, str(_ROOT / "src"))

from repro_torch.launch.dryrun import RESULTS  # noqa: E402

RES = RESULTS
VAR = Path("experiments/torch_perf_variants.json")
EXP = Path("EXPERIMENTS.md")


def roofline_table(results: dict) -> str:
    lines = ["| arch | shape | mesh | t_comp (s) | t_mem (s) | t_coll (s) "
             "| dominant | useful | mfu_bound |",
             "|---|---|---|---|---|---|---|---|---|"]
    for key, cell in sorted(results.items()):
        parts = key.split("|")
        arch, shape, mesh = parts[:3]
        tag = parts[3] if len(parts) > 3 else ""
        label = f"{arch}{'+' + tag if tag else ''}"
        if cell.get("status") == "skipped":
            lines.append(f"| {label} | {shape} | {mesh} | — | — | — | "
                         f"skipped (full-attn @500k) | — | — |")
            continue
        if cell.get("status") != "ok":
            lines.append(f"| {label} | {shape} | {mesh} | ERROR | | | | | |")
            continue
        r = cell["roofline"]
        lines.append(
            f"| {label} | {shape} | {mesh} | {r['t_compute_s']:.4f} "
            f"| {r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} "
            f"| {r['dominant']} | {r['useful_flops_ratio']:.2f} "
            f"| {r['mfu_bound']:.3f} |")
    return "\n".join(lines)


def memory_table(results: dict) -> str:
    lines = ["| arch | shape | mesh | args GB/dev | temp GB/dev | compile s |",
             "|---|---|---|---|---|---|"]
    for key, cell in sorted(results.items()):
        if cell.get("status") != "ok":
            continue
        arch, shape, mesh = key.split("|")[:3]
        m = cell.get("memory", {})
        lines.append(
            f"| {arch} | {shape} | {mesh} "
            f"| {m.get('argument_size_in_bytes', 0)/1e9:.2f} "
            f"| {m.get('temp_size_in_bytes', 0)/1e9:.2f} "
            f"| {cell.get('compile_s', 0)} |")
    return "\n".join(lines)


def replace_block(text: str, marker: str, content: str) -> str:
    pat = re.compile(
        rf"(<!-- BEGIN {marker} -->).*?(<!-- END {marker} -->)", re.S)
    return pat.sub(rf"\1\n{content}\n\2", text)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--results", type=Path, default=RES,
                    help="the dry-run's records")
    ap.add_argument("--variants", type=Path, default=VAR,
                    help="the perf variants' records")
    ap.add_argument("--doc", type=Path, default=EXP,
                    help="the markdown document whose blocks are replaced")
    args = ap.parse_args(argv)
    text = args.doc.read_text()
    if args.results.exists():
        results = json.loads(args.results.read_text())
        single = {k: v for k, v in results.items() if "|single" in k}
        text = replace_block(text, "ROOFLINE_SINGLE", roofline_table(single))
        text = replace_block(text, "MEM_TABLE", memory_table(results))
    if args.variants.exists():
        variants = json.loads(args.variants.read_text())
        text = replace_block(text, "PERF_VARIANTS", roofline_table(variants))
    args.doc.write_text(text)
    print(f"{args.doc} updated")


if __name__ == "__main__":
    main()
