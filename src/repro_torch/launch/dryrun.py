"""Dry-run: count every (arch x shape x mesh) cell on ``meta`` tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

The counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for its production mesh on 512 virtual CPU devices and
reads XLA's cost and memory analyses; the port has no compiler, so it runs
one member's program on ``meta`` tensors (every shape and dtype, nothing
allocated or computed) under ``roofline.count.count_costs`` and reads the
ops that program dispatches.  The device is ``meta`` by definition, as the
reference's is a compiler without a TPU.

**The mesh** is the reference's 16 x 16 (data, model), or 2 x 16 x 16
(pod, data, model) with ``--mesh multi``, every member on ``meta``
(``launch.mesh.make_test_mesh(shape, axes, device="meta")``;
``make_production_mesh`` needs 256 distinct devices).

**The program** is ``steps.member_step``, the program each member runs
where it holds a device of its own, as member 0 runs it on ``meta``
(``distributed.spmd.Member.counting``): under policy ``tp`` it holds and
computes only its ``model`` share of every leaf the specs split (heads,
hidden units, experts, vocabulary, channels) and its DP block of the
batch (the global batch over the DP members, as ``sharding.batch_spec``
splits it), with the collectives over ``model`` that tensor and expert
parallelism need (``spmd``: the column-parallel inputs' gradients and the
row-parallel outputs all-reduced, the embedding's columns, a KV head cut
across members and Mamba2's packed projection all-gathered, the
vocab-parallel cross entropy's three all-reduces); a train step reduces
its gradient over the DP axes to the member's ZeRO-1 region, updates it
and all-gathers the regions back; a serve step's logits are gathered
whole, as its out-sharding asks.  So a cell's FLOPs, temp bytes and
collective bytes are one member's of the split program, as the
reference's per-device costs are.  Every member's blocks have one shape
(placement splits only dimensions that divide), so member 0's program is
every member's, up to which blocks it reads.

**Memory per member.**  Argument and output bytes are exact: member 0's
blocks under ``steps.train_shardings``, ``serve_shardings`` or
``batch_shardings`` and ``sharding.cache_spec`` (a prefill's logits over
the batch's DP axes), from shapes alone.  Temp bytes are the counter's
peak of storages the program creates (outputs included: an eager program
donates nothing).  A cell whose argument plus temp bytes exceed a card's
80 GB cannot run under this design; the record says so by its numbers.
``generated_code_size_in_bytes`` is 0 (there is no generated code).

**Costs.**  An eager count has no scan undercount: with ``--no-probes``
the program is counted at full depth.  By default it is counted at two
depths, 2g and 3g layers (g = ``attn_every`` for the hybrid, whose shared
block recurs every g layers, else 1; g and 2g for a model of fewer than
3g layers), and extrapolated linearly to the full depth, as the
reference's ``probe_costs`` does from g and 2g: FLOPs, bytes, collective
bytes and the temp peak.  The split program's peak is its activations'
(the parameters are arguments), and the first layer's is not the others':
its input is the embedding's output, which the caller still holds while
the later layers run, so the peak grows from one layer to two and not
after (a prefill's or a decode's) or by a first step unlike the rest (a
train step's).  That is what makes the recurrent families' train_4k and
prefill_32k affordable (their recurrences are Python loops over time,
~0.3 ms an op on ``meta``).  The extrapolated FLOPs, bytes and collective
bytes equal the full-depth count (the model's layer loop costs the same
each layer: ``models.model._layer_stack`` unbinds the stacked leaves once);
the temp peak lies within 1% of it (``tests/test_torch_dryrun.py``).  The
record's ``raw_scan_costs`` is the deepest program counted directly
(``n_layers`` beside it).  The count
runs in the config's own dtype: the reference's float32 probes and its
0.5 byte factor only correct XLA:CPU's bf16 weight copies, which an eager
bf16 program does not make.

**Results** are appended incrementally to
``experiments/torch_dryrun_results.json`` (not the reference's file),
keyed ``arch|shape|single|multi[|variant]``, with the reference's record
schema; ``compile_s`` is the count's wall time, and ``roofline`` is
``roofline.analysis.analyze`` of the counts with ``n_chips`` the mesh's
members.  These are counts on the CPU, divided by the H100 constants of
``roofline.analysis``: no time here was measured on a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, get_arch, shape_applicable
from repro_torch.distributed import sharding, spmd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import layers, model
from repro_torch.roofline import analysis
from repro_torch.roofline.count import Costs, count_costs

RESULTS = Path("experiments/torch_dryrun_results.json")

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(multi_pod: bool):
    """The reference's production mesh, every member on ``meta``."""
    shape, axes = MESHES[multi_pod]
    return mesh_lib.make_test_mesh(shape, axes, device="meta")


# --- §Perf variants (the reference's) ---------------------------------------

def _quantize_params(params):
    from repro_torch.models import moe as moe_lib
    out = dict(params)
    if "blocks" in out and isinstance(out["blocks"], dict) \
            and "moe" in out["blocks"]:
        blocks = dict(out["blocks"])
        blocks["moe"] = moe_lib.abstract_quantize_expert_weights(
            blocks["moe"])
        out["blocks"] = blocks
    return out


VARIANTS = {
    "": dict(),
    # paper-faithful attention (no triangular block skip)
    "noskip": dict(cfg=lambda c: dataclasses.replace(c, block_skip=False)),
    # fold the 'model' axis into pure DP
    "dp": dict(policy="dp"),
    # per-group decode dispatch
    "moe_groupdecode": dict(
        cfg=lambda c: dataclasses.replace(c, moe_decode_global=False)),
    # int8 expert weights, dequantized on use
    "quantx": dict(param_transform=_quantize_params),
    # chunkwise-parallel SSD
    "ssd128": dict(cfg=lambda c: dataclasses.replace(c, ssd_chunk=128)),
    "ssd256": dict(cfg=lambda c: dataclasses.replace(c, ssd_chunk=256)),
}


def _blocks(tree, shardings):
    """``tree``'s tensor leaves as member 0's blocks under ``shardings``:
    ``meta`` tensors of the block shapes (every member's have one
    shape)."""
    if isinstance(tree, dict):
        return {k: _blocks(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_blocks(v, s) for v, s in zip(tree, shardings))
    if not isinstance(tree, torch.Tensor):
        return tree
    return torch.empty(shardings.shard_shape(tree.shape), dtype=tree.dtype,
                       device="meta")


def member_bytes(tree, shardings) -> int:
    """Bytes of one member's blocks of ``tree``'s tensor leaves."""
    if isinstance(tree, dict):
        return sum(member_bytes(v, shardings[k]) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(member_bytes(v, s) for v, s in zip(tree, shardings))
    if not isinstance(tree, torch.Tensor):
        return 0
    n = 1
    for d in shardings.shard_shape(tree.shape):
        n *= d
    return n * tree.dtype.itemsize


def member_program(cfg, shape, mesh, param_transform=None):
    """``(run, argument bytes, output bytes)`` of member 0's step for
    ``shape`` on ``mesh`` (module docstring), every argument a ``meta``
    block; call under the sharding policy of the cell."""
    B = shape.global_batch
    meta = {"device": "meta"}
    if shape.kind == "train":
        params, opt_state = steps.abstract_train_state(cfg)
        ins, outs = steps.train_shardings(cfg, shape, mesh)
        args = (params, opt_state, steps.input_specs(cfg, shape))
        out_tree = (params, opt_state, torch.empty((), **meta))
        step = steps.build_train_step(cfg)
    else:
        params = model.abstract_params(cfg)
        if param_transform:
            params = param_transform(params)
        p_sh = sharding.param_shardings(params, mesh)
        b_sh = steps.batch_shardings(cfg, shape, mesh)
        batch = steps.input_specs(cfg, shape)
        logits = torch.empty((B, 1, cfg.vocab),
                             dtype=model.DTYPES[cfg.dtype], **meta)
        if shape.kind == "prefill":
            bax = sharding.batch_spec(mesh, B)
            args, ins = (params, batch), (p_sh, b_sh)
            out_tree = logits
            outs = sharding.NamedSharding(mesh, sharding.P(*bax, None, None))
            step = steps.build_prefill_step(cfg)
        else:
            cache = model.init_cache(cfg, B, shape.seq_len, device="meta")
            c_sh = {k: sharding.NamedSharding(mesh, v) for k, v in
                    sharding.cache_spec(mesh, cfg, B).items()}
            args, ins = (params, cache, batch), (p_sh, c_sh, b_sh)
            out_tree = (logits, cache)
            outs = (sharding.NamedSharding(mesh, sharding.P()), c_sh)
            step = steps.build_serve_step(cfg)
    blocks = _blocks(args, ins)
    member = spmd.Member.counting(mesh, 0, sharding.current_policy())
    run = steps.member_step(step, ins, outs, member=member)
    return (lambda: run(*blocks)), member_bytes(args, ins), \
        member_bytes(out_tree, outs)


def count_cell(cfg, shape, mesh, param_transform=None) -> dict:
    """Member 0's program counted once: ``{"costs": Costs, "argument",
    "output", "seconds"}``."""
    run, arg, out = member_program(cfg, shape, mesh, param_transform)
    # the rope frequencies are uploaded once a device and kept: upload them
    # in every count, so that no count depends on the counts before it
    layers._rope_freqs_on.cache_clear()
    t0 = time.time()
    with count_costs() as counter:
        result = run()
        del result
    return {"costs": counter.at("meta"), "argument": arg, "output": out,
            "seconds": time.time() - t0}


def _lincomb(a: Costs, b: Costs, fa: float, fb: float) -> Costs:
    kinds = set(a.coll) | set(b.coll)
    return Costs(flops=fa * a.flops + fb * b.flops,
                 bytes=fa * a.bytes + fb * b.bytes,
                 coll={k: fa * a.coll.get(k, 0) + fb * b.coll.get(k, 0)
                       for k in kinds},
                 peak=fa * a.peak + fb * b.peak)


def probe_costs(cfg, shape, mesh, param_transform=None) -> dict:
    """The program counted at p1 = 2g and p2 = 3g layers (g and 2g below 3g
    layers; module docstring) and extrapolated linearly to
    ``cfg.n_layers``: cost(L) = cost(p1) + (L - p1) / g * (cost(p2) -
    cost(p1)), FLOPs, bytes, collective bytes and the temp peak.  Returns
    ``count_cell``'s dict for the extrapolation, with the p2 count as
    ``raw`` (its ``n_layers`` beside it)."""
    g = cfg.attn_every if cfg.attn_every else 1
    p1, p2 = (2 * g, 3 * g) if cfg.n_layers >= 3 * g else (g, 2 * g)
    c1 = count_cell(dataclasses.replace(cfg, n_layers=p1), shape, mesh,
                    param_transform)
    c2 = count_cell(dataclasses.replace(cfg, n_layers=p2), shape, mesh,
                    param_transform)
    steps_n = (cfg.n_layers - p1) / g
    costs = _lincomb(c1["costs"], _lincomb(c2["costs"], c1["costs"], 1.0,
                                           -1.0), 1.0, steps_n)
    return {"costs": costs, "seconds": c1["seconds"] + c2["seconds"],
            "raw": c2["costs"], "raw_layers": p2}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             extra_tag: str = "", probes: bool = True,
             variant: str = "") -> dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}
    vspec = VARIANTS[variant]
    if "cfg" in vspec:
        cfg = vspec["cfg"](cfg)
    policy = vspec.get("policy", "tp")
    ptrans = vspec.get("param_transform")

    mesh = make_mesh(multi_pod)
    n_chips = mesh.size
    t0 = time.time()
    with sharding.use_mesh(None, policy):
        # argument and output bytes at full depth, from shapes alone
        _, arg, out = member_program(cfg, shape, mesh, ptrans)
        if probes:
            got = probe_costs(cfg, shape, mesh, ptrans)
            raw, raw_layers = got["raw"], got["raw_layers"]
        else:
            got = count_cell(cfg, shape, mesh, ptrans)
            raw, raw_layers = got["costs"], cfg.n_layers
    cost = got["costs"]
    mem = {"argument_size_in_bytes": int(arg),
           "output_size_in_bytes": int(out),
           "temp_size_in_bytes": int(round(cost.peak)),
           "generated_code_size_in_bytes": 0}
    print(mem)
    roof = analysis.analyze(cost, analysis.model_flops_for(cfg, shape),
                            n_chips)
    return {
        "status": "ok",
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "compile_s": round(got["seconds"], 1),
        "total_s": round(time.time() - t0, 1),
        "memory": mem,
        "raw_scan_costs": {"flops": raw.flops, "bytes": raw.bytes,
                           "coll": dict(raw.coll), "n_layers": raw_layers},
        "roofline": roof.to_dict(),
        "tag": extra_tag,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--variant", default="", choices=sorted(VARIANTS),
                    help="the reference's perf variants")
    ap.add_argument("--no-probes", action="store_true",
                    help="count each program at full depth instead of "
                         "extrapolating from two shallower depths")
    args = ap.parse_args(argv)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    archs = configs.list_archs() if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                key = f"{arch}|{shape}|{'multi' if multi else 'single'}"
                if args.variant:
                    key += f"|{args.variant}"
                if key in results and results[key].get("status") in (
                        "ok", "skipped") and not args.force:
                    print(f"[cached] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    res = run_cell(arch, shape, multi, args.variant,
                                   variant=args.variant,
                                   probes=not args.no_probes)
                except Exception as e:  # record failures; they are bugs
                    res = {"status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(res["error"])
                results[key] = res
                out_path.write_text(json.dumps(results, indent=1))
                if res["status"] == "ok":
                    r = res["roofline"]
                    print(f"  ok: count={res['compile_s']}s "
                          f"dom={r['dominant']} "
                          f"t=({r['t_compute_s']:.4f},{r['t_memory_s']:.4f},"
                          f"{r['t_collective_s']:.4f})s "
                          f"useful={r['useful_flops_ratio']:.2f}",
                          flush=True)

    n_ok = sum(1 for v in results.values() if v.get("status") == "ok")
    n_skip = sum(1 for v in results.values() if v.get("status") == "skipped")
    n_err = sum(1 for v in results.values() if v.get("status") == "error")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
