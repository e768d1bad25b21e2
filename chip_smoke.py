#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--gib 1.0] [--reps 5]

Phases, each of which must pass (any failure exits non-zero, with no result
line):

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. kernel build (nvcc, sm_90a) and its time;
  3. kernel vs its plain PyTorch version on the card, bit-exact: rle_v1 and
     rle_v2 at widths 1/2/4, on a 64-chunk table of 128 KiB chunks plus edge
     rows (empty chunk, one-element tail, 16386-long run, delta
     wraparound, literals at odd offsets);
  4. the main path at scale: ``api.compress_many`` -> ``api.decompress_many
     (device_out=True)`` decoding >= ``--gib`` GiB of a table-scan-shaped
     column set in one call, checked against the inputs, with the kernel's
     launch count, decode time, output GB/s and the bytes bound;
  5. a fused dequant epilogue against its plain torch version;
  6. a JSON line per kernel, then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX and nothing of the JAX package ``repro``.  It
exits non-zero without a card, or without the port's sources beside it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
CHUNK_BYTES = 128 * 1024           # the paper's chunk size


def log(msg: str) -> None:
    print(msg, flush=True)


def ms_of(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bound_ms(table_bytes_read: int, n: int, chunk_elems: int,
             width: int) -> float:
    """Least time for one decode: compressed bytes and out_lens read once,
    the (n, chunk_elems) output written once, at the card's memory rate."""
    return (table_bytes_read + 4 * n + n * chunk_elems * width) \
        / HBM_BYTES_PER_S * 1e3


# --------------------------------------------------------------------------
# data, made from the seed
# --------------------------------------------------------------------------


def runs(rng, values: np.ndarray, max_run: int, n: int) -> np.ndarray:
    out = np.repeat(values, rng.integers(1, max_run, len(values)))
    if len(out) < n:
        out = np.resize(out, n)
    return out[:n]


def scan_columns(rng, col_bytes: int):
    """A table scan's columns: (name, array, codec)."""
    n4 = col_bytes // 4
    m = n4 // 30 + 1
    ids = runs(rng, np.cumsum(rng.integers(1, 1000, m)).astype(np.uint32),
               120, n4)
    seg = rng.integers(100, 5000, n4 // 100 + 1)
    steps = np.repeat(rng.integers(-5, 6, len(seg)), seg)[:n4]
    ramp = (np.int64(1 << 20) + np.cumsum(steps)).astype(np.int32)
    vals = runs(rng, rng.normal(size=m).astype(np.float32), 80, n4)
    flags = runs(rng, rng.integers(0, 4, col_bytes // 60 + 1).astype(np.uint8),
                 200, col_bytes)
    codes = runs(rng, rng.integers(0, 1000, col_bytes // 100 + 1)
                 .astype(np.uint16), 100, col_bytes // 2)
    n8 = col_bytes // 8
    ts_steps = np.repeat(rng.choice(np.array([0, 1000, 5000]), n8 // 200 + 1),
                         200)[:n8]
    ts = np.int64(1_700_000_000_000_000_000) + np.cumsum(ts_steps)
    return [("ids_u32", ids, "rle_v1"), ("ramp_i32", ramp, "rle_v2"),
            ("vals_f32", vals, "rle_v1"), ("flags_u8", flags, "rle_v2"),
            ("codes_u16", codes, "rle_v1"), ("ts_i64", ts, "rle_v2")]


def edge_arrays(rng, width: int, chunk_elems: int):
    """Edge rows for one width, each its own blob."""
    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]
    top = 1 << (8 * width)
    base = runs(rng, rng.integers(0, 50, 64).astype(dt), 40, chunk_elems)
    odd = np.concatenate([  # literal runs at odd byte offsets
        np.concatenate([rng.integers(0, top, 5, dtype=np.uint64).astype(dt),
                        np.full(3, 7, dt)]) for _ in range(200)])
    wrap = ((top - 50 + 7 * np.arange(3000, dtype=np.int64)) % top).astype(dt)
    return {
        "empty": np.zeros(0, dt),
        "one_elem_tail": np.resize(base, chunk_elems + 1),
        "run_16386": np.full(16386 + 5, 9, dt),
        "delta_wrap": wrap,
        "odd_literals": odd,
    }


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_env() -> None:
    log(f"== 1 environment: python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])


def phase_build(cuda_rle) -> None:
    t0 = time.perf_counter()
    path = cuda_rle.build()
    dt = time.perf_counter() - t0
    log(f"== 2 kernel build: {path.name} in {dt:.2f} s")
    for line in cuda_rle.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"   ptxas: {line.strip()}")


def phase_kernel_vs_plain(rng, fmt, enc, cuda_rle, errs, device) -> None:
    log("== 3 kernel vs plain version on the card (bit-exact)")
    for codec in ("rle_v1", "rle_v2"):
        for width in (1, 2, 4):
            chunk_elems = CHUNK_BYTES // width
            dt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]
            moderate = runs(rng, rng.integers(0, 200, 64 * chunk_elems // 20)
                            .astype(dt), 40, 64 * chunk_elems)
            arrays = {"moderate_64": moderate,
                      **edge_arrays(rng, width, chunk_elems)}
            blobs = [enc.compress(a, codec, CHUNK_BYTES)
                     for a in arrays.values()]
            table = fmt.concat_blobs(blobs)
            dev = fmt.to_device(table, device)
            kern = cuda_rle.decode(codec, dev["comp"], dev["out_lens"],
                                   chunk_elems=chunk_elems, width=width)
            plain = cuda_rle.plain(codec, dev["comp"], dev["out_lens"],
                                   chunk_elems=chunk_elems, width=width)
            torch.cuda.synchronize()
            err = max_abs_err(kern, plain)
            errs[codec] = max(errs[codec], err)
            host = kern.cpu().numpy()
            row = 0
            for (name, a), b in zip(arrays.items(), blobs):
                got = fmt.reassemble(b, host[row:row + b.num_chunks].copy())
                if not np.array_equal(got, a):
                    raise AssertionError(f"{codec} w{width} {name}: kernel "
                                         "output differs from the input")
                row += b.num_chunks
            cap_err = group_cap_err(rng, fmt, cuda_rle, codec, width, device)
            errs[codec] = max(errs[codec], cap_err)
            log(f"   {codec} w{width}: {table.num_chunks} rows x "
                f"{chunk_elems} elems, kernel == plain "
                f"(max_abs_err {err}), edge rows == inputs; group-cap rows "
                f"max_abs_err {cap_err}")
            if err or cap_err:
                raise AssertionError(f"{codec} w{width}: kernel differs "
                                     f"from plain by {max(err, cap_err)}")


def group_cap_err(rng, fmt, cuda_rle, codec, width, device) -> int:
    """Rows of one-literal groups, more than ``max_groups`` admits: the last
    admitted group must cover every lane up to out_len, as in the
    reference's lane->group map.  No encoder writes such rows, so they are
    built here, on a 64-element chunk."""
    hdr = 255 if codec == "rle_v1" else 2 << 6      # one literal
    groups = rng.integers(0, 256, (3, 200, 1 + width)).astype(np.uint8)
    groups[:, :, 0] = hdr
    comp = groups.reshape(3, -1)
    table = fmt.CompressedBlob(
        codec=codec, width=width, chunk_elems=64, total_elems=3 * 64,
        orig_dtype=str(np.dtype(f"u{width}")), orig_shape=(3 * 64,),
        comp=comp, comp_lens=np.full(3, comp.shape[1], np.int32),
        out_lens=np.array([64, 50, 7], np.int32))
    dev = fmt.to_device(table, device)
    kern = cuda_rle.decode(codec, dev["comp"], dev["out_lens"],
                           chunk_elems=64, width=width)
    plain = cuda_rle.plain(codec, dev["comp"], dev["out_lens"],
                           chunk_elems=64, width=width)
    return max_abs_err(kern, plain)


def phase_main(args, rng, api, plan_mod, transfers, cuda_rle, engine, errs):
    log("== 4 main path: compress_many -> decompress_many(device_out=True) "
        "on cuda")
    col_bytes = 64 << 20
    target = int(args.gib * (1 << 30))
    t0 = time.perf_counter()
    cols = scan_columns(rng, min(col_bytes, max(1 << 20, target // 6)))
    distinct = api.compress_many([a for _, a, _ in cols],
                                 [c for _, _, c in cols], CHUNK_BYTES)
    encode_s = time.perf_counter() - t0
    per_copy = sum(a.nbytes for _, a, _ in cols)
    copies = -(-target // per_copy)
    arrays = [a for _, a, _ in cols] * copies
    cas = distinct * copies
    out_bytes = per_copy * copies
    comp_bytes = sum(ca.compressed_bytes for ca in cas)
    flat = [b for ca in cas for b in ca.blobs]
    t0 = time.perf_counter()
    plan = plan_mod.DecodePlan.build(flat)
    build_ms = (time.perf_counter() - t0) * 1e3
    n_groups = plan.num_dispatches
    log(f"   {len(cols)} distinct columns ({per_copy / 2**20:.0f} MiB, "
        f"encoded in {encode_s:.1f} s) listed {copies}x: {len(cas)} arrays, "
        f"{len(flat)} blobs, {plan.num_chunks} chunks, {n_groups} groups")

    # one call through the user's entry point, counted
    cuda_rle.LAUNCHES = 0
    for k in cuda_rle.CODEC_LAUNCHES:
        cuda_rle.CODEC_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    outs = api.decompress_many(cas, engine, device_out=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(cuda_rle.CODEC_LAUNCHES)
    if cuda_rle.LAUNCHES != n_groups:
        raise AssertionError(f"LAUNCHES grew by {cuda_rle.LAUNCHES}, "
                             f"expected {n_groups} (one per plan group)")
    log(f"   LAUNCHES grew by {cuda_rle.LAUNCHES} == {n_groups} plan groups "
        f"{launches}; first call {first_s * 1e3:.1f} ms (plan build, "
        "staging, decode)")
    # checked on the host only now, after the counted call
    for i, (a, o) in enumerate(zip(arrays, outs)):
        if o.device != engine.device:
            raise AssertionError(f"array {i} came back on {o.device}")
        got = o.cpu().numpy()
        if got.dtype != a.dtype or not np.array_equal(got, a):
            raise AssertionError(f"array {i} ({a.dtype}) differs from input")
    log(f"   {len(outs)} arrays bit-exact against the numpy inputs")
    del outs

    # end-to-end call time (host clock; includes plan build and staging)
    e2e = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        o = api.decompress_many(cas, engine, device_out=True)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
        del o
    # decode time of a staged plan, under the no-host-transfer guard
    t0 = time.perf_counter()
    plan.stage(engine.device)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    plan.execute_device(engine)
    torch.cuda.synchronize()

    def run_staged():
        with transfers.no_host_transfers():
            plan.execute_device(engine)

    dec_ms = ms_of(run_staged, args.reps)
    bound = sum(bound_ms(int(g.merged.comp_lens.sum()), g.num_chunks,
                         g.key[2], g.key[1]) for g in plan.groups)
    log(f"   output {out_bytes / 2**30:.3f} GiB, compressed "
        f"{comp_bytes / 2**20:.1f} MiB (ratio {comp_bytes / out_bytes:.4f})")
    log(f"   decompress_many end to end: median "
        f"{np.median(e2e) * 1e3:.2f} ms over {args.reps}; of one call, "
        f"DecodePlan.build {build_ms:.2f} ms and stage {stage_ms:.2f} ms "
        "(host clock, once each)")
    log(f"   staged decode (execute_device, no host transfers): median "
        f"{dec_ms:.3f} ms over {args.reps} = "
        f"{out_bytes / dec_ms / 1e6:.1f} GB/s of output; bytes bound "
        f"{bound:.3f} ms ({bound / dec_ms * 100:.1f}% of it)")
    log("   library_ms: no single PyTorch call computes an RLE decode")

    # per kernel: launch time, plain version time, bound, on the main
    # path's own group tables
    per = {c: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
           for c in cuda_rle.CODEC_IDS}
    for gi, g in enumerate(plan.groups):
        codec, width, chunk_elems, _ = g.key
        dev = plan._staged[engine.device][gi]
        comp, lens = dev["comp"], dev["out_lens"]

        def kern():
            return cuda_rle.decode(codec, comp, lens,
                                   chunk_elems=chunk_elems, width=width)

        k_ms = ms_of(kern, args.reps)
        out_k = kern()
        plain_ms = ms_of(lambda: cuda_rle.plain(
            codec, comp, lens, chunk_elems=chunk_elems, width=width), 1)
        out_p = cuda_rle.plain(codec, comp, lens, chunk_elems=chunk_elems,
                               width=width)
        err = max_abs_err(out_k, out_p)
        del out_k, out_p
        torch.cuda.empty_cache()
        errs[codec] = max(errs[codec], err)
        b = bound_ms(int(g.merged.comp_lens.sum()), g.num_chunks, chunk_elems,
                     width)
        per[codec]["ms"] += k_ms
        per[codec]["plain_ms"] += plain_ms
        per[codec]["bound_ms"] += b
        log(f"   group {g.key[:3]}: {g.num_chunks} chunks, kernel "
            f"{k_ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b:.3f} ms, "
            f"max_abs_err {err}")
        if err:
            raise AssertionError(f"group {g.key}: kernel differs from plain")
    return launches, per, distinct, cols


def phase_epilogue(api, harness, engine, distinct, cols) -> None:
    log("== 5 epilogue: u8 column -> float32 (x - zero) * scale")
    idx = [n for n, _, _ in cols].index("flags_u8")
    ca, flags = distinct[idx], cols[idx][1]
    epi = harness.Epilogue(out_dtype="float32", scale_key="epi_scale",
                           zero_key="epi_zero")
    operands = {"epi_scale": np.float32(0.37), "epi_zero": np.uint8(2)}
    [got] = api.decompress_many([ca], engine, device_out=True, epilogue=epi,
                                epilogue_operands=operands)
    x = torch.from_numpy(flags).to(engine.device)
    want = ((x.to(torch.float32)
             - torch.tensor(2, dtype=torch.uint8, device=x.device)
             .to(torch.float32))
            * torch.tensor(0.37, dtype=torch.float32, device=x.device))
    if got.dtype != torch.float32 or not torch.equal(got, want):
        raise AssertionError("epilogue output differs from the plain torch "
                             "version")
    log(f"   {flags.size} elements, exact against the plain torch version")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gib", type=float, default=1.0,
                    help="uncompressed GiB decoded by the main-path call")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc" / "two_phase_rle.cu").exists():
        print(f"FAIL: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.core import api, encoders as enc, format as fmt
    from repro_torch.core import plan as plan_mod, transfers
    from repro_torch.core.engine import CodagEngine
    from repro_torch.kernels import cuda_rle, harness

    rng = np.random.default_rng(args.seed)
    phase_env()
    phase_build(cuda_rle)
    engine = CodagEngine()
    errs = {c: 0 for c in cuda_rle.CODEC_IDS}
    phase_kernel_vs_plain(rng, fmt, enc, cuda_rle, errs, engine.device)
    launches, per, distinct, cols = phase_main(
        args, rng, api, plan_mod, transfers, cuda_rle, engine, errs)
    phase_epilogue(api, harness, engine, distinct, cols)
    kernels = [{
        "name": f"two_phase_rle<{codec}>",
        "route": "cuda",
        "source": "src/repro_torch/csrc/two_phase_rle.cu",
        "replaces": "src/repro/kernels/harness.py:359",
        "launches": launches[codec],
        "max_abs_err": errs[codec],
        "ms": per[codec]["ms"],
        "plain_ms": per[codec]["plain_ms"],
        "bound_ms": per[codec]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    } for codec in cuda_rle.CODEC_IDS]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on the main "
                                 "path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
