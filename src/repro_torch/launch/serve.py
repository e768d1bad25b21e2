"""Serving entry point: sequential per-token prefill + cached greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --preset tiny --batch 8 --prompt-len 64 --gen 32 [--device cpu] \\
        [--n-layers N]

The counterpart of ``repro/launch/serve.py``: a batch of requests is
prefilled into the KV / recurrent-state cache one token position a step
(``prefill_into_cache`` loops ``decode_step`` over the prompt), then
decoded greedily one token a step.  The reference's flags and presets
(``tiny``, ``small``, ``full``) plus ``--device`` (default ``cuda``, which
must exist) and ``--n-layers`` (a preset's depth cut, widths unchanged, as
``launch.train`` takes it).  ``--mesh 2x2x2`` serves under a mesh whose
members share the device: the parameters and the cache placed by
``steps.serve_shardings``, every step ``steps.sharded_step`` of the serve
step.  ``--spmd`` serves the same ``--mesh`` with one process a member on
``--device`` (``launch.mesh.spawn``, ``gloo``): each holds only its blocks
of the parameters and the cache and its DP block of the requests, and
every step is ``steps.member_step`` of the serve step (under ``tp`` its
``model`` share; the logits gathered whole, so every member takes the
same greedy token).  Timings are host clock around work that ends in a
device synchronise.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import ShapeSpec, get_arch, reduced
from repro_torch.core.engine import resolve_device
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--preset", choices=("tiny", "small", "full"),
                    default="tiny")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--compile-cache", nargs="?", const=True, default=None,
                    metavar="DIR",
                    help="persistent kernel-library cache (optional dir; "
                         "default dir when given bare)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the preset's depth to this many layers "
                         "(widths unchanged)")
    ap.add_argument("--mesh", default=None, metavar="SHAPE",
                    help="serve under a mesh of this shape whose members "
                         "share the device, e.g. 2x2x2 (pod, data, model)")
    ap.add_argument("--spmd", action="store_true",
                    help="with --mesh: one process a member on --device "
                         "(gloo), each holding and computing only its "
                         "share (steps.member_step)")
    return ap


def resolve_cfg(args):
    base = get_arch(args.arch)
    cfg = {"tiny": reduced(base),
           "small": reduced(base, n_layers=4, d_model=256, vocab=2048),
           "full": base}[args.preset]
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def prefill_into_cache(cfg, params, cache, tokens: torch.Tensor,
                       decode: Optional[Callable] = None):
    """Sequential prefill via decode steps (the cache-filling path).
    ``decode(params, cache, tokens) -> (logits, cache)``: the step
    (default ``model.decode_step``)."""
    decode = decode or functools.partial(model.decode_step, cfg)
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = decode(params, cache, tokens[:, i:i + 1])
    return logits, cache


def mesh_decode(cfg, mesh, batch: int, max_seq: int):
    """``(decode, (param shardings, cache shardings))``: the serve step
    under ``mesh`` and the current sharding policy (``steps.sharded_step``
    on ``steps.serve_shardings``), as ``prefill_into_cache`` takes a step;
    its logits come back whole, its cache placed."""
    shape = ShapeSpec("decode", max_seq, batch, "decode")
    with sharding.use_mesh(mesh, sharding.current_policy()):
        ins, outs = steps.serve_shardings(cfg, shape, mesh)
        step = steps.sharded_step(steps.build_serve_step(cfg), ins, outs)

    def decode(params, cache, tokens):
        logits, cache = step(params, cache, {"tokens": tokens})
        return logits.full(), cache

    return decode, ins[:2]


@torch.no_grad()
def generate(cfg, params, prompts: torch.Tensor, gen: int,
             max_seq: Optional[int] = None, *, mesh=None) -> dict:
    """Prefill ``prompts`` (B, P) into a fresh cache, then ``gen`` greedy
    tokens.  Returns the tokens ``(B, gen)`` (numpy), the last logits, the
    cache, and the prefill and decode seconds.  ``mesh``: every step under
    it (:func:`mesh_decode`); the parameters and the cache are placed
    first, and the cache comes back placed."""
    device = prompts.device
    B, P = prompts.shape
    max_seq = max_seq or P + gen + 8
    cache = model.init_cache(cfg, B, max_seq, device=device)
    decode = None
    if mesh is not None:
        decode, (p_sh, c_sh) = mesh_decode(cfg, mesh, B, max_seq)
        params, cache = sharding.place(params, p_sh), \
            sharding.place(cache, c_sh)
    decode = decode or functools.partial(model.decode_step, cfg)
    _sync(device)
    t0 = time.time()
    logits, cache = prefill_into_cache(cfg, params, cache, prompts, decode)
    _sync(device)
    t_prefill = time.time() - t0
    out = []
    cur = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t0 = time.time()
    for _ in range(gen):
        out.append(cur)
        logits, cache = decode(params, cache, cur)
        cur = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    _sync(device)
    t_decode = time.time() - t0
    return {"tokens": torch.cat(out, dim=1).cpu().numpy(), "logits": logits,
            "cache": cache, "prefill_s": t_prefill, "decode_s": t_decode}


def member_decode(cfg, member, mesh, batch: int, max_seq: int):
    """``(decode, (param shardings, cache shardings, batch shardings))``:
    the serve step as ``member``'s program (``steps.member_step`` on
    ``steps.serve_shardings``), as ``prefill_into_cache`` takes a step; it
    takes the member's blocks, and its logits come back whole."""
    from repro_torch.distributed import spmd
    shape = ShapeSpec("decode", max_seq, batch, "decode")
    with sharding.use_mesh(None, member.policy):
        ins, outs = steps.serve_shardings(cfg, shape, mesh)
    step = steps.member_step(steps.build_serve_step(cfg), ins, outs,
                             member=member)
    tok_sh = ins[2]["tokens"]

    def decode(params, cache, tokens):
        return step(params, cache,
                    {"tokens": spmd.blocks(tokens, tok_sh, member.index)})

    return decode, ins


def _spmd_rank(args, cache_dir) -> dict:
    """One member's process of ``--spmd``: :func:`generate`'s loop on the
    member's blocks; the tokens (every member's are the same) and its
    cache blocks on the CPU."""
    from repro_torch.distributed import spmd
    if cache_dir is not None:
        from repro_torch.core import tuning
        tuning.enable_compile_cache(cache_dir)
    cfg = resolve_cfg(args)
    shape = mesh_lib.parse_mesh(args.mesh, device="meta")
    mesh = mesh_lib.world_mesh(tuple(shape.shape.values()),
                               shape.axis_names, device=args.device)
    member = spmd.Member.join(mesh)
    device = mesh.member_device()
    params = model.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)).to(
        device)
    max_seq = args.prompt_len + args.gen + 8
    decode, (p_sh, c_sh, _) = member_decode(cfg, member, mesh, args.batch,
                                            max_seq)
    params = spmd.blocks(params, p_sh, member.index)
    cache = spmd.blocks(model.init_cache(cfg, args.batch, max_seq,
                                         device=device), c_sh, member.index)
    with torch.no_grad():
        _sync(device)
        t0 = time.time()
        logits, cache = prefill_into_cache(cfg, params, cache, prompts,
                                           decode)
        _sync(device)
        t_prefill = time.time() - t0
        out = []
        cur = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        t0 = time.time()
        for _ in range(args.gen):
            out.append(cur)
            logits, cache = decode(params, cache, cur)
            cur = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        _sync(device)
    return {"tokens": torch.cat(out, dim=1).cpu().numpy(),
            "logits": logits.cpu(), "prefill_s": t_prefill,
            "decode_s": time.time() - t0,
            "cache": {k: v.cpu() if isinstance(v, torch.Tensor) else v
                      for k, v in cache.items()}}


def _run_spmd(args) -> dict:
    if not args.mesh:
        raise ValueError("--spmd needs --mesh")
    from repro_torch.core import tuning
    cache = tuning.compile_cache_dir()
    resolve_device(args.device)
    n = mesh_lib.parse_mesh(args.mesh, device="meta").size
    ranks = mesh_lib.spawn(_spmd_rank, n, (args, None if cache is None
                                           else str(cache)),
                           device=args.device)
    if any(not np.array_equal(r["tokens"], ranks[0]["tokens"])
           for r in ranks):
        raise RuntimeError("the members took different tokens")
    out = dict(ranks[0])
    out["caches"] = [r["cache"] for r in ranks]
    out["cfg"] = resolve_cfg(args)
    return out


def run_serving(args, params=None) -> dict:
    """Drive one serving run; ``params`` (the model's tree on the device)
    replaces the random init, e.g. weights carried across from the JAX
    package.  Returns ``generate``'s dict with the config, the parameters
    and the prompts."""
    if args.compile_cache:
        from repro_torch.core import tuning
        path = tuning.enable_compile_cache(
            None if args.compile_cache is True else args.compile_cache)
        print(f"compile cache: {path}")
    device = resolve_device(args.device)
    cfg = resolve_cfg(args)
    cut = (f" depth cut {get_arch(args.arch).n_layers} -> {cfg.n_layers}"
           if args.n_layers else "")
    print(f"arch={cfg.name} preset={args.preset} device={device}{cut}")
    if args.spmd:
        if params is not None:
            raise ValueError("--spmd draws its own parameters")
        return _run_spmd(args)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init_params(cfg, gen, device=device)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32))
    mesh = (mesh_lib.parse_mesh(args.mesh, device=str(device))
            if args.mesh else None)
    out = generate(cfg, params, prompts.to(device), args.gen, mesh=mesh)
    out.update(cfg=cfg, params=params, prompts=prompts)
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    m = run_serving(args)
    gen, logits = m["tokens"], m["logits"]
    tok_s = args.batch * args.gen / m["decode_s"]
    print(f"prefill (per-token loop): {args.batch}x{args.prompt_len} "
          f"in {m['prefill_s']:.2f}s")
    print(f"decode:  {args.batch}x{args.gen} in {m['decode_s']:.2f}s "
          f"({tok_s:.1f} tok/s)")
    print("sample tokens:", gen[0, :16].tolist())
    if gen.shape != (args.batch, args.gen):
        raise RuntimeError(f"generated {gen.shape}")
    if bool(torch.isnan(logits.float()).any()):
        raise RuntimeError("NaN logits")
    print("OK")


if __name__ == "__main__":
    main()
