"""Training entry point on one device: the compressed data pipeline, the
fault-tolerant loop, and DiLoCo pods sharing the device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --preset tiny --steps 50 --batch 4 --seq 128 [--device cpu] \\
        [--grad-int8] [--compress-moments] [--spill-dir DIR] \\
        [--fail-at 12 --ckpt-every 5] [--n-layers N]

    # compressed multi-pod training: 2 pods, int8 outer wire, overlapped sync
    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
        --steps 32 --diloco 2 --outer-every 8 --grad-int8 [--device cpu]

The counterpart of ``repro/launch/train.py``'s single-device path: token
shards compressed with a registry codec (rle_v2 by default) and decoded on
the device by the loader (``data/pipeline.py``; ``--spill-dir`` pages them
through the tiered blob store), AdamW (``--compress-moments``: int8
moments), checkpoints and restarts (``distributed/fault.py``; ``--fail-at``
injects failures), and ``--grad-int8``: every gradient leaf through the
int8 bitpack wire and back through ``plan.dispatch``, one fused bitpack
launch a leaf on a card (``distributed/collectives.py``).  ``--device``
defaults to ``cuda``, which must exist; ``--n-layers`` cuts a preset's depth
(widths unchanged).  ``--diloco N`` trains N pods DiLoCo-style
(``distributed/diloco.py``): the pods are members of a ``(pod, data)`` mesh
of N x 1 that share the one device the run was asked for; each pod's inner
steps run through the loader and (``--grad-int8``) the int8 gradient wire,
and every ``--outer-every`` steps an outer sync moves the pods' deltas
through the compressed wire (``--outer-wire``: int8, whose dequant and
member mean are fused into the bitpack kernel's stores; ``--topk FRAC``:
top-k values + 1-bit bitmap with error feedback; ``none``), overlapped with
the next window's inner steps (``--link-rtt`` injects a link round trip).
``--mesh 2x2x2`` runs every step under a mesh whose members share the
device (``launch.mesh.parse_mesh``: ``data``, ``data x model`` or ``pod x
data x model``; ``--policy`` tp or dp): the state is placed by
``steps.train_shardings`` and each step is ``steps.sharded_step``; with
``--restart-mesh 2x2`` a restart after a failure restores the checkpoint
onto that mesh (``fault.onto``) and the loop goes on there.

    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
        --steps 12 --mesh 4x2 --restart-mesh 2x2 --fail-at 7 \\
        --ckpt-every 5 [--device cpu]

``--spmd`` runs the same ``--mesh`` with one process a member on
``--device`` (``launch.mesh.spawn``, ``gloo``): each process builds the
loader, draws the same global batches and keeps its DP block of each,
holds only its blocks of the parameters and the optimizer state, and runs
``steps.member_step`` (under ``tp`` its ``model`` share of the compute)
inside the fault-tolerant runner: every ``--ckpt-every`` steps the blocks
are gathered and rank 0 writes the checkpoint (``checkpoint.save(
shardings=)``), and after a ``--fail-at`` failure (the same step in
every process) each process restores its own blocks
(``checkpoint.restore(shardings=)``) onto the same world mesh.  The
world's size is fixed, so ``--restart-mesh`` is refused there.  Rank 0's
losses are the run's.  ``--diloco N --spmd`` runs one process a pod on a
``(pod, data)`` world of N x 1: each holds its pod's block, draws the
same N batches a step and trains on its own, and the outer sync travels
over the ``pod`` process group from a worker thread (``diloco.
OuterSyncPipeline``); the losses are the pods' mean.

    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
        --steps 8 --batch 4 --seq 32 --mesh 2x2 --spmd --grad-int8 \\
        [--ckpt-every 5 --fail-at 7] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
        --steps 8 --diloco 2 --outer-every 4 --spmd [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import ShapeSpec, get_arch, reduced
from repro_torch.core.engine import CodagEngine, EngineConfig, resolve_device
from repro_torch.core.tree import checksums, leaves, map_tree
from repro_torch.data import pipeline
from repro_torch.distributed import fault, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model
from repro_torch.optim import adamw


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", choices=("tiny", "small", "100m", "full"),
                    default="tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--codec", default="rle_v2")
    ap.add_argument("--spill-dir", default=None,
                    help="route token shards through the tiered blob store "
                         "(disk-backed, demand-paged) instead of host RAM")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--grad-int8", action="store_true",
                    help="push gradients through the int8 bitpack wire + "
                         "DecodePlan decode (collectives.make_wire_compressor)")
    ap.add_argument("--compress-moments", action="store_true")
    ap.add_argument("--diloco", type=int, default=0, metavar="N_PODS",
                    help="train N pods DiLoCo-style (the pods share the "
                         "run's device); outer syncs move compressed bytes")
    ap.add_argument("--outer-every", type=int, default=16,
                    help="inner steps per DiLoCo outer sync window (H)")
    ap.add_argument("--outer-wire", choices=("int8", "topk", "none"),
                    default="int8",
                    help="DiLoCo outer-sync wire format ('none' = "
                         "uncompressed f32 member mean baseline)")
    ap.add_argument("--topk", type=float, default=0.0, metavar="FRAC",
                    help="outer-sync wire: top-FRAC values + 1-bit bitmap "
                         "with error feedback (implies --outer-wire topk)")
    ap.add_argument("--link-rtt", type=float, default=0.0,
                    help="injected inter-pod link RTT seconds, for "
                         "measuring sync/compute overlap")
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
                    help="run the steps under a mesh of this shape whose "
                         "members share the device, e.g. 2x2x2 (pod, data, "
                         "model) or 4x2 (data, model)")
    ap.add_argument("--policy", choices=("tp", "dp"), default="tp",
                    help="with --mesh: the sharding policy")
    ap.add_argument("--restart-mesh", default=None, metavar="SHAPE",
                    help="with --mesh: restart after a failure onto a mesh "
                         "of this shape (the elastic restart); not with "
                         "--spmd, whose world has a fixed size")
    ap.add_argument("--spmd", action="store_true",
                    help="with --mesh (or --diloco N): one process a member "
                         "(a pod) on --device (gloo), each holding and "
                         "computing only its share (steps.member_step); "
                         "checkpoints and --fail-at restore each member's "
                         "blocks onto the same world")
    return ap


def _resolve_cfg(args):
    cfg = _preset_cfg(args)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def _preset_cfg(args):
    base = get_arch(args.arch)
    if args.preset == "tiny":
        return reduced(base)
    if args.preset == "small":
        return reduced(base, n_layers=4, d_model=256, vocab=2048)
    if args.preset == "100m":
        return dataclasses.replace(
            reduced(base, n_layers=12, d_model=768, vocab=32768, d_ff=2304),
            dtype="float32")
    return base


def _build_loader(args, cfg, device: torch.device):
    """The reference's corpus and store; shards decode on ``device`` and
    the batches are tensors there."""
    corpus = pipeline.synthetic_corpus(
        max(args.batch * args.seq * 8, 1 << 18), cfg.vocab)
    store = pipeline.CompressedTokenStore.build(
        corpus, cfg.vocab, codec=args.codec, spill_dir=args.spill_dir)
    print(f"token store: {store.num_shards} shards, "
          f"compression ratio {store.ratio:.3f} ({args.codec}"
          f"{', spilled' if args.spill_dir else ''})")
    engine = CodagEngine(EngineConfig(device=str(device)))
    return pipeline.CompressedLoader(store, args.batch, args.seq,
                                     engine=engine, device_out=True)


def _stack_batches(it, n_pods: int):
    """The next ``n_pods`` batches, stacked on a leading pod axis."""
    bs = [next(it) for _ in range(n_pods)]
    return map_tree(lambda *xs: torch.stack(xs), *bs)


def _run_diloco(args, cfg, loader, device: torch.device,
                params=None) -> dict:
    """N-pod DiLoCo loop: each pod's inner steps, compressed outer syncs
    overlapped with the next window (``OuterSyncPipeline``)."""
    from repro_torch.distributed import collectives, diloco

    n_pods = args.diloco
    mesh = mesh_lib.make_test_mesh((n_pods, 1), ("pod", "data"),
                                   device=str(device))
    wire = "topk" if args.topk > 0 else args.outer_wire
    dcfg = diloco.DiLoCoConfig(inner_steps=args.outer_every, wire=wire,
                               compress=(wire != "none"),
                               topk_frac=args.topk or 0.01)
    opt_cfg = adamw.AdamWConfig(lr=args.lr,
                                compress_moments=args.compress_moments)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init_params(cfg, gen, device=device)
    opt_state = adamw.init(params, opt_cfg)
    econfig = EngineConfig(device=str(device))
    compressor = (collectives.make_wire_compressor(econfig)
                  if args.grad_int8 else None)
    inner = steps_lib.build_pod_inner_step(cfg, opt_cfg,
                                           grad_compressor=compressor)

    pod_params = diloco.replicate_for_pods(params, n_pods, mesh)
    pod_opt = diloco.replicate_for_pods(opt_state, n_pods, mesh)
    outer = diloco.init_outer_state(params, mesh=mesh, cfg=dcfg)
    sync = diloco.make_outer_sync(mesh, dcfg, config=econfig)
    pipe = diloco.OuterSyncPipeline(sync, link_rtt_s=args.link_rtt)

    it = iter(loader)
    losses, step_seconds = [], []
    t0 = time.time()
    for step in range(args.steps):
        s0 = time.perf_counter()
        if step and step % dcfg.inner_steps == 0:
            # finish the PREVIOUS window's sync (it ran under this window's
            # inner steps), then launch the next one
            if pipe.in_flight:
                pod_params, outer = pipe.finish(pod_params)
            pipe.launch(pod_params, outer)
        batch = _stack_batches(it, n_pods)
        pod_params, pod_opt, loss = inner(pod_params, pod_opt, batch)
        losses.append(float(loss.mean()))
        step_seconds.append(time.perf_counter() - s0)
    if pipe.in_flight:
        pod_params, outer = pipe.finish(pod_params)
    dt = time.time() - t0

    wire_rep = collectives.wire_report(params, n_pods, wire=wire,
                                       frac=dcfg.topk_frac)
    return {"losses": losses, "seconds": dt, "steps_done": args.steps,
            "restarts": 0, "stragglers": 0,
            "tokens_per_step": n_pods * args.batch * args.seq,
            "overlap": pipe.stats(), "wire": wire_rep, "n_pods": n_pods,
            "step_seconds": step_seconds,
            "state": (pod_params, pod_opt, outer)}


class _MeshSteps:
    """The train step under each mesh a run meets (``--mesh``, then
    ``--restart-mesh`` after a restart): ``steps.sharded_step`` on that
    mesh's ``train_shardings``, chosen by the mesh the parameters lie on;
    the loss comes back whole."""

    def __init__(self, args, cfg, opt_cfg, train_step, device):
        self.args, self.cfg, self.opt_cfg = args, cfg, opt_cfg
        self.train_step, self.device = train_step, device
        self.meshes = {}                 # shape text -> mesh
        self.steps = {}                  # id(mesh) -> (shardings, step)

    def _built(self, mesh):
        if id(mesh) not in self.steps:
            shape = ShapeSpec("train", self.args.seq, self.args.batch,
                              "train")
            with sharding.use_mesh(mesh, self.args.policy):
                ins, outs = steps_lib.train_shardings(self.cfg, shape, mesh,
                                                      self.opt_cfg)
                self.steps[id(mesh)] = (ins, steps_lib.sharded_step(
                    self.train_step, ins, outs))
        return self.steps[id(mesh)]

    def shardings(self, text: str):
        """(params, optimizer state) shardings on the mesh ``text``."""
        if text not in self.meshes:
            self.meshes[text] = mesh_lib.parse_mesh(text,
                                                    device=str(self.device))
        return self._built(self.meshes[text])[0][:2]

    def __call__(self, params, opt_state, batch):
        mesh = next(leaf.sharding.mesh for leaf in leaves(params)
                    if isinstance(leaf, sharding.ShardedTensor))
        params, opt_state, loss = self._built(mesh)[1](params, opt_state,
                                                       batch)
        return params, opt_state, loss.full()


def _run_single(args, cfg, loader, device: torch.device,
                params=None) -> dict:
    opt_cfg = adamw.AdamWConfig(lr=args.lr,
                                compress_moments=args.compress_moments)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init_params(cfg, gen, device=device)
    opt_state = adamw.init(params, opt_cfg)
    if args.grad_int8:
        from repro_torch.distributed import collectives
        compressor = collectives.make_wire_compressor(
            EngineConfig(device=str(device)))
    else:
        compressor = None
    train_step = steps_lib.build_train_step(cfg, opt_cfg,
                                            grad_compressor=compressor)
    reshard_fn = None
    if args.mesh:
        mesh_step = _MeshSteps(args, cfg, opt_cfg, train_step, device)
        params, opt_state = sharding.place(
            (params, opt_state), mesh_step.shardings(args.mesh))
        if args.restart_mesh:
            reshard_fn = fault.onto(mesh_step.shardings(args.restart_mesh))
    elif args.restart_mesh:
        raise ValueError("--restart-mesh needs --mesh")

    def step_fn(state, batch):
        params, opt_state = state
        if args.mesh:
            params, opt_state, loss = mesh_step(params, opt_state, batch)
        else:
            params, opt_state, loss = train_step(params, opt_state, batch)
        if device.type == "cuda":     # the monitor times the whole step
            torch.cuda.synchronize(device)
        return (params, opt_state), loss

    injector = fault.FailureInjector(args.fail_at) if args.fail_at else None
    monitor = fault.StepMonitor()
    runner = fault.FaultTolerantRunner(
        step_fn, args.ckpt_dir, ckpt_every=args.ckpt_every, monitor=monitor,
        injector=injector, reshard_fn=reshard_fn)

    # the runner holds the only reference to the first state, so it is
    # freed after the first step (a placed state is 8 copies at 2x2x2)
    first = [(params, opt_state)]
    del params, opt_state
    t0 = time.time()
    (params, opt_state), report = runner.run(
        first.pop(), iter(loader), args.steps)
    dt = time.time() - t0
    return {"losses": report.losses, "seconds": dt,
            "steps_done": report.steps_done, "restarts": report.restarts,
            "stragglers": report.stragglers,
            "tokens_per_step": args.batch * args.seq,
            "step_seconds": [r.seconds for r in monitor.records],
            "state": (params, opt_state)}


def spmd_kernels(device: torch.device) -> None:
    """Build the kernel libraries a member's process launches (the
    loader's rle_v2 decode, the gradient wire's bitpack) before the
    processes start, so that they bind the builds and none runs ``nvcc``
    beside another; nothing on the CPU."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import bitpack, cuda_build, cuda_rle
    cuda_build.build_all([cuda_rle.LIB, *cuda_rle.LIB_EPI.values(),
                          bitpack.LIB])


def _spmd_rank(args, params, cache_dir) -> dict:
    """One member's process of :func:`_run_spmd`."""
    from repro_torch.distributed import spmd
    if cache_dir is not None:
        from repro_torch.core import tuning
        tuning.enable_compile_cache(cache_dir)
    cfg = _resolve_cfg(args)
    if args.diloco:
        mesh = mesh_lib.world_mesh((args.diloco, 1), ("pod", "data"),
                                   device=args.device)
        device = mesh.member_device()
        return _spmd_diloco(args, cfg, mesh, _build_loader(args, cfg, device),
                            device, params)
    shape = mesh_lib.parse_mesh(args.mesh, device="meta")
    mesh = mesh_lib.world_mesh(tuple(shape.shape.values()),
                               shape.axis_names, device=args.device)
    member = spmd.Member.join(mesh, args.policy)
    device = mesh.member_device()
    loader = _build_loader(args, cfg, device)
    opt_cfg = adamw.AdamWConfig(lr=args.lr,
                                compress_moments=args.compress_moments)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init_params(cfg, gen, device=device)
    else:
        params = map_tree(lambda t: t.to(device), params)
    compressor = None
    if args.grad_int8:
        from repro_torch.distributed import collectives
        compressor = collectives.make_wire_compressor(
            EngineConfig(device=str(device)))
    step = steps_lib.build_train_step(cfg, opt_cfg,
                                      grad_compressor=compressor)
    with sharding.use_mesh(None, args.policy):
        ins, outs = steps_lib.train_shardings(
            cfg, ShapeSpec("train", args.seq, args.batch, "train"), mesh,
            opt_cfg)
    fn = steps_lib.member_step(step, ins, outs, member=member)
    r = member.index
    state = (spmd.blocks(params, ins[0], r),
             spmd.blocks(adamw.init(params, opt_cfg), ins[1], r))
    del params

    def step_fn(state, batch):
        p, o, loss = fn(*state, spmd.blocks(batch, ins[2], r))
        return (p, o), loss

    monitor = fault.StepMonitor()
    runner = fault.FaultTolerantRunner(
        step_fn, args.ckpt_dir, ckpt_every=args.ckpt_every, monitor=monitor,
        injector=fault.FailureInjector(args.fail_at) if args.fail_at
        else None, async_ckpt=False,
        engine=CodagEngine(EngineConfig(device=str(device))),
        shardings=(ins[0], ins[1]))
    t0 = time.time()
    (p, o), report = runner.run(state, iter(loader), args.steps)
    return {"losses": report.losses, "seconds": time.time() - t0,
            "steps_done": report.steps_done, "restarts": report.restarts,
            "stragglers": report.stragglers,
            "tokens_per_step": args.batch * args.seq,
            "step_seconds": [x.seconds for x in monitor.records],
            "state": (map_tree(lambda t: t.cpu(), p),
                      map_tree(lambda t: t.cpu(), o))}


def _spmd_diloco(args, cfg, mesh, loader, device: torch.device,
                 params=None) -> dict:
    """One pod's process of ``--diloco N --spmd``: :func:`_run_diloco` on
    its pod's block (a leading pod axis of 1), the outer syncs over the
    ``pod`` process group; the losses all-gathered at the end (no
    collective runs beside a sync in flight) and averaged over the pods.
    Its record's ``state`` is the pod's parameter block alone (the
    optimizer and outer states stay in the process: a full-width pod's
    are several GB), and it adds ``sync_digests`` (``tree.checksums`` of
    the anchor after each sync) and the launches of its wire kernels."""
    from repro_torch.distributed import collectives, diloco, spmd
    from repro_torch.kernels import bitpack, harness

    n_pods = args.diloco
    wire = "topk" if args.topk > 0 else args.outer_wire
    dcfg = diloco.DiLoCoConfig(inner_steps=args.outer_every, wire=wire,
                               compress=(wire != "none"),
                               topk_frac=args.topk or 0.01)
    opt_cfg = adamw.AdamWConfig(lr=args.lr,
                                compress_moments=args.compress_moments)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init_params(cfg, gen, device=device)
    else:
        params = map_tree(lambda t: t.to(device), params)
    econfig = EngineConfig(device=str(device))
    compressor = (collectives.make_wire_compressor(econfig)
                  if args.grad_int8 else None)
    inner = steps_lib.build_pod_inner_step(cfg, opt_cfg,
                                           grad_compressor=compressor)
    pod_params = diloco.replicate_for_pods(params, n_pods, mesh)
    pod_opt = diloco.replicate_for_pods(adamw.init(params, opt_cfg), n_pods,
                                        mesh)
    outer = diloco.init_outer_state(params, mesh=mesh, cfg=dcfg)
    sync = diloco.make_outer_sync(mesh, dcfg, config=econfig)
    pipe = diloco.OuterSyncPipeline(sync, link_rtt_s=args.link_rtt)
    pod = mesh.coord("pod")
    launched0 = (bitpack.REDUCE_LAUNCHES, harness.EPILOGUE_UNFUSED)
    digests = []

    def finish(pod_params):
        pod_params, new_outer = pipe.finish(pod_params)
        digests.append(checksums(new_outer["anchor"]))
        return pod_params, new_outer

    it = iter(loader)
    losses, step_seconds = [], []
    t0 = time.time()
    for step in range(args.steps):
        s0 = time.perf_counter()
        if step and step % dcfg.inner_steps == 0:
            if pipe.in_flight:
                pod_params, outer = finish(pod_params)
            pipe.launch(pod_params, outer)
        batch = map_tree(lambda t: t[pod:pod + 1],
                         _stack_batches(it, n_pods))
        pod_params, pod_opt, loss = inner(pod_params, pod_opt, batch)
        losses.append(loss.float().reshape(1))
        step_seconds.append(time.perf_counter() - s0)
    if pipe.in_flight:
        pod_params, outer = finish(pod_params)
    dt = time.time() - t0
    with spmd.use(spmd.member_of(mesh)):
        every = spmd.all_gather(torch.cat(losses)[None], "pod")
    wire_rep = collectives.wire_report(params, n_pods, wire=wire,
                                       frac=dcfg.topk_frac)
    return {"losses": [float(x) for x in every.mean(0).cpu()],
            "seconds": dt, "steps_done": args.steps, "restarts": 0,
            "stragglers": 0,
            "tokens_per_step": n_pods * args.batch * args.seq,
            "overlap": pipe.stats(), "wire": wire_rep, "n_pods": n_pods,
            "step_seconds": step_seconds, "sync_digests": digests,
            "launches": {"bitpack_reduce":
                         bitpack.REDUCE_LAUNCHES - launched0[0],
                         "epilogue_unfused":
                         harness.EPILOGUE_UNFUSED - launched0[1]},
            "state": (map_tree(lambda t: t.cpu(), pod_params),)}


def _run_spmd(args, params=None) -> dict:
    """``--spmd``: one process a member of ``--mesh`` (a pod, with
    ``--diloco``); rank 0's record, with every rank's ``state`` (its
    blocks, on the CPU) as ``states``."""
    if args.restart_mesh:
        raise ValueError("--spmd runs one world of a fixed size: it "
                         "restarts onto the mesh it runs, so "
                         "--restart-mesh is refused")
    if args.diloco:
        if args.mesh or args.fail_at:
            raise ValueError("--diloco N --spmd runs a (pod, data) world of "
                             "N x 1 and takes neither --mesh nor --fail-at")
        n = args.diloco
    elif not args.mesh:
        raise ValueError("--spmd needs --mesh (or --diloco N)")
    else:
        n = mesh_lib.parse_mesh(args.mesh, device="meta").size
    device = resolve_device(args.device)
    spmd_kernels(device)
    from repro_torch.core import tuning
    cache = tuning.compile_cache_dir()
    if params is not None:
        params = map_tree(lambda t: t.cpu(), params)
    ranks = mesh_lib.spawn(_spmd_rank, n, (args, params,
                                           None if cache is None
                                           else str(cache)),
                           device=args.device)
    out = dict(ranks[0])
    out["states"] = [r.pop("state") for r in ranks]
    out.pop("state")
    if args.diloco:
        out["ranks"] = ranks
    return out


def run_training(args, params=None) -> dict:
    """Drive one training run; returns a metrics dict (losses, timings,
    the final state; the wire and overlap stats of a DiLoCo run).
    ``params`` (the model's tree on the device) replaces the random init,
    e.g. weights carried across from the JAX package."""
    if args.compile_cache:
        from repro_torch.core import tuning
        path = tuning.enable_compile_cache(
            None if args.compile_cache is True else args.compile_cache)
        print(f"compile cache: {path}")
    device = resolve_device(args.device)
    cfg = _resolve_cfg(args)
    print(f"arch={cfg.name} preset={args.preset} device={device} "
          f"params~{cfg.param_count()/1e6:.1f}M")
    if args.spmd:
        return _run_spmd(args, params)
    loader = _build_loader(args, cfg, device)
    if args.diloco:
        return _run_diloco(args, cfg, loader, device, params)
    return _run_single(args, cfg, loader, device, params)


# The allocator the driver runs with unless the caller sets its own: an
# MoE's 805 M-element expert leaves free and allocate 3.2 GB float32
# transients leaf after leaf (AdamW, the gradient wire), and fixed-size
# segments fragment under that (qwen3-moe-235B-A22B at 1 layer, 8 x 512,
# ran out of memory on an H100 with 17.6 GiB reserved but free).  Torch
# reads it when the process first uses the card.
ALLOC_CONF = "expandable_segments:True"


def main(argv=None) -> None:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
    args = build_parser().parse_args(argv)
    m = run_training(args)
    losses, dt = m["losses"], m["seconds"]
    print(f"done: {m['steps_done']} steps in {dt:.1f}s "
          f"({m['tokens_per_step'] * len(losses) / dt:.0f} tok/s), "
          f"restarts={m['restarts']} stragglers={m['stragglers']}")
    if "wire" in m:
        w, o = m["wire"], m["overlap"]
        print(f"outer wire: {w['wire_bytes']:.0f}B vs f32 ring "
              f"{w['f32_ring_bytes']:.0f}B ({w['ratio']:.1f}x); "
              f"overlap: {o['syncs']} syncs, "
              f"hidden {o['overlap_frac']*100:.0f}% of "
              f"{o['collective_s']:.2f}s collective")
    k = max(1, len(losses) // 10)
    print(f"loss: first10={np.mean(losses[:k]):.4f} "
          f"last10={np.mean(losses[-k:]):.4f}")
    if not np.mean(losses[-k:]) < np.mean(losses[:k]):
        raise RuntimeError("loss did not improve")
    print("OK")


if __name__ == "__main__":
    main()
