"""The decode path one process a mesh member, held to the JAX package on the
CPU: ``plan.gather_member_tables``' member form, ``DecodePlan.
execute_sharded`` / ``api.decompress_many(mesh=, out_shardings=)``,
``checkpoint.restore(shardings=)`` and ``save(shardings=)``, the
compressed collectives (``compressed_psum``, ``topk_psum``,
``make_tree_reduce``, ``grad_compress.compressed_psum``), the loader's
``mesh=``, DiLoCo's outer sync, and the train driver's ``--spmd`` with a
failure and with ``--diloco``, on meshes over the ranks of a ``gloo``
world (``launch.mesh.spawn`` / ``world_mesh``).

The reference runs these inside ``shard_map`` over a multi-device mesh, so
its half runs as ``tests/test_torch_sharded.py`` and
``tests/test_torch_collectives.py`` run it: one subprocess on 8 virtual CPU
devices, on numpy inputs made here from a seed, recording each device's
block in ``mesh.devices.flat`` order (and the checkpoint directory it
writes from a (data 4, model 2) mesh), beside a subprocess of its driver's
``--diloco 2`` on 2 devices.  The port's half is one world of 4 processes
for the file (started once, while the reference runs; its restore waits
for the reference's directory), each member returning its own blocks, and
the two driver runs, each a world of its own.

Member r's blocks equal device r's bit for bit for integer decode, the
restore and the loader.  The collectives equal on every member and bit for
bit the one-process path on the same leaves; against the reference, the
tolerances of ``tests/test_torch_collectives.py`` (the int8 member sum
within ``n * 2^-23 * max|x|``, top-k within an ulp, its residuals equal)
and ``tests/test_torch_diloco.py`` (the driver's losses ``rtol=1e-4``).
"""
import filecmp
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as rtrain
from repro.models import model as rmodel
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ShapeSpec
from repro_torch.core import api, plan as plan_mod, registry
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.data import pipeline
from repro_torch.distributed import collectives, diloco, sharding, spmd
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.kernels import harness
from repro_torch.launch import mesh as mesh_lib, steps, train
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = EngineConfig(device="cpu")
ULP = 2.0 ** -23
WORLD = 4
CODECS = ("rle_v1", "rle_v2", "dbp", "bitpack", "tdeflate", "huffman",
          "lzss")
SIZES = (1, 777, 1032, 4104)         # a tail, and sizes 4 divides
GRID = (24, 50)
CHUNK = 1024
PSUM_SIZE = 4096 + 77
RAGGED = (2, 3, 1, 3)                # each member's valid rows of 3
CORPUS = 32768 + 99                  # a ragged last shard
RESTORE_FROM = ((4, 2), ("data", "model"))
RESTORE_SPECS = {"w": ("data", "model"), "m": ("data", None), "small": ()}
RESTORE_ONTO = {"w": ("model", "data"), "m": (None, "model"), "small": ()}
TREE_KEYS = ("w", "b", "m")
SYNC_KEYS = ("w", "b", "n")
FAIL_RUN = ["--preset", "tiny", "--steps", "12", "--batch", "4", "--seq",
            "32", "--lr", "1e-4", "--grad-int8", "--mesh", "2x2",
            "--ckpt-every", "5", "--fail-at", "7"]
DILOCO_RUN = ["--preset", "tiny", "--steps", "5", "--batch", "2", "--seq",
              "64", "--diloco", "2", "--outer-every", "2", "--grad-int8",
              "--compress-moments"]


def _inputs() -> dict:
    out = {}
    for ci, name in enumerate(CODECS):
        codec = registry.get(name)
        for j, n in enumerate(SIZES + (GRID[0] * GRID[1],)):
            a = codec.demo_data(n, np.random.default_rng(300 * ci + j))[:n]
            out[f"arr/{name}/{j}"] = a.reshape(GRID) if j == len(SIZES) \
                else a
    rng = np.random.default_rng(27)
    out["ragged_vals"] = (np.arange(WORLD * 3 * 128, dtype=np.uint32)
                          .reshape(WORLD, 3, 128) * 7 % 253)
    out["ragged_scale"] = rng.uniform(0.01, 0.1, (WORLD, 3, 1)).astype(
        np.float32)
    out["psum_x"] = rng.standard_normal((WORLD, PSUM_SIZE)).astype(
        np.float32)
    out["topk_g"] = rng.standard_normal((WORLD, 1000)).astype(np.float32)
    out["tr_w"] = rng.standard_normal((WORLD, 300)).astype(np.float32)
    out["tr_b"] = rng.standard_normal((WORLD, 5)).astype(np.float32)
    out["tr_m"] = (0.1 * rng.standard_normal((WORLD, 16, 40))).astype(
        np.float32)
    out["ck_w"] = rng.normal(size=(64, 64)).astype(np.float32)
    out["ck_m"] = rng.integers(0, 200, (128, 32)).astype(np.int32)
    out["ck_small"] = np.float32(1.5)
    for k, shape in {"w": (300,), "b": (5,), "n": (16, 40)}.items():
        out[f"sync_p_{k}"] = rng.standard_normal(shape).astype(np.float32)
        for i in (1, 2):
            out[f"sync_d{i}_{k}"] = (0.01 * rng.standard_normal(
                (2,) + shape)).astype(np.float32)
    return out


INPUTS = _inputs()

REF = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.checkpoint import checkpoint as ckpt
from repro.core import api, plan as plan_mod, tuning
from repro.core.engine import CodagEngine, EngineConfig
from repro.data import pipeline as pl
from repro.distributed import collectives as C
from repro.kernels.harness import Epilogue

inp = dict(np.load(sys.argv[1]))
cfgs = json.loads(sys.argv[4])
work = sys.argv[3]
arr, js = {}, {}
devs = jax.devices()
eng = CodagEngine(EngineConfig())
tune = tuning.kernel_tune("bitpack", 1)


def mesh_of(shape, axes):
    return Mesh(np.asarray(devs[:int(np.prod(shape))]).reshape(shape), axes)


def record(key, a, mesh, want):
    arr[key] = np.asarray(a)
    placed = want is not None and a.sharding.is_equivalent_to(want, a.ndim)
    js[key] = bool(placed)
    if placed:
        order = {d: i for i, d in enumerate(mesh.devices.flat)}
        for s in a.addressable_shards:
            arr[f"{key}/shard{order[s.device]}"] = np.asarray(s.data)


# the checkpoint first: the port's members wait for its directory
m42 = mesh_of(tuple(cfgs["from"][0]), tuple(cfgs["from"][1]))
state = {"w": inp["ck_w"], "m": inp["ck_m"], "small": inp["ck_small"]}
placed = {k: jax.device_put(v, NamedSharding(m42, P(*cfgs["specs"][k])))
          for k, v in state.items()}
ckpt.save(work, 3, placed, codec="rle_v2")
m22 = mesh_of((2, 2), ("data", "model"))
shs = {k: NamedSharding(m22, P(*v)) for k, v in cfgs["onto"].items()}
out = ckpt.restore(work, 3, state, shardings=shs, device_out=True)
for k in state:
    record(f"restore/{k}", out[k], m22, shs[k])

# the executor on (data 4): every codec in one call
m4 = mesh_of((4,), ("data",))
for name in cfgs["codecs"]:
    arrays = [inp[f"arr/{name}/{j}"] for j in range(cfgs["n_arrays"])]
    cas = [api.compress(a, name, chunk_bytes=cfgs["chunk"]) for a in arrays]
    sh = [NamedSharding(m4, P("data", None) if a.ndim == 2 else P("data"))
          for a in arrays]
    outs = api.decompress_many(cas, eng, mesh=m4, out_shardings=sh)
    for j, (o, s) in enumerate(zip(outs, sh)):
        record(f"exec/{name}/{j}", o, m4, s)

# the collectives over pod 4 (x 2 data)
mp = mesh_of((4, 2), ("pod", "data"))


def smap(body, n_in, n_out=1):
    specs = tuple(P("pod") for _ in range(n_in))
    outs = P("pod") if n_out == 1 else tuple(P("pod") for _ in range(n_out))
    return jax.jit(shard_map(body, mesh=mp, in_specs=specs, out_specs=outs,
                             check_rep=False))


def ragged(v, c, s):
    dev = C.wire_dev(C.pack_bits_rows(v[0], 8), chunk_elems=128, bits=8)
    g = plan_mod.gather_member_tables(dev, "pod", codec="bitpack",
                                      row_counts=c[0, 0])
    g["wire_scale"] = lax.all_gather(s[0], "pod").reshape(-1, 1)
    g["wire_zero"] = jnp.float32(C.WIRE_ZERO)
    epi = Epilogue(out_dtype="float32", scale_key="wire_scale",
                   zero_key="wire_zero", fn=C._member_reduce(4, False))
    red = plan_mod.dispatch(g, config=EngineConfig(), codec="bitpack",
                            width=1, chunk_elems=128, bits=8, epilogue=epi,
                            tune=tune)
    return (g["out_lens"][None], g["comp_lens"][None],
            g["comp_words"][None], red[None])


counts = jnp.asarray([[c] for c in cfgs["ragged"]], jnp.int32)
ol, cl, cw, red = smap(ragged, 3, 4)(jnp.asarray(inp["ragged_vals"]), counts,
                                     jnp.asarray(inp["ragged_scale"]))
arr["ragged_out_lens"] = np.asarray(ol)[0]
arr["ragged_comp_lens"] = np.asarray(cl)[0]
arr["ragged_comp_words"] = np.asarray(cw)[0]
arr["ragged_reduce"] = np.asarray(red)[0]

x = jnp.asarray(inp["psum_x"])
for mean in (False, True):
    f = smap(lambda xs, mean=mean: C.compressed_psum(
        xs[0], "pod", tune=tune, mean=mean)[None], 1)
    arr[f"psum_{int(mean)}"] = np.asarray(f(x))[0]


def tk(xs, rs):
    d, nr = C.topk_psum(xs[0], rs[0], "pod", frac=0.01, mean=True,
                        tune=tune)
    return d[None], nr[None]


f = smap(tk, 2, 2)
g = jnp.asarray(inp["topk_g"])
res = jnp.zeros_like(g)
for i in range(3):
    dense, res = f(g, res)
    arr[f"topk_dense{i}"] = np.asarray(dense)[0]
    arr[f"topk_res{i}"] = np.asarray(res)

tree = {k: jnp.asarray(inp[f"tr_{k}"]) for k in ("w", "b", "m")}
for wire in ("int8", "topk", "none"):
    f = C.make_tree_reduce(mp, "pod", wire=wire)
    res = jax.tree.map(jnp.zeros_like, tree) if wire == "topk" else None
    with mp:
        mean, nr = jax.jit(lambda t, r: f(t, r))(tree, res)
    for k in tree:
        arr[f"tree_{wire}_{k}"] = np.asarray(mean[k])
        if nr is not None:
            arr[f"tree_{wire}_res_{k}"] = np.asarray(nr[k])

# the loader's mesh= on (data 4): token shards, and the batches' blocks
toks = pl.synthetic_corpus(cfgs["corpus"], 500, seed=2)
store = pl.CompressedTokenStore.build(toks, 500, shard_tokens=8192,
                                      chunk_bytes=2048)
want = NamedSharding(m4, P("data"))
for i, d in enumerate(store.decoded_shards(eng, window=2, mesh=m4)):
    record(f"shards/{i}", d, m4, want)
js["shards"] = i + 1
it = iter(pl.CompressedLoader(store, batch=4, seq=128, engine=eng,
                              prefetch=False, mesh=m4))
bsh = NamedSharding(m4, P("data", None))
for i in range(3):
    b = next(it)
    for k in ("tokens", "labels"):
        record(f"loader/{i}/{k}", jax.device_put(b[k], bsh), m4, bsh)

np.savez(sys.argv[2], **arr)
with open(sys.argv[2] + ".json", "w") as f:
    json.dump(js, f)
print("PASS")
'''

# the reference driver's --diloco 2 on 2 devices (2 pods x 1)
DRIVER_REF = r'''
import sys
import numpy as np
import jax
from repro.launch import train as rtrain

real = jax.devices
jax.devices = lambda *a, **k: real(*a, **k)[:2]
m = rtrain.run_training(rtrain.build_parser().parse_args(sys.argv[2:]))
np.savez(sys.argv[1], losses=np.asarray(m["losses"]),
         syncs=np.asarray(m["overlap"]["syncs"]))
print("PASS")
'''


class RefRun:
    """The reference's two subprocesses, started together once a module
    and waited for on first use; ``ckpt`` is the directory the first
    writes (published by a rename, so a member may wait for it)."""

    def __init__(self, tmp: Path):
        self.inp, self.out = tmp / "in.npz", tmp / "out.npz"
        self.ckpt, self.drv = tmp / "ckpt", tmp / "driver.npz"
        np.savez(self.inp, **INPUTS)
        cfgs = {"codecs": CODECS, "n_arrays": len(SIZES) + 1,
                "chunk": CHUNK, "ragged": RAGGED, "corpus": CORPUS,
                "from": RESTORE_FROM, "specs": RESTORE_SPECS,
                "onto": RESTORE_ONTO}
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = os.path.join(ROOT, "src")
        env["JAX_PLATFORMS"] = "cpu"
        self.ckpt.mkdir()
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", REF, str(self.inp), str(self.out),
             str(self.ckpt), json.dumps(cfgs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env), subprocess.Popen(
            [sys.executable, "-c", DRIVER_REF, str(self.drv), *DILOCO_RUN,
             "--ckpt-dir", str(tmp / "drv_ckpt"), "--log-every", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(tmp))]
        self._res = None

    def get(self):
        if self._res is None:
            for proc in self.procs:
                so, se = proc.communicate(timeout=900)
                assert proc.returncode == 0 and "PASS" in so, \
                    f"stdout:\n{so[-4000:]}\nstderr:\n{se[-4000:]}"
            with open(str(self.out) + ".json") as f:
                self._res = (dict(np.load(self.out)), json.load(f),
                             dict(np.load(self.drv)))
        return self._res

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


# --------------------------------------------------------------------------
# the members' program: one world of 4 processes for the file
# --------------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy() if t.dtype != torch.bfloat16 else \
        t.view(torch.uint16).numpy()


def _arrays():
    return [(name, INPUTS[f"arr/{name}/{j}"]) for name in CODECS
            for j in range(len(SIZES) + 1)]


def _out_sh(mesh, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, P("data", None) if ndim == 2 else P("data"))


def _t(key: str) -> torch.Tensor:
    return torch.from_numpy(np.array(INPUTS[key]))


def _wait_for(path: Path, timeout: float = 600.0) -> None:
    end = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.2)


def _sync_run(mesh, wire: str, pod: int) -> dict:
    """Two outer syncs of this pod's block (the second through the
    threaded pipeline), on (pod 2, data 2): anchors, momenta, pods,
    residuals."""
    params = {k: _t(f"sync_p_{k}") for k in SYNC_KEYS}
    cfgd = diloco.DiLoCoConfig(outer_lr=0.7, outer_momentum=0.9, wire=wire,
                               compress=wire != "none")
    outer = diloco.init_outer_state(params, mesh=mesh, cfg=cfgd)
    sync = diloco.make_outer_sync(mesh, cfgd, config=CPU)
    pods = diloco.replicate_for_pods(params, 2, mesh)
    out = {}
    for i in (1, 2):
        pods = {k: pods[k] + _t(f"sync_d{i}_{k}")[pod:pod + 1]
                for k in SYNC_KEYS}
        if i == 1:
            pods, outer = sync(pods, outer)
        else:
            pipe = diloco.OuterSyncPipeline(sync)
            pipe.launch(pods, outer)
            pods, outer = pipe.finish()
            out["stats"] = pipe.stats()
        for k in SYNC_KEYS:
            out[f"{i}/anchor/{k}"] = outer["anchor"][k].numpy()
            out[f"{i}/mom/{k}"] = outer["outer_mom"][k].numpy()
            out[f"{i}/pod/{k}"] = pods[k].numpy()
            if outer["residual"] is not None:
                out[f"{i}/res/{k}"] = outer["residual"][k].numpy()
    return out


def _replay(args_list: list, drawn_at: list) -> dict:
    """The failure run's member program without the failure, over the
    batches its steps drew: this member's final blocks and losses."""
    args = train.build_parser().parse_args(args_list + ["--device", "cpu"])
    cfg = train._resolve_cfg(args)
    shape = mesh_lib.parse_mesh(args.mesh, device="meta")
    mesh = mesh_lib.world_mesh(tuple(shape.shape.values()),
                               shape.axis_names, device="cpu")
    member = spmd.Member.join(mesh)
    loader = iter(train._build_loader(args, cfg, torch.device("cpu")))
    drawn = [next(loader) for _ in range(max(drawn_at) + 1)]
    oc = adamw.AdamWConfig(lr=args.lr)
    step = steps.build_train_step(
        cfg, oc, grad_compressor=collectives.make_wire_compressor(CPU))
    with sharding.use_mesh(None, args.policy):
        ins, outs = steps.train_shardings(
            cfg, ShapeSpec("train", args.seq, args.batch, "train"), mesh, oc)
    fn = steps.member_step(step, ins, outs, member=member)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    r = member.index
    p = spmd.blocks(params, ins[0], r)
    o = spmd.blocks(adamw.init(params, oc), ins[1], r)
    losses = []
    for i in drawn_at:
        p, o, loss = fn(p, o, spmd.blocks(drawn[i], ins[2], r))
        losses.append(float(loss))
    return {"losses": losses, "state": (p, o)}


def rank_program(inp_path: str, ckpt_dir: str, save_dir: str) -> dict:
    """One member's process: every case on its own blocks."""
    inputs = dict(np.load(inp_path))
    eng = CodagEngine(CPU)
    out = {}
    r = int(torch.distributed.get_rank())

    # gather_member_tables' member form, ragged, over pod 4
    mp = mesh_lib.world_mesh((WORLD,), ("pod",), device="cpu")
    member = spmd.member_of(mp)
    vals = torch.from_numpy(inputs["ragged_vals"][r])
    own = collectives.wire_dev(collectives.pack_bits_rows(vals, 8),
                               chunk_elems=128, bits=8)
    with spmd.use(member):
        g = plan_mod.gather_member_tables(own, "pod", codec="bitpack",
                                          row_counts=RAGGED[r])
        g["wire_scale"] = spmd.all_gather(
            torch.from_numpy(inputs["ragged_scale"][r]), "pod")
    g["wire_zero"] = torch.tensor(collectives.WIRE_ZERO)
    out["ragged/bits_shared"] = g["bitpack_bits"] is own["bitpack_bits"]
    out["ragged/words_view"] = \
        g["comp_words"].data_ptr() == g["comp"].data_ptr()
    for k in ("out_lens", "comp_lens", "comp_words", "comp"):
        out[f"ragged/{k}"] = g[k].numpy()
    epi = harness.Epilogue(out_dtype="float32", scale_key="wire_scale",
                           zero_key="wire_zero",
                           fn=collectives._member_reduce(WORLD, False))
    out["ragged/reduce"] = plan_mod.dispatch(
        g, config=CPU, codec="bitpack", width=1, chunk_elems=128, bits=8,
        epilogue=epi).numpy()

    # the executor on (data 4): one launch a group a member
    m4 = mesh_lib.world_mesh((WORLD,), ("data",), device="cpu")
    arrays = _arrays()
    cas = [api.compress(a, name, CHUNK) for name, a in arrays]
    with plan_mod.count_lowered() as lowered:
        got = api.decompress_many(cas, eng, mesh=m4, out_shardings=[
            _out_sh(m4, a.ndim) for _, a in arrays])
    out["exec/lowered"] = [(c["codec"], c["num_chunks"]) for c in lowered]
    for i, t in enumerate(got):
        out[f"exec/{i}"] = _np(t)
    out["exec/bytes"] = spmd.member_of(m4).transfer_bytes["all_gather"]

    # the collectives over pod 4: this member's own leaf
    x = torch.from_numpy(inputs["psum_x"][r])
    for mean in (False, True):
        out[f"psum/{int(mean)}"] = collectives.compressed_psum(
            x, "pod", mesh=mp, config=CPU, mean=mean).numpy()
    with spmd.use(member):        # an installed member, no mesh
        out["psum/installed"] = collectives.compressed_psum(
            x, "pod", config=CPU).numpy()
    out["seed"] = gc.compressed_psum(x, "pod", mesh=mp).numpy()
    out["seed_fn"] = gc.make_compressed_psum_fn(mp, "pod")(
        {"a": x[None]})["a"].numpy()
    g1 = torch.from_numpy(inputs["topk_g"][r])
    res = torch.zeros_like(g1)
    for i in range(3):
        dense, res = collectives.topk_psum(g1, res, "pod", mesh=mp,
                                           frac=0.01, config=CPU, mean=True)
        out[f"topk/dense{i}"], out[f"topk/res{i}"] = dense.numpy(), \
            res.numpy()
    tree = {k: torch.from_numpy(inputs[f"tr_{k}"][r:r + 1])
            for k in TREE_KEYS}
    for wire in ("int8", "topk", "none"):
        f = collectives.make_tree_reduce(mp, "pod", wire=wire, config=CPU)
        resid = ({k: torch.zeros_like(v) for k, v in tree.items()}
                 if wire == "topk" else None)
        mean, nr = f(tree, resid)
        for k in TREE_KEYS:
            out[f"tree/{wire}/{k}"] = mean[k].numpy()
            if nr is not None:
                out[f"tree/{wire}/res/{k}"] = nr[k].numpy()

    # the loader's mesh= on (data 4), its prefetch thread on groups of its
    # own
    toks = pipeline.synthetic_corpus(CORPUS, 500, seed=2)
    store = pipeline.CompressedTokenStore.build(toks, 500, shard_tokens=8192,
                                                chunk_bytes=2048)
    shards = list(store.decoded_shards(eng, window=2, mesh=m4))
    out["shards/n"] = len(shards)
    for i, d in enumerate(shards):
        out[f"shards/{i}"] = d.numpy()
    it = iter(pipeline.CompressedLoader(store, batch=4, seq=128,
                                        engine=eng, mesh=m4))
    for i in range(3):
        b = next(it)
        for k in ("tokens", "labels"):
            out[f"loader/{i}/{k}"] = b[k].numpy()
    it.close()

    # DiLoCo's outer sync, one pod's block, on (pod 2, data 2)
    m22p = mesh_lib.world_mesh((2, 2), ("pod", "data"), device="cpu")
    for wire in ("int8", "topk", "none"):
        for k, v in _sync_run(m22p, wire, m22p.coord("pod")).items():
            out[f"sync/{wire}/{k}"] = v

    # the failure run's replay (steps 0-4, then 8-14, as the runner draws)
    rep = _replay(FAIL_RUN, list(range(5)) + list(range(8, 15)))
    out["replay/losses"] = rep["losses"]
    out["replay/state"] = rep["state"]

    # the restore of the reference's directory onto (data 2, model 2),
    # then a save of its blocks
    m22 = mesh_lib.world_mesh((2, 2), ("data", "model"), device="cpu")
    shs = {k: NamedSharding(m22, P(*v)) for k, v in RESTORE_ONTO.items()}
    _wait_for(Path(ckpt_dir) / "step_3" / ckpt.MANIFEST)
    with plan_mod.count_lowered() as lowered:
        st = ckpt.restore(ckpt_dir, 3, {"w": 0, "m": 0, "small": 0},
                          shardings=shs, engine=eng, device_out=True)
    out["restore/lowered"] = len(lowered)
    for k, v in st.items():
        out[f"restore/{k}"] = _np(v)
    ckpt.save(save_dir, 3, st, codec="rle_v2", shardings=shs)
    out["saved"] = sorted(os.listdir(save_dir)) if r == 0 else None
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    run = RefRun(tmp_path_factory.mktemp("spmd_decode_ref"))
    yield run
    run.close()


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """Every member's outputs, from one world of 4 ``gloo`` processes
    started while the reference runs (as many torch threads a process as
    the driver's own worlds take, so the replay runs what they run)."""
    save_dir = tmp_path_factory.mktemp("spmd_decode_save")
    got = mesh_lib.spawn(rank_program, WORLD,
                         (str(ref.inp), str(ref.ckpt), str(save_dir)),
                         device="cpu", timeout=600)
    return got, save_dir


def _check_blocks(ranks, arrs, js, key: str, got_key: str) -> None:
    """Member r's ``got_key`` equals device r's block of the reference's
    ``key`` (the whole output where the reference left it whole)."""
    for r, got in enumerate(ranks):
        want = arrs[f"{key}/shard{r}"] if js[key] else arrs[key]
        g = np.asarray(got[got_key])
        assert g.shape == want.shape and str(g.dtype) == str(want.dtype), \
            (key, r, g.shape, want.shape, g.dtype, want.dtype)
        np.testing.assert_array_equal(g, want, err_msg=f"{key} member {r}")


def _one_mesh(shape, axes):
    return mesh_lib.make_test_mesh(shape, axes, device="cpu")


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------


def test_gather_member_tables_ragged_matches_the_reference_and_the_list(
        ref, ranks):
    """Each member's own table, 3 rows of which 2, 3, 1 and 3 are valid,
    all-gathered over ``pod``: the gathered lens, bytes and words equal
    the reference's and the one-process list form's, ``comp_words`` a view
    of the gathered ``comp`` and the shared ``bitpack_bits`` this member's
    own; the member reduce over it equals the reference's within its
    tolerance and the list form's bit for bit."""
    got, _ = ranks
    arrs, _, _ = ref.get()
    tables = [collectives.wire_dev(collectives.pack_bits_rows(
        _t("ragged_vals")[m], 8), chunk_elems=128, bits=8)
        for m in range(WORLD)]
    lst = plan_mod.gather_member_tables(tables, codec="bitpack",
                                        row_counts=list(RAGGED))
    lst["wire_scale"] = _t("ragged_scale").reshape(-1, 1)
    lst["wire_zero"] = torch.tensor(collectives.WIRE_ZERO)
    red = plan_mod.dispatch(lst, config=CPU, codec="bitpack", width=1,
                            chunk_elems=128, bits=8,
                            epilogue=harness.Epilogue(
                                out_dtype="float32", scale_key="wire_scale",
                                zero_key="wire_zero",
                                fn=collectives._member_reduce(WORLD, False)))
    bound = WORLD * ULP * float(np.abs(arrs["ragged_reduce"]).max())
    for r, g in enumerate(got):
        assert g["ragged/bits_shared"] and g["ragged/words_view"], r
        for k in ("out_lens", "comp_lens", "comp_words"):
            np.testing.assert_array_equal(g[f"ragged/{k}"],
                                          arrs[f"ragged_{k}"], err_msg=k)
        for k in ("out_lens", "comp_lens", "comp_words", "comp"):
            np.testing.assert_array_equal(g[f"ragged/{k}"], lst[k].numpy())
        np.testing.assert_array_equal(g["ragged/reduce"], red.numpy())
        np.testing.assert_allclose(g["ragged/reduce"], arrs["ragged_reduce"],
                                   rtol=0, atol=bound)
    assert list(got[0]["ragged/out_lens"][:3]) == [128, 128, 0]


def test_execute_sharded_every_codec_matches_the_reference(ref, ranks):
    """All seven codecs in one ``decompress_many(mesh=, out_shardings=)``
    on (data 4): one dispatch a group a member, each of a quarter of the
    group's padded rows (some groups padded with zero-length rows); every
    member's block of every output equals device r's bit for bit."""
    got, _ = ranks
    arrs, js, _ = ref.get()
    arrays = _arrays()
    plan = plan_mod.DecodePlan.build(
        [b for name, a in arrays for b in api.compress(a, name,
                                                       CHUNK).blobs])
    want = [(g.key[0], -(-g.num_chunks // WORLD)) for g in plan.groups]
    assert any(g.num_chunks % WORLD for g in plan.groups)
    for g in got:
        assert g["exec/lowered"] == want
        assert g["exec/bytes"] > 0
    for i, (name, a) in enumerate(arrays):
        j = i % (len(SIZES) + 1)
        _check_blocks(got, arrs, js, f"exec/{name}/{j}", f"exec/{i}")
    # the one-process executor's shards are the same blocks
    one = _one_mesh((WORLD,), ("data",))
    whole = api.decompress_many(
        [api.compress(a, name, CHUNK) for name, a in arrays],
        CodagEngine(CPU), mesh=one,
        out_shardings=[_out_sh(one, a.ndim) for _, a in arrays])
    for i, w in enumerate(whole):
        for r, g in enumerate(got):
            block = w.shards[r] if isinstance(w, sharding.ShardedTensor) \
                else w
            np.testing.assert_array_equal(g[f"exec/{i}"], _np(block))


def test_restore_onto_a_world_mesh_and_save_from_blocks(ref, ranks,
                                                        tmp_path):
    """The reference's rle_v2 directory, written from (data 4, model 2),
    restored with ``shardings=`` onto a (data 2, model 2) world: each
    member decodes its block of the window's rows (one dispatch) and its
    blocks equal device r's bit for bit; ``save(shardings=)`` of those
    blocks writes the directory a save of the whole state writes, byte for
    byte."""
    got, save_dir = ranks
    arrs, js, _ = ref.get()
    for r, g in enumerate(got):
        assert g["restore/lowered"] == 1, r
    for k in RESTORE_ONTO:
        _check_blocks(got, arrs, js, f"restore/{k}", f"restore/{k}")
    whole = {"w": _t("ck_w"), "m": _t("ck_m"), "small": _t("ck_small")}
    ckpt.save(str(tmp_path), 3, whole, codec="rle_v2")
    assert got[0]["saved"] == ["step_3"]
    a, b = Path(save_dir) / "step_3", tmp_path / "step_3"
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors


def test_compressed_psum_on_every_member_equals_the_one_process_path(
        ref, ranks):
    """Each member's own leaf through the int8 wire over pod 4 (mean or
    sum; on a mesh or under an installed member): the same leaf on every
    member, bit for bit the one-process path on the stacked leaves, and
    within the reference's bounds; the seed path too."""
    got, _ = ranks
    arrs, _, _ = ref.get()
    one = _one_mesh((WORLD, 1), ("pod", "data"))
    x = _t("psum_x")
    deq = float(np.abs(INPUTS["psum_x"]).max()) * (1 + 1e-6)
    for mean in (False, True):
        want = collectives.compressed_psum(x, "pod", mesh=one, config=CPU,
                                           mean=mean).numpy()
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g[f"psum/{int(mean)}"], want)
            np.testing.assert_allclose(g[f"psum/{int(mean)}"],
                                       arrs[f"psum_{int(mean)}"], rtol=0,
                                       atol=WORLD * ULP * deq)
    seed = gc.compressed_psum(x, "pod", mesh=one).numpy()
    for g in got:
        np.testing.assert_array_equal(g["psum/installed"], g["psum/0"])
        np.testing.assert_array_equal(g["seed"], seed)
        np.testing.assert_array_equal(g["seed_fn"], seed[None])


def test_topk_psum_on_every_member_equals_the_one_process_path(ref, ranks):
    """Three rounds of top-k 1% with error feedback over pod 4: the same
    dense mean on every member, equal to the one-process path's bit for
    bit and to the reference's within an ulp; each member's residual
    equals its row of both."""
    got, _ = ranks
    arrs, _, _ = ref.get()
    one = _one_mesh((WORLD, 1), ("pod", "data"))
    g1 = _t("topk_g")
    res = torch.zeros_like(g1)
    for i in range(3):
        dense, res = collectives.topk_psum(g1, res, "pod", mesh=one,
                                           frac=0.01, config=CPU, mean=True)
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g[f"topk/dense{i}"], dense.numpy())
            np.testing.assert_array_equal(g[f"topk/res{i}"], res[r].numpy())
            np.testing.assert_array_equal(g[f"topk/res{i}"],
                                          arrs[f"topk_res{i}"][r])
        np.testing.assert_allclose(dense.numpy(), arrs[f"topk_dense{i}"],
                                   rtol=ULP, atol=0)


@pytest.mark.parametrize("wire", ["int8", "topk", "none"])
def test_make_tree_reduce_on_every_member(ref, ranks, wire):
    """Each member's block of the tree (a leading axis of 1) through each
    wire over pod 4: the mean the one-process reduce gives, bit for bit,
    on every member (a leaf under one quant block through the plain
    float32 mean), within the reference's bounds; top-k's residual blocks
    equal its rows."""
    got, _ = ranks
    arrs, _, _ = ref.get()
    one = _one_mesh((WORLD, 1), ("pod", "data"))
    tree = {k: _t(f"tr_{k}") for k in TREE_KEYS}
    res = ({k: torch.zeros_like(v) for k, v in tree.items()}
           if wire == "topk" else None)
    mean, nr = collectives.make_tree_reduce(one, "pod", wire=wire,
                                            config=CPU)(tree, res)
    for k in TREE_KEYS:
        w = arrs[f"tree_{wire}_{k}"]
        big = tree[k][0].numel() >= gc.QBLOCK
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g[f"tree/{wire}/{k}"],
                                          mean[k].numpy())
            if nr is not None:
                np.testing.assert_array_equal(g[f"tree/{wire}/res/{k}"],
                                              nr[k][r:r + 1].numpy())
        if wire == "int8" and big:
            deq = float(np.abs(INPUTS[f"tr_{k}"]).max()) * (1 + 1e-6)
            np.testing.assert_allclose(mean[k].numpy(), w, rtol=0,
                                       atol=WORLD * ULP * deq)
        elif wire == "topk" and big:
            np.testing.assert_allclose(mean[k].numpy(), w, rtol=ULP, atol=0)
            np.testing.assert_array_equal(nr[k].numpy(),
                                          arrs[f"tree_{wire}_res_{k}"])
        else:   # the plain float32 mean of 4 members, in another order
            deq = float(np.abs(INPUTS[f"tr_{k}"]).max())
            np.testing.assert_allclose(mean[k].numpy(), w, rtol=0,
                                       atol=WORLD * ULP * deq)


def test_loader_mesh_yields_each_members_blocks(ref, ranks):
    """On (data 4): every token shard's block (the ragged last shard
    whole) and every batch's block under ``decode_out_sharding(mesh, 2)``
    equal device r's, through the loader's prefetch thread."""
    got, _ = ranks
    arrs, js, _ = ref.get()
    for g in got:
        assert g["shards/n"] == js["shards"] == 5
    for i in range(js["shards"]):
        _check_blocks(got, arrs, js, f"shards/{i}", f"shards/{i}")
    assert not js["shards/4"]
    for i in range(3):
        for k in ("tokens", "labels"):
            assert js[f"loader/{i}/{k}"]
            _check_blocks(got, arrs, js, f"loader/{i}/{k}",
                          f"loader/{i}/{k}")


@pytest.mark.parametrize("wire", ["int8", "topk", "none"])
def test_outer_sync_one_process_a_pod_equals_the_one_process_sync(ranks,
                                                                  wire):
    """Two outer syncs on a (pod 2, data 2) world, each process its pod's
    block (the second through ``OuterSyncPipeline``'s worker thread): every
    sync's anchor, momentum and rebased pods equal the one-process sync's
    on the same deltas bit for bit, the same on every member; top-k's
    residual blocks equal its rows."""
    got, _ = ranks
    one = _one_mesh((2, 2), ("pod", "data"))
    params = {k: _t(f"sync_p_{k}") for k in SYNC_KEYS}
    cfgd = diloco.DiLoCoConfig(outer_lr=0.7, outer_momentum=0.9, wire=wire,
                               compress=wire != "none")
    outer = diloco.init_outer_state(params, mesh=one, cfg=cfgd)
    sync = diloco.make_outer_sync(one, cfgd, config=CPU)
    pods = diloco.replicate_for_pods(params, 2, one)
    for i in (1, 2):
        pods = {k: pods[k] + _t(f"sync_d{i}_{k}") for k in SYNC_KEYS}
        pods, outer = sync(pods, outer)
        for r, g in enumerate(got):
            p = r // 2                        # rank r's pod
            for k in SYNC_KEYS:
                base = f"sync/{wire}/{i}"
                np.testing.assert_array_equal(g[f"{base}/anchor/{k}"],
                                              outer["anchor"][k].numpy())
                np.testing.assert_array_equal(g[f"{base}/mom/{k}"],
                                              outer["outer_mom"][k].numpy())
                np.testing.assert_array_equal(g[f"{base}/pod/{k}"],
                                              pods[k][p:p + 1].numpy())
                if wire == "topk":
                    np.testing.assert_array_equal(
                        g[f"{base}/res/{k}"],
                        outer["residual"][k][p:p + 1].numpy())
    for g in got:
        assert g[f"sync/{wire}/stats"]["syncs"] == 1


def _bits_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bits_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_bits_equal, a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and \
            torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                        else a, b.view(torch.uint8)
                        if b.dtype == torch.bfloat16 else b)
    return a == b


def test_train_spmd_restores_each_members_blocks_after_a_failure(
        ranks, tmp_path):
    """``train --spmd --mesh 2x2 --ckpt-every 5 --fail-at 7``: one restart
    (every member fails at step 7 and restores step 5's blocks through
    ``restore(shardings=)``), and every member's final blocks and losses
    equal, bit for bit, the same member program run without the failure
    over the batches the steps drew (0-4, 8-14)."""
    got, _ = ranks
    args = train.build_parser().parse_args(
        FAIL_RUN + ["--spmd", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path / "ck")])
    m = train.run_training(args)
    assert m["restarts"] == 1 and m["steps_done"] == 12
    assert len(m["losses"]) == 14
    rep = got[0]["replay/losses"]
    assert m["losses"][:5] == rep[:5] and m["losses"][7:] == rep[5:]
    for r, state in enumerate(m["states"]):
        assert _bits_equal(state, got[r]["replay/state"]), r
    with pytest.raises(ValueError, match="fixed size"):
        train.run_training(train.build_parser().parse_args(
            FAIL_RUN + ["--spmd", "--device", "cpu", "--restart-mesh",
                        "4x1", "--ckpt-dir", str(tmp_path / "ck2")]))


def test_train_diloco_spmd_matches_the_reference_driver(ref, tmp_path):
    """``train --diloco 2 --spmd``, one process a pod, int8 wires and
    moments: the pods' mean losses within ``rtol=1e-4`` of the reference's
    ``--diloco 2``, from the same weights; the anchor after each sync the
    same on both pods; no epilogue unfused (the outer reduce and the
    gradient wire fused, as in one process)."""
    _, _, drv = ref.get()
    rargs = rtrain.build_parser().parse_args(DILOCO_RUN)
    rp = rmodel.init_params(rtrain._resolve_cfg(rargs), jax.random.key(0))
    params = model.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    args = train.build_parser().parse_args(
        DILOCO_RUN + ["--spmd", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path)])
    m = train.run_training(args, params=params)
    np.testing.assert_allclose(m["losses"], drv["losses"], rtol=1e-4)
    assert m["overlap"]["syncs"] == int(drv["syncs"]) == 2
    a, b = m["ranks"]
    assert a["sync_digests"] == b["sync_digests"] and \
        len(a["sync_digests"]) == 2
    for rank in m["ranks"]:
        assert rank["launches"]["epilogue_unfused"] == 0
    pods = m["states"][0][0]
    assert pods["embed"].shape == (1,) + tuple(params["embed"].shape)


@pytest.mark.parametrize("example,flags,checks", [
    ("torch_sharded_restore.py", ["--mesh", "2x2"],
     ["born under PartitionSpec('data', 'model')",
      "across 4 members, one process each, with 0 device->host crossings "
      "of the port's own"]),
    ("torch_grad_compression.py", [],
     ["window 9: anchor mean=1.4982", "overlap: 10 syncs"]),
])
def test_the_port_examples_run_one_process_a_member(example, flags, checks):
    """The examples on the port print the check their references print
    (the restore's blocks under their specs; the pods' anchor moving to
    the consensus 1.5, as ``examples/grad_compression.py``'s windows do)
    and end "OK", with ``--device cpu``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", example),
         "--device", "cpu", *flags], capture_output=True, text=True,
        env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.splitlines()
    assert lines[-1] == "OK"
    for want in checks:
        assert any(want in line for line in lines), (want, res.stdout)
