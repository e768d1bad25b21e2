"""The model's member program split over ``model``, run with one process
per mesh member, held to the JAX package on the CPU:
``distributed.spmd``, ``launch.mesh.spawn`` / ``world_mesh`` and
``launch.steps.member_step`` for the train, prefill and serve steps.

The reference runs its steps jitted with ``in_shardings`` and
``out_shardings`` on a (data 2, model 4) mesh of 8 virtual CPU devices, so
its half runs as ``tests/test_torch_mesh_steps.py`` runs it: one
subprocess, started when the first test of this file asks for it, with
XLA's cheaper compile passes, on weights made here from a seed (carried to
the port by ``params_from_numpy``).  It records every output whole and,
where the output lies under its out-sharding, its per-device blocks in
``mesh.devices.flat`` order.

The port's side is 8 processes, one a member, joined by a ``gloo``
process group on the CPU (``launch.mesh.spawn``, started once for the
file): each holds only its blocks of the parameters, optimizer state,
batch and cache and runs ``member_step``.  Member r's blocks are held to
device r's within 1e-4: losses, logits, parameters, moments and caches,
for reduced qwen3 (2 KV heads over 4 members: a KV head cut across
members, and a decode cache split over the sequence), the MoE (one KV
head; experts over ``model``), rwkv6, zamba2 (4 KV heads: the cache's
heads over ``model``) and olmo (tied embeddings: the head's columns).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_arch, reduced
from repro_torch.distributed import sharding, spmd
from repro_torch.launch import mesh as mesh_lib, steps
from repro_torch.models import model
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, AXES = (2, 4), ("data", "model")
ARCHS = {"qwen3": "qwen3-1.7b", "moe": "qwen3-moe-235b-a22b",
         "rwkv6": "rwkv6-1.6b", "zamba2": "zamba2-2.7b", "olmo": "olmo-1b"}
TRAIN_CASES = [(a, "f32") for a in ARCHS] + [("qwen3", "int8")]
BATCH, SEQ = 4, 32
SERVE_B, SERVE_S, SERVE_STEPS = 8, 16, 3
MOE_CF = 1.0                      # capacity drops at the reduced widths
LR = 1e-3
TOL = 1e-4


def _cfg(key: str):
    cfg = reduced(get_arch(ARCHS[key]))
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CF)
    return cfg


def _flat(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _tree(arrs: dict, prefix: str) -> dict:
    out: dict = {}
    for key, a in arrs.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return out


def _inputs() -> dict:
    rng = np.random.default_rng(26)
    out = {"tokens": rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32),
           "labels": rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32),
           "serve_tokens": rng.integers(
               0, 512, (SERVE_STEPS, SERVE_B, 1)).astype(np.int32),
           "prefill_tokens": rng.integers(
               0, 512, (SERVE_B, SERVE_S)).astype(np.int32)}
    for key in ARCHS:
        params = model.init_params(
            _cfg(key), torch.Generator().manual_seed(len(key)), device="cpu")
        out.update({k: v.numpy() for k, v in
                    _flat(params, f"params/{key}").items()})
    return out


REF = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ShapeSpec, get_arch, reduced
from repro.distributed import collectives, sharding as shd
from repro.launch import steps
from repro.models import model
from repro.optim import adamw

inp = dict(np.load(sys.argv[1]))
cfgs = json.loads(sys.argv[3])
arr, js = {}, {}
mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(cfgs["shape"]),
            tuple(cfgs["axes"]))
B, S, LR = cfgs["batch"], cfgs["seq"], cfgs["lr"]


def cfg_of(key):
    cfg = reduced(get_arch(cfgs["archs"][key]))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfgs["moe_cf"])
    return cfg


def tree(prefix):
    out = {}
    for key, a in inp.items():
        if key.startswith(prefix + "/"):
            node = out
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(a)
    return out


def flat(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def record(key, a, sh):
    arr[key] = np.asarray(a)
    placed = sh is not None and a.sharding.is_equivalent_to(sh, a.ndim)
    js[key] = bool(placed)
    if placed:
        order = {d: i for i, d in enumerate(sh.mesh.devices.flat)}
        for s in a.addressable_shards:
            arr[f"{key}/shard{order[s.device]}"] = np.asarray(s.data)


def record_tree(prefix, tree, shs):
    fs = flat(shs, prefix)
    for k, a in flat(tree, prefix).items():
        record(k, a, fs[k])


batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
for key, case in cfgs["train_cases"]:
    cfg = cfg_of(key)
    params = tree(f"params/{key}")
    oc = adamw.AdamWConfig(lr=LR, compress_moments=case == "int8")
    comp = collectives.make_wire_compressor() if case == "int8" else None
    with mesh, shd.use_mesh(mesh, "tp"):
        (p_sh, o_sh, b_sh), out_sh = steps.train_shardings(
            cfg, ShapeSpec("t", S, B, "train"), mesh, oc)
        fn = jax.jit(steps.build_train_step(cfg, oc, grad_compressor=comp),
                     in_shardings=(p_sh, o_sh, b_sh), out_shardings=out_sh)
        p2, o2, loss = fn(jax.device_put(params, p_sh),
                          jax.device_put(adamw.init(params, oc), o_sh),
                          {k: jax.device_put(v, b_sh[k])
                           for k, v in batch.items()})
    base = f"train/{key}/{case}"
    record(f"{base}/loss", loss, out_sh[2])
    record_tree(f"{base}/p", p2, out_sh[0])
    record_tree(f"{base}/o", {"m": o2["m"], "v": o2["v"]},
                {"m": out_sh[1]["m"], "v": out_sh[1]["v"]})

SB, SS = cfgs["serve_b"], cfgs["serve_s"]
for key in cfgs["archs"]:
    cfg = cfg_of(key)
    params = tree(f"params/{key}")
    with mesh, shd.use_mesh(mesh, "tp"):
        (p_sh, c_sh, b_sh), out_sh = steps.serve_shardings(
            cfg, ShapeSpec("d", SS, SB, "decode"), mesh)
        pd = jax.device_put(params, p_sh)
        cache = model.init_cache(cfg, SB, SS)
        cache = {k: jax.device_put(v, c_sh[k]) for k, v in cache.items()}
        fn = jax.jit(steps.build_serve_step(cfg),
                     in_shardings=(p_sh, c_sh, b_sh), out_shardings=out_sh)
        for t in range(cfgs["serve_steps"]):
            tok = jax.device_put(jnp.asarray(inp["serve_tokens"][t]),
                                 b_sh["tokens"])
            logits, cache = fn(pd, cache, {"tokens": tok})
            record(f"serve/{key}/logits{t}", logits, out_sh[0])
        for k, v in cache.items():
            if k != "pos":
                record(f"serve/{key}/cache/{k}", v, c_sh[k])
        pb = steps.batch_shardings(cfg, ShapeSpec("p", SS, SB, "prefill"),
                                   mesh)
        pf = jax.jit(steps.build_prefill_step(cfg),
                     in_shardings=(p_sh, {"tokens": pb["tokens"]}),
                     out_shardings=NamedSharding(mesh, P()))
        logits = pf(pd, {"tokens": jax.device_put(
            jnp.asarray(inp["prefill_tokens"]), pb["tokens"])})
        record(f"prefill/{key}/logits", logits, NamedSharding(mesh, P()))

np.savez(sys.argv[2], **arr)
with open(sys.argv[2] + ".json", "w") as f:
    json.dump(js, f)
print("PASS")
'''


def _block(x, sh, index: int):
    """Member ``index``'s block of the whole tensor ``x`` under ``sh``."""
    if not isinstance(x, torch.Tensor):
        return x
    return x[sh.member_indices(x.shape)[index]].contiguous()


def _blocks(tree, shs, index: int):
    if isinstance(tree, dict):
        return {k: _blocks(v, shs[k], index) for k, v in tree.items()}
    return _block(tree, shs, index)


def _numpy(tree, prefix: str) -> dict:
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in _flat(tree, prefix).items()}


def _collectives_check(member, mesh) -> dict:
    """Each collective of ``spmd`` over each axis, in member order: what
    every member can predict of the others' blocks."""
    x = torch.full((2, 3), float(member.index))
    out = {}
    with spmd.use(member):
        for axis in AXES:
            out[f"gather/{axis}"] = spmd.all_gather(x, axis, 1).numpy()
            out[f"sum/{axis}"] = spmd.all_reduce(x, axis).numpy()
            out[f"max/{axis}"] = spmd.all_reduce(x, axis, "max").numpy()
            out[f"scatter/{axis}"] = spmd.reduce_scatter(
                torch.arange(8.0).repeat(2, 1) + member.index, axis,
                1).numpy()
        whole = torch.arange(16.0).reshape(4, 4)
        mine = _block(whole, sharding.NamedSharding(
            mesh, sharding.P("data", "model")), member.index)
        out["relayout"] = spmd.relayout(mine, sharding.P("data", "model"),
                                        sharding.P(None, "data")).numpy()
    return out


def rank_program(inp_path: str) -> dict:
    """One member's program (one process of ``launch.mesh.spawn``): every
    step of every case on its blocks; returns its outputs as numpy."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.distributed import collectives
    inputs = dict(np.load(inp_path))
    mesh = mesh_lib.world_mesh(SHAPE, AXES, device="cpu")
    member = spmd.Member.join(mesh)
    r = member.index
    out = {f"coll/{k}": v for k, v in _collectives_check(member, mesh).items()}
    batch = {k: torch.from_numpy(inputs[k]) for k in ("tokens", "labels")}
    for key, case in TRAIN_CASES:
        cfg = _cfg(key)
        params = model.params_from_numpy(_tree(inputs, f"params/{key}"),
                                         "cpu")
        oc = adamw.AdamWConfig(lr=LR, compress_moments=case == "int8")
        comp = collectives.make_wire_compressor(EngineConfig(device="cpu")) \
            if case == "int8" else None
        with sharding.use_mesh(None, "tp"):
            ins, outs = steps.train_shardings(
                cfg, ShapeSpec("t", SEQ, BATCH, "train"), mesh, oc)
        fn = steps.member_step(steps.build_train_step(cfg, oc,
                                                      grad_compressor=comp),
                               ins, outs, member=member)
        p, o, loss = fn(_blocks(params, ins[0], r),
                        _blocks(adamw.init(params, oc), ins[1], r),
                        _blocks(batch, ins[2], r))
        base = f"train/{key}/{case}"
        out[f"{base}/loss"] = loss.numpy()
        out.update(_numpy(p, f"{base}/p"))
        out.update(_numpy({"m": o["m"], "v": o["v"]}, f"{base}/o"))
    for key in ARCHS:
        cfg = _cfg(key)
        params = model.params_from_numpy(_tree(inputs, f"params/{key}"),
                                         "cpu")
        with sharding.use_mesh(None, "tp"):
            ins, outs = steps.serve_shardings(
                cfg, ShapeSpec("d", SERVE_S, SERVE_B, "decode"), mesh)
            pb = steps.batch_shardings(
                cfg, ShapeSpec("p", SERVE_S, SERVE_B, "prefill"), mesh)
        pm = _blocks(params, ins[0], r)
        serve = steps.member_step(steps.build_serve_step(cfg), ins, outs,
                                  member=member)
        cache = _blocks(model.init_cache(cfg, SERVE_B, SERVE_S,
                                         device="cpu"), ins[1], r)
        for t in range(SERVE_STEPS):
            tok = torch.from_numpy(inputs["serve_tokens"][t])
            logits, cache = serve(pm, cache,
                                  {"tokens": _block(tok, ins[2]["tokens"],
                                                    r)})
            out[f"serve/{key}/logits{t}"] = logits.numpy()
        out.update(_numpy({k: v for k, v in cache.items() if k != "pos"},
                          f"serve/{key}/cache"))
        prefill = steps.member_step(
            steps.build_prefill_step(cfg), (ins[0], {"tokens": pb["tokens"]}),
            sharding.NamedSharding(mesh, sharding.P()), member=member)
        tok = torch.from_numpy(inputs["prefill_tokens"])
        out[f"prefill/{key}/logits"] = prefill(
            pm, {"tokens": _block(tok, pb["tokens"], r)}).numpy()
    return out


INPUTS = _inputs()


class RefRun:
    """The reference's subprocess, started once a module and waited for on
    first use."""

    def __init__(self, tmp):
        self.inp, self.out = tmp / "in.npz", tmp / "out.npz"
        np.savez(self.inp, **INPUTS)
        cfgs = {"shape": SHAPE, "axes": AXES, "archs": ARCHS,
                "train_cases": TRAIN_CASES, "batch": BATCH, "seq": SEQ,
                "lr": LR, "moe_cf": MOE_CF, "serve_b": SERVE_B,
                "serve_s": SERVE_S, "serve_steps": SERVE_STEPS}
        env = dict(os.environ)
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                            "--xla_backend_optimization_level=0 "
                            "--xla_llvm_disable_expensive_passes=true")
        env["PYTHONPATH"] = os.path.join(ROOT, "src")
        env["JAX_PLATFORMS"] = "cpu"
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF, str(self.inp), str(self.out),
             json.dumps(cfgs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self._res = None

    def get(self):
        if self._res is None:
            so, se = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0 and "PASS" in so, \
                f"stdout:\n{so}\nstderr:\n{se[-4000:]}"
            with open(str(self.out) + ".json") as f:
                self._res = (dict(np.load(self.out)), json.load(f))
        return self._res

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """Started by the file's first test; the port's processes run while it
    computes."""
    run = RefRun(tmp_path_factory.mktemp("spmd_ref"))
    yield run
    run.close()


@pytest.fixture(scope="module")
def ranks(ref):
    """Every member's outputs, from one spawn of 8 ``gloo`` processes."""
    return mesh_lib.spawn(rank_program, int(np.prod(SHAPE)),
                          (str(ref.inp),), device="cpu", threads=1,
                          timeout=600)


def _close(got, want, key: str) -> None:
    got = np.asarray(got)
    assert got.shape == want.shape, key
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=key)


def _updated(got, want, key: str) -> None:
    """A parameter after one AdamW step: within 1e-4 of the reference's but
    on at most 0.01% of its elements (at least 2), which may differ by up
    to the step's size, ``LR`` (``tests/test_torch_mesh_steps.py``: the
    first step moves an element by ``LR * g / (|g| + eps)``, so where
    ``g`` is near AdamW's eps, or where the int8 wire rounds it to 0 in
    one framework and to a grid step in the other, the two updates are 0
    and ``LR`` apart)."""
    assert got.shape == want.shape, key
    d = np.abs(got - want)
    off = d > TOL + TOL * np.abs(want)
    assert off.sum() <= max(2, off.size // 10000), key
    assert d.max(initial=0) <= LR * 1.01, key


def _int8_close(q, s, qw, sw, key: str) -> None:
    """An int8 moment block: the scales within 1e-4, the int8 values equal
    but on at most 0.1% of a leaf, where they lie one grid step apart (the
    frameworks' gradients differ in their last bits)."""
    np.testing.assert_allclose(s, sw, rtol=TOL, atol=0, err_msg=key)
    d = np.abs(q.astype(np.int64) - qw.astype(np.int64))
    assert d.max(initial=0) <= 1 and (d > 0).mean() <= 1e-3, key


def _per_member(ranks, arrs, js, key: str, close=_close) -> None:
    """Member r's output ``key`` against device r's block (the reference
    placed it under its out-sharding), or against the whole output where
    every device holds it whole."""
    for r, got in enumerate(ranks):
        want = arrs[f"{key}/shard{r}"] if js[key] else arrs[key]
        close(got[key], want, f"{key} member {r}")


# --------------------------------------------------------------------------
# what needs no reference
# --------------------------------------------------------------------------


def test_member_reads_its_coordinates_and_policy():
    mesh = mesh_lib.make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                                   device="meta")
    m = spmd.Member.counting(mesh, 5)
    assert m.coords == {"pod": 1, "data": 0, "model": 1}
    assert m.tp == 2 and m.size("expert") == 1
    d = spmd.Member.counting(mesh, 5, policy="dp")
    assert d.tp == 1
    with spmd.use(d):
        assert spmd.tp() == 1 and spmd.tp_rank() == 0
    assert spmd.tp() == 1 and spmd.current() is None
    with spmd.use(m):
        assert spmd.tp() == 2 and spmd.tp_rank() == 1
        assert spmd.block(8) == slice(4, 8)
        x = torch.empty(3, 4, device="meta")
        assert spmd.all_gather(x, "data", 1).shape == (3, 8)
    with pytest.raises(ValueError, match="policy"):
        spmd.Member({"model": 2}, 0, policy="fsdp")


def test_a_python_thread_reads_only_the_member_it_installed():
    """A thread started in Python (a loader's prefetch, a DiLoCo sync)
    never runs on the main thread's member; a thread Python did not start
    (as the autograd engine's device threads) reads it."""
    import _thread
    import threading
    mesh = mesh_lib.make_test_mesh((2, 2), ("data", "model"), device="meta")
    main, own = spmd.Member.counting(mesh, 1), spmd.Member.counting(mesh, 2)
    seen = {}

    def python_thread():
        seen["bare"] = spmd.current()
        with spmd.use(own):
            seen["own"] = spmd.current()

    def foreign_thread(done):
        seen["foreign"] = spmd.current()
        done.set()

    with spmd.use(main):
        t = threading.Thread(target=python_thread)
        t.start()
        t.join()
        done = threading.Event()
        _thread.start_new_thread(foreign_thread, (done,))
        assert done.wait(10)
        assert spmd.current() is main
    assert seen == {"bare": None, "own": own, "foreign": main}


def test_meta_collectives_count_their_result_bytes():
    """On ``meta`` a collective makes its result's shape and records its
    bytes a member, by kind; an axis of one member is no collective."""
    from repro_torch.roofline import count
    mesh = mesh_lib.make_test_mesh((1, 4), ("data", "model"), device="meta")
    x = torch.empty(6, 8, dtype=torch.bfloat16, device="meta")
    with count.count_costs() as c, spmd.use(spmd.Member.counting(mesh, 2)):
        assert spmd.all_gather(x, "model", 1).shape == (6, 32)
        assert spmd.reduce_scatter(x, "model", 1).shape == (6, 2)
        assert spmd.all_reduce(x, "model").shape == (6, 8)
        assert spmd.all_reduce(x, "data") is x
        assert spmd.relayout(x, sharding.P(None, "model"),
                             sharding.P(None, None)).shape == (6, 32)
    assert c.only().coll == {"all-gather": 2 * 6 * 32 * 2,
                             "reduce-scatter": 6 * 2 * 2,
                             "all-reduce": 6 * 8 * 2}


def test_a_stray_collective_under_count_costs_raises():
    """A ``torch.distributed`` collective that is not ``spmd``'s is
    refused by name under ``count_costs``, never left out."""
    from repro_torch.roofline import count
    x = torch.zeros(4)
    with count.count_costs(), pytest.raises(RuntimeError,
                                            match="collective"):
        torch.ops._c10d_functional.all_reduce(x, "sum", "0")


def test_spawn_needs_its_device_and_fails_with_a_rank():
    """The launcher starts nothing on a device that is absent (no CPU
    fallback), and a rank that raises fails the launch."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.spawn(_raises_on_rank_1, 2)
    with pytest.raises(Exception, match="rank 1 fails"):
        mesh_lib.spawn(_raises_on_rank_1, 2, device="cpu", timeout=120)


def _raises_on_rank_1():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    return dist.get_rank()


def test_collectives_run_in_member_order(ranks):
    """Every rank's all-gather, sum, maximum and reduce-scatter over each
    axis, and a block moved from (data, model) to (None, data), as the
    members' blocks predict."""
    sizes = dict(zip(AXES, SHAPE))
    for r, got in enumerate(ranks):
        coords = dict(zip(AXES, np.unravel_index(r, SHAPE)))
        for axis in AXES:
            peers = [int(np.ravel_multi_index(
                tuple(i if a == axis else coords[a] for a in AXES), SHAPE))
                for i in range(sizes[axis])]
            np.testing.assert_array_equal(
                got[f"coll/gather/{axis}"],
                np.concatenate([np.full((2, 3), float(p)) for p in peers],
                               axis=1))
            np.testing.assert_array_equal(got[f"coll/sum/{axis}"],
                                          np.full((2, 3), float(sum(peers))))
            np.testing.assert_array_equal(got[f"coll/max/{axis}"],
                                          np.full((2, 3), float(max(peers))))
            whole = sum(np.arange(8.0) + p for p in peers)
            n = 8 // sizes[axis]
            i = int(coords[axis])
            np.testing.assert_array_equal(
                got[f"coll/scatter/{axis}"],
                np.tile(whole[i * n:(i + 1) * n], (2, 1)))
        want = np.arange(16.0).reshape(4, 4)[:, 2 * coords["data"]:
                                              2 * coords["data"] + 2]
        np.testing.assert_array_equal(got["coll/relayout"], want)


# --------------------------------------------------------------------------
# against the reference's program on 8 devices
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key, case", TRAIN_CASES)
def test_train_step_matches_the_reference(ref, ranks, key, case):
    arrs, js = ref.get()
    base = f"train/{key}/{case}"
    _per_member(ranks, arrs, js, f"{base}/loss")
    p_keys = [k for k in js if k.startswith(f"{base}/p/")
              and "/shard" not in k]
    assert p_keys and all(k in ranks[0] for k in p_keys)
    for k in p_keys:
        _per_member(ranks, arrs, js, k, close=_updated)
    o_keys = sorted(k for k in js if k.startswith(f"{base}/o/"))
    if case == "f32":
        for k in o_keys:
            _per_member(ranks, arrs, js, k)
        return
    for k in o_keys:
        if not k.endswith("/q"):
            continue
        stem = k[:-2]
        for r, got in enumerate(ranks):
            pick = (lambda n: arrs[f"{n}/shard{r}"]) if js[k] else \
                (lambda n: arrs[n])
            _int8_close(got[k], got[f"{stem}/s"], pick(k),
                        pick(f"{stem}/s"), f"{stem} member {r}")


def test_the_split_program_holds_only_its_share(ranks):
    """Under ``tp`` a member's blocks are its ``model`` share of every
    split leaf: qwen3's ``wq`` a quarter of its columns, the MoE's experts
    a quarter, the vocabulary's head a quarter."""
    got = ranks[0]
    cfg = _cfg("qwen3")
    assert got["train/qwen3/f32/p/blocks/attn/wq"].shape == \
        (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd // 4)
    assert got["train/qwen3/f32/p/lm_head"].shape == \
        (cfg.d_model, cfg.vocab // 4)
    moe_cfg = _cfg("moe")
    assert got["train/moe/f32/p/blocks/moe/w_up"].shape[1] == \
        moe_cfg.n_experts // 4


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_serve_steps_match_the_reference(ref, ranks, key):
    """Three decode steps from a zero cache: the logits (whole, as the
    out-sharding asks) and each member's cache block."""
    arrs, js = ref.get()
    for t in range(SERVE_STEPS):
        _per_member(ranks, arrs, js, f"serve/{key}/logits{t}")
    cache_keys = [k for k in js if k.startswith(f"serve/{key}/cache/")]
    assert cache_keys
    for k in cache_keys:
        assert js[k], k
        _per_member(ranks, arrs, js, k)


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_prefill_step_matches_the_reference(ref, ranks, key):
    arrs, js = ref.get()
    _per_member(ranks, arrs, js, f"prefill/{key}/logits")


def test_the_sequence_split_cache_is_tested():
    """qwen3's and the MoE's K/V heads do not divide over 4 members, so
    their caches lie over the sequence; zamba2's do, so its lie over the
    heads."""
    mesh = mesh_lib.make_test_mesh(SHAPE, AXES, device="meta")
    for key, where in (("qwen3", 2), ("moe", 2), ("zamba2", 3)):
        spec = sharding.cache_spec(mesh, _cfg(key), SERVE_B)["k"]
        assert spec[where] == "model", key
