"""The model's steps under a mesh held to the JAX package on the CPU:
``sharding.use_mesh`` / ``dp_groups`` / ``constrain``,
``launch.steps.sharded_step`` for the train, prefill and serve steps, the
MoE's per-group routing, and the runner's elastic restart onto a mesh.

The reference runs its steps jitted with ``in_shardings`` and
``out_shardings`` on a multi-device mesh, so its half runs as
``tests/test_torch_sharded.py`` runs it: one subprocess on 8 virtual CPU
devices (``--xla_force_host_platform_device_count=8``), started when the
first test of this file asks for it, on weights and inputs made here from
a seed (the weights carried to the port by ``params_from_numpy``), with
XLA's cheaper compile passes (the same programs; ~45 s against ~65 s on
this file's steps); the port's side is computed meanwhile.  It records
every output whole and, where the output lies under its out-sharding, its
per-device blocks in ``mesh.devices.flat`` order.  The port's meshes are
the same shapes with every member on the CPU: losses, logits, parameters,
moments and caches within 1e-4 of the reference's, each member's block
against its device's block, and the port's sharded steps equal to its own
unsharded steps bit for bit (the MoE excepted, where the mesh's G changes
the routing).
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
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.core.tree import leaves
from repro_torch.distributed import collectives, fault, sharding
from repro_torch.distributed.sharding import NamedSharding, P, ShardedTensor
from repro_torch.launch import mesh as mesh_lib, serve, steps, train
from repro_torch.models import model, moe
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
TRAIN_CASES = ("tp-f32", "tp-int8", "dp-f32", "dp-int8")
SERVE_ARCHS = ("zamba2-2.7b", "rwkv6-1.6b", "qwen3-1.7b")
BATCH, SEQ = 4, 32                 # test_distributed.py:25's train batch
SERVE_B, SERVE_S, SERVE_STEPS = 8, 16, 3
MOE_CF = 1.0                       # capacity drops at the reduced widths
LR = 1e-3
TOL = 1e-4


def _moe_cfg():
    return dataclasses.replace(reduced(get_arch("qwen3-moe-235b-a22b")),
                               capacity_factor=MOE_CF)


def _inputs() -> dict:
    rng = np.random.default_rng(24)
    out = {"tokens": rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32),
           "labels": rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32),
           "serve_tokens": rng.integers(
               0, 512, (SERVE_STEPS, SERVE_B, 1)).astype(np.int32),
           "prefill_tokens": rng.integers(
               0, 512, (SERVE_B, SERVE_S)).astype(np.int32)}
    # the planted MoE layer: batch row 0's tokens all rank experts 0 and 1
    # first, so one DP group overflows their capacity alone (G = 4), where
    # one global group (G = 1) drops other rows' tokens instead
    D, E, F = 128, 8, 64
    x = rng.normal(size=(BATCH, SEQ, D)).astype(np.float32) * 0.1
    x[:, :, 0] = 0.0
    x[0, :, 0] = 1.0
    router = rng.normal(size=(D, E)).astype(np.float32) * 0.05
    router[0, 0], router[0, 1] = 5.0, 4.0
    out.update({"moe/x": x, "moe/router": router,
                "moe/w_up": rng.normal(size=(E, D, F)).astype(np.float32)
                * 0.1,
                "moe/w_gate": rng.normal(size=(E, D, F)).astype(np.float32)
                * 0.1,
                "moe/w_down": rng.normal(size=(E, F, D)).astype(np.float32)
                * 0.1})
    cfgs = {"dense": reduced(get_arch("qwen3-1.7b")), "moe": _moe_cfg()}
    cfgs.update({a: reduced(get_arch(a)) for a in SERVE_ARCHS})
    for name, cfg in cfgs.items():
        if name == "qwen3-1.7b":
            continue                       # the dense train case's weights
        params = model.init_params(
            cfg, torch.Generator().manual_seed(len(name)), device="cpu")
        out.update({k: v.numpy() for k, v in
                    _flat(params, f"params/{name}").items()})
    return out


def _flat(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _tree(arrs: dict, prefix: str) -> dict:
    """The nested dict of the arrays under ``prefix/``."""
    out: dict = {}
    for key, a in arrs.items():
        if not key.startswith(prefix + "/") or "/shard" in key:
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return out


def _params(name: str):
    name = "dense" if name == "qwen3-1.7b" else name
    return model.params_from_numpy(_tree(INPUTS, f"params/{name}"), "cpu")


INPUTS = _inputs()

REF = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ShapeSpec, get_arch, reduced
from repro.distributed import collectives, sharding as shd
from repro.launch import steps
from repro.models import model, moe
from repro.optim import adamw

inp = dict(np.load(sys.argv[1]))
cfgs = json.loads(sys.argv[3])
arr, js = {}, {}
devs = jax.devices()


def mesh_of(shape, axes):
    return Mesh(np.asarray(devs[:int(np.prod(shape))]).reshape(shape),
                tuple(axes))


MESHES = {k: mesh_of(tuple(s), a) for k, (s, a) in cfgs["meshes"].items()}
M3 = MESHES["2x2x2"]
B, S, LR = cfgs["batch"], cfgs["seq"], cfgs["lr"]


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
    """a whole, and its blocks in mesh.devices.flat order where it lies
    under ``sh``."""
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


# dp_groups and batch_spec on every mesh, both policies, batches 1-16
for mk, mesh in MESHES.items():
    for policy in ("tp", "dp"):
        with shd.use_mesh(mesh, policy):
            js[f"groups/{mk}/{policy}"] = {
                str(b): [shd.dp_groups(b),
                         [p if p is None or isinstance(p, str) else list(p)
                          for p in shd.batch_spec(mesh, b)]]
                for b in range(1, 17)}

# the train step on 2x2x2: qwen3 under both policies, f32 and the int8
# wire with int8 moments; the MoE (G = 4) under tp
dense = reduced(get_arch("qwen3-1.7b"))
moe_cfg = dataclasses.replace(reduced(get_arch("qwen3-moe-235b-a22b")),
                              capacity_factor=cfgs["moe_cf"])
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
shape = ShapeSpec("t", S, B, "train")
for name, cfg, cases in (("dense", dense, cfgs["train_cases"]),
                         ("moe", moe_cfg, ["tp-f32"])):
    params = tree(f"params/{name}")
    for case in cases:
        policy, kind = case.split("-")
        oc = adamw.AdamWConfig(lr=LR, compress_moments=kind == "int8")
        comp = collectives.make_wire_compressor() if kind == "int8" else None
        opt = adamw.init(params, oc)
        with M3, shd.use_mesh(M3, policy):
            (p_sh, o_sh, b_sh), out_sh = steps.train_shardings(
                cfg, shape, M3, oc)
            fn = jax.jit(steps.build_train_step(cfg, oc,
                                                grad_compressor=comp),
                         in_shardings=(p_sh, o_sh, b_sh),
                         out_shardings=out_sh)
            p2, o2, loss = fn(jax.device_put(params, p_sh),
                              jax.device_put(opt, o_sh),
                              {k: jax.device_put(v, b_sh[k])
                               for k, v in batch.items()})
        key = f"train/{name}/{case}"
        record(f"{key}/loss", loss, out_sh[2])
        record_tree(f"{key}/p", p2, out_sh[0])
        record_tree(f"{key}/o", {"m": o2["m"], "v": o2["v"]},
                    {"m": out_sh[1]["m"], "v": out_sh[1]["v"]})

# the MoE's routing tables, read off moe_ffn's dispatch vmap (the lambda
# of moe.py:119) in the prefill step, unrolled so the tables are values of
# the jitted program
TABLES = []


class _J:
    def __getattr__(self, k):
        return getattr(jax, k)

    def vmap(self, f, *a, **kw):
        g = jax.vmap(f, *a, **kw)
        if getattr(f, "__name__", "") != "<lambda>":
            return g

        def h(*args):
            out = g(*args)
            TABLES.append(out)
            return out
        return h


moe.jax = _J()
params = tree("params/moe")
prefill = steps.build_prefill_step(moe_cfg, unroll=True)


def with_tables(p, b):
    TABLES.clear()
    logits = prefill(p, b)
    return logits, [t for t in TABLES]


with M3, shd.use_mesh(M3, "tp"):
    p_sh = shd.param_shardings(params, M3)
    b_sh = steps.batch_shardings(moe_cfg, ShapeSpec("p", S, B, "prefill"),
                                 M3)
    rep = NamedSharding(M3, P())
    logits, tables = jax.jit(with_tables, in_shardings=(
        p_sh, {"tokens": b_sh["tokens"]}))(
        jax.device_put(params, p_sh),
        {"tokens": jax.device_put(batch["tokens"], b_sh["tokens"])})
    js["moe_groups"] = shd.dp_groups(B)
record("prefill/moe/logits", logits, None)
for i, (tos, gos) in enumerate(tables):
    arr[f"prefill/moe/tos{i}"] = np.asarray(tos)
    arr[f"prefill/moe/gos{i}"] = np.asarray(gos)
js["moe_layers"] = len(tables)

# the planted layer: per-group routing on the mesh, one global group off it
pm = {k: jnp.asarray(inp[f"moe/{k}"]) for k in
      ("router", "w_up", "w_gate", "w_down")}
x = jnp.asarray(inp["moe/x"])


def planted(p, x):
    TABLES.clear()
    out = moe.moe_ffn(p, x, n_experts=8, top_k=2,
                      capacity_factor=cfgs["moe_cf"])
    return out, [t for t in TABLES]


for label, mesh in (("mesh", M3), ("global", None)):
    if mesh is None:
        out, tables = jax.jit(planted)(pm, x)
    else:
        with mesh, shd.use_mesh(mesh, "tp"):
            out, tables = jax.jit(planted)(pm, x)
    arr[f"planted/{label}/out"] = np.asarray(out)
    arr[f"planted/{label}/tos"] = np.asarray(tables[0][0])
    arr[f"planted/{label}/gos"] = np.asarray(tables[0][1])

# the serve steps (decode from a zero cache) and the prefill step under
# serve_shardings on 2x2x2
SB, SS = cfgs["serve_b"], cfgs["serve_s"]
for arch in cfgs["serve_archs"]:
    cfg = reduced(get_arch(arch))
    params = tree("params/dense" if arch == "qwen3-1.7b" else
                  f"params/{arch}")
    with M3, shd.use_mesh(M3, "tp"):
        (p_sh, c_sh, b_sh), out_sh = steps.serve_shardings(
            cfg, ShapeSpec("d", SS, SB, "decode"), M3)
        pd = jax.device_put(params, p_sh)
        cache = model.init_cache(cfg, SB, SS)
        cache = {k: jax.device_put(v, c_sh[k]) for k, v in cache.items()}
        fn = jax.jit(steps.build_serve_step(cfg),
                     in_shardings=(p_sh, c_sh, b_sh), out_shardings=out_sh)
        for t in range(cfgs["serve_steps"]):
            tok = jax.device_put(jnp.asarray(inp["serve_tokens"][t]),
                                 b_sh["tokens"])
            logits, cache = fn(pd, cache, {"tokens": tok})
            record(f"serve/{arch}/logits{t}", logits, out_sh[0])
        for k, v in cache.items():
            if k != "pos":
                record(f"serve/{arch}/cache/{k}", v, c_sh[k])
        pb = steps.batch_shardings(cfg, ShapeSpec("p", SS, SB, "prefill"),
                                   M3)
        pf = jax.jit(steps.build_prefill_step(cfg),
                     in_shardings=(p_sh, {"tokens": pb["tokens"]}),
                     out_shardings=NamedSharding(M3, P()))
        logits = pf(pd, {"tokens": jax.device_put(
            jnp.asarray(inp["prefill_tokens"]), pb["tokens"])})
        record(f"prefill/{arch}/logits", logits, NamedSharding(M3, P()))

np.savez(sys.argv[2], **arr)
with open(sys.argv[2] + ".json", "w") as f:
    json.dump(js, f)
print("PASS")
'''


class RefRun:
    """The reference's subprocess, started once a module and waited for on
    first use."""

    def __init__(self, tmp):
        self.inp, self.out = tmp / "in.npz", tmp / "out.npz"
        np.savez(self.inp, **INPUTS)
        cfgs = {"meshes": MESHES, "train_cases": TRAIN_CASES,
                "batch": BATCH, "seq": SEQ, "lr": LR, "moe_cf": MOE_CF,
                "serve_archs": SERVE_ARCHS, "serve_b": SERVE_B,
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
    """Started by the file's first test; the tests that need no reference
    come first and run while it computes."""
    run = RefRun(tmp_path_factory.mktemp("mesh_steps_ref"))
    yield run
    run.close()


def _mesh(key: str):
    shape, axes = MESHES[key]
    return mesh_lib.make_test_mesh(shape, axes, device="cpu")


def _close(got, want, key: str) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, key
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=key)


def _updated(got, want, key: str) -> None:
    """A parameter after one AdamW step: within 1e-4 of the reference's but
    on at most 0.01% of its elements (at least 2), which may differ by up
    to the step's size, ``LR``.  The first step moves an element by ``LR *
    g / (|g| + eps)``, so where ``g`` is near AdamW's eps (an expert few
    tokens reach) or where the int8 wire rounds it to 0 in one framework
    and to one grid step in the other (a value at the grid's half point;
    the frameworks' gradients differ in their last bits), the two updates
    are 0 and ``LR`` apart: 1-2 elements of a leaf here."""
    got = got.numpy()
    assert got.shape == want.shape, key
    d = np.abs(got - want)
    off = d > TOL + TOL * np.abs(want)
    assert off.sum() <= max(2, off.size // 10000), key
    assert d.max(initial=0) <= LR * 1.01, key


def _check(got, key: str, arrs: dict, js: dict, close=_close) -> None:
    """``got`` within 1e-4 of the reference's output ``key`` (by
    ``close``); where the reference placed it under its out-sharding,
    ``got`` is placed too and each member's shard lies within 1e-4 of its
    device's block."""
    if js[key]:
        assert isinstance(got, ShardedTensor), key
        for m, shard in enumerate(got.shards):
            close(shard, arrs[f"{key}/shard{m}"], f"{key} member {m}")
        got = got.full()
    elif isinstance(got, ShardedTensor):
        got = got.full()
    close(got, arrs[key], key)


def _check_int8(q, s, base: str, arrs: dict, js: dict) -> None:
    """An int8 moment, whole and member by member (placed as the reference
    placed it): the scales within 1e-4, the int8 values equal but on at most
    0.1% of a leaf, where they lie one grid step apart.  The two
    frameworks' gradients differ in their last bits, which puts a few
    elements (up to 4 of 8,192 in a leaf here) across an int8 rounding
    boundary; a step of the grid is ~1.1e-4 on the embedding's moments."""
    def same(qa, sa, qb, sb, where):
        np.testing.assert_allclose(sa.numpy(), sb, rtol=TOL, atol=0,
                                   err_msg=where)
        d = np.abs(qa.numpy().astype(np.int64) - qb.astype(np.int64))
        assert d.max(initial=0) <= 1 and (d > 0).mean() <= 1e-3, where

    assert js[f"{base}/q"] == js[f"{base}/s"], base
    if js[f"{base}/q"]:
        for m, (qm, sm) in enumerate(zip(q.shards, s.shards)):
            same(qm, sm, arrs[f"{base}/q/shard{m}"],
                 arrs[f"{base}/s/shard{m}"], f"{base} member {m}")
    same(q.full(), s.full(), arrs[f"{base}/q"], arrs[f"{base}/s"], base)


def _bits_equal(a, b) -> bool:
    a, b = sharding.gather(a), sharding.gather(b)
    if isinstance(a, tuple):
        a, b = dict(enumerate(a)), dict(enumerate(b))
    fa, fb = _flat(a, ""), _flat(b, "")
    return sorted(fa) == sorted(fb) and all(
        isinstance(fa[k], int) and fa[k] == fb[k]
        or torch.equal(fa[k], fb[k]) for k in fa)


# --------------------------------------------------------------------------
# what needs no reference (first: the reference runs meanwhile)
# --------------------------------------------------------------------------


def test_constrain_resolves_axes_and_keeps_values():
    """Under a mesh ``constrain`` resolves its logical axes (a spec naming a
    mesh axis twice raises, as ``with_sharding_constraint`` does) and
    returns its input; without one it is a no-op."""
    mesh = _mesh("2x2x2")
    x = torch.zeros(4, 8, 16)
    assert sharding.constrain(x, "dp", "model", None) is x
    with sharding.use_mesh(mesh):
        assert sharding._resolve(mesh, "dp") == ("pod", "data")
        assert sharding._resolve(mesh, "model") == "model"
        assert sharding._resolve(mesh, "expert") is None
        assert sharding.constrain(x, "dp", None, "model") is x
        with pytest.raises(ValueError, match="axes for a 3-d"):
            sharding.constrain(x, "dp", None, None, None)
    with sharding.use_mesh(mesh, "dp"):
        assert sharding._resolve(mesh, "dp") == ("pod", "data", "model")
        with pytest.raises(ValueError, match="more than one dimension"):
            sharding.constrain(x, "dp", "model", None)
    with pytest.raises(ValueError, match="policy"):
        sharding.use_mesh(mesh, "fsdp").__enter__()


def test_sharded_steps_refuse_what_they_cannot_place():
    """An uneven placement raises as the placement path does (here the
    decode cache's sequence split over ``model``, since the reduced MoE's
    one K/V head does not divide over it), and a mesh over distinct devices
    raises, pointing to ``launch.mesh.spawn``."""
    cfg = _moe_cfg()
    assert cfg.n_kv % 2
    with pytest.raises(ValueError, match="cannot be placed"):
        serve.generate(cfg, model.init_params(cfg, torch.Generator()
                                              .manual_seed(0), device="cpu"),
                       torch.zeros(8, 3, dtype=torch.int32), 2, max_seq=9,
                       mesh=_mesh("2x2x2"))
    spread = mesh_lib.Mesh([torch.device("cpu"), torch.device("meta")],
                           ("data",))
    sh = (NamedSharding(spread, P()),)
    for call in (lambda: sharding.use_mesh(spread).__enter__(),
                 lambda: steps.sharded_step(lambda x: x, sh)):
        with pytest.raises(NotImplementedError, match="launch.mesh.spawn"):
            call()


def test_elastic_restart_onto_a_smaller_mesh(tmp_path, monkeypatch):
    """The train driver under a 4x2 (data, model) mesh with a failure at
    step 7 and checkpoints every 5: the runner restores step 5 onto a 2x2
    mesh (``fault.onto``, ``restore(shardings=)``) and goes on there; every
    loss equals an uninterrupted unsharded run's over the batches the
    steps drew, bit for bit."""
    drawn = []
    real = train._build_loader

    def recording(*a, **kw):
        loader = real(*a, **kw)

        def it():
            for b in loader:
                drawn.append({k: v.clone() for k, v in b.items()})
                yield b
        return it()

    monkeypatch.setattr(train, "_build_loader", recording)
    args = train.build_parser().parse_args(
        ["--arch", "qwen3-1.7b", "--preset", "tiny", "--steps", "12",
         "--batch", "4", "--seq", "32", "--ckpt-every", "5", "--fail-at",
         "7", "--device", "cpu", "--lr", "1e-4", "--grad-int8",
         "--compress-moments", "--mesh", "4x2", "--restart-mesh", "2x2",
         "--ckpt-dir", str(tmp_path / "ck")])
    cfg = train._resolve_cfg(args)
    init = model.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    m = train.run_training(args, params=init)
    assert m["restarts"] == 1 and m["steps_done"] == 12
    params, opt = m["state"]
    assert {str(leaf.sharding.mesh) for leaf in leaves(params)} == \
        {"Mesh(data=2, model=2; devices ['cpu'])"}
    # the steps drew batches 0-6, lost 7 to the failure, then drew 8-14
    ran = drawn[:5] + drawn[8:15]
    oc = adamw.AdamWConfig(lr=1e-4, compress_moments=True)
    step = steps.build_train_step(cfg, oc, grad_compressor=collectives
                                  .make_wire_compressor(
                                      EngineConfig(device="cpu")))
    p, o, losses = init, adamw.init(init, oc), []
    for b in ran:
        p, o, loss = step(p, o, b)
        losses.append(float(loss))
    got = m["losses"]
    assert len(got) == 14
    assert got[:5] == losses[:5] and got[7:] == losses[5:]
    assert _bits_equal((p, o), (params, opt))


def test_runner_restores_a_placed_state_onto_its_mesh(tmp_path):
    """Without a ``reshard_fn`` a restart restores a placed state onto the
    mesh it was on, each leaf placed as before; ``fault.onto`` restores
    onto its own shardings."""
    mesh, other = _mesh("4x2"), _mesh("2x2")
    sh = {"w": NamedSharding(mesh, P("data", "model"))}
    to = {"w": NamedSharding(other, P("model", "data"))}
    state = sharding.place({"w": torch.arange(64.0).reshape(8, 8)}, sh)
    seen = []

    def step_fn(st, batch):
        seen.append(st["w"].sharding)
        return {"w": st["w"].map(lambda t: t + 1)}, 0.0

    for reshard, want in ((None, sh["w"]), (fault.onto(to), to["w"])):
        seen.clear()
        runner = fault.FaultTolerantRunner(
            step_fn, str(tmp_path / str(id(reshard))), ckpt_every=2,
            injector=fault.FailureInjector([3]), reshard_fn=reshard,
            async_ckpt=False,
            engine=CodagEngine(EngineConfig(device="cpu")))
        out, rep = runner.run(state, iter(range(10)), 4)
        assert rep.restarts == 1 and seen[3] == want and seen[2] == sh["w"]
        assert torch.equal(out["w"].full(),
                           torch.arange(64.0).reshape(8, 8) + 4)


# --------------------------------------------------------------------------
# the sharding context
# --------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["tp", "dp"])
@pytest.mark.parametrize("mk", sorted(MESHES))
def test_dp_groups_and_batch_spec_match_the_reference(ref, mk, policy):
    """``dp_groups`` and ``batch_spec`` equal the reference's on each
    mesh, both policies, batches 1-16, and walk the same axes: the product
    of the axes ``batch_spec`` splits a batch over is ``dp_groups``."""
    _, js = ref.get()
    mesh = _mesh(mk)
    with sharding.use_mesh(mesh, policy):
        for b in range(1, 17):
            g, spec = js[f"groups/{mk}/{policy}"][str(b)]
            got = sharding.batch_spec(mesh, b)
            assert sharding.dp_groups(b) == g, (mk, policy, b)
            assert got == P(*[tuple(p) if isinstance(p, list) else p
                              for p in spec]), (mk, policy, b)
            axes = got[0] if got and got[0] is not None else ()
            axes = (axes,) if isinstance(axes, str) else axes
            assert int(np.prod([mesh.shape[a] for a in axes])) == g
    assert sharding.current_mesh() is None
    assert sharding.dp_groups(8) == 1


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


def _batch() -> dict:
    return {k: torch.from_numpy(INPUTS[k]) for k in ("tokens", "labels")}


def _train_case(cfg, params, case: str):
    """The port's unsharded and sharded train step on 2x2x2:
    ``((p, o, loss) unsharded, (p, o, loss) sharded)``."""
    policy, kind = case.split("-")
    oc = adamw.AdamWConfig(lr=LR, compress_moments=kind == "int8")
    comp = (collectives.make_wire_compressor(EngineConfig(device="cpu"))
            if kind == "int8" else None)
    step = steps.build_train_step(cfg, oc, grad_compressor=comp)
    opt = adamw.init(params, oc)
    whole = step(params, opt, _batch())
    mesh = _mesh("2x2x2")
    with sharding.use_mesh(mesh, policy):
        ins, outs = steps.train_shardings(cfg, ShapeSpec("t", SEQ, BATCH,
                                                         "train"), mesh, oc)
        fn = steps.sharded_step(step, ins, outs)
    return whole, fn(params, opt, _batch())


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_sharded_train_step_matches_the_reference(ref, case):
    """Reduced qwen3-1.7b, one step on (pod 2, data 2, model 2), batch 4 x
    32: the loss, every parameter (``_updated``) and every moment
    (``_check_int8``) within 1e-4 of the reference's sharded step, each
    member's block within 1e-4 of its
    device's block under the reference's out-shardings, and the whole step
    equal to the port's unsharded step bit for bit."""
    arrs, js = ref.get()
    cfg = reduced(get_arch("qwen3-1.7b"))
    params = _params("dense")
    whole, (p2, o2, loss) = _train_case(cfg, params, case)
    key = f"train/dense/{case}"
    _check(loss, f"{key}/loss", arrs, js)
    for k, leaf in _flat(p2, f"{key}/p").items():
        _check(leaf, k, arrs, js, close=_updated)
    moments = _flat({"m": o2["m"], "v": o2["v"]}, f"{key}/o")
    for k, leaf in moments.items():
        if k.endswith("/s"):
            _check_int8(moments[k[:-2] + "/q"], leaf, k[:-2], arrs, js)
        elif not k.endswith("/q"):
            _check(leaf, k, arrs, js)
    # storage stays partitioned: each member keeps its own blocks
    pm = P(None, None, "model") if case.startswith("tp") else P()
    assert p2["blocks"]["attn"]["wq"].sharding.spec == pm
    assert isinstance(o2["step"], ShardedTensor)
    assert _bits_equal(whole[0], p2) and _bits_equal(whole[1], o2)
    assert torch.equal(whole[2], loss.full())


# --------------------------------------------------------------------------
# the MoE: per-group routing
# --------------------------------------------------------------------------


def _spy_tables(monkeypatch) -> list:
    seen = []
    real = moe._dispatch_group

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(moe, "_dispatch_group", spy)
    return seen


def test_moe_routes_per_dp_group_as_the_reference(ref, monkeypatch):
    """A planted layer (batch row 0 ranks experts 0 and 1 first): on the
    mesh (G = 4) the routing tables equal the reference's exactly, and so
    do they in one global group (G = 1); the two differ in which tokens
    overflow capacity; the outputs lie within 1e-4 of the reference's."""
    arrs, _ = ref.get()
    p = {k: torch.from_numpy(INPUTS[f"moe/{k}"])
         for k in ("router", "w_up", "w_gate", "w_down")}
    x = torch.from_numpy(INPUTS["moe/x"])
    seen = _spy_tables(monkeypatch)
    kept = {}
    for label, mesh in (("mesh", _mesh("2x2x2")), ("global", None)):
        seen.clear()
        with sharding.use_mesh(mesh):
            out = moe.moe_ffn(p, x, n_experts=8, top_k=2,
                              capacity_factor=MOE_CF)
        tos = torch.stack([t for t, _ in seen]).numpy()
        gos = torch.stack([g for _, g in seen]).numpy()
        np.testing.assert_array_equal(tos, arrs[f"planted/{label}/tos"],
                                      err_msg=label)
        np.testing.assert_allclose(gos, arrs[f"planted/{label}/gos"],
                                   rtol=1e-6, atol=1e-6, err_msg=label)
        _close(out, arrs[f"planted/{label}/out"], label)
        T = BATCH * SEQ // tos.shape[0]          # tokens a group
        kept[label] = {int(g * T + t) for g in range(tos.shape[0])
                       for t in tos[g].reshape(-1) if t < T}
    # row 0 fills its own group's capacity on the mesh and loses tokens;
    # in one global group all of row 0 fits
    row0 = set(range(SEQ))
    assert row0 <= kept["global"] and not row0 <= kept["mesh"]


def test_moe_sharded_steps_match_the_reference(ref, monkeypatch):
    """Reduced qwen3-moe (capacity factor 1, so groups drop tokens) on
    2x2x2 with G = 4: the prefill step's routing tables equal the
    reference's exactly, its logits and the train step's loss and
    parameters within 1e-4; the prefill logits equal each DP block run
    alone through the unsharded prefill step."""
    arrs, js = ref.get()
    cfg = _moe_cfg()
    params = _params("moe")
    mesh = _mesh("2x2x2")
    tokens = torch.from_numpy(INPUTS["tokens"])
    with sharding.use_mesh(mesh):
        assert sharding.dp_groups(BATCH) == js["moe_groups"] == 4
        p_sh = sharding.param_shardings(params, mesh)
        b_sh = steps.batch_shardings(cfg, ShapeSpec("p", SEQ, BATCH,
                                                    "prefill"), mesh)
    prefill = steps.build_prefill_step(cfg)
    fn = steps.sharded_step(prefill, (p_sh, {"tokens": b_sh["tokens"]}))
    seen = _spy_tables(monkeypatch)
    logits = fn(params, {"tokens": tokens})
    G = 4
    assert len(seen) == G * js["moe_layers"]
    for i in range(js["moe_layers"]):
        tos = torch.stack([t for t, _ in seen[i * G:(i + 1) * G]]).numpy()
        gos = torch.stack([g for _, g in seen[i * G:(i + 1) * G]]).numpy()
        np.testing.assert_array_equal(tos, arrs[f"prefill/moe/tos{i}"])
        np.testing.assert_allclose(gos, arrs[f"prefill/moe/gos{i}"],
                                   rtol=1e-6, atol=1e-6)
    _close(logits, arrs["prefill/moe/logits"], "prefill logits")
    blocks = torch.cat([prefill(params, {"tokens": tokens[g:g + 1]})
                        for g in range(BATCH)])
    assert torch.equal(blocks, logits)
    whole, (p2, _, loss) = _train_case(cfg, params, "tp-f32")
    key = "train/moe/tp-f32"
    _check(loss, f"{key}/loss", arrs, js)
    for k, leaf in _flat(p2, f"{key}/p").items():
        _check(leaf, k, arrs, js, close=_updated)


# --------------------------------------------------------------------------
# the serve and prefill steps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_and_prefill_steps_under_the_mesh(ref, arch):
    """Reduced zamba2 (test_distributed.py:343), rwkv6 and qwen3 under
    ``serve_shardings`` on 2x2x2: three decode steps from a zero cache, each
    step's logits and every cache leaf's member blocks within 1e-4 of the
    reference's; the prefill step's logits too; both equal the port's
    unsharded steps bit for bit."""
    arrs, js = ref.get()
    cfg = reduced(get_arch(arch))
    params = _params(arch)
    mesh = _mesh("2x2x2")
    decode, (p_sh, c_sh) = serve.mesh_decode(cfg, mesh, SERVE_B, SERVE_S)
    placed = sharding.place(params, p_sh)
    cache = sharding.place(model.init_cache(cfg, SERVE_B, SERVE_S,
                                            device="cpu"), c_sh)
    plain = model.init_cache(cfg, SERVE_B, SERVE_S, device="cpu")
    for t in range(SERVE_STEPS):
        tok = torch.from_numpy(INPUTS["serve_tokens"][t])
        logits, cache = decode(placed, cache, tok)
        want, plain = model.decode_step(cfg, params, plain, tok)
        _close(logits, arrs[f"serve/{arch}/logits{t}"], f"logits {t}")
        assert torch.equal(logits, want)
    assert cache["pos"] == plain["pos"] == SERVE_STEPS
    for k, v in cache.items():
        if k != "pos":
            assert v.sharding == c_sh[k]
            _check(v, f"serve/{arch}/cache/{k}", arrs, js)
            assert torch.equal(v.full(), plain[k])
    b_sh = steps.batch_shardings(cfg, ShapeSpec("p", SERVE_S, SERVE_B,
                                                "prefill"), mesh)
    rep = NamedSharding(mesh, P())
    fn = steps.sharded_step(steps.build_prefill_step(cfg),
                            (p_sh, {"tokens": b_sh["tokens"]}), rep)
    batch = {"tokens": torch.from_numpy(INPUTS["prefill_tokens"])}
    logits = fn(placed, batch)
    _check(logits, f"prefill/{arch}/logits", arrs, js)
    assert torch.equal(logits.full(),
                       steps.build_prefill_step(cfg)(params, batch))


