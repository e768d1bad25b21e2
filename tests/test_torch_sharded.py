"""Mesh placement held to the JAX package on the CPU: the sharded decode
executor (``DecodePlan.execute_sharded``, ``api.decompress_many(mesh=,
out_shardings=)``), ``checkpoint.restore(shardings=)``, the loader's
``mesh=``, the placement types and the parameter, optimizer, batch and
cache specs (``distributed/sharding.py``, ``launch/steps.py``).

The reference places on a multi-device mesh, so its half runs as
``tests/test_plan_sharded.py`` runs it: one subprocess on 8 virtual CPU
devices (``--xla_force_host_platform_device_count=8``), started when the
first test of this file asks for it, on inputs made here from a seed.  It
records every output's per-device blocks in ``mesh.devices.flat`` order,
the spec trees as lists, and each sharding's ``devices_indices_map``.  The
port's meshes are the same shapes with every member on the CPU; each
member's shard must equal the reference device's block bit for bit, and
every spec tree must equal the reference's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ShapeSpec, SHAPES, get_arch, list_archs
from repro_torch.configs import reduced
from repro_torch.core import api, plan as plan_mod, registry, transfers
from repro_torch.core import server as srv
from repro_torch.core import store as bs
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.data import pipeline
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              ShardedTensor)
from repro_torch.kernels import harness, ops
from repro_torch.launch import mesh as mesh_lib, steps
from repro_torch.models import model
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = CodagEngine(EngineConfig(device="cpu"))
CODECS = ("rle_v1", "rle_v2", "dbp", "bitpack", "tdeflate", "huffman",
          "lzss")
# 1-D sizes: one element, a ragged tail, and two that 1, 2, 3 and 4 divide
SIZES = (1, 777, 1032, 4104)
GRID = (24, 50)                    # a 2-D output whose rows straddle chunks
CHUNK = 1024
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SPEC_CFGS = tuple(list_archs()) + ("full:qwen3-1.7b",
                                   "full:qwen3-moe-235b-a22b")
INDEX_CASES = (("4x2", ("data", "model"), (8, 6)),
               ("4x2", (("data", "model"),), (16,)),
               ("4x2", ("model", "data"), (4, 8)),
               ("4x2", (None, "data"), (3, 8)),
               ("4x2", (), (5,)),
               ("2x2x2", (("pod", "data"), "model"), (8, 4)))
CORPUS = 32768 + 99                # a ragged last shard


def _inputs() -> dict:
    out = {}
    for ci, name in enumerate(CODECS):
        codec = registry.get(name)
        for j, n in enumerate(SIZES + (GRID[0] * GRID[1],)):
            a = codec.demo_data(n, np.random.default_rng(100 * ci + j))[:n]
            out[f"arr/{name}/{j}"] = a.reshape(GRID) if j == len(SIZES) \
                else a
    rng = np.random.default_rng(7)
    out["epi"] = np.repeat(rng.integers(0, 50, 60).astype(np.uint32), 20)
    out["block"] = np.repeat(rng.integers(0, 50, 40).astype(np.uint32), 60)
    out["i64"] = rng.integers(-5000, 5000, 1200).astype(np.int64)
    out["u64"] = rng.integers(0, 1 << 40, 1003).astype(np.uint64)
    out["f64"] = np.round(rng.normal(size=1200), 2).astype(np.float64)
    out["ck_w"] = rng.normal(size=(64, 64)).astype(np.float32)
    out["ck_m"] = rng.integers(0, 200, (128, 32)).astype(np.int32)
    out["ck_small"] = np.float32(1.5)
    return out


INPUTS = _inputs()
EPI_OPERANDS = {"s": np.float32(0.5), "z": np.float32(3.0)}

REF = r'''
import functools, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint import checkpoint as ckpt
from repro.configs import ShapeSpec, SHAPES, get_arch, list_archs, reduced
from repro.core import api, transfers
from repro.core.engine import CodagEngine, EngineConfig
from repro.data import pipeline as pl
from repro.distributed import sharding as shd
from repro.kernels.harness import Epilogue
from repro.launch import steps
from repro.models import model
from repro.optim import adamw

inp = dict(np.load(sys.argv[1]))
cfgs = json.loads(sys.argv[4])
work = sys.argv[3]
arr, js = {}, {}
devs = jax.devices()
eng = CodagEngine(EngineConfig())


def mesh_of(shape, axes):
    return Mesh(np.asarray(devs[:int(np.prod(shape))]).reshape(shape), axes)


MESHES = {k: mesh_of(tuple(s), tuple(a)) for k, (s, a) in cfgs["meshes"].items()}


def record(key, a, mesh, want):
    """a's value, and its blocks in mesh.devices.flat order where it lies
    under ``want``."""
    arr[key] = np.asarray(a)
    placed = want is not None and a.sharding.is_equivalent_to(want, a.ndim)
    js[key] = placed
    if placed:
        order = {d: i for i, d in enumerate(mesh.devices.flat)}
        for s in a.addressable_shards:
            arr[f"{key}/shard{order[s.device]}"] = np.asarray(s.data)


def out_sh(mesh, a):
    if a.ndim == 2:
        return NamedSharding(mesh, P("data", "model") if "model" in
                             mesh.axis_names else P("data", None))
    return NamedSharding(mesh, P(("data", "model")) if "model" in
                         mesh.axis_names else P("data"))


# the executor: every codec at axis sizes 1-4 and on a 2-D mesh
for name in cfgs["codecs"]:
    arrays = [inp[f"arr/{name}/{j}"] for j in range(cfgs["n_arrays"])]
    cas = [api.compress(a, name, chunk_bytes=cfgs["chunk"]) for a in arrays]
    cases = [(f"d{n}", mesh_of((n,), ("data",)), None)
             for n in ((1, 2, 3, 4) if name == "rle_v2" else (3, 4))]
    cases.append(("2x2", MESHES["2x2"], None))
    if name == "rle_v2":
        cases.append(("2x2/model", MESHES["2x2"], "model"))
    for label, mesh, axis in cases:
        shs = [out_sh(mesh, a) for a in arrays]
        outs = api.decompress_many(cas, eng, mesh=mesh, mesh_axis=axis,
                                   out_shardings=shs)
        for j, (o, s) in enumerate(zip(outs, shs)):
            record(f"exec/{name}/{label}/{j}", o, mesh, s)

# an epilogue with replicated operands, and the block unit
m3 = mesh_of((3,), ("data",))
ca = api.compress(inp["epi"], "rle_v2", chunk_bytes=512)
epi = Epilogue(out_dtype="float32", scale_key="s", zero_key="z")
[o] = api.decompress_many([ca], eng, mesh=m3, epilogue=epi,
                          epilogue_operands={"s": np.float32(0.5),
                                             "z": np.float32(3.0)},
                          out_shardings=NamedSharding(m3, P("data")))
record("epi", o, m3, NamedSharding(m3, P("data")))
m4 = mesh_of((4,), ("data",))
blk = CodagEngine(EngineConfig(unit="block", n_units=2))
ca = api.compress(inp["block"], "rle_v2", chunk_bytes=512)
[o] = api.decompress_many([ca], blk, mesh=m4,
                          out_shardings=NamedSharding(m4, P("data")))
record("block", o, m4, NamedSharding(m4, P("data")))

# each sharding's devices_indices_map, members in mesh.devices.flat order
for i, (mk, spec, shape) in enumerate(cfgs["index_cases"]):
    mesh = MESHES[mk]
    spec = P(*[tuple(p) if isinstance(p, list) else p for p in spec])
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    js[f"index/{i}"] = [[[s.start or 0, shape[d] if s.stop is None
                          else s.stop] for d, s in enumerate(m[dv])]
                        for dv in mesh.devices.flat]

# restore(shardings=): the reference test's case, and elastically onto
# another mesh
state = {"w": inp["ck_w"], "m": inp["ck_m"], "small": inp["ck_small"]}
ckpt.save(work, 3, state, codec="rle_v2")
for label, mk, specs in cfgs["restores"]:
    mesh = MESHES[mk] if mk in MESHES else mesh_of((2, 4), ("data", "model"))
    shs = {k: NamedSharding(mesh, P(*v)) for k, v in specs.items()}
    with transfers.count_host_transfers() as c:
        out = ckpt.restore(work, 3, state, shardings=shs, device_out=True)
    assert c["d2h"] == 0, c
    for k in state:
        record(f"restore/{label}/{k}", out[k], mesh, shs[k])

# the loader's mesh=
toks = pl.synthetic_corpus(cfgs["corpus"], 500, seed=2)
store = pl.CompressedTokenStore.build(toks, 500, shard_tokens=8192,
                                      chunk_bytes=2048)
m4 = mesh_of((4,), ("data",))
want = shd.decode_out_sharding(m4)
for i, d in enumerate(store.decoded_shards(eng, window=2, mesh=m4)):
    record(f"shards/{i}", d, m4, want)
js["shards"] = i + 1
it = iter(pl.CompressedLoader(store, batch=4, seq=128, engine=eng,
                              prefetch=False, mesh=mesh_of((2,), ("data",))))
for i in range(3):
    b = next(it)
    arr[f"loader/{i}/tokens"] = np.asarray(b["tokens"])
    arr[f"loader/{i}/labels"] = np.asarray(b["labels"])

# the spec trees; a spec is {"P": its entries}
def tree_js(t):
    if isinstance(t, NamedSharding):
        t = t.spec
    if isinstance(t, P):
        return {"P": [p if p is None or isinstance(p, str) else list(p)
                      for p in t]}
    if isinstance(t, dict):
        return {str(k): tree_js(v) for k, v in t.items()}
    return [tree_js(v) for v in t]


model.abstract_params = functools.lru_cache(maxsize=None)(
    model.abstract_params)
for cname in cfgs["spec_cfgs"]:
    full = cname.startswith("full:")
    cfg = get_arch(cname[5:]) if full else reduced(get_arch(cname))
    params = model.abstract_params(cfg)
    o32 = jax.eval_shape(functools.partial(
        adamw.init, cfg=adamw.AdamWConfig()), params)
    o8 = jax.eval_shape(functools.partial(
        adamw.init, cfg=adamw.AdamWConfig(compress_moments=True)), params)
    st = SHAPES["train_4k"] if full else ShapeSpec("t", 64, 12, "train")
    sd = SHAPES["decode_32k"] if full else ShapeSpec("d", 64, 6, "decode")
    for mk, mesh in MESHES.items():
        for policy in ("tp", "dp"):
            with shd.use_mesh(mesh, policy):
                try:
                    serve = tree_js(steps.serve_shardings(cfg, sd, mesh))
                except Exception as e:       # an axis named twice
                    if type(e).__name__ != "DuplicateSpecError":
                        raise
                    serve = {"error": type(e).__name__}
                js[f"specs/{cname}/{mk}/{policy}"] = tree_js({
                    "param": shd.param_specs(params, mesh),
                    "opt32": shd.opt_specs(o32, params, mesh),
                    "opt8": shd.opt_specs(o8, params, mesh),
                    "batch": {str(b): shd.batch_spec(mesh, b)
                              for b in (1, 2, 4, 6, 8, 12, 16)},
                    "cache": {str(b): shd.cache_spec(mesh, cfg, b)
                              for b in (1, 4, 8)},
                    "train": steps.train_shardings(
                        cfg, st, mesh,
                        adamw.AdamWConfig(compress_moments=True)),
                    "decode_out": shd.decode_out_sharding(mesh, 2),
                    "member": shd.member_sharding(mesh, "data", 3),
                })
                js[f"specs/{cname}/{mk}/{policy}"]["serve"] = serve

# 64-bit planes last, under x64 (jax.experimental.enable_x64 is gone)
jax.config.update("jax_enable_x64", True)
for k in ("i64", "u64", "f64"):
    ca = api.compress(inp[k], "rle_v2", chunk_bytes=1024)
    [o] = api.decompress_many([ca], eng, mesh=m3,
                              out_shardings=NamedSharding(m3, P("data")))
    assert str(o.dtype) == str(inp[k].dtype)
    record(f"planes/{k}", o, m3, NamedSharding(m3, P("data")))

np.savez(sys.argv[2], **arr)
with open(sys.argv[2] + ".json", "w") as f:
    json.dump(js, f)
print("PASS")
'''

RESTORES = (("4x2", "4x2", {"w": ("data", "model"), "m": ("data", None),
                            "small": ()}),
            ("elastic", "2x4", {"w": ("model", "data"), "m": (None, "model"),
                                "small": ()}))


class RefRun:
    """The reference's subprocess, started once a module and waited for on
    first use."""

    def __init__(self, tmp):
        self.inp, self.out = tmp / "in.npz", tmp / "out.npz"
        np.savez(self.inp, **INPUTS)
        cfgs = {"meshes": MESHES, "codecs": CODECS, "chunk": CHUNK,
                "n_arrays": len(SIZES) + 1, "index_cases": INDEX_CASES,
                "restores": RESTORES, "corpus": CORPUS,
                "spec_cfgs": SPEC_CFGS}
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = os.path.join(ROOT, "src")
        env["JAX_PLATFORMS"] = "cpu"
        (tmp / "ckpt").mkdir()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF, str(self.inp), str(self.out),
             str(tmp / "ckpt"), json.dumps(cfgs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self.ckpt = tmp / "ckpt"
        self._res = None

    def get(self):
        if self._res is None:
            so, se = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0 and "PASS" in so, \
                f"stdout:\n{so}\nstderr:\n{se[-4000:]}"
            with open(str(self.out) + ".json") as f:
                self._res = (dict(np.load(self.out)), json.load(f))
        return self._res

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    run = RefRun(tmp_path_factory.mktemp("sharded_ref"))
    yield run
    run.close()


def _mesh(shape, axes):
    return mesh_lib.make_test_mesh(shape, axes, device="cpu")


def _outcome(fn, *args):
    try:
        return fn(*args), None
    except Exception as e:           # raised again in the test it belongs to
        return None, e


@pytest.fixture(scope="module")
def port(ref):
    """The port's side of the executor and spec cases, computed while the
    reference's subprocess runs: ``{"exec": {codec: ...}, "specs": {name:
    ...}}``, each an (outcome, exception) pair."""
    return {"exec": {c: _outcome(_port_exec, c) for c in CODECS},
            "specs": {c: _outcome(_port_specs, c) for c in SPEC_CFGS}}


def _result(pair):
    value, error = pair
    if error is not None:
        raise error
    return value


def _out_sh(mesh, ndim: int) -> NamedSharding:
    model_ax = "model" in mesh.axis_names
    if ndim == 2:
        return NamedSharding(mesh, P("data", "model") if model_ax
                             else P("data", None))
    return NamedSharding(mesh, P(("data", "model")) if model_ax
                         else P("data"))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy() if t.dtype != torch.bfloat16 else \
        t.view(torch.uint16).numpy()


def _check(got, key: str, arrs: dict, js: dict, sh) -> None:
    """``got`` equals the reference's output ``key``: placed as the
    reference placed it, each member's shard equal to its device's block,
    on that member's device, in a storage of its own."""
    want = arrs[key]
    if js[key]:
        assert isinstance(got, ShardedTensor), key
        assert got.sharding is sh or got.sharding == sh, key
        assert tuple(got.shape) == want.shape, key
        ptrs = set()
        for m, (shard, dev) in enumerate(zip(got.shards,
                                             sh.mesh.devices.flat)):
            assert shard.device == dev, key
            np.testing.assert_array_equal(_np(shard),
                                          arrs[f"{key}/shard{m}"],
                                          err_msg=f"{key} member {m}")
            if shard.numel():
                ptrs.add(shard.data_ptr())
        assert len(ptrs) == sum(s.numel() > 0 for s in got.shards), key
        got = got.full()
    else:
        assert isinstance(got, torch.Tensor), key
    assert str(_np(got).dtype) == str(want.dtype), key
    np.testing.assert_array_equal(_np(got), want, err_msg=key)


# --------------------------------------------------------------------------
# the placement types
# --------------------------------------------------------------------------


def test_partition_specs_compare_as_the_reference_does(ref):
    assert P("data", None) == P("data") == ("data",)
    assert P(("data",), None) == P("data")
    assert P(("pod", "data")) != P("data")
    assert hash(P("a", None, None)) == hash(P("a"))
    assert sharding.member_sharding(_mesh((2,), ("pod",)), "pod", 3).spec \
        == ("pod", None, None)
    with pytest.raises(TypeError):
        P((1, 2))


def test_a_sharded_tensor_round_trips_and_owns_its_shards():
    mesh = _mesh((2, 3), ("data", "model"))
    x = torch.arange(4 * 9, dtype=torch.int64).reshape(4, 9)
    for spec in (P("data", "model"), P(None, "model"), P(), P("model"),
                 P(("data", "model"))):
        if not sharding.placeable(x.shape, NamedSharding(mesh, spec)):
            continue
        st = ShardedTensor.place(x, NamedSharding(mesh, spec))
        assert torch.equal(st.full(), x) and st.dtype == x.dtype
        assert len({s.data_ptr() for s in st.shards}) == mesh.size
    st = ShardedTensor.place(x, NamedSharding(mesh, P("data", "model")))
    assert st.sharding.shard_shape(x.shape) == (2, 3)
    assert st.map(lambda t: t.to(torch.int32)).dtype == torch.int32
    assert not sharding.placeable((5, 9), NamedSharding(mesh, P("data")))
    with pytest.raises(ValueError, match="cannot be placed"):
        ShardedTensor.place(x[:3], NamedSharding(mesh, P("data")))
    with pytest.raises(ValueError, match="not an axis"):
        sharding.placeable((4,), NamedSharding(mesh, P("pod")))


# --------------------------------------------------------------------------
# the sharded decode executor
# --------------------------------------------------------------------------


def test_zero_length_padding_rows_through_every_codec():
    """The padding rows of every group decode to nothing through each
    codec's body, its fused epilogue and the single-thread body; a staged
    plan re-executes with no host transfer."""
    mesh = _mesh((4,), ("data",))
    for codec in CODECS:
        arrays = [INPUTS[f"arr/{codec}/{j}"] for j in (1, 2)]
        plan = plan_mod.DecodePlan.build(
            [b for ca in api.compress_many(arrays, codec, CHUNK)
             for b in ca.blobs])
        n = plan.groups[0].num_chunks
        plan.stage_sharded(mesh, "data")
        dev = plan._staged[(mesh, "data")][0]
        assert dev["comp"].shape[0] == -(-n // 4) * 4
        assert not dev["out_lens"][n:].any() and not \
            dev["comp_lens"][n:].any()
        width = plan.groups[0].key[1]
        want = plan.execute_device(CPU)
        for config in (CPU.config, EngineConfig(device="cpu",
                                                all_thread=False)):
            got = plan.execute_sharded(mesh, engine=CodagEngine(config))
            for g, w in zip(got, want):
                assert torch.equal(g, w), (codec, config.all_thread)
        if codec in ("tdeflate", "huffman"):
            continue                     # bytes: no widening epilogue
        epi = harness.Epilogue(out_dtype="float32", scale_key="s",
                               zero_key="z")
        fused = plan.execute_sharded(mesh, engine=CPU, epilogue=epi,
                                     epilogue_operands=EPI_OPERANDS)
        for g, a in zip(fused, arrays):
            np.testing.assert_array_equal(
                g.numpy(), (a.astype(np.float32) - 3.0) * 0.5,
                err_msg=f"{codec} w{width}")
        with transfers.count_host_transfers() as c, \
                transfers.no_host_transfers():
            plan.execute_sharded(mesh, engine=CPU,
                                 out_shardings=sharding.decode_out_sharding(
                                     mesh))
        assert c["d2h"] == 0 and c["h2d"] == 0, (codec, c)


def test_the_service_path_and_bad_meshes_raise_as_the_reference():
    ca = api.compress(np.arange(100, dtype=np.uint32), "rle_v2", CHUNK)
    rca = ref_api.compress(np.arange(100, dtype=np.uint32), "rle_v2", CHUNK)
    mesh = _mesh((2,), ("data",))
    with srv.DecompressionService(CPU, cache_bytes=0) as svc:
        with pytest.raises(ValueError) as got:
            api.decompress_many([ca], service=svc, mesh=mesh)
    with pytest.raises(ValueError) as want:
        ref_api.decompress_many([rca], service=object(), mesh=object())
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="out_shardings requires"):
        api.decompress_many([ca], CPU, out_shardings=NamedSharding(mesh, P()))
    with pytest.raises(ValueError, match="engine decodes on"):
        plan_mod.decompress_blobs(ca.blobs, CPU, mesh=mesh_lib.Mesh(
            [torch.device("meta")] * 2, ("data",)))
    with pytest.raises(ValueError, match="not an axis"):
        api.decompress_many([ca], CPU, mesh=mesh, mesh_axis="model")
    with pytest.raises(ValueError, match="2 out_shardings for 1 arrays"):
        api.decompress_many([ca], CPU, mesh=mesh, out_shardings=[None] * 2)


def _port_exec(codec: str) -> list:
    """Every executor case of ``codec``: (label, shardings, outputs, the
    launches' chunk counts), after checking the launches and that each
    output equals ``execute_device``'s."""
    arrays = [INPUTS[f"arr/{codec}/{j}"] for j in range(len(SIZES) + 1)]
    cas = api.compress_many(arrays, codec, CHUNK)
    flat = [b for ca in cas for b in ca.blobs]
    plan = plan_mod.DecodePlan.build(flat)
    plain = plan.execute_device(CPU)
    cases = [(f"d{n}", _mesh((n,), ("data",)), None)
             for n in ((1, 2, 3, 4) if codec == "rle_v2" else (3, 4))]
    m22 = _mesh(*MESHES["2x2"])
    cases.append(("2x2", m22, None))
    if codec == "rle_v2":
        cases.append(("2x2/model", m22, "model"))
    done = []
    for label, mesh, axis in cases:
        shs = [_out_sh(mesh, a.ndim) for a in arrays]
        with ops.count_dispatches() as calls:
            outs = api.decompress_many(cas, CPU, mesh=mesh, mesh_axis=axis,
                                       out_shardings=shs)
        # one launch a group, each table padded to a multiple of the axis
        assert len(calls) == plan.num_dispatches, label
        members = mesh.shape[axis or "data"]
        for call, g in zip(calls, plan.groups):
            assert call["num_chunks"] % members == 0, label
            assert 0 <= call["num_chunks"] - g.num_chunks < members, label
        for o, want in zip(outs, plain):
            full = o.full() if isinstance(o, ShardedTensor) else o
            assert torch.equal(full, want.reshape(full.shape)), label
        done.append((label, shs, outs))
    return done


@pytest.mark.parametrize("codec", CODECS)
def test_execute_sharded_matches_the_reference(ref, port, codec):
    """Every codec on 3- and 4-member axes (rle_v2 on 1 to 4), each group
    padded to the axis with zero-length rows (ragged groups), and on a
    (data=2, model=2) mesh with the rows split over ``data`` (and, for
    rle_v2, over ``model``) while the 2-D outputs are placed over both:
    each member's shard equals the reference device's block; one launch a
    group, the outputs equal ``execute_device``'s."""
    done = _result(port["exec"][codec])
    arrs, js = ref.get()
    for label, shs, outs in done:
        for j, (o, s) in enumerate(zip(outs, shs)):
            _check(o, f"exec/{codec}/{label}/{j}", arrs, js, s)


def test_epilogue_block_unit_and_64bit_planes_match_the_reference(ref):
    arrs, js = ref.get()
    m3, m4 = _mesh((3,), ("data",)), _mesh((4,), ("data",))
    ca = api.compress(INPUTS["epi"], "rle_v2", 512)
    epi = harness.Epilogue(out_dtype="float32", scale_key="s", zero_key="z")
    sh = NamedSharding(m3, P("data"))
    [o] = api.decompress_many([ca], CPU, mesh=m3, epilogue=epi,
                              epilogue_operands=EPI_OPERANDS,
                              out_shardings=sh)
    _check(o, "epi", arrs, js, sh)
    block = CodagEngine(EngineConfig(device="cpu", unit="block", n_units=2))
    ca = api.compress(INPUTS["block"], "rle_v2", 512)
    sh4 = NamedSharding(m4, P("data"))
    with ops.count_dispatches() as calls:
        [o] = api.decompress_many([ca], block, mesh=m4, out_shardings=sh4)
    assert len(calls) == -(-ca.blobs[0].num_chunks // 4) * 4 // 2
    _check(o, "block", arrs, js, sh4)
    for k in ("i64", "u64", "f64"):
        ca = api.compress(INPUTS[k], "rle_v2", CHUNK)
        assert len(ca.blobs) == 2                  # lo and hi u32 planes
        [o] = api.decompress_many([ca], CPU, mesh=m3, out_shardings=sh)
        _check(o, f"planes/{k}", arrs, js, sh)


def test_member_indices_match_devices_indices_map(ref, port):
    _, js = ref.get()
    for i, (mk, spec, shape) in enumerate(INDEX_CASES):
        mesh = _mesh(*MESHES[mk])
        got = NamedSharding(mesh, P(*spec)).member_indices(shape)
        assert [[[s.start, s.stop] for s in idx] for idx in got] == \
            js[f"index/{i}"], (mk, spec, shape)


# --------------------------------------------------------------------------
# the consumers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("way", ["engine", "store", "host"])
def test_sharded_restore_places_leaves_as_the_reference(ref, tmp_path, way):
    """The reference test's case (rle_v2, (data=4, model=2), P("data",
    "model"), P("data", None), P()) and an elastic restore onto (data=2,
    model=4), from the reference's own directory: every leaf's shards equal
    the reference devices' blocks.  The engine and store paths decode on
    the mesh with no device->host transfer."""
    arrs, js = ref.get()
    like = {"w": 0, "m": 0, "small": 0}
    for label, mk, specs in RESTORES:
        mesh = _mesh(*MESHES[mk]) if mk in MESHES else \
            _mesh((2, 4), ("data", "model"))
        shs = {k: NamedSharding(mesh, P(*v)) for k, v in specs.items()}
        with transfers.count_host_transfers() as c:
            if way == "store":
                with bs.filesystem_store(ref.ckpt,
                                         host_budget_bytes=1 << 20) as st:
                    out = ckpt.restore(str(ref.ckpt), 3, like, shardings=shs,
                                       device_out=True, store=st,
                                       decode_window=1)
            else:
                out = ckpt.restore(str(ref.ckpt), 3, like, shardings=shs,
                                   engine=CPU if way == "host" else None,
                                   device_out=way != "host")
        if way != "host":
            assert c["d2h"] == 0, c
        for k in like:
            _check(out[k], f"restore/{label}/{k}", arrs, js, shs[k])


def test_loader_mesh_matches_the_reference(ref):
    """Token shards born under ``decode_out_sharding`` on a 4-member mesh
    (the ragged last shard left whole), and the loader's batches on a
    2-member mesh, equal the reference's; the batches are placed over
    their batch dimension."""
    toks = pipeline.synthetic_corpus(CORPUS, 500, seed=2)
    store = pipeline.CompressedTokenStore.build(toks, 500, shard_tokens=8192,
                                                chunk_bytes=2048)
    m4, m2 = _mesh((4,), ("data",)), _mesh((2,), ("data",))
    got = list(store.decoded_shards(CPU, window=2, mesh=m4))
    it = iter(pipeline.CompressedLoader(store, batch=4, seq=128,
                                        prefetch=False, mesh=m2))
    batches = [next(it) for _ in range(3)]
    it.close()
    arrs, js = ref.get()
    assert len(got) == js["shards"] == 5
    assert isinstance(got[-1], torch.Tensor)          # the ragged tail
    for i, d in enumerate(got):
        _check(d, f"shards/{i}", arrs, js, sharding.decode_out_sharding(m4))
    bsh = sharding.decode_out_sharding(m2, 2)
    for i, b in enumerate(batches):
        for k in ("tokens", "labels"):
            assert isinstance(b[k], ShardedTensor) and b[k].sharding == bsh
            np.testing.assert_array_equal(b[k].full().numpy(),
                                          arrs[f"loader/{i}/{k}"])
    with srv.DecompressionService(CPU, cache_bytes=0) as svc:
        with pytest.raises(ValueError, match="not supported with service"):
            pipeline.CompressedLoader(store, 4, 128, service=svc, mesh=m2)


# --------------------------------------------------------------------------
# the specs
# --------------------------------------------------------------------------


def _as_lists(t):
    """The reference subprocess's form of a spec tree: a spec is {"P": its
    entries}."""
    if isinstance(t, NamedSharding):
        t = t.spec
    if isinstance(t, P):
        return {"P": [p if p is None or isinstance(p, str) else list(p)
                      for p in t]}
    if isinstance(t, dict):
        return {str(k): _as_lists(v) for k, v in t.items()}
    return [_as_lists(v) for v in t]


def _same(got, want, where: str) -> None:
    """Spec trees equal: the same keys, and each spec equal to the
    reference's as ``PartitionSpec`` s compare (trailing Nones aside)."""
    if isinstance(want, dict) and "error" in want:
        assert got == want, (where, got, want)
    elif isinstance(want, dict) and "P" in want:
        assert isinstance(got, dict) and "P" in got, where
        assert P(*got["P"]) == P(*want["P"]), (where, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
    else:
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}/{i}")


def _port_specs(cname: str) -> dict:
    full = cname.startswith("full:")
    cfg = get_arch(cname[5:]) if full else reduced(get_arch(cname))
    params = model.abstract_params(cfg)
    o32 = adamw.init(params, adamw.AdamWConfig())
    o8 = adamw.init(params, adamw.AdamWConfig(compress_moments=True))
    assert next(iter(params.values())).device.type == "meta"
    st = SHAPES["train_4k"] if full else ShapeSpec("t", 64, 12, "train")
    sd = SHAPES["decode_32k"] if full else ShapeSpec("d", 64, 6, "decode")
    out = {}
    for mk, (shape, axes) in MESHES.items():
        mesh = _mesh(shape, axes)
        for policy in ("tp", "dp"):
            with sharding.use_mesh(None, policy):
                try:
                    serve = _as_lists(steps.serve_shardings(cfg, sd, mesh))
                except ValueError:           # an axis named twice
                    serve = {"error": "DuplicateSpecError"}
                got = _as_lists({
                    "param": sharding.param_specs(params, mesh),
                    "opt32": sharding.opt_specs(o32, params, mesh),
                    "opt8": sharding.opt_specs(o8, params, mesh),
                    "batch": {b: sharding.batch_spec(mesh, b)
                              for b in (1, 2, 4, 6, 8, 12, 16)},
                    "cache": {b: sharding.cache_spec(mesh, cfg, b)
                              for b in (1, 4, 8)},
                    "train": steps.train_shardings(
                        cfg, st, mesh,
                        adamw.AdamWConfig(compress_moments=True)),
                    "decode_out": sharding.decode_out_sharding(mesh, 2),
                    "member": sharding.member_sharding(mesh, "data", 3),
                })
                got["serve"] = serve
            out[f"{mk}/{policy}"] = got
    tr = steps.train_shardings(cfg, st, mesh)
    assert all(s.mesh is mesh for s in (tr[0][2]["tokens"], tr[1][2]))
    return out


@pytest.mark.parametrize("cname", SPEC_CFGS)
def test_spec_trees_match_the_reference(ref, port, cname):
    """param / opt (float32 and int8 moments) / batch / cache specs and
    the train and serve step shardings, on (data=2, model=2), (data=4,
    model=2) and (pod=2, data=2, model=2), under both policies: the
    registered configs at ``--preset tiny`` widths, qwen3-1.7B and
    qwen3-moe-235B-A22B at full width (shapes only, ``meta`` tensors).  A
    serve sharding that names the model axis twice (the dp policy's batch
    beside K/V heads over ``model``) is refused by both."""
    got = _result(port["specs"][cname])
    _, js = ref.get()
    for key, tree in got.items():
        _same(tree, js[f"specs/{cname}/{key}"], f"{cname}/{key}")
