"""The port's dry-run (``repro_torch.launch.dryrun``) held to the JAX
package's on the CPU.

The reference's dry-run compiles for a multi-device mesh, so its half runs
as ``tests/test_torch_mesh_steps.py`` runs it: one subprocess on virtual
CPU devices (256 here: the 16 x 16 mesh), started when the first test of
this file asks for it, while the port's side is computed.  It gives:

* ``probe_costs`` per device of three reduced configs at seq 64 x batch 8
  on an (8, 1) data x model mesh, where pure DP means no tensor-parallel
  split on either side: the port's FLOPs per member must lie within 5% of
  the reference's for qwen3 (its matmuls alone give 97.4%), and within
  the tolerances stated beside the MoE's and rwkv6's readings; and the
  same on a (2, 4) mesh, where both sides split the compute over
  ``model`` (the port's member program, ``steps.member_step``);
* every arch x applicable shape's per-device argument bytes on the 16 x 16
  mesh, from ``NamedSharding.shard_shape`` with no compile: the port's
  member blocks must equal them exactly.

The port's side needs no reference for the rest: the probes' linear
extrapolation against the full-depth count, the (8, 1) collective bytes,
the CLI's record schema, ``--force`` and resume, and member 0's program
run on the CPU in a process of a ``gloo`` world of 8 (``launch.mesh.
spawn``), whose counts must equal its count on ``meta``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

import torch

from repro_torch.configs import ShapeSpec, get_arch, list_archs, reduced
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core.tree import leaves
from repro_torch.distributed import sharding, spmd
from repro_torch.launch import dryrun, mesh as mesh_lib, steps
from repro_torch.models import layers, model
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY_SHAPE = (64, 8)               # seq x global batch
PARITY = {"qwen3": "qwen3-1.7b", "moe": "qwen3-moe-235b-a22b",
          "rwkv6": "rwkv6-1.6b"}
# FLOPs per member against the reference's probes, |port / ref - 1| (the
# readings: qwen3 0.9898, the MoE 0.9892, rwkv6 1.0615): the port counts
# the matmuls the reference does and one FLOP an elementwise output, where
# XLA fuses and counts its own; rwkv6's reference counts its time-step
# recurrence body once (a lax.scan), the port every step
FLOP_TOL = {"qwen3": 0.05, "moe": 0.05, "rwkv6": 0.10}
SPLIT_MESH = (2, 4)                  # data x model: the split's parity
# the probes' temp peak against the full-depth count (readings: 0 to
# +0.84%, the largest qwen3's prefill)
PEAK_TOL = 0.01

REF = r'''
import json, os, sys
from repro.launch import dryrun
# dryrun sets 512 devices at import; 256 back the 16 x 16 mesh
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import dataclasses
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_arch, list_archs, reduced
from repro.configs.base import SHAPES, ShapeSpec, shape_applicable
from repro.distributed import sharding
from repro.launch import steps

cfgs = json.loads(sys.argv[2])
out = {"probes": {}, "probes_split": {}, "bytes": {}}
seq, batch = cfgs["parity_shape"]
for label, shape in (("probes", (8, 1)), ("probes_split", cfgs["split"])):
    mesh8 = Mesh(np.asarray(jax.devices()[:8]).reshape(shape),
                 ("data", "model"))
    for key, arch in cfgs["parity"].items():
        cfg = dataclasses.replace(reduced(get_arch(arch), n_layers=4),
                                  dtype="bfloat16")
        with mesh8, sharding.use_mesh(mesh8):
            got = dryrun.probe_costs(cfg, ShapeSpec("t", seq, batch,
                                                    "train"), mesh8)
        out[label][key] = {"flops": got["flops"], "coll": got["coll"]}


def member_bytes(tree, shardings):
    return int(sum(np.prod(s.shard_shape(l.shape)) * l.dtype.itemsize
                   for l, s in zip(jax.tree.leaves(tree),
                                   jax.tree.leaves(shardings))))


mesh = Mesh(np.asarray(jax.devices()).reshape(16, 16), ("data", "model"))
with mesh, sharding.use_mesh(mesh):
    for arch in list_archs():
        cfg = get_arch(arch)
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape)[0]:
                continue
            rec = {}
            b_sh = steps.batch_shardings(cfg, shape, mesh)
            rec["batch"] = member_bytes(steps.input_specs(cfg, shape), b_sh)
            if shape.kind == "train":
                params, opt = steps.abstract_train_state(cfg)
                (p_sh, o_sh, _), _ = steps.train_shardings(cfg, shape, mesh)
                rec["opt"] = member_bytes(opt, o_sh)
            else:
                params = steps.abstract_params_cached(cfg)
                p_sh = sharding.param_shardings(params, mesh)
            rec["params"] = member_bytes(params, p_sh)
            if shape.kind == "decode":
                cache = steps.abstract_cache(cfg, shape)
                spec = sharding.cache_spec(mesh, cfg, shape.global_batch)
                rec["cache"] = sum(
                    member_bytes(cache[k], NamedSharding(mesh, spec[k]))
                    for k in cache if k != "pos")
            out["bytes"][f"{arch}|{name}"] = rec
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("PASS")
'''


class RefRun:
    """The reference's subprocess, started once a module and waited for on
    first use."""

    def __init__(self, tmp):
        self.out = tmp / "out.json"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(ROOT, "src")
        env["JAX_PLATFORMS"] = "cpu"
        cfgs = {"parity": PARITY, "parity_shape": PARITY_SHAPE,
                "split": SPLIT_MESH}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF, str(self.out), json.dumps(cfgs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self._res = None

    def get(self):
        if self._res is None:
            so, se = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0 and "PASS" in so, \
                f"stdout:\n{so}\nstderr:\n{se[-4000:]}"
            with open(self.out) as f:
                self._res = json.load(f)
        return self._res

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """Started by the file's first test; the tests that need no reference
    come first and run while it computes."""
    run = RefRun(tmp_path_factory.mktemp("dryrun_ref"))
    yield run
    run.close()


def _meta_mesh(shape, axes):
    return mesh_lib.make_test_mesh(shape, axes, device="meta")


def _parity_cfg(key: str):
    return dataclasses.replace(reduced(get_arch(PARITY[key]), n_layers=4),
                               dtype="bfloat16")


def _parity_count(key: str, shape=(8, 1)) -> dict:
    seq, batch = PARITY_SHAPE
    with sharding.use_mesh(None, "tp"):
        return dryrun.count_cell(_parity_cfg(key),
                                 ShapeSpec("t", seq, batch, "train"),
                                 _meta_mesh(shape, ("data", "model")))


@pytest.mark.parametrize("arch, n_layers", [
    ("qwen3-1.7b", 4), ("qwen3-moe-235b-a22b", 3), ("rwkv6-1.6b", 3),
    ("zamba2-2.7b", 6)])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_probe_extrapolation_equals_the_full_depth_count(arch, n_layers,
                                                         kind):
    """Counted at 2g and 3g layers and extrapolated, a program's FLOPs,
    bytes and collective bytes equal its full-depth count (zamba2's g is
    its reduced ``attn_every``, 2).  The mesh's 8 ``data`` members divide
    none of these depths, so ZeRO-1 splits the same dimension of every
    stacked leaf at each depth.  The temp peak is extrapolated too: the
    largest live set need not grow by the same storages a layer, so it is
    held within PEAK_TOL of the full-depth peak."""
    cfg = reduced(get_arch(arch), n_layers=n_layers)
    shape = ShapeSpec("t", 32, 8, kind)
    mesh = _meta_mesh((8, 2), ("data", "model"))
    with sharding.use_mesh(None, "tp"):
        full = dryrun.count_cell(cfg, shape, mesh)["costs"]
        probed = dryrun.probe_costs(cfg, shape, mesh)["costs"]
    assert probed.flops == full.flops and probed.bytes == full.bytes
    assert probed.coll == full.coll
    assert full.coll["all-gather"] > 0
    assert abs(probed.peak / full.peak - 1) <= PEAK_TOL, \
        (probed.peak, full.peak)


def test_collective_bytes_at_8x1():
    """Pure DP on (8, 1): the parameters are replicated, so the step's
    start gathers nothing; the gradient is reduce-scattered to each
    member's ZeRO-1 region and the updated regions all-gathered back, the
    whole parameter tree, and the loss (a float32 scalar) is all-reduced
    to the DP members' mean.  The reference's XLA program all-reduces the
    whole gradient instead (1,837,826 bytes beside its 1,837,824-byte
    all-gather, its f32 probes halved)."""
    got = _parity_count("qwen3")["costs"]
    cfg = _parity_cfg("qwen3")
    params, opt = steps.abstract_train_state(cfg)
    mesh = _meta_mesh((8, 1), ("data", "model"))
    with sharding.use_mesh(None, "tp"):
        (p_sh, o_sh, _), _ = steps.train_shardings(
            cfg, ShapeSpec("t", *PARITY_SHAPE, "train"), mesh)
    tree = sum(p.numel() * p.element_size() for p in leaves(params))
    regions = dryrun.member_bytes(opt["m"], o_sh["m"]) // 2   # f32 -> bf16
    print(f"port: all-gather {got.coll['all-gather']:,}, reduce-scatter "
          f"{got.coll['reduce-scatter']:,}; reference: all-gather "
          f"1,837,824, all-reduce 1,837,826")
    assert got.coll == {"all-gather": tree, "reduce-scatter": regions,
                        "all-reduce": 4}
    assert tree == 1_837_824 and regions * 8 == tree


def test_cli_writes_the_record_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda name: reduced(get_arch(name)))
    out = tmp_path / "r.json"
    argv = ["--arch", "qwen3-1.7b", "--out", str(out)]
    dryrun.main(argv + ["--shape", "decode_32k"])
    dryrun.main(argv + ["--shape", "long_500k"])
    rec = json.loads(out.read_text())
    cell = rec["qwen3-1.7b|decode_32k|single"]
    assert cell["status"] == "ok" and cell["mesh"] == "16x16"
    assert cell["n_chips"] == 256
    assert set(cell) == {"status", "arch", "shape", "mesh", "n_chips",
                         "compile_s", "total_s", "memory", "raw_scan_costs",
                         "roofline", "tag"}
    assert set(cell["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes"}
    assert cell["memory"]["generated_code_size_in_bytes"] == 0
    assert cell["raw_scan_costs"]["n_layers"] == 2      # the 2g probe
    #                                                     (under 3g layers)
    assert cell["roofline"]["n_chips"] == 256
    assert cell["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")
    assert rec["qwen3-1.7b|long_500k|single"]["status"] == "skipped"
    capsys.readouterr()
    dryrun.main(argv + ["--shape", "decode_32k"])
    assert "[cached] qwen3-1.7b|decode_32k|single" in capsys.readouterr().out
    assert json.loads(out.read_text()) == rec
    dryrun.main(argv + ["--shape", "decode_32k", "--force", "--no-probes"])
    again = json.loads(out.read_text())["qwen3-1.7b|decode_32k|single"]
    assert again["raw_scan_costs"]["n_layers"] == 2     # full depth
    for k in ("memory", "roofline"):
        assert again[k] == cell[k]


@pytest.mark.parametrize("key", sorted(PARITY))
def test_flops_per_member_match_the_reference_probes(ref, key):
    want = ref.get()["probes"][key]["flops"]
    got = _parity_count(key)["costs"].flops
    print(f"{key}: port {got:,} FLOP a member, reference {want:,.0f} "
          f"({got / want:.4f}; limit {FLOP_TOL[key]:.0%})")
    assert abs(got / want - 1) <= FLOP_TOL[key]


@pytest.mark.parametrize("key", sorted(PARITY))
def test_split_flops_per_member_match_the_reference_probes(ref, key):
    """On (2, 4) each member computes its quarter of the heads, hidden
    units, experts and vocabulary, as each of the reference's devices
    does: the port's FLOPs per member (``steps.member_step`` on ``meta``)
    within ``FLOP_TOL`` of the reference's per device."""
    want = ref.get()["probes_split"][key]["flops"]
    got = _parity_count(key, SPLIT_MESH)["costs"].flops
    whole = _parity_count(key)["costs"].flops
    print(f"{key} on {SPLIT_MESH}: port {got:,} FLOP a member, reference "
          f"{want:,.0f} ({got / want:.4f}; limit {FLOP_TOL[key]:.0%}); on "
          f"(8, 1) {whole:,}")
    assert abs(got / want - 1) <= FLOP_TOL[key]


def _counted_member(key: str):
    """One process of a ``gloo`` world of 8 on the CPU: member r of
    ``SPLIT_MESH`` runs its train step on real blocks; member 0 counts it
    (``adamw._sqrt`` taken plain, as on ``meta``)."""
    from repro_torch.roofline import count
    adamw._sqrt = torch.sqrt
    cfg = _parity_cfg(key)
    seq, batch = PARITY_SHAPE
    mesh = mesh_lib.world_mesh(SPLIT_MESH, ("data", "model"), device="cpu")
    member = spmd.Member.join(mesh)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    opt = adamw.init(params, adamw.AdamWConfig())
    gen = torch.Generator().manual_seed(1)
    data = {k: torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                             dtype=torch.int32)
            for k in ("tokens", "labels")}
    with sharding.use_mesh(None, "tp"):
        ins, outs = steps.train_shardings(
            cfg, ShapeSpec("t", seq, batch, "train"), mesh)
    fn = steps.member_step(steps.build_train_step(cfg), ins, outs,
                           member=member)
    args = [spmd.blocks(t, sh, member.index)
            for t, sh in zip((params, opt, data), ins)]
    layers._rope_freqs_on.cache_clear()
    with count.count_costs() as c:
        fn(*args)
    return c.at("cpu").as_dict()


def test_member_program_counts_equal_on_the_cpu_and_meta():
    """Member 0's train step run on the CPU in a world of 8 processes,
    its collectives real (``gloo``), counts the FLOPs, bytes, collective
    bytes and ops its program counts on ``meta`` (the dry-run's)."""
    ranks = mesh_lib.spawn(_counted_member, 8, ("qwen3",), device="cpu",
                           threads=1, timeout=300)
    layers._rope_freqs_on.cache_clear()
    meta = _parity_count("qwen3", SPLIT_MESH)["costs"].as_dict()
    got = ranks[0]
    for k in ("flops", "bytes", "coll", "ops"):
        assert got[k] == meta[k], k
    assert meta["coll"]["all-reduce"] > 0 and meta["flops"] > 0


def test_argument_bytes_equal_the_reference_shards(ref):
    """Every arch x applicable shape on 16 x 16: each member's parameter,
    optimizer, batch and cache blocks equal the reference's per-device
    shard bytes.  The reference's cache also holds ``pos``, a 4-byte int32
    scalar, which is a Python int in the port."""
    want = ref.get()["bytes"]
    mesh = dryrun.make_mesh(False)
    got = {}
    for arch in list_archs():
        cfg = get_arch(arch)
        params, opt = steps.abstract_train_state(cfg)
        with sharding.use_mesh(None, "tp"):
            p_sh = sharding.param_shardings(params, mesh)
            for name, shape in SHAPES.items():
                if not shape_applicable(cfg, shape)[0]:
                    continue
                rec = {"params": dryrun.member_bytes(params, p_sh),
                       "batch": dryrun.member_bytes(
                           steps.input_specs(cfg, shape),
                           steps.batch_shardings(cfg, shape, mesh))}
                if shape.kind == "train":
                    rec["opt"] = dryrun.member_bytes(
                        opt, sharding.opt_shardings(opt, params, mesh))
                if shape.kind == "decode":
                    cache = model.init_cache(cfg, shape.global_batch,
                                             shape.seq_len, device="meta")
                    spec = sharding.cache_spec(mesh, cfg, shape.global_batch)
                    rec["cache"] = dryrun.member_bytes(
                        {k: v for k, v in cache.items() if k != "pos"},
                        {k: sharding.NamedSharding(mesh, spec[k])
                         for k in cache if k != "pos"})
                got[f"{arch}|{name}"] = rec
    assert got == want
    assert len(got) == 32      # long_500k for the two sub-quadratic archs
