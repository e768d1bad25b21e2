"""The port's DiLoCo training path (``distributed/diloco.py``,
``launch/steps.build_pod_inner_step``, ``launch/train.py --diloco``) and
the runner's drain of an in-flight outer sync, held to the JAX package on
the CPU.

The reference's outer sync runs its reduce inside ``shard_map`` over a
``pod`` mesh axis, so its half runs in subprocesses on 8 virtual CPU
devices, as ``tests/test_distributed.py`` runs it: the outer-sync cases on a
(2 pod x 4 data) mesh in one, and each of the driver's ``--diloco 2`` runs
at 2 devices (the first two, so its mesh is 2 pods x 1) in one of its own,
all started together, on numpy inputs made here from a seed and the
reference's ``init_params(cfg, key(0))``; each writes an ``.npz``.
The port's pods share the CPU.  The mapped inner step needs no mesh and
runs in this process.

Tolerances: the int8 wire's outer step within a few float32 ulps of the
deltas and the anchor (the member sum in another order, see
``tests/test_torch_collectives.py``); the top-k wire's residuals equal and
its step within an ulp; the inner step's and the driver's losses within
``rtol=1e-4`` (float32 sums in another order), as PR 20's driver parity.
"""
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget_arch, reduced as rreduced
from repro.distributed import collectives as rcoll
from repro.launch import steps as rsteps
from repro.launch import train as rtrain
from repro.models import model as rmodel
from repro.optim import adamw as radamw
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.distributed import collectives, diloco, fault
from repro_torch.kernels import harness, ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, train
from repro_torch.models import model
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = EngineConfig(device="cpu")
ULP = 2.0 ** -23
DRIVER = ["--preset", "tiny", "--steps", "5", "--batch", "2", "--seq", "64",
          "--diloco", "2", "--outer-every", "2"]
DRIVER_WIRES = {"int8": ["--grad-int8", "--compress-moments"],
                "topk": ["--topk", "0.01"]}


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    shapes = {"w": (4096 + 77,), "b": (8, 16), "n": (5,)}
    inp = {}
    for k, shape in shapes.items():
        inp[f"p_{k}"] = rng.standard_normal(shape).astype(np.float32)
        for i in (1, 2):
            inp[f"d{i}_{k}"] = (0.01 * rng.standard_normal((2,) + shape)
                                ).astype(np.float32)
    return inp


INPUTS = _inputs()
KEYS = ("w", "b", "n")

REF = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed import diloco
inp = dict(np.load(sys.argv[1]))
out = {}
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("pod", "data"))
KEYS = ("w", "b", "n")

# a 64-element leaf under one quant block: the plain mean, lr 1, no momentum
params = {"w": jnp.ones((64,)) * 0.5}
pod = diloco.replicate_for_pods(params, 2, mesh)
pod = {"w": pod["w"] + jnp.asarray([[0.1], [0.3]])}
cfgd = diloco.DiLoCoConfig(outer_lr=1.0, outer_momentum=0.0)
outer = diloco.init_outer_state(params, mesh=mesh, cfg=cfgd)
with mesh:
    new_pod, new_outer = jax.jit(diloco.make_outer_sync(mesh, cfgd))(
        pod, outer)
out["s1_anchor"] = np.asarray(new_outer["anchor"]["w"])
out["s1_pod"] = np.asarray(new_pod["w"])

# two syncs through each wire, Nesterov momentum
params = {k: jnp.asarray(inp[f"p_{k}"]) for k in KEYS}
for wire in ("int8", "topk", "none"):
    cfgd = diloco.DiLoCoConfig(outer_lr=0.7, outer_momentum=0.9,
                               wire=wire, compress=wire != "none")
    outer = diloco.init_outer_state(params, mesh=mesh, cfg=cfgd)
    sync = jax.jit(diloco.make_outer_sync(mesh, cfgd))
    pod = diloco.replicate_for_pods(params, 2, mesh)
    for i in (1, 2):
        pod = {k: pod[k] + jnp.asarray(inp[f"d{i}_{k}"]) for k in KEYS}
        with mesh:
            pod, outer = sync(pod, outer)
        for k in KEYS:
            out[f"{wire}{i}_anchor_{k}"] = np.asarray(outer["anchor"][k])
            out[f"{wire}{i}_mom_{k}"] = np.asarray(outer["outer_mom"][k])
            out[f"{wire}{i}_pod_{k}"] = np.asarray(pod[k])
            if outer["residual"] is not None:
                out[f"{wire}{i}_res_{k}"] = np.asarray(outer["residual"][k])

np.savez(sys.argv[2], **out)
print("PASS")
'''

# the driver at 2 devices (2 pods x 1): argv[3] names the run, the rest are
# its flags
DRIVER_REF = r'''
import sys
import numpy as np
import jax
from repro.launch import train as rtrain

real = jax.devices
jax.devices = lambda *a, **k: real(*a, **k)[:2]
name = sys.argv[3]
m = rtrain.run_training(rtrain.build_parser().parse_args(sys.argv[4:]))
np.savez(sys.argv[2], **{
    f"drv_{name}_losses": np.asarray(m["losses"]),
    f"drv_{name}_syncs": np.asarray(m["overlap"]["syncs"]),
    f"drv_{name}_ratio": np.asarray(m["wire"]["ratio"])})
print("PASS")
'''


class RefRun:
    """The reference's subprocesses, started together once a module (the
    outer-sync cases, and each driver run in a process of its own, so the
    three compile at once) and waited for on first use."""

    def __init__(self, tmp):
        inp = tmp / "in.npz"
        np.savez(inp, **INPUTS)
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = os.path.join(ROOT, "src")
        env["JAX_PLATFORMS"] = "cpu"
        jobs = [(REF, "sync", [])] + [
            (DRIVER_REF, name, [name] + DRIVER + extra
             + ["--ckpt-dir", str(tmp / name), "--log-every", "0"])
            for name, extra in DRIVER_WIRES.items()]
        self.procs = []
        for script, name, argv in jobs:
            out = tmp / f"{name}.npz"
            self.procs.append((out, subprocess.Popen(
                [sys.executable, "-c", script, str(inp), str(out), *argv],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=str(tmp))))
        self._res = None

    def get(self) -> dict:
        if self._res is None:
            res = {}
            for out, proc in self.procs:
                so, se = proc.communicate(timeout=900)
                assert proc.returncode == 0 and "PASS" in so, \
                    f"stdout:\n{so[-4000:]}\nstderr:\n{se[-4000:]}"
                res.update(np.load(out))
            self._res = res
        return self._res

    def close(self) -> None:
        for _, proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    run = RefRun(tmp_path_factory.mktemp("diloco_ref"))
    yield run
    run.close()


def _mesh():
    return mesh_lib.make_test_mesh((2, 4), ("pod", "data"), device="cpu")


def _t(name: str) -> torch.Tensor:
    return torch.from_numpy(INPUTS[name].copy())


# --------------------------------------------------------------------------
# in this process (the reference's subprocesses run meanwhile)
# --------------------------------------------------------------------------


def test_pods_replicate_and_the_outer_state_starts_at_the_params(ref):
    params = {"w": torch.arange(6.0), "b": {"c": torch.ones(2, 3)}}
    pods = diloco.replicate_for_pods(params, 3, _mesh())
    assert pods["w"].shape == (3, 6) and pods["b"]["c"].shape == (3, 2, 3)
    assert pods["w"].is_contiguous() and pods["w"].stride(0) == 6
    assert all(torch.equal(pods["w"][p], params["w"]) for p in range(3))
    outer = diloco.init_outer_state(params, mesh=_mesh())
    assert outer["anchor"]["w"] is params["w"] and outer["residual"] is None
    assert outer["outer_mom"]["b"]["c"].dtype == torch.float32
    topk = diloco.DiLoCoConfig(wire="topk")
    outer = diloco.init_outer_state(params, mesh=_mesh(), cfg=topk)
    assert outer["residual"]["w"].shape == (2, 6)
    with pytest.raises(ValueError, match="needs the mesh"):
        diloco.init_outer_state(params, cfg=topk)


def test_outer_sync_keeps_the_pods_on_the_mesh(ref):
    """The counterpart of the reference's placement regression: after a
    sync every leaf still carries the pod axis, on the device the mesh's
    members share, each pod its own copy."""
    params = {"w": torch.ones(512), "b": torch.ones(8, 16)}
    pod = diloco.replicate_for_pods(params, 2, _mesh())
    cfgd = diloco.DiLoCoConfig(outer_lr=0.7, outer_momentum=0.9)
    outer = diloco.init_outer_state(params, mesh=_mesh(), cfg=cfgd)
    new_pod, _ = diloco.make_outer_sync(_mesh(), cfgd, config=CPU)(pod,
                                                                   outer)
    for k, v in params.items():
        assert new_pod[k].shape == (2,) + tuple(v.shape)
        assert new_pod[k].device == _mesh().shared_device
        assert new_pod[k][0].data_ptr() != new_pod[k][1].data_ptr()


def test_outer_sync_pipeline_overlap_and_fault_drain(ref, tmp_path):
    """The overlapped sync hides an injected link round trip behind inner
    work, and a WorkerFailure drains the in-flight sync while the runner
    restores a compressed checkpoint (the reference test's case)."""
    params = {"w": torch.ones(4096) * 0.5}
    cfgd = diloco.DiLoCoConfig(outer_lr=0.5, outer_momentum=0.0)
    outer = diloco.init_outer_state(params, mesh=_mesh(), cfg=cfgd)
    sync = diloco.make_outer_sync(_mesh(), cfgd, config=CPU)
    pod = diloco.replicate_for_pods(params, 2, _mesh())
    pod = {"w": pod["w"] + torch.tensor([[0.1], [0.3]])}

    pipe = diloco.OuterSyncPipeline(sync, link_rtt_s=0.2)
    pipe.launch(pod, outer)
    assert pipe.in_flight
    with pytest.raises(RuntimeError, match="already in flight"):
        pipe.launch(pod, outer)
    time.sleep(0.35)                   # ... inner steps run meanwhile ...
    merged, outer = pipe.finish(pod)
    st = pipe.stats()
    assert st["syncs"] == 1 and st["overlap_frac"] >= 0.5, st
    # now == snapshot: the merged params are the synced ones
    assert torch.equal(merged["w"][0], merged["w"][1])
    with pytest.raises(RuntimeError, match="no outer sync"):
        pipe.finish()

    state = {"w": np.arange(4096, dtype=np.float32)}
    ckpt.save(str(tmp_path), 5, state, codec="rle_v2")
    calls = {"n": 0}

    def step_fn(s, b):
        calls["n"] += 1
        if calls["n"] == 1:
            pipe.launch(pod, outer)
            raise fault.WorkerFailure("boom")
        return s, 0.0

    runner = fault.FaultTolerantRunner(
        step_fn, str(tmp_path), ckpt_every=100, ckpt_codec="rle_v2",
        sync_pipeline=pipe, engine=CodagEngine(CPU))
    got, report = runner.run(state, iter([None] * 20), 7)
    assert report.restarts == 1
    assert not pipe.in_flight          # drained during the restore
    assert pipe.stats()["syncs"] == 1  # a drain is not a sync
    np.testing.assert_array_equal(np.asarray(got["w"]), state["w"])
    pipe.launch(pod, outer)
    pipe.abandon()
    assert not pipe.in_flight and pipe.stats()["syncs"] == 1


def _carried(rcfg):
    rp = rmodel.init_params(rcfg, jax.random.key(0))
    return rp, model.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def test_pod_inner_step_matches_the_reference_mapped_step():
    """Two steps of two pods (each its own batches) through the int8
    gradient wire: the reference's ``jit(vmap(train_step))`` against the
    port's step run once a pod, on carried-across weights and the same
    AdamW state: losses within rtol=1e-4, the pods' parameters close."""
    rcfg = rreduced(rget_arch("olmo-1b"))
    rp, params = _carried(rcfg)
    ropt_cfg = radamw.AdamWConfig(lr=1e-3)
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    rinner = jax.jit(rsteps.build_pod_inner_step(
        rcfg, ropt_cfg, grad_compressor=rcoll.make_wire_compressor()))
    inner = steps.build_pod_inner_step(
        train._resolve_cfg(train.build_parser().parse_args(
            ["--preset", "tiny"])), opt_cfg,
        grad_compressor=collectives.make_wire_compressor(CPU))
    from repro.distributed import diloco as rdiloco
    rpod = rdiloco.replicate_for_pods(rp, 2)
    ropt = rdiloco.replicate_for_pods(radamw.init(rp, ropt_cfg), 2)
    pod = diloco.replicate_for_pods(params, 2)
    opt = diloco.replicate_for_pods(adamw.init(params, opt_cfg), 2)
    rng = np.random.default_rng(5)
    for _ in range(2):
        tok = rng.integers(0, rcfg.vocab, (2, 2, 32)).astype(np.int32)
        lab = rng.integers(0, rcfg.vocab, (2, 2, 32)).astype(np.int32)
        rpod, ropt, rloss = rinner(rpod, ropt, {"tokens": tok,
                                                "labels": lab})
        with ops.count_dispatches() as calls:
            pod, opt, loss = inner(pod, opt, {
                "tokens": torch.from_numpy(tok),
                "labels": torch.from_numpy(lab)})
        assert loss.shape == (2,)
        np.testing.assert_allclose(loss.numpy(), np.asarray(rloss),
                                   rtol=1e-4)
        n_wire = sum(np.asarray(t).size >= 128 for t in jax.tree.leaves(rp))
        assert len(calls) == 2 * n_wire
    # the parameters agree but where the int8 wire rounded a gradient
    # element to the neighbouring grid point in one package (its value a
    # float32 rounding from a half-way point): there the update differs, by
    # at most the two steps' lr each
    flipped, total = 0, 0
    for (path, rleaf) in jax.tree_util.tree_flatten_with_path(rpod)[0]:
        leaf = pod
        for key in path:
            leaf = leaf[key.key]
        got, want = leaf.float().numpy(), np.asarray(rleaf, np.float32)
        far = ~np.isclose(got, want, rtol=1e-4, atol=1e-6)
        flipped += int(far.sum())
        total += far.size
        assert not far.size or np.abs(got - want).max() <= 2 * 2 * opt_cfg.lr
    assert flipped <= total // 10_000, (flipped, total)


# --------------------------------------------------------------------------
# against the reference's subprocesses
# --------------------------------------------------------------------------


def test_outer_sync_rebases_every_pod_alike(ref):
    """The reference test's case: a 64-element leaf (under one quant block,
    the plain member mean) on diverged pods, outer lr 1 and no momentum:
    the anchor moves by the mean delta (0.2) and both pods are rebased onto
    it.  Equal to the reference's bit for bit."""
    want = ref.get()
    params = {"w": torch.ones(64) * 0.5}
    pod = diloco.replicate_for_pods(params, 2, _mesh())
    pod = {"w": pod["w"] + torch.tensor([[0.1], [0.3]])}
    cfgd = diloco.DiLoCoConfig(outer_lr=1.0, outer_momentum=0.0)
    outer = diloco.init_outer_state(params, mesh=_mesh(), cfg=cfgd)
    new_pod, new_outer = diloco.make_outer_sync(_mesh(), cfgd, config=CPU)(
        pod, outer)
    np.testing.assert_allclose(new_outer["anchor"]["w"].numpy(),
                               0.7 * np.ones(64), rtol=0.02)
    assert torch.equal(new_pod["w"][0], new_pod["w"][1])
    np.testing.assert_array_equal(new_outer["anchor"]["w"].numpy(),
                                  want["s1_anchor"])
    np.testing.assert_array_equal(new_pod["w"].numpy(), want["s1_pod"])


@pytest.mark.parametrize("wire", ["int8", "topk", "none"])
def test_outer_sync_matches_the_reference(ref, wire):
    """Two syncs of diverged pods (anchor, Nesterov momentum, error-feedback
    residuals, every pod rebased), through each wire; the int8 wire's
    reduce one fused bitpack dispatch a leaf of at least one quant block."""
    want = ref.get()
    params = {k: _t(f"p_{k}") for k in KEYS}
    cfgd = diloco.DiLoCoConfig(outer_lr=0.7, outer_momentum=0.9, wire=wire,
                               compress=wire != "none")
    outer = diloco.init_outer_state(params, mesh=_mesh(), cfg=cfgd)
    sync = diloco.make_outer_sync(_mesh(), cfgd, config=CPU)
    pod = diloco.replicate_for_pods(params, 2, _mesh())
    for i in (1, 2):
        pod = {k: pod[k] + _t(f"d{i}_{k}") for k in KEYS}
        before = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
        with ops.count_dispatches() as calls:
            pod, outer = sync(pod, outer)
        wired = 0 if wire == "none" else 2      # "w" and "b"; "n" is short
        assert len(calls) == wired
        assert harness.EPILOGUE_FUSED - before[0] == \
            (wired if wire == "int8" else 0)
        assert harness.EPILOGUE_UNFUSED - before[1] == \
            (wired if wire == "topk" else 0)
        for k in KEYS:
            assert torch.equal(pod[k][0], pod[k][1])
            a, m = want[f"{wire}{i}_anchor_{k}"], want[f"{wire}{i}_mom_{k}"]
            scale = float(np.abs(a).max() + np.abs(m).max())
            tol = 16 * ULP * scale
            np.testing.assert_allclose(outer["anchor"][k].numpy(), a,
                                       rtol=0, atol=tol)
            np.testing.assert_allclose(outer["outer_mom"][k].numpy(), m,
                                       rtol=0, atol=tol)
            np.testing.assert_allclose(pod[k].numpy(),
                                       want[f"{wire}{i}_pod_{k}"], rtol=0,
                                       atol=tol)
            if wire == "topk":
                np.testing.assert_array_equal(
                    outer["residual"][k].numpy(), want[f"topk{i}_res_{k}"])
            else:
                assert outer["residual"] is None


@pytest.mark.parametrize("wire", list(DRIVER_WIRES))
def test_diloco_driver_matches_the_reference(ref, wire, tmp_path):
    """``--diloco 2 --preset tiny`` over two outer syncs, int8 (with the
    int8 gradient wire and moments) and top-k 1%: the losses equal the
    reference's ``--diloco 2`` on 2 virtual devices within rtol=1e-4, from
    the same weights; every sync's int8 reduce one fused dispatch a leaf."""
    want = ref.get()
    rargs = rtrain.build_parser().parse_args(DRIVER + DRIVER_WIRES[wire])
    _, params = _carried(rtrain._resolve_cfg(rargs))
    args = train.build_parser().parse_args(
        DRIVER + DRIVER_WIRES[wire] + ["--device", "cpu", "--ckpt-dir",
                                       str(tmp_path)])
    before = harness.EPILOGUE_UNFUSED
    got = train.run_training(args, params=params)
    np.testing.assert_allclose(got["losses"], want[f"drv_{wire}_losses"],
                               rtol=1e-4)
    assert got["overlap"]["syncs"] == int(want[f"drv_{wire}_syncs"]) == 2
    assert got["wire"]["ratio"] == float(want[f"drv_{wire}_ratio"])
    assert got["n_pods"] == 2 and got["tokens_per_step"] == 2 * 2 * 64
    if wire == "int8":      # the gradient wire and the outer reduce: fused
        assert harness.EPILOGUE_UNFUSED == before
    pods = got["state"][0]
    for k in ("embed", "ln_f"):
        assert pods[k].shape == (2,) + tuple(params[k].shape)


def test_diloco_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_training(train.build_parser().parse_args(
            DRIVER + ["--ckpt-dir", str(tmp_path)]))


def test_train_main_runs_diloco_and_prints_the_wire(tmp_path, capsys):
    train.main(DRIVER + ["--device", "cpu", "--ckpt-dir", str(tmp_path),
                         "--outer-wire", "none"])
    out = capsys.readouterr().out
    assert "outer wire:" in out and "(1.0x)" in out and out.endswith("OK\n")
