"""The port's launch layer (``launch/{steps,serve,train}.py``) held to the
JAX package's entry points on the CPU, on the same corpus and weights (the
reference's ``init_params(cfg, key(0))``, carried across by
``params_from_numpy``).

Training losses within ``rtol=1e-4`` of the reference's ``run_training`` (float32
sums in another order); greedy serving tokens equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as rserve
from repro.launch import steps as rsteps
from repro.launch import train as rtrain
from repro.models import model as rmodel
from repro_torch.kernels import harness, ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import model


def _carried(rcfg):
    rp = rmodel.init_params(rcfg, jax.random.key(0))
    return rp, model.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def test_training_run_matches_the_reference_run(tmp_path):
    """Three steps of the ``tiny`` preset with ``--grad-int8
    --compress-moments``: the same losses; every step's gradient leaves
    each go through one bitpack wire decode with the dequant epilogue
    fused, and the loader's shards through the rle_v2 decode."""
    flags = ["--preset", "tiny", "--steps", "3", "--batch", "2", "--seq",
             "64", "--grad-int8", "--compress-moments"]
    rargs = rtrain.build_parser().parse_args(
        flags + ["--ckpt-dir", str(tmp_path / "ref")])
    want = rtrain.run_training(rargs)
    _, params = _carried(rtrain._resolve_cfg(rargs))
    before = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
    args = train.build_parser().parse_args(
        flags + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    with ops.count_dispatches() as calls:
        got = train.run_training(args, params=params)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["steps_done"] == 3 and got["restarts"] == 0
    # olmo's non-parametric norms are empty leaves: below one block, they
    # pass the wire by
    n_wire = sum(t.numel() >= 128 for t in jax.tree.leaves(params))
    assert n_wire == 8
    wire = [c for c in calls if c["codec"] == "bitpack"]
    assert len(wire) == 3 * n_wire
    assert all(c["bits"] == 8 and c["chunk_elems"] == 128 for c in wire)
    assert harness.EPILOGUE_UNFUSED == before[1]
    assert harness.EPILOGUE_FUSED - before[0] == 3 * n_wire
    assert any(c["codec"] == "rle_v2" for c in calls)


def test_training_restarts_from_a_checkpoint_and_spills(tmp_path):
    """The reference system test's case on the port: a failure at step 7
    with checkpoints every 5 steps is one restart, and the loss falls;
    shards paged through the tiered store (``--spill-dir``)."""
    args = train.build_parser().parse_args(
        ["--arch", "qwen3-1.7b", "--preset", "tiny", "--steps", "12",
         "--batch", "2", "--seq", "64", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-every", "5", "--fail-at", "7", "--spill-dir",
         str(tmp_path / "spill"), "--device", "cpu", "--lr", "1e-2"])
    m = train.run_training(args)
    assert m["restarts"] == 1 and m["steps_done"] == 12
    assert len(m["losses"]) == 12 + 2          # steps 5 and 6 ran twice
    assert np.mean(m["losses"][-2:]) < np.mean(m["losses"][:2])
    assert (tmp_path / "ck" / "step_10" / "manifest.json").exists()
    params, opt = m["state"]
    assert int(opt["step"]) == 12
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(params))


def test_train_main_prints_ok(tmp_path, capsys):
    train.main(["--preset", "tiny", "--steps", "4", "--batch", "2", "--seq",
                "32", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "OK" in out and "compression ratio" in out


def test_train_main_sets_the_allocator_unless_the_caller_did(monkeypatch):
    """``main`` grows expandable segments (``train.ALLOC_CONF``) before the
    run first uses the card; a caller's own allocator config stands."""
    seen = []

    class Ran(Exception):
        pass

    def run_training(args):
        seen.append(os.environ.get("PYTORCH_CUDA_ALLOC_CONF"))
        raise Ran

    monkeypatch.setattr(train, "run_training", run_training)
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    with pytest.raises(Ran):
        train.main(["--device", "cpu"])
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "backend:native")
    with pytest.raises(Ran):
        train.main(["--device", "cpu"])
    assert seen == ["expandable_segments:True", "backend:native"]
    assert train.ALLOC_CONF == "expandable_segments:True"


def test_diloco_and_mesh_steps_raise_naming_the_roadmap_item(tmp_path):
    """``--diloco`` and the pod inner step run, and so do the step
    shardings, the mesh-sharded decode, the sharded restore and the
    loader's ``mesh=`` on a mesh whose members share one device
    (``tests/test_torch_sharded.py``), and so do a mesh for the model's
    steps and the runner's restart onto such a mesh
    (``tests/test_torch_mesh_steps.py``), and one process a member on a
    mesh over a world's ranks (``tests/test_torch_spmd_decode.py``); what
    raises, pointing to ``launch.mesh.spawn``: the same paths over a mesh
    of distinct devices in one process."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import api
    from repro_torch.core.engine import CodagEngine, EngineConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as mesh_lib
    args = train.build_parser().parse_args(
        ["--diloco", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    cfg = train._resolve_cfg(args)
    assert callable(steps.build_pod_inner_step(cfg))
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed import fault, sharding
    mesh = mesh_lib.make_decode_mesh(device="cpu")
    engine = CodagEngine(EngineConfig(device="cpu"))
    ca = api.compress(np.arange(1000, dtype=np.uint32), "rle_v2")
    shape = ShapeSpec("t", 16, 2, "train")
    (p_sh, o_sh, b_sh), _ = steps.train_shardings(cfg, shape, mesh)
    assert b_sh["tokens"].spec == sharding.P("data", None)
    assert steps.batch_shardings(cfg, shape, mesh) == b_sh
    assert steps.serve_shardings(cfg, shape, mesh)[0][1]["pos"].spec == ()
    [out] = api.decompress_many([ca], engine=engine, mesh=mesh)
    assert torch.equal(out, torch.from_numpy(np.arange(1000, dtype=np.uint32)))
    spread = mesh_lib.Mesh([torch.device("cpu"), torch.device("meta")],
                           ("data",))
    ckpt.save(str(tmp_path / "c"), 0, {"w": torch.zeros(4)})
    store = pipeline.CompressedTokenStore.build(
        pipeline.synthetic_corpus(4096, 64), 64)

    def placing_on(m):
        def placing(state):
            return {"w": sharding.ShardedTensor.place(
                state["w"], sharding.NamedSharding(m, sharding.P()))}
        return placing

    def runner(m):
        return fault.FaultTolerantRunner(
            lambda st, b: (st, 0.0), str(tmp_path / "c"), ckpt_every=100,
            injector=fault.FailureInjector(fail_at_steps=[1]),
            reshard_fn=placing_on(m), async_ckpt=False, engine=engine)

    # on a mesh whose members share the device: a step under the mesh, and
    # a restart onto it that goes on
    with sharding.use_mesh(mesh):
        assert sharding.current_mesh() is mesh
    out, rep = runner(mesh).run({"w": torch.zeros(4)}, iter(range(9)), 3)
    assert rep.restarts == 1 and rep.steps_done == 3
    assert isinstance(out["w"], sharding.ShardedTensor)
    for call in (lambda: sharding.use_mesh(spread).__enter__(),
                 lambda: api.decompress_many([ca], engine=engine,
                                             mesh=spread),
                 lambda: ckpt.restore(str(tmp_path / "c"), 0, {"w": 0},
                                      shardings={"w": sharding.NamedSharding(
                                          spread, sharding.P())}),
                 lambda: pipeline.CompressedLoader(store, 2, 16,
                                                   mesh=spread),
                 lambda: runner(spread).run({"w": torch.zeros(4)},
                                            iter(range(9)), 3)):
        with pytest.raises(NotImplementedError, match="launch.mesh.spawn"):
            call()


def test_entry_points_need_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_training(train.build_parser().parse_args(
            ["--ckpt-dir", str(tmp_path)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--batch", "1", "--prompt-len", "2", "--gen", "1"])


def test_serving_matches_the_reference_loop(capsys):
    """The ``tiny`` serve run's greedy tokens equal the reference's on
    the same weights and prompts (the reference's loop: its
    ``prefill_into_cache``, then argmax decode)."""
    argv = ["--arch", "qwen3-1.7b", "--preset", "tiny", "--batch", "3",
            "--prompt-len", "12", "--gen", "10"]
    args = serve.build_parser().parse_args(argv + ["--device", "cpu"])
    cfg = serve.resolve_cfg(args)
    rcfg = rtrain._resolve_cfg(rtrain.build_parser().parse_args(
        ["--arch", "qwen3-1.7b", "--preset", "tiny"]))
    rp, params = _carried(rcfg)
    got = serve.run_serving(args, params=params)
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 12)), jnp.int32)
    logits, cache = rserve.prefill_into_cache(
        rcfg, rp, rmodel.init_cache(rcfg, 3, 12 + 10 + 8), prompts)
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = []
    for _ in range(10):
        want.append(np.asarray(cur))
        logits, cache = rmodel.decode_step(rcfg, rp, cache, cur)
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    np.testing.assert_array_equal(got["tokens"], np.concatenate(want, 1))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(logits),
                               rtol=2e-4, atol=2e-4)
    serve.main(argv + ["--device", "cpu"])
    assert "OK" in capsys.readouterr().out


def test_prefill_and_serve_steps_match_the_reference():
    rcfg = rtrain._resolve_cfg(rtrain.build_parser().parse_args(
        ["--arch", "minitron-4b", "--preset", "tiny"]))
    cfg = train._resolve_cfg(train.build_parser().parse_args(
        ["--arch", "minitron-4b", "--preset", "tiny"]))
    rp, params = _carried(rcfg)
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (2, 9)).astype(
        np.int32)
    want = rsteps.build_prefill_step(rcfg)(rp, {"tokens": jnp.asarray(tok)})
    got = steps.build_prefill_step(cfg)(params,
                                        {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    cache = model.init_cache(cfg, 2, 4, device="cpu")
    rcache = rmodel.init_cache(rcfg, 2, 4)
    lg, cache = steps.build_serve_step(cfg)(
        params, cache, {"tokens": torch.from_numpy(tok[:, :1])})
    rlg, _ = rsteps.build_serve_step(rcfg)(rp, rcache,
                                           {"tokens": jnp.asarray(tok[:, :1])})
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=2e-4,
                               atol=2e-4)
    assert cache["pos"] == 1


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "rwkv6-1.6b",
                                  "zamba2-2.7b"])
def test_family_training_matches_the_reference_run(tmp_path, arch):
    """The MoE, RWKV6 and hybrid families through the same driver: three
    ``tiny`` steps with ``--grad-int8 --compress-moments`` give the
    reference's losses on its weights, one fused wire decode a gradient
    leaf a step."""
    flags = ["--arch", arch, "--preset", "tiny", "--steps", "3", "--batch",
             "2", "--seq", "64", "--grad-int8", "--compress-moments"]
    rargs = rtrain.build_parser().parse_args(
        flags + ["--ckpt-dir", str(tmp_path / "ref")])
    want = rtrain.run_training(rargs)
    _, params = _carried(rtrain._resolve_cfg(rargs))
    args = train.build_parser().parse_args(
        flags + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    with ops.count_dispatches() as calls:
        got = train.run_training(args, params=params)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    n_wire = sum(t.numel() >= 128 for t in jax.tree.leaves(params))
    assert sum(c["codec"] == "bitpack" for c in calls) == 3 * n_wire
    assert any(c["codec"] == "rle_v2" for c in calls)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
                                  "rwkv6-1.6b", "zamba2-2.7b"])
def test_family_serving_matches_the_reference_loop(arch):
    """The ``tiny`` serve run of each new family: greedy tokens equal the
    reference's loop on the same weights and prompts, the last logits
    within 2e-4; ``--n-layers`` cuts the depth (here 2 -> 2, printed)."""
    argv = ["--arch", arch, "--preset", "tiny", "--batch", "2",
            "--prompt-len", "8", "--gen", "6"]
    args = serve.build_parser().parse_args(argv + ["--device", "cpu",
                                                   "--n-layers", "2"])
    cfg = serve.resolve_cfg(args)
    rcfg = rtrain._resolve_cfg(rtrain.build_parser().parse_args(
        ["--arch", arch, "--preset", "tiny"]))
    assert cfg.n_layers == rcfg.n_layers == 2
    rp, params = _carried(rcfg)
    got = serve.run_serving(args, params=params)
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)), jnp.int32)
    logits, cache = rserve.prefill_into_cache(
        rcfg, rp, rmodel.init_cache(rcfg, 2, 8 + 6 + 8), prompts)
    step = jax.jit(lambda c, t: rmodel.decode_step(rcfg, rp, c, t))
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = []
    for _ in range(6):
        want.append(np.asarray(cur))
        logits, cache = step(cache, cur)
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    np.testing.assert_array_equal(got["tokens"], np.concatenate(want, 1))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(logits),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mesh, policy", [("2x2", "tp"), ("2x2x2", "tp"),
                                          ("4x2", "dp")])
def test_train_spmd_runs_one_process_a_member(tmp_path, mesh, policy):
    """``--spmd``: one ``gloo`` process a member on the CPU, each holding
    its blocks (``steps.member_step``; under ``dp`` the weights whole and
    the batch over ``data`` alone, 4 rows over 4 members).  Its losses lie
    within ``rtol=1e-4`` of the same run under the mesh whose members
    share the device, and each rank's final parameter blocks within 1e-4
    of that run's member shards, but on at most 0.01% of the elements (at
    least 2), which AdamW and the int8 wire may put up to a step apart
    (lr)."""
    lr = 1e-3
    flags = ["--preset", "tiny", "--steps", "3", "--batch", "4", "--seq",
             "32", "--device", "cpu", "--grad-int8", "--mesh", mesh,
             "--policy", policy, "--lr", str(lr), "--ckpt-every", "100"]
    base = train.run_training(train.build_parser().parse_args(
        flags + ["--ckpt-dir", str(tmp_path / "mesh")]))
    got = train.run_training(train.build_parser().parse_args(
        flags + ["--spmd", "--ckpt-dir", str(tmp_path / "spmd")]))
    np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-4)
    assert len(got["states"]) == len(base["state"][0]["embed"].shards)
    assert got["steps_done"] == 3
    from repro_torch.core.tree import leaves
    for r, (p, _) in enumerate(got["states"]):
        for whole, block in zip(leaves(base["state"][0]), leaves(p)):
            d = (block - whole.shards[r]).abs()
            assert int((d > 1e-4).sum()) <= max(2, d.numel() // 10000)
            assert d.numel() == 0 or float(d.max()) <= lr


def test_serve_spmd_takes_the_mesh_runs_tokens():
    """``--spmd`` serving on a 2x2 mesh: every process takes the same
    greedy tokens as the run under the shared-device mesh, and each
    rank's cache blocks lie within 1e-4 of that run's member shards."""
    flags = ["--preset", "tiny", "--device", "cpu", "--batch", "4",
             "--prompt-len", "8", "--gen", "4", "--mesh", "2x2"]
    base = serve.run_serving(serve.build_parser().parse_args(flags))
    got = serve.run_serving(serve.build_parser().parse_args(
        flags + ["--spmd"]))
    np.testing.assert_array_equal(got["tokens"], base["tokens"])
    for r, cache in enumerate(got["caches"]):
        assert cache["pos"] == base["cache"]["pos"]
        for k in cache:
            if k != "pos":
                np.testing.assert_allclose(
                    cache[k].numpy(), base["cache"][k].shards[r].numpy(),
                    atol=1e-4, rtol=1e-4)
