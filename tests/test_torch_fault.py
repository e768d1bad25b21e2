"""The port's fault-tolerant runner (``repro_torch.distributed.fault``)
against the reference's, on the CPU.

The runner and monitor cases of ``tests/test_checkpoint.py``, each run on
both packages with the same quadratic step, injected failures and batches:
equal reports (steps, restarts, losses) and equal final states.  Then the
port's one adaptation: the runner restores onto the device that holds the
state's tensors, through ``checkpoint.restore(device_out=True)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import fault as ref_fault
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.distributed import fault

CPU = CodagEngine(EngineConfig(device="cpu"))


def _quadratic_step(state, batch):
    w = state["w"]
    g = 2 * (w - batch)
    w = w - 0.1 * g
    return {"w": w}, float(((w - batch) ** 2).sum())


def _ref_quadratic_step(state, batch):
    w = state["w"]
    g = 2 * (w - batch)
    w = w - 0.1 * g
    return {"w": w}, float(jnp.sum((w - batch) ** 2))


def _forever(x):
    return (x for _ in iter(int, 1))


@pytest.mark.parametrize("codec", ["none", "rle_v2"])
def test_runner_restarts_from_checkpoint(tmp_path, codec):
    n = 4 if codec == "none" else 512      # rle_v2 compresses from 1 KiB
    injector = fault.FailureInjector(fail_at_steps=[7, 13])
    runner = fault.FaultTolerantRunner(
        _quadratic_step, str(tmp_path / "port"), ckpt_every=5,
        injector=injector, async_ckpt=False, ckpt_codec=codec, engine=CPU)
    state, report = runner.run({"w": torch.zeros(n)},
                               _forever(torch.ones(n)), 20)
    assert report.steps_done == 20
    assert report.restarts == 2
    assert report.losses[-1] < 1e-3 * n / 4
    ref_runner = ref_fault.FaultTolerantRunner(
        _ref_quadratic_step, str(tmp_path / "ref"), ckpt_every=5,
        injector=ref_fault.FailureInjector(fail_at_steps=[7, 13]),
        async_ckpt=False, ckpt_codec=codec)
    ref_state, ref_report = ref_runner.run({"w": jnp.zeros((n,))},
                                           _forever(jnp.ones((n,))), 20)
    assert (report.steps_done, report.restarts) == \
        (ref_report.steps_done, ref_report.restarts)
    np.testing.assert_allclose(report.losses, ref_report.losses, rtol=1e-6)
    np.testing.assert_allclose(state["w"].numpy(),
                               np.asarray(ref_state["w"]), rtol=1e-6)


def test_runner_gives_up_after_max_restarts(tmp_path):
    class AlwaysFail(fault.FailureInjector):
        def maybe_fail(self, step):
            raise fault.WorkerFailure("dead node")

    runner = fault.FaultTolerantRunner(
        _quadratic_step, str(tmp_path), ckpt_every=5,
        injector=AlwaysFail(), max_restarts=2, async_ckpt=False)
    with pytest.raises(fault.WorkerFailure):
        runner.run({"w": torch.zeros(4)}, _forever(torch.ones(4)), 10)


def test_straggler_detection():
    mon = fault.StepMonitor(straggler_factor=3.0)
    ref = ref_fault.StepMonitor(straggler_factor=3.0)
    for i in range(10):
        assert mon.observe(i, 0.1) == fault.StepRecord(i, 0.1, False)
        ref.observe(i, 0.1)
    rec = mon.observe(10, 0.55)
    assert rec.straggler and ref.observe(10, 0.55).straggler
    assert len(mon.stragglers) == 1
    assert mon.healthy(timeout=60)


def test_resume_from_existing_checkpoint(tmp_path):
    """A fresh runner resumes at the last checkpointed step."""
    r1 = fault.FaultTolerantRunner(_quadratic_step, str(tmp_path),
                                   ckpt_every=5, async_ckpt=True)
    state, rep1 = r1.run({"w": torch.zeros(4)}, _forever(torch.ones(4)), 10)
    r2 = fault.FaultTolerantRunner(_quadratic_step, str(tmp_path),
                                   ckpt_every=5, async_ckpt=False)
    state2, rep2 = r2.run({"w": torch.zeros(4)}, _forever(torch.ones(4)), 15)
    # resumed from step 10, ran only 5 more
    assert rep2.steps_done == 15
    assert len(rep2.losses) == 5


def test_runner_restores_onto_the_state_device(tmp_path, monkeypatch):
    """The state's device decides the restore: the engine's device gets
    ``device_out=True`` (each restored leaf equal to the state saved at
    that step), a CPU state without an engine a host restore, and a
    non-CPU device the engine on that device."""
    calls, saved = [], {}
    real_restore, real_save = ckpt.restore, ckpt.save

    def spy_save(d, step, state, **kw):
        saved[step] = {k: v.clone() for k, v in state.items()}
        return real_save(d, step, state, **kw)

    def spy_restore(d, step, like, **kw):
        calls.append((step, kw))
        out = real_restore(d, step, like, **kw)
        assert torch.equal(out["w"], saved[step]["w"])
        return out

    monkeypatch.setattr(ckpt, "save", spy_save)
    monkeypatch.setattr(ckpt, "restore", spy_restore)
    for engine, want in ((CPU, True), (None, False)):
        if engine is None and not torch.cuda.is_available():
            break      # a compressed host restore decodes on the card
        calls.clear()
        runner = fault.FaultTolerantRunner(
            _quadratic_step, str(tmp_path / str(want)), ckpt_every=3,
            injector=fault.FailureInjector(fail_at_steps=[4, 8]),
            async_ckpt=True, ckpt_codec="rle_v2", engine=engine)
        _, report = runner.run({"w": torch.zeros(512)},
                               _forever(torch.ones(512)), 10)
        assert report.restarts == 2 and report.steps_done == 10
        assert [(s, kw["device_out"]) for s, kw in calls] == \
            [(3, want), (6, want)]
        assert all(kw["engine"] is engine for _, kw in calls)

    # a state on another device: an engine there, device_out
    monkeypatch.setattr(ckpt, "restore",
                        lambda d, step, like, **kw: (calls.append(kw),
                                                     like)[1])
    meta = CodagEngine(EngineConfig(device="meta"))
    runner = fault.FaultTolerantRunner(_quadratic_step, str(tmp_path / "m"),
                                       engine=meta)
    calls.clear()
    state = {"w": torch.zeros(4, device="meta")}
    assert runner._restore(1, state) is state
    assert calls[0]["device_out"] and calls[0]["engine"] is meta
    assert fault._state_device({"a": [1, state["w"]]}) == \
        torch.device("meta")
