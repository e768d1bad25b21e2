"""Fault tolerance: heartbeats, straggler detection, restart from checkpoint.

The counterpart of ``repro/distributed/fault.py``; all decision logic is
host Python.

* ``StepMonitor`` wraps step execution: per-step wall-time heartbeat,
  straggler flagging (> k x rolling median), failure counting.
* ``FaultTolerantRunner`` drives a train loop: periodic async checkpoints,
  failure capture (a worker exception == lost node), restore-and-continue,
  an optional ``reshard_fn`` applied to the restored state, and an
  optional ``sync_pipeline`` (``diloco.OuterSyncPipeline``) drained on a
  failure.  The elastic restart: a state of ``sharding.ShardedTensor``
  leaves (placed on a mesh whose members share one device) is restored
  onto a mesh through ``checkpoint.restore(shardings=)``: onto
  ``reshard_fn.shardings`` where the ``reshard_fn`` carries them
  (:func:`onto`: another mesh's shardings), else onto the shardings the
  state had; the ``reshard_fn`` then lays the restored state out as it
  likes, and the loop goes on with the step on that state (a step that
  runs under a mesh, ``launch.steps.sharded_step``, takes it from there).
  One process a member (a state of this member's blocks of a mesh over a
  world's ranks, given with ``shardings=``): every process checkpoints
  through ``checkpoint.save(shardings=)`` (gathered, rank 0 writes) and,
  after a failure at the same step in every process, restores its own
  blocks through ``checkpoint.restore(shardings=)`` onto the same mesh.
* ``FailureInjector`` deterministically raises at chosen steps (tests).

One adaptation to torch.  The reference restores to host arrays and lets
``jax.jit`` move them to the device; a torch step cannot mix host and card
tensors.  So the runner restores the state onto the device that holds its
tensors: where that is a card (or the device of the runner's ``engine``),
``checkpoint.restore(device_out=True)`` decodes, reassembles and bitcasts
every compressed leaf there, on the decode kernels; anywhere else it
restores to the host.  After a restart the step sees its state where it
was before.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import ShardedTensor


class WorkerFailure(RuntimeError):
    """Raised when a (simulated or real) worker dies mid-step."""


@dataclasses.dataclass
class StepRecord:
    step: int
    seconds: float
    straggler: bool


class StepMonitor:
    """Heartbeat + straggler detection over step wall-times."""

    def __init__(self, straggler_factor: float = 3.0, window: int = 32):
        self.factor = straggler_factor
        self.window = window
        self.records: List[StepRecord] = []
        self.last_heartbeat = time.time()

    def observe(self, step: int, seconds: float) -> StepRecord:
        recent = [r.seconds for r in self.records[-self.window:]]
        med = statistics.median(recent) if recent else seconds
        rec = StepRecord(step, seconds,
                         straggler=bool(recent) and seconds > self.factor * med)
        self.records.append(rec)
        self.last_heartbeat = time.time()
        return rec

    @property
    def stragglers(self) -> List[StepRecord]:
        return [r for r in self.records if r.straggler]

    def healthy(self, timeout: float) -> bool:
        return (time.time() - self.last_heartbeat) < timeout


class FailureInjector:
    def __init__(self, fail_at_steps=(), exc=WorkerFailure):
        self.fail_at = set(fail_at_steps)
        self.exc = exc
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected node failure at step {step}")


@dataclasses.dataclass
class RunReport:
    steps_done: int
    restarts: int
    stragglers: int
    losses: List[float]


def _state_device(state) -> Optional[torch.device]:
    """The device of the state's first tensor leaf (a sharded leaf's
    members' device), or None."""
    for leaf in ckpt._flatten(state).values():
        if isinstance(leaf, (torch.Tensor, ShardedTensor)):
            return leaf.device
    return None


def _shardings_of(state):
    """The tree of the state's placements (None where a leaf is not a
    ``ShardedTensor``), or None where no leaf is placed."""
    flat = ckpt._flatten(state)
    if not any(isinstance(v, ShardedTensor) for v in flat.values()):
        return None
    return ckpt._rebuild(state, {k: v.sharding if isinstance(
        v, ShardedTensor) else None for k, v in flat.items()})


def onto(shardings) -> Callable:
    """A ``reshard_fn`` for the elastic restart onto a mesh: the runner
    restores the checkpoint straight onto ``shardings`` (a tree like the
    state of ``sharding.NamedSharding`` s, e.g. another mesh's
    ``launch.steps.train_shardings``) with ``checkpoint.restore(
    shardings=)``; called on a state, it places it there
    (``sharding.place``).  On a mesh over a world's ranks the restore
    already gives this rank's blocks, and it leaves a state as it is."""
    ranked = ckpt._ranked_mesh(shardings) is not None

    def reshard(state):
        return state if ranked else sharding.place(state, shardings)

    reshard.shardings = shardings
    return reshard


class FaultTolerantRunner:
    """Checkpointed, restartable training driver.

    run() executes ``step_fn(state, batch) -> (state, loss)`` for
    ``total_steps``, checkpointing every ``ckpt_every``; on WorkerFailure it
    restores the latest checkpoint (passed through ``reshard_fn`` if given)
    and continues.  ``max_restarts`` bounds the retry loop.

    ``ckpt_codec`` selects a registry codec for checkpoint payloads
    (restore then decodes through the batched ``DecodePlan`` path), and
    ``engine`` the ``CodagEngine`` it decodes on: by default the card that
    holds the state, or the card's default engine for a host restore.  The
    restore lands on the state's device (module docstring).

    ``shardings``: where ``state`` holds this member's blocks of a mesh
    over a world's ranks (one process a member), the tree of their
    ``NamedSharding`` s: saves gather the blocks (``checkpoint.save(
    shardings=)``) and a restart restores this member's blocks onto them.
    Every process must fail at the same steps.

    ``sync_pipeline`` (an outer-sync pipeline with ``in_flight`` and
    ``drain()``, duck-typed) lets an in-flight compressed outer sync DRAIN
    concurrently with the compressed restore: on failure the pending
    collective is released to finish in a waiter thread while
    ``checkpoint.restore`` decodes, and joined only after the restored state
    is live.
    """

    def __init__(self, step_fn: Callable, ckpt_dir: str, ckpt_every: int = 10,
                 monitor: Optional[StepMonitor] = None,
                 injector: Optional[FailureInjector] = None,
                 reshard_fn: Optional[Callable] = None,
                 max_restarts: int = 3, async_ckpt: bool = True,
                 ckpt_codec: str = "none", sync_pipeline=None,
                 engine=None, shardings=None):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.monitor = monitor or StepMonitor()
        self.injector = injector
        self.reshard_fn = reshard_fn
        self.max_restarts = max_restarts
        self.async_ckpt = async_ckpt
        self.ckpt_codec = ckpt_codec
        self.sync_pipeline = sync_pipeline
        self.engine = engine
        self.shardings = shardings

    def _restore(self, step: int, state, *, resharding: bool = False):
        """``checkpoint.restore`` of ``step`` onto the device of ``state``'s
        tensors, and onto a mesh where the state is placed on one or
        ``resharding`` with a ``reshard_fn`` that carries its shardings
        (module docstring)."""
        dev = _state_device(state)
        shardings = getattr(self.reshard_fn, "shardings", None) \
            if resharding else None
        if shardings is None:
            shardings = self.shardings if self.shardings is not None \
                else _shardings_of(state)
        engine = self.engine
        if engine is None and dev is not None and dev.type == "cuda":
            engine = CodagEngine(EngineConfig(device=str(dev)))
        device_out = dev is not None and engine is not None \
            and engine.device == dev
        return ckpt.restore(self.ckpt_dir, step, state, engine=engine,
                            device_out=device_out, shardings=shardings)

    def run(self, state, batches, total_steps: int) -> tuple:
        restarts = 0
        losses: List[float] = []
        step = 0
        pending = None
        # resume if a checkpoint exists (restart-from-scratch case)
        latest = ckpt.latest_step(self.ckpt_dir)
        if latest is not None:
            state = self._restore(latest, state)
            step = latest
        it = iter(batches)
        while step < total_steps:
            try:
                batch = next(it)
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                t0 = time.time()
                state, loss = self.step_fn(state, batch)
                self.monitor.observe(step, time.time() - t0)
                losses.append(float(loss))
                step += 1
                if step % self.ckpt_every == 0:
                    if pending is not None:
                        pending.join()
                    pending = ckpt.save(self.ckpt_dir, step, state,
                                        codec=self.ckpt_codec,
                                        async_=self.async_ckpt,
                                        shardings=self.shardings)
            except WorkerFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                if pending is not None:
                    pending.join()
                    pending = None
                # release any in-flight outer sync: its waiter thread keeps
                # draining the collective WHILE restore decodes the
                # compressed checkpoint below; joined after restore.
                th = None
                if (self.sync_pipeline is not None
                        and self.sync_pipeline.in_flight):
                    th = threading.Thread(target=self.sync_pipeline.drain,
                                          daemon=True)
                    th.start()
                latest = ckpt.latest_step(self.ckpt_dir)
                if latest is None:
                    if th is not None:
                        th.join()
                    step = 0  # no checkpoint yet: restart from scratch
                    continue
                state = self._restore(latest, state, resharding=True)
                if self.reshard_fn is not None:
                    state = self.reshard_fn(state)
                if th is not None:
                    th.join()
                step = latest
        if pending is not None:
            pending.join()
        report = RunReport(steps_done=step, restarts=restarts,
                           stragglers=len(self.monitor.stragglers),
                           losses=losses)
        return state, report
