"""DiLoCo-style cross-pod training: local inner steps + compressed outer sync.

The counterpart of ``repro/distributed/diloco.py``.  Each pod trains on its
own replica for H inner steps, then the pods reconcile with ONE compressed
collective:

    inner:  per-pod AdamW on per-pod parameter replicas (every leaf carries
            a leading (n_pods,) member axis; :func:`make_inner_step` runs
            the single-device train step once a pod, so no collective runs
            inside a window)
    outer:  delta = local - anchor per pod; the deltas cross the pod axis as
            registry-codec compressed bytes (``collectives.make_tree_reduce``:
            the int8 bitpack wire, its dequant -> member mean fused into the
            bitpack kernel's stores, or top-k values + 1-bit bitmap with
            error feedback); the Nesterov outer step (DiLoCo,
            arXiv:2311.08105) consumes the decode's output and every pod
            rebases onto the new anchor.
    overlap: :class:`OuterSyncPipeline` runs the sync of window W while
            window W+1's inner steps run, on a side CUDA stream on a card,
            and merges the delayed update streaming-DiLoCo style
            (merged = synced + (now - snapshot)).

Two forms.  In one process the pods are members of a mesh
(``launch.mesh.Mesh``) that share one device, so a pod tree is one tensor a
leaf with the pod axis leading.  One process a pod (a ``(pod, data)`` mesh
over a world's ranks, ``launch.mesh.spawn``), each process holds its own
pod's block of every pod tree, a leading pod axis of 1
(``sharding.member_sharding``), the sync's reduce travels over the ``pod``
process group (``collectives.make_tree_reduce``), and
each sync runs in :class:`OuterSyncPipeline`'s worker thread (in both
forms), as the reference's waiter thread waits on its collective: nothing
else in the process uses the ``pod`` group while a sync is in flight.  Wire cost per
outer sync: ``collectives.wire_report``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import torch

from repro_torch.core.tree import leaves, map_tree
from repro_torch.distributed import sharding


@dataclasses.dataclass(frozen=True)
class DiLoCoConfig:
    inner_steps: int = 16
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    compress: bool = True
    wire: str = "int8"          # "int8" | "topk" | "none" (compress=False)
    topk_frac: float = 0.01


def replicate_for_pods(tree, n_pods: int, mesh=None):
    """Every leaf with a leading ``(n_pods,)`` member axis: ``n_pods``
    copies, on the device the mesh's members share when ``mesh`` is given
    (``sharding.member_sharding``), else on the leaf's own.  On a mesh
    over a world's ranks, this pod's block: one copy, on its device."""
    rows = n_pods
    if mesh is not None and mesh.rank is not None:
        if int(mesh.shape["pod"]) != n_pods:
            raise ValueError(f"{n_pods} pods for {mesh}")
        rows = 1

    def rep(x):
        if mesh is not None:
            x = x.to(sharding.member_sharding(mesh, "pod", x.dim() + 1)
                     .device)
        return x.unsqueeze(0).expand((rows,) + tuple(x.shape)).clone()
    return map_tree(rep, tree)


def _pod(tree, p: int):
    return map_tree(lambda t: t[p], tree)


def make_inner_step(train_step: Callable):
    """A ``(params, opt, batch) -> (params, opt, loss)`` step run once a
    pod over trees whose leaves carry a leading ``(n_pods,)`` axis: each
    pod's slice of params, optimizer state and batch through the step, the
    results stacked again (the loss ``(n_pods,)``)."""
    def inner(pod_params, pod_opt, batch):
        n_pods = next(leaves(pod_params)).shape[0]
        outs = [train_step(_pod(pod_params, p), _pod(pod_opt, p),
                           _pod(batch, p)) for p in range(n_pods)]

        def stack(*ts):
            return torch.stack(ts)

        return (map_tree(stack, *[o[0] for o in outs]),
                map_tree(stack, *[o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))

    return inner


def init_outer_state(params, *, mesh=None, cfg: DiLoCoConfig = None):
    """The outer loop's state: ``anchor`` (the params every pod rebases
    onto), the float32 Nesterov ``outer_mom`` and, for the top-k wire,
    the per-pod error-feedback ``residual`` trees (leading ``(n_pods,)``
    axis, as the pod params)."""
    cfg = cfg or DiLoCoConfig()
    state = {
        "anchor": map_tree(lambda x: x, params),
        "outer_mom": map_tree(
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), params),
        "residual": None,
    }
    if cfg.compress and cfg.wire == "topk":
        if mesh is None:
            raise ValueError("wire='topk' needs the mesh to place per-pod "
                             "error-feedback residuals")
        zeros = map_tree(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                               device=x.device), params)
        state["residual"] = replicate_for_pods(zeros, int(mesh.shape["pod"]),
                                               mesh)
    return state


def make_outer_sync(mesh, cfg: DiLoCoConfig, *, config=None):
    """``sync(pod_params, outer) -> (pod_params, outer)``.

    ``pod_params``: leaves ``(n_pods, ...)``; ``outer``: the
    :func:`init_outer_state` dict.  The deltas cross the pod axis through
    the wire ``cfg.wire`` selects, and the averaged delta is the decode's
    output (the int8 wire's dequant and member mean fused into the bitpack
    kernel's stores); every pod is rebased onto the new anchor.
    ``config``: the engine's (``EngineConfig``; default the card).  On a
    mesh over a world's ranks each process syncs its own pod's block
    (``pod_params`` and the residuals with a leading axis of 1) and every
    process gets the same anchor."""
    from repro_torch.distributed import collectives

    n_pods = int(mesh.shape["pod"])
    wire = cfg.wire if cfg.compress else "none"
    reduce_fn = collectives.make_tree_reduce(
        mesh, "pod", wire=wire, frac=cfg.topk_frac, config=config)

    def sync(pod_params, outer):
        anchor, outer_mom = outer["anchor"], outer["outer_mom"]
        # each pod's delta from the anchor
        deltas = map_tree(lambda p, a: (p - a[None].to(p.dtype)).float(),
                          pod_params, anchor)
        avg, new_res = reduce_fn(deltas, outer.get("residual"))
        # the Nesterov outer step on the decode's output
        new_mom = map_tree(lambda m, g: cfg.outer_momentum * m + g,
                           outer_mom, avg)
        new_anchor = map_tree(
            lambda a, m, g: (a.float() + cfg.outer_lr
                             * (cfg.outer_momentum * m + g)).to(a.dtype),
            anchor, new_mom, avg)
        new_pod_params = replicate_for_pods(new_anchor, n_pods, mesh)
        return new_pod_params, {"anchor": new_anchor, "outer_mom": new_mom,
                                "residual": new_res}

    return sync


def _tensors(*trees):
    return [t for tree in trees if tree is not None for t in leaves(tree)
            if isinstance(t, torch.Tensor)]


class OuterSyncPipeline:
    """Overlap the outer sync with the next window's inner steps.

    ``launch(pod_params, outer)`` snapshots the pod params and starts the
    sync; the caller keeps running inner steps on the un-synced params;
    ``finish(pod_params_now)`` waits only for what of the sync the window
    did not hide and merges the delayed update streaming-DiLoCo style:

        merged = synced_params + (pod_params_now - snapshot)

    The sync runs in a worker thread, so the caller goes on at once (one
    process a pod, its collectives block the thread that issues them; a
    thread started in Python reads no other thread's ``spmd`` member).  On
    a card its launches go to a side CUDA stream that first waits for the
    caller's stream (its inputs are that stream's work); its inputs are
    marked used on the side stream (``record_stream``), so their memory is
    not reused while the sync reads them, and at ``finish`` the caller's
    stream waits on the sync's event and its outputs are marked used on
    the caller's stream.  The train step returns new tensors and leaves
    its inputs as they were, so the inner steps never write what the sync
    reads.  The thread waits for the event, then for the injected link
    round trip ``link_rtt_s``, so overlap is measurable anywhere:
    ``stats()['overlap_frac'] = 1 - wait / collective``.
    """

    def __init__(self, sync_fn: Callable, *, link_rtt_s: float = 0.0):
        self.sync_fn = sync_fn
        self.link_rtt_s = link_rtt_s
        self._pending = None
        self._streams = {}
        self.syncs = 0
        self.collective_s = 0.0
        self.wait_s = 0.0

    def _side_stream(self, device: torch.device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def launch(self, pod_params, outer) -> None:
        if self._pending is not None:
            raise RuntimeError("outer sync already in flight "
                               "(finish() or abandon() it first)")
        t0 = time.perf_counter()
        device = next(leaves(pod_params)).device
        side = None
        if device.type == "cuda":
            side = self._side_stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            for t in _tensors(pod_params, outer["anchor"],
                              outer["outer_mom"], outer.get("residual")):
                t.record_stream(side)
        done = threading.Event()
        box = {"done_at": None, "out": None, "event": None, "error": None}

        def run():
            try:
                if side is None:
                    box["out"] = self.sync_fn(pod_params, outer)
                else:
                    with torch.cuda.stream(side):
                        box["out"] = self.sync_fn(pod_params, outer)
                        box["event"] = torch.cuda.Event()
                        box["event"].record(side)
                    box["event"].synchronize()
                if self.link_rtt_s:
                    time.sleep(self.link_rtt_s)
            except BaseException as e:          # raised again in finish
                box["error"] = e
            box["done_at"] = time.perf_counter()
            done.set()

        threading.Thread(target=run, daemon=True,
                         name="diloco-outer-sync").start()
        self._pending = (pod_params, device, done, box, t0)

    @property
    def in_flight(self) -> bool:
        return self._pending is not None

    def _wait(self):
        snapshot, device, done, box, t0 = self._pending
        self._pending = None
        w0 = time.perf_counter()
        done.wait()
        self.wait_s += time.perf_counter() - w0
        self.collective_s += box["done_at"] - t0
        if box["error"] is not None:
            raise box["error"]
        new_pod_params, new_outer = box["out"]
        return snapshot, new_pod_params, new_outer, (device, box["event"])

    def finish(self, pod_params_now=None):
        """Wait for the rest of the sync and return ``(merged_pod_params,
        new_outer)``.  With ``pod_params_now`` the delayed update is
        corrected for the inner progress made during the overlap; without
        it the synced params are returned as they are."""
        if self._pending is None:
            raise RuntimeError("no outer sync in flight")
        snapshot, new_pod_params, new_outer, (device, event) = self._wait()
        self.syncs += 1
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in _tensors(new_pod_params, new_outer["anchor"],
                              new_outer["outer_mom"],
                              new_outer.get("residual")):
                t.record_stream(stream)
        if pod_params_now is not None:
            new_pod_params = map_tree(
                lambda synced, now, snap:
                    (synced.float() + (now.float() - snap.float())
                     ).to(synced.dtype),
                new_pod_params, pod_params_now, snapshot)
        return new_pod_params, new_outer

    def drain(self) -> None:
        """Wait out an in-flight sync without taking its result: the fault
        path calls it before it restores a checkpoint."""
        if self._pending is None:
            return
        self._wait()

    def abandon(self) -> None:
        """Drop the in-flight sync at once (its thread ends in the
        background); used when a failure invalidates the window."""
        self._pending = None

    def stats(self) -> dict:
        frac = (1.0 - self.wait_s / self.collective_s
                if self.collective_s > 0 else 0.0)
        return {"syncs": self.syncs, "collective_s": self.collective_s,
                "wait_s": self.wait_s, "overlap_frac": max(0.0, frac)}
