"""Compressed collectives on the PyTorch port: DiLoCo's outer sync over a
registry-codec wire, one process a pod.

Two pods, each a process of a ``gloo`` world on a (pod 2, data 1) mesh,
train a toy model toward pod-specific targets, then reconcile through a
compressed collective across the ``pod`` axis: each pod's delta is encoded
into the bitpack codec's exact wire layout on its device, the wire's
tables and scales are all-gathered over the ``pod`` process group, and the
receive path decodes through ``plan.dispatch`` with the dequant and the
member mean in the decode's epilogue (``codag_bitpack_reduce``'s stores
on a card); the Nesterov outer step consumes the decode's output.  The
sync runs in a worker thread (``OuterSyncPipeline``) while the next
window's inner steps run.

    PYTHONPATH=src python examples/torch_grad_compression.py [--device cpu]

The counterpart of ``examples/grad_compression.py``; ``--device`` defaults
to ``cuda``.
"""
import argparse

import torch

from repro_torch.core.engine import EngineConfig
from repro_torch.distributed import collectives, diloco
from repro_torch.launch import mesh as mesh_lib

PODS, WINDOWS, SIZE = 2, 10, 1024


def pod(device: str) -> dict:
    """One pod's process: 10 windows of 8 inner steps, each window's sync
    overlapped with the next window's steps."""
    mesh = mesh_lib.world_mesh((PODS, 1), ("pod", "data"), device=device)
    dev = mesh.member_device()
    params = {"w": torch.zeros(SIZE, device=dev)}
    pod_params = diloco.replicate_for_pods(params, PODS, mesh)   # (1, SIZE)
    target = torch.full((SIZE,), float(mesh.coord("pod") + 1), device=dev)
    cfg = diloco.DiLoCoConfig(inner_steps=8, outer_lr=1.0,
                              outer_momentum=0.0, wire="int8")
    outer = diloco.init_outer_state(params, mesh=mesh, cfg=cfg)
    sync = diloco.make_outer_sync(mesh, cfg,
                                  config=EngineConfig(device=str(dev)))
    pipe = diloco.OuterSyncPipeline(sync, link_rtt_s=0.05)
    means = []
    for _ in range(WINDOWS):
        # the previous window's sync drains WHILE these inner steps run;
        # finish() merges the inner progress onto the rebased anchor
        if pipe.in_flight:
            pod_params, outer = pipe.finish(pod_params)
        pipe.launch(pod_params, outer)
        for _ in range(cfg.inner_steps):
            w = pod_params["w"]
            pod_params = {"w": w - 0.05 * 2 * (w - target)}
        means.append(float(outer["anchor"]["w"].mean()))
    pod_params, outer = pipe.finish(pod_params)
    return {"means": means, "anchor": outer["anchor"]["w"].cpu(),
            "stats": pipe.stats()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(f"mesh: {{'pod': {PODS}, 'data': 1}}, one process a pod")
    ranks = mesh_lib.spawn(pod, PODS, (args.device,), device=args.device)
    for window, mean in enumerate(ranks[0]["means"]):
        print(f"window {window}: anchor mean={mean:.4f} "
              f"(target consensus: 1.5)")
    st = ranks[0]["stats"]
    print(f"\noverlap: {st['syncs']} syncs, "
          f"{st['overlap_frac']*100:.0f}% of {st['collective_s']:.2f}s "
          f"collective hidden behind inner steps")
    params = {"w": torch.zeros(SIZE)}
    rep = {w: collectives.wire_report(params, PODS, wire=w, frac=0.01)
           for w in ("none", "int8", "topk")}
    print("wire bytes/outer-sync per pod member:")
    print(f"  f32 ring all-reduce : {rep['none']['f32_ring_bytes']:,.0f}")
    print(f"  int8 bitpack wire   : {rep['int8']['wire_bytes']:,.0f} "
          f"({rep['int8']['ratio']:.1f}x less)")
    print(f"  top-1% + bitmask    : {rep['topk']['wire_bytes']:,.0f} "
          f"({rep['topk']['ratio']:.1f}x less)")
    anchors = [r["anchor"] for r in ranks]
    assert all(torch.equal(a, anchors[0]) for a in anchors)  # pods agree
    assert abs(float(anchors[0].mean()) - 1.5) < 0.05
    assert st["syncs"] == WINDOWS
    print("OK")


if __name__ == "__main__":
    main()
