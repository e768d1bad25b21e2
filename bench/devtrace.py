"""The device trace of a measured window: ``torch.profiler`` with CUDA
activity only (the card's kernels, copies and sets, and the runtime calls
that launched them), read back from its Chrome trace.

Only device activity is read.  Host spans are the harness's own clock
readings around each call into the program (``Record``), so tracing adds
CUPTI's cost to each launch and nothing per host operation.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}


def profiler():
    """A profiler of the card's activity, not yet started."""
    import torch
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list: up to
    the first ``(`` outside its template arguments."""
    name = name.strip().removeprefix("void ")
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:160].strip()


def read(prof, n_ops: int, window_s: float) -> dict:
    """What the trace says of the window: device busy seconds (the union of
    every activity), device seconds (their sum), kernel count, the device
    operations that took most time, and the idle gaps by what the host was
    doing (an activity's place within its operation: the n-th of each
    operation's ``k`` activities, where every operation ran ``k``)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    acts = sorted(
        ((float(e["ts"]), float(e.get("dur", 0.0)), e.get("name", "?"),
          str(e.get("cat", "")).lower())
         for e in events
         if e.get("ph") == "X" and str(e.get("cat", "")).lower()
         in DEVICE_CATS), key=lambda a: a[0])
    if not acts:
        return {}
    by_name, raw = defaultdict(float), {}
    for _, dur, name, _ in acts:
        by_name[_short(name)] += dur * 1e-6
        raw.setdefault(_short(name), name[:400])
    busy, gaps = 0.0, defaultdict(float)
    k = len(acts) // n_ops if n_ops and len(acts) % n_ops == 0 else 0
    end = acts[0][0]
    for i, (ts, dur, name, _) in enumerate(acts):
        if ts > end and i:
            if not k:
                what = "host: between device operations"
            elif i % k == 0:
                what = ("host: between operations (waiting for the oldest, "
                        "then queueing the next)")
            else:
                what = f"host: queueing within an operation, before " \
                       f"{_short(name)}"
            gaps[what] += (ts - end) * 1e-6
        start = max(ts, end)
        if ts + dur > start:
            busy += (ts + dur - start) * 1e-6
        end = max(end, ts + dur)
    rest = window_s - busy - sum(gaps.values())
    if rest > 0:
        gaps["host: before the first and after the last device "
             "operation"] += rest
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "device_s": sum(a[1] for a in acts) * 1e-6,
            "kernels": sum(1 for a in acts if a[3] == "kernel"),
            "device_ops": [list(t) for t in top],
            "idle_gaps": [list(t) for t in idle],
            "names": {k: raw[k] for k, _ in top}}
