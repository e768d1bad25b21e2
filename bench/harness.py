"""The benchmark's harness: one run of one cell.

Everything a cell names is found by name, so a later change adds a cell,
a configuration, a traffic mix or a metric by adding files:

  BENCHMARK.json                 the cells, their metrics and bounds
  bench/configs/<config>.json    a deployment: its columns (Table IV
                                 datasets under codecs) and its scale
                                 (``bench/table.py``)
  bench/traffic/<traffic>.json   a mix: its parameters, run by the one
                                 generator ``bench/mix.py``
  bench/metrics/<metric>.py      ``read(run) -> float | None``

A run: make the data from the seed and encode it (worker processes, while
the program is imported), build and stage the queries, warm up every
query, then the mix's closed loop for ``seconds``; an operation lasts from
the moment the host starts queueing it to the moment the card finishes it
(a CUDA event, read on the device's clock).  With ``trace`` the window
runs under the device profiler.  After the window the outputs kept from it
are compared with the plain reference (``bench/reference.py``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from bench import devtrace, mix, reference, table

ROOT = Path(__file__).resolve().parents[1]
# the one number compared: lossless decode is exact.  An output of another
# dtype or size, or one missing, counts all its elements.
LIMITS = {"mismatched_elements": 0}
POISON = 0xA5          # the byte set-up writes over free device memory
POISON_SPARE = 4 << 30  # device memory the poisoned segment leaves free


class NoCard(RuntimeError):
    """The cell needs more cards than this machine shows."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, root: Path = ROOT):
    """(benchmark, cell, config, traffic) for the cell ``name``."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    config = load_json(root / "bench" / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "bench" / "traffic"
                        / f"{cell['traffic']}.json")
    return spec, cell, config, traffic


def metric_names(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end ones, or with ``trace``
    its per-layer ones (those without ``workloads`` in every cell)."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


# --------------------------------------------------------------------------
# clocks: the card's, or the host's for a rehearsal on the CPU
# --------------------------------------------------------------------------


class CardClock:
    def __init__(self, torch):
        self.torch = torch

    def sync(self):
        self.torch.cuda.synchronize()

    def mark(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wait(self, m):
        m.synchronize()

    def seconds(self, m0, m1) -> float:
        return m0.elapsed_time(m1) / 1e3

    def poison(self):
        """Free every cached block, then fill one segment over the free
        memory with :data:`POISON` and free it: the window's outputs are
        carved from it, so an output the program never writes reads
        poison, never an earlier right answer."""
        cuda = self.torch.cuda
        self.sync()
        cuda.empty_cache()
        free = cuda.mem_get_info()[0] - POISON_SPARE
        if free > 0:
            block = self.torch.empty(free, dtype=self.torch.uint8,
                                     device="cuda")
            block.fill_(POISON)
            self.sync()
            del block
        cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated())

    def describe(self) -> dict:
        cuda = self.torch.cuda
        return {"platform": "gpu", "kind": cuda.get_device_name(0),
                "count": 1}


class HostClock:
    """The CPU rehearsal's stand-in: operations run as they are called."""

    def sync(self):
        pass

    def mark(self):
        return time.perf_counter()

    def wait(self, m):
        pass

    def seconds(self, m0, m1) -> float:
        return m1 - m0

    def poison(self):
        pass

    def peak(self) -> int:
        return 0

    def describe(self) -> dict:
        return {"platform": "cpu", "kind": "cpu", "count": 1}


# --------------------------------------------------------------------------
# one run
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What a run measured; the metrics' readers read it."""

    cell: dict
    config: dict
    traffic: dict
    records: List[mix.Record]
    queries: list
    window_s: float
    setup_s: float
    setup: Dict[str, Optional[float]]
    trace: Optional[dict] = None


def plugin(root: Path, kind: str, name: str):
    """The module ``bench/<kind>/<name>.py`` under ``root``, by its path."""
    path = root / "bench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.{kind}.{name}",
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r}: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = ROOT,
             config_over: Optional[dict] = None,
             traffic_over: Optional[dict] = None, workers=None,
             op_over: Optional[Callable] = None,
             t_start: Optional[float] = None, log=print) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``device="cpu"`` rehearses on the program's plain CPU bodies with the
    host's clock and no trace.  ``config_over`` / ``traffic_over`` update
    the cell's files (the rehearsal's small sizes); ``op_over(query) ->
    outputs`` puts something else in the program's place (the control).
    """
    t_start = time.perf_counter() if t_start is None else t_start
    spec, cell, config, traffic = cell_spec(name, root)
    config = {**config, **(config_over or {})}
    traffic = {**traffic, **(traffic_over or {})}
    marks = [("start", t_start), ("read", time.perf_counter())]
    building = table.Build(config, seed, workers)
    marks.append(("making and encoding started", time.perf_counter()))
    try:
        import torch
        from repro_torch.core.engine import CodagEngine, EngineConfig
        if device == "cuda":
            if (not torch.cuda.is_available()
                    or torch.cuda.device_count() < int(cell["chips"])):
                raise NoCard(f"cell {name} needs {cell['chips']} card(s); "
                             f"cuda available: {torch.cuda.is_available()}")
            torch.cuda.init()
            clock = CardClock(torch)
        else:
            clock = HostClock()
        engine = CodagEngine(EngineConfig(device=device))
        marks.append(("program imported, card up", time.perf_counter()))
        columns = building.result()
        marks.append(("made and encoded", time.perf_counter()))
    finally:
        building.close()
    setup: Dict[str, Optional[float]] = {
        "make_s": building.make_s, "encode_s": building.encode_s}
    queries = mix.queries(columns)
    keep = mix.keep_set(traffic, len(queries),
                        table.seed_stream(seed, 1 << 20))
    load = mix.PATHS[traffic["path"]](queries, engine, clock.sync)
    marks.append(("queries built and staged", time.perf_counter()))
    setup.update(build_s=load.build_s, stage_s=load.stage_s)
    run_op = load.run if op_over is None else \
        (lambda j: op_over(queries[j]))
    inflight = int(traffic["inflight"])
    _, _, failure, _ = mix.closed_loop(
        run_op, len(queries), max(len(queries), inflight + 2), None,
        inflight, clock)
    if failure:
        raise RuntimeError(f"warm-up failed:\n{failure}")
    marks.append(("warmed up", time.perf_counter()))
    clock.poison()
    marks.append(("poisoned", time.perf_counter()))
    prof = None
    if trace and device == "cuda":
        prof = devtrace.profiler()
        prof.start()
    records, kept, failure, t0 = mix.closed_loop(
        run_op, len(queries), None, seconds, inflight, clock, keep)
    if prof is not None:
        clock.sync()
        prof.stop()
    setup_s = t0 - t_start
    window_s = (max(r.end for r in records) - t0) if records else seconds
    dev = {**clock.describe(), "memory_peak_bytes": clock.peak()}
    del load
    if device == "cuda":
        torch.cuda.empty_cache()
    run = Run(cell, config, traffic, records, queries, window_s, setup_s,
              setup)
    if prof is not None:
        run.trace = devtrace.read(prof, len(records), window_s)
        del prof
    if failure:
        log(f"operation {len(records)} raised:\n{failure}", file=sys.stderr)

    expected = reference.Expected(engine.device)
    wrong = mismatched = checked = 0
    for i, outs in sorted(kept.items()):
        parts = queries[records[i].query].parts
        if not isinstance(outs, (list, tuple)) or len(outs) != len(parts):
            outs = [None] * len(parts)
        for out, (col, idx) in zip(outs, parts):
            w, m = reference.compare(out, col, idx, expected)
            wrong += int(w)
            mismatched += m
            checked += 1
    n_kept = len(kept)
    kept.clear()
    numbers = {"mismatched_elements": mismatched}
    correct = (not failure and checked > 0
               and all(numbers[k] <= LIMITS[k] for k in LIMITS))

    metrics = {}
    for m in metric_names(spec, name, trace):
        v = plugin(root, "metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace and run.trace:
        dev.update(busy_s=run.trace["busy_s"], window_s=window_s)
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": int(bool(failure)), "metrics": metrics,
              "device": dev}
    if trace and run.trace:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": LIMITS[k]}
                        for k in LIMITS}
    lat = sorted(r.end - r.start for r in records)
    info = {"operations": len(records),
            "op_ms_p50": 1e3 * lat[len(lat) // 2] if lat else None,
            "outputs_checked": checked, "wrong_outputs": wrong,
            "operations_kept": n_kept,
            "setup_phases_s": {b[0]: round(b[1] - a[1], 4)
                               for a, b in zip(marks, marks[1:])},
            "window_s": window_s, "setup_s": setup_s,
            **{k: v for k, v in setup.items() if v is not None}}
    if run.trace:
        info["kernel_names"] = run.trace["names"]
    log("info " + json.dumps(info), file=sys.stderr)
    for k in LIMITS:
        log(f"check {k} {numbers[k]} limit {LIMITS[k]}", file=sys.stderr)
    return result
