"""Every cell of ``BENCHMARK.json`` rehearsed at a tiny size on the CPU,
through the harness and the cells' own files; the checks on the check
(the control and each fault must come out not correct); the harness
finding new files by name; the contract's exits; the import gate."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import control, harness
from bench.tests.rehearse import overrides

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in SPEC["workloads"]}
SEED = 2**33 + 17


def tiny(cell: str) -> dict:
    w = CELLS[cell]
    return overrides(w["config"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_runs_correct_on_cpu(cell):
    res = harness.run_cell(cell, SEED, 0.3, False, **tiny(cell))
    assert res["correct"] is True, res
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("what", control.WHAT)
def test_control_and_faults_come_out_not_correct(cell, what):
    """The reference at the next precision below (float32 columns in
    bfloat16), an output left unwritten, half the chunks left out, one
    element altered: each is caught."""
    res = control.run(cell, SEED + 1, 0.3, what, **tiny(cell))
    assert res["correct"] is False, (what, res["checks"])
    assert res["checks"]["mismatched_elements"]["value"] > 0


def test_from_host_path_runs_correct_on_cpu():
    """``path: from_host``: every operation is ``decompress_many`` from the
    host blobs, so there is no plan built or staged in set-up."""
    over = tiny("rle_scan")
    over["traffic_over"].update(path="from_host", inflight=1)
    res = harness.run_cell("rle_scan", SEED, 0.3, True, **over)
    assert res["correct"] is True, res["checks"]
    assert "dispatch_host_ms" in res["metrics"]
    assert not {"plan_build_ms", "stage_ms"} & set(res["metrics"])


@pytest.mark.parametrize("bad", ["short", "dtype", "missing"])
def test_an_output_of_the_wrong_shape_is_not_correct(bad):
    import torch
    from bench import reference
    expected = {}

    def op(query):
        exp = expected.setdefault(0, reference.Expected(torch.device("cpu")))
        outs = [exp.rows(col, idx).view(getattr(torch, col.dtype))
                for col, idx in query.parts]
        if bad == "short":
            return [o[:-1] for o in outs]
        if bad == "dtype":
            return [o.view(torch.uint8) for o in outs]
        return outs[:-1]

    res = harness.run_cell("rle_scan", SEED, 0.2, False, op_over=op,
                           **tiny("rle_scan"))
    assert res["correct"] is False
    assert res["checks"]["mismatched_elements"]["value"] > 0


def build(cell: str, seed: int, workers: int) -> list:
    from bench import table
    spec, w, config, traffic = harness.cell_spec(cell)
    return table.Build({**config, **tiny(cell)["config_over"]}, seed,
                       workers).result()


def test_same_seed_same_inputs():
    cols = [build("deflate_scan", s, 0) for s in (5, 5, 6)]
    for a, b in zip(cols[0], cols[1]):
        assert (a.base == b.base).all()
        assert [x["comp"].tobytes() for x in a.base_blobs] == \
            [x["comp"].tobytes() for x in b.base_blobs]
    assert any((a.base != c.base).any() for a, c in zip(cols[0], cols[2]))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_worker_processes_make_what_one_process_makes(cell):
    """The columns made and encoded on a pool of spawned workers equal, byte
    for byte, those made in the calling process."""
    one, pool = build(cell, 2**35 + 1, 0), build(cell, 2**35 + 1, 2)
    assert [c.name for c in one] == [c.name for c in pool]
    for a, b in zip(one, pool):
        assert a.rows == b.rows and (a.base == b.base).all()
        for x, y in zip(a.base_blobs, b.base_blobs, strict=True):
            assert x["comp"].tobytes() == y["comp"].tobytes()
            assert sorted(x["extras"]) == sorted(y["extras"])
            assert all((x["extras"][k] == y["extras"][k]).all()
                       for k in x["extras"])


def add_files(root: Path) -> None:
    """A throwaway configuration, traffic mix, metric and cell, each a new
    file or entry; no file already there is edited but BENCHMARK.json,
    which gains entries."""
    cfg = json.loads((root / "bench/configs/table4_rle.json").read_text())
    cfg["columns"] = cfg["columns"][:3]
    (root / "bench/configs/zz_tiny.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/zz_mix.json").write_text(json.dumps(
        {"path": "resident", "inflight": 1,
         "check": {"drawn": 1, "drawn_from": 2}}))
    (root / "bench/metrics/zz_ops_seen.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "zz_tiny", "source": "test",
                            "file": "bench/configs/zz_tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "zz_cell", "config": "zz_tiny",
                              "traffic": "zz_mix", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "zz_ops_seen", "unit": "ops",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "decode_GBps",
                              "workloads": ["zz_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_harness_finds_new_files_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    add_files(tmp_path)
    assert all(p.read_bytes() == b for p, b in before.items())
    over = overrides("table4_rle")
    over["config_over"]["table_chunks"] = 4
    res = harness.run_cell("zz_cell", SEED, 0.2, True, root=tmp_path, **over)
    assert res["correct"] is True
    assert res["metrics"]["zz_ops_seen"]["value"] == res["attempted"]
    res = harness.run_cell("rle_scan", SEED, 0.2, True, root=tmp_path,
                           **tiny("rle_scan"))
    assert "zz_ops_seen" not in res["metrics"]


def run_script(args, cwd, timeout=300):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd), "TMPDIR": str(cwd),
           "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_run_without_a_card_exits_nonzero_with_no_result(tmp_path):
    p = run_script(["bench/run.py", "--workload", "rle_scan", "--seed",
                    str(2**32 + 1), "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "card" in p.stderr


def test_run_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_script(["bench/run.py", "--workload", "rle_scan", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


GATE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded_after(body: str) -> set:
    code = GATE.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Top-level names compared whole: ``repro_torch`` is the program,
    ``repro`` the JAX package."""
    body = ("from bench import harness\n"
            "from bench.tests.rehearse import overrides\n"
            "r = harness.run_cell('rle_scan', 3, 0.2, False, "
            "**overrides('table4_rle'))\n"
            "assert r['correct']\n")
    mods = loaded_after(body)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    body = ("import bench.reference, bench.table, bench.blobs, "
            "bench.roofline, bench.data.table4\n"
            "import bench.codecs.rle_v1, bench.codecs.rle_v2, "
            "bench.codecs.tdeflate\n")
    mods = loaded_after(body)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_nothing_in_the_benchmark_reads_the_jax_benchmarks():
    for path in (ROOT / "bench").rglob("*.py"):
        top = {n.split(".")[0] for n in imported_names(path)}
        assert not top & {"benchmarks", "jax", "jaxlib", "flax", "repro"}, \
            path
        assert "benchmarks" + "/" not in path.read_text(), path


def test_reference_and_yardstick_import_no_program():
    for name in ("reference.py", "table.py", "blobs.py", "roofline.py",
                 "data/table4.py", "codecs/rle_v1.py", "codecs/rle_v2.py",
                 "codecs/tdeflate.py"):
        top = {n.split(".")[0] for n in imported_names(ROOT / "bench" / name)}
        assert "repro_torch" not in top, name
