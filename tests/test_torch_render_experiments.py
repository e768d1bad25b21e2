"""``scripts/torch_render_experiments.py`` against the reference's
``scripts/render_experiments.py``: the same records and the same marked
document give the same bytes.

The records are the port's dry-run's own (``repro_torch.launch.dryrun`` on
reduced qwen3-1.7b: an ``ok`` cell on each mesh, a ``skipped`` one, and a
perf variant's file) plus an ``error`` cell.  The reference's script
imports nothing of JAX, so it is loaded here by path and pointed at the
same temporary files through its module paths; the port's script takes
them as arguments and may not import it.
"""
import ast
import importlib.util
import json
from pathlib import Path

import pytest

from repro_torch.configs import get_arch, reduced
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parent.parent
DOC = """# Experiments

Narrative kept as it is.

<!-- BEGIN ROOFLINE_SINGLE -->
stale roofline
<!-- END ROOFLINE_SINGLE -->

## Memory

<!-- BEGIN MEM_TABLE -->
<!-- END MEM_TABLE -->

## Variants

<!-- BEGIN PERF_VARIANTS -->
old | rows
<!-- END PERF_VARIANTS -->

Closing text.
"""


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The dry-run's records of reduced qwen3-1.7b and a variant's file."""
    tmp = tmp_path_factory.mktemp("records")
    mp = pytest.MonkeyPatch()
    mp.setattr(dryrun, "get_arch", lambda name: reduced(get_arch(name)))
    try:
        res, var = tmp / "results.json", tmp / "variants.json"
        base = ["--arch", "qwen3-1.7b"]
        dryrun.main(base + ["--shape", "decode_32k", "--mesh", "both",
                            "--out", str(res)])
        dryrun.main(base + ["--shape", "long_500k", "--out", str(res)])
        dryrun.main(base + ["--shape", "decode_32k", "--variant", "noskip",
                            "--out", str(var)])
    finally:
        mp.undo()
    cells = json.loads(res.read_text())
    cells["qwen3-1.7b|train_4k|single"] = {
        "status": "error", "error": "RuntimeError: planted",
        "trace": "Traceback ..."}
    res.write_text(json.dumps(cells, indent=1))
    assert sorted(c["status"] for c in cells.values()) == [
        "error", "ok", "ok", "skipped"]
    assert {c.get("mesh") for c in cells.values()} >= {"16x16", "2x16x16"}
    return res, var


def _render_both(tmp_path, res, var, monkeypatch) -> tuple:
    ref_doc, port_doc = tmp_path / "ref.md", tmp_path / "port.md"
    ref_doc.write_text(DOC)
    port_doc.write_text(DOC)
    ref = _load("render_experiments")
    monkeypatch.setattr(ref, "RES", res)
    monkeypatch.setattr(ref, "VAR", var)
    monkeypatch.setattr(ref, "EXP", ref_doc)
    ref.main()
    _load("torch_render_experiments").main(
        ["--results", str(res), "--variants", str(var), "--doc",
         str(port_doc)])
    return ref_doc.read_bytes(), port_doc.read_bytes()


def test_renders_the_reference_bytes(records, tmp_path, monkeypatch):
    res, var = records
    want, got = _render_both(tmp_path, res, var, monkeypatch)
    assert got == want
    text = got.decode()
    assert "stale roofline" not in text and "old | rows" not in text
    assert "Narrative kept as it is." in text and "Closing text." in text
    assert "| qwen3-1.7b | decode_32k | single |" in text
    assert "| qwen3-1.7b | decode_32k | multi |" in text   # memory rows
    assert "| qwen3-1.7b+noskip | decode_32k | single |" in text
    assert "skipped (full-attn @500k)" in text and "ERROR" in text


def test_missing_records_leave_their_blocks(tmp_path, monkeypatch):
    """Without records or variants both scripts leave the blocks as they
    were and rewrite the document unchanged."""
    want, got = _render_both(tmp_path, tmp_path / "none.json",
                             tmp_path / "none_v.json", monkeypatch)
    assert got == want == DOC.encode()


def test_a_missing_document_raises_in_both(tmp_path, monkeypatch):
    ref = _load("render_experiments")
    monkeypatch.setattr(ref, "EXP", tmp_path / "missing.md")
    with pytest.raises(FileNotFoundError):
        ref.main()
    with pytest.raises(FileNotFoundError):
        _load("torch_render_experiments").main(
            ["--doc", str(tmp_path / "missing.md")])


def test_the_port_script_does_not_import_the_reference_script():
    tree = ast.parse((ROOT / "scripts" / "torch_render_experiments.py")
                     .read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert names and not any(
        n.split(".")[0] in ("render_experiments", "repro", "jax")
        for n in names), names
