"""The port's examples and scripts, on the CPU, against the JAX package.

``scripts/torch_make_vectors.py`` must write every codec's golden vectors
byte for byte as ``tests/vectors/`` holds them, and refuse to write there;
``scripts/torch_check_registry.py`` must pass on the port's registry and
name each thing a codec registered nowhere else lacks.  The five
``examples/torch_*.py`` each run with ``--device cpu`` in a subprocess,
all started together when the file starts (the single-thread strategy of
the quickstart steps its plain body an element at a time on the CPU, so
it sets the file's time), and must end "OK" after their reference's check
lines.  The examples with a ``main()`` run through it, their returned
numbers written to a file, so that:

  * the quickstart's compressed sizes equal the reference's
    ``api.compress(column, codec).compressed_bytes`` on the same column;
  * the streaming restore's backend fetches and fetched bytes equal the
    reference example's paging (its fetch count and bytes are the same in
    every run; its times are not and are not compared).  A port blob file
    is 12 bytes longer than the reference's: its pickle names
    ``repro_torch.core.{api,format}`` where the reference's names
    ``repro.core.{api,format}``;
  * the checkpoint example's manifest, for the reference's parameters and
    AdamW state carried across with ``models.model.params_from_numpy``,
    names the same compressed leaves with the same stored ratios as the
    reference's ``save`` of the same tree.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rck
from repro.configs import get_arch as rget_arch, reduced as rreduced
from repro.core import api as ref_api
from repro.core import store as ref_bs
from repro.models import model as rmodel
from repro.optim import adamw as radamw
from repro_torch.core import format as fmt, registry
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.models import model

ROOT = Path(__file__).resolve().parent.parent
VEC_DIR = ROOT / "tests" / "vectors"
CODECS = sorted(p.stem for p in VEC_DIR.glob("*.json"))
# bytes a port blob file adds to the reference's: the two pickled class
# modules' names
NAME_GROWTH = sum(len(f"repro_torch.core.{m}") - len(f"repro.core.{m}")
                  for m in ("api", "format"))
TIMEOUT = 600

# example -> (flags, check lines its reference prints, runs through main())
EXAMPLES = {
    "torch_quickstart.py": ([], [
        "engine [CODAG  warp-unit, all-thread  ] decode OK",
        "engine [RAPIDS block-unit, single-thr.] decode OK",
        "plain PyTorch twin (backend='torch', CPU) decode OK"], True),
    "torch_compressed_checkpoint.py": ([], [
        "restore bit-exact OK", "43 leaves codec-compressed, mean stored "
        "ratio 0.212"], True),
    "torch_streaming_restore.py": ([], [
        "(over budget: True)", "12 backend fetches", "12 released + 0 "
        "evicted, 0 B resident at the end", "ms of I/O hidden behind "
        "decode"], True),
    "torch_serve_lm.py": ([], ["--arch zamba2-2.7b --preset tiny --batch 4 "
                               "--prompt-len 32 --gen 16 --device cpu",
                               "decode:  4x16 in", "sample tokens:"], False),
    "torch_train_lm.py": (["--preset", "tiny", "--steps", "2"], [
        "--arch olmo-1b --preset tiny --steps 2 --batch 4 --seq 256",
        "--codec rle_v2 --device cpu", "done: 2 steps in", "loss: first10="],
        False),
}
VENEERS = [name for name, (_, _, via_main) in EXAMPLES.items()
           if not via_main]
# an example with a main(): run it, then write what it returned as JSON
RUNNER = ("import json, runpy, sys; path, out = sys.argv[1:3]; "
          "got = runpy.run_path(path)['main'](sys.argv[3:]); "
          "open(out, 'w').write(json.dumps(got))")


def _load(relpath: str):
    path = ROOT / relpath
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """Every example and the registry gate, each in a subprocess on the
    CPU, all started at once; a test waits for its own."""
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    jobs = {name: ([sys.executable, "-c", RUNNER,
                    str(ROOT / "examples" / name), str(tmp / f"{name}.json")]
                   if via_main else
                   [sys.executable, str(ROOT / "examples" / name)])
            + ["--device", "cpu", *flags]
            for name, (flags, _, via_main) in EXAMPLES.items()}
    jobs["torch_check_registry.py"] = [
        sys.executable, str(ROOT / "scripts" / "torch_check_registry.py"),
        "--device", "cpu"]
    for name in VENEERS:           # no --device: the card, which is absent
        jobs[f"{name} --device cuda"] = [
            sys.executable, str(ROOT / "examples" / name)]
    procs = {}
    for name, cmd in jobs.items():
        out = open(tmp / f"{name}.out", "w+")
        err = open(tmp / f"{name}.err", "w+")
        procs[name] = (subprocess.Popen(cmd, stdout=out, stderr=err, env=env,
                                        cwd=tmp, text=True), out, err)

    def result(name: str):
        proc, out, err = procs[name]
        rc = proc.wait(timeout=TIMEOUT)
        out.seek(0)
        err.seek(0)
        ret = tmp / f"{name}.json"
        return (rc, out.read(), err.read(),
                json.loads(ret.read_text()) if ret.exists() else None)

    yield result
    for proc, out, err in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()


# --------------------------------------------------------------------------
# the golden-vector generator
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = tmp_path_factory.mktemp("vectors")
    assert _load("scripts/torch_make_vectors.py").main(["--out",
                                                        str(out)]) == 0
    return out


def test_the_committed_vectors_are_the_seven_codecs():
    assert CODECS == sorted(registry.names()) and len(CODECS) == 7


@pytest.mark.parametrize("codec", CODECS)
def test_make_vectors_writes_the_committed_bytes(written, codec):
    assert sorted(p.name for p in written.iterdir()) == \
        [f"{c}.json" for c in CODECS]
    assert (written / f"{codec}.json").read_bytes() == \
        (VEC_DIR / f"{codec}.json").read_bytes()


def test_make_vectors_refuses_the_committed_directory(monkeypatch, capsys):
    before = {p.name: p.read_bytes() for p in VEC_DIR.iterdir()}
    stamps = {p.name: p.stat().st_mtime_ns for p in VEC_DIR.iterdir()}
    script = _load("scripts/torch_make_vectors.py")
    monkeypatch.chdir(ROOT)
    for out in ("tests/vectors", str(VEC_DIR), "tests/../tests/vectors"):
        assert script.main(["--out", out]) == 2
        assert "refusing to write" in capsys.readouterr().err
    assert {p.name: p.read_bytes() for p in VEC_DIR.iterdir()} == before
    assert {p.name: p.stat().st_mtime_ns for p in VEC_DIR.iterdir()} == \
        stamps


# --------------------------------------------------------------------------
# the registry gate
# --------------------------------------------------------------------------


def test_registry_gate_builtins_are_the_format_codec_names():
    gate = _load("scripts/torch_check_registry.py")
    assert gate.BUILTINS == (fmt.RLE_V1, fmt.RLE_V2, fmt.TDEFLATE,
                             fmt.BITPACK, fmt.DBP, fmt.HUFFMAN, fmt.LZSS)
    assert gate.BUILTINS == tuple(registry._PLUGINS)
    assert sorted(gate.matrix_codecs()) == sorted(registry.names())


def test_registry_gate_passes_on_the_cpu(runs):
    rc, out, err, _ = runs("torch_check_registry.py")
    assert rc == 0, err[-4000:]
    assert out.splitlines()[-1] == f"registry complete: {CODECS}"


@pytest.mark.parametrize("entry", [
    "examples/torch_quickstart.py", "examples/torch_compressed_checkpoint.py",
    "examples/torch_streaming_restore.py", "scripts/torch_check_registry.py"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        _load(entry).main([])


@pytest.mark.parametrize("veneer", VENEERS)
def test_veneers_default_to_the_card_and_fail_without_one(runs, veneer):
    """With no ``--device`` the driver asks for the card, raises, and the
    veneer exits with its code."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    rc, out, err, _ = runs(f"{veneer} --device cuda")
    assert rc != 0
    assert "--device cuda" in out.splitlines()[0]
    assert "no CUDA device is available" in err


def test_registry_gate_names_what_an_extra_codec_lacks(capsys):
    """A codec registered nowhere else fails the gate three times over,
    each problem named; the registry is restored afterwards."""
    gate = _load("scripts/torch_check_registry.py")
    extra = dataclasses.replace(registry.get("rle_v2"), name="rle_v2_extra")
    registry.register(extra)
    try:
        assert gate.main(["--device", "cpu"]) == 1
    finally:
        del registry._REGISTRY["rle_v2_extra"]
    assert sorted(registry.names()) == CODECS
    failed = [line for line in capsys.readouterr().err.splitlines()
              if line.startswith("REGISTRY CHECK FAILED: ")]
    assert len(failed) == 3, failed
    matrix, vectors, tuned = failed
    assert "tests/test_torch_codecs.py ALL_CODECS: missing codec(s) " \
        "['rle_v2_extra']" in matrix
    assert "rle_v2_extra: no golden vectors at" in vectors
    assert "rle_v2_extra: missing from tuned-defaults table" in tuned


# --------------------------------------------------------------------------
# the examples: the in-process reference work first, while the
# subprocesses run
# --------------------------------------------------------------------------


def _reference_paging(state) -> tuple:
    """The reference example's paging: the same save, host budget and
    delayed backend, and its overlapped restore's store counters."""
    with tempfile.TemporaryDirectory() as d:
        rck.save(d, 1, state, codec="rle_v2")
        comp = sum(p.stat().st_size for p in Path(d, "step_1").glob("*"))
        with ref_bs.filesystem_store(d, host_budget_bytes=comp // 2,
                                     read_delay_s=0.005) as store:
            got = rck.restore(d, 1, state, store=store, decode_window=3,
                              prefetch_windows=1)
            s = store.stats()
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)
    return s.backend_fetches, s.backend_bytes_fetched


def test_streaming_restore_pages_as_the_reference(runs):
    state = _load("examples/torch_streaming_restore.py").make_state()
    fetches, fetched = _reference_paging(state)
    rc, out, err, got = runs("torch_streaming_restore.py")
    assert rc == 0, err[-4000:]
    assert got["backend_fetches"] == fetches == len(state)
    assert got["backend_bytes_fetched"] == fetched + fetches * NAME_GROWTH


def test_checkpoint_manifest_equals_the_reference():
    """The reference's reduced qwen3-1.7B parameters and int8-moment AdamW
    state, saved by each package with rle_v2: the same compressed leaves
    with the same stored ratios (and the port's restore bit-exact)."""
    example = _load("examples/torch_compressed_checkpoint.py")
    rparams = rmodel.init_params(rreduced(rget_arch("qwen3-1.7b")),
                                 jax.random.key(0))
    rstate = {"params": rparams, "opt": radamw.init(
        rparams, radamw.AdamWConfig(compress_moments=True))}
    params = model.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                     "cpu")
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        rck.save(a, 100, rstate, codec="rle_v2")
        want = json.loads(Path(a, "step_100", "manifest.json").read_text())
        got = example.save_and_restore(
            example.make_state(params), b,
            CodagEngine(EngineConfig(device="cpu")))

    def compressed(man):
        return {k: e["ratio"] for k, e in man["leaves"].items()
                if e["codec"] != "none"}

    assert compressed(got) == compressed(want)
    assert len(compressed(got)) == 43
    assert got == want


@pytest.mark.parametrize("example", list(EXAMPLES))
def test_the_port_examples_run_on_the_cpu(runs, example):
    """Each example ends "OK" after the check lines its reference prints
    (the veneers: the driver's flags and its report)."""
    rc, out, err, _ = runs(example)
    assert rc == 0, err[-4000:]
    lines = out.splitlines()
    assert lines[-1] == "OK"
    for want in EXAMPLES[example][1]:
        assert any(want in line for line in lines), (want, out)


def test_quickstart_sizes_equal_the_reference(runs):
    quick = _load("examples/torch_quickstart.py")
    column = quick.make_column()
    rc, out, err, got = runs("torch_quickstart.py")
    assert rc == 0, err[-4000:]
    want = {codec: ref_api.compress(column, codec).compressed_bytes
            for codec in quick.CODECS}
    assert got["sizes"] == want
    for codec, nbytes in want.items():
        assert (f"{codec:9s}: {column.nbytes/1e6:6.2f} MB -> "
                f"{nbytes/1e6:6.3f} MB") in out
