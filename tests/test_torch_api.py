"""The port's public path against the reference package and the inputs.

``api.compress_many`` -> ``api.decompress_many(device="cpu")``, host and
device out, must equal the reference's host ``decompress_many`` and the
numpy inputs bit for bit, including a reference-encoded blob carried across
with ``blob_from_reference`` and 64-bit plane-split columns.  Plus: the
epilogue against the reference's, the plane-split epilogue refusal, block
unit == warp unit, one dispatch per plan group, the one-dispatch-site gate,
the transfer funnel, and the refusal to fall back to the CPU without a card.
"""
import ast
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core.engine import CodagEngine as RefEngine
from repro.core.engine import EngineConfig as RefConfig
from repro.kernels.harness import Epilogue as RefEpilogue
from repro_torch.core import api, engine as engine_mod, format as fmt
from repro_torch.core import plan as plan_mod, registry, transfers
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.kernels import harness, ops

CPU = CodagEngine(EngineConfig(device="cpu"))
REF = RefEngine(RefConfig())
CHUNK = 512


def _columns(seed=0):
    """A small table scan: (array, codec) pairs."""
    rng = np.random.default_rng(seed)

    def runs(n, dtype, top, max_run):
        vals = rng.integers(0, top, n // 8 + 1).astype(dtype)
        return np.resize(np.repeat(vals, rng.integers(1, max_run, len(vals))), n)

    ts = np.int64(1_700_000_000_000_000_000) + np.cumsum(
        np.repeat(rng.choice([0, 1000, 5000], 30), 40))
    u64 = rng.integers(0, 1 << 63, 300, dtype=np.uint64) | np.uint64(1 << 63)
    return [
        (runs(900, np.uint32, 1000, 60), "rle_v1"),
        ((np.int64(1 << 20) + np.cumsum(np.repeat(rng.integers(-5, 6, 9), 100)))
         .astype(np.int32).reshape(30, 30), "rle_v2"),
        (runs(777, np.float32, 50, 30) * np.float32(0.5), "rle_v1"),
        (runs(3000, np.uint8, 4, 200), "rle_v2"),
        (runs(1500, np.uint16, 1000, 50), "rle_v1"),
        (ts, "rle_v2"),
        (np.repeat(u64, 3), "rle_v1"),
        (rng.normal(size=200), "rle_v2"),                 # float64 planes
    ]


def _equal(got, want):
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("device_out", [False, True])
def test_decompress_many_equals_reference_and_inputs(device_out):
    cols = _columns()
    cas = api.compress_many([a for a, _ in cols], [c for _, c in cols], CHUNK)
    ref_cas = ref_api.compress_many([a for a, _ in cols],
                                    [c for _, c in cols], CHUNK)
    # the reference decodes the reference's encoding; the port decodes its own
    ref_outs = ref_api.decompress_many(ref_cas, REF)
    outs = api.decompress_many(cas, device=torch.device("cpu"),
                               device_out=device_out)
    for (a, _), o, r in zip(cols, outs, ref_outs):
        if device_out:
            assert isinstance(o, torch.Tensor) and o.device.type == "cpu"
            o = o.numpy()
        _equal(o, a)
        _equal(o, r)
    for ca, rca in zip(cas, ref_cas):
        assert [fmt.blob_digest(b) for b in ca.blobs] == \
               [fmt.blob_digest(fmt.blob_from_reference(dataclasses.asdict(b)))
                for b in rca.blobs]


def test_reference_blob_carried_across_decodes_on_device_path():
    cols = _columns(1)
    ref_cas = ref_api.compress_many([a for a, _ in cols],
                                    [c for _, c in cols], CHUNK)
    cas = [api.CompressedArray(
        blobs=[fmt.blob_from_reference(dataclasses.asdict(b)) for b in rca.blobs],
        orig_dtype=rca.orig_dtype, orig_shape=rca.orig_shape) for rca in ref_cas]
    outs = api.decompress_many(cas, CPU, device_out=True)
    ref_outs = ref_api.decompress_many(ref_cas, REF)
    for (a, _), o, r in zip(cols, outs, ref_outs):
        _equal(o.numpy(), a)
        _equal(o.numpy(), r)


@pytest.mark.parametrize("device_out", [False, True])
def test_decompress_one_array(device_out):
    arr = _columns()[5][0]
    ca = api.compress(arr, "rle_v2", CHUNK)
    got = api.decompress(ca, CPU, device_out=device_out)
    _equal(got.numpy() if device_out else got, arr)
    _equal(np.asarray(ref_api.decompress(ref_api.compress(arr, "rle_v2", CHUNK),
                                         REF)), arr)


@pytest.mark.parametrize("backend", ["cuda", "torch", "oracle"])
def test_block_unit_equals_warp_unit(backend):
    cols = _columns(2)
    cas = api.compress_many([a for a, _ in cols], [c for _, c in cols], CHUNK)
    warp = CodagEngine(EngineConfig(unit="warp", backend=backend, device="cpu"))
    block = CodagEngine(EngineConfig(unit="block", n_units=3, backend=backend,
                                     device="cpu"))
    for w, b in zip(api.decompress_many(cas, warp, device_out=True),
                    api.decompress_many(cas, block, device_out=True)):
        assert torch.equal(w, b)


def test_single_thread_ablation_on_cpu():
    cols = _columns(3)[:2]
    cas = api.compress_many([a for a, _ in cols], [c for _, c in cols], CHUNK)
    eng = CodagEngine(EngineConfig(all_thread=False, device="cpu"))
    for (a, _), o in zip(cols, api.decompress_many(cas, eng)):
        _equal(o, a)


def test_one_dispatch_per_plan_group():
    cols = _columns()
    cas = api.compress_many([a for a, _ in cols], [c for _, c in cols], CHUNK)
    plan = plan_mod.DecodePlan.build([b for ca in cas for b in ca.blobs])
    keys = {fmt.group_key(b) for ca in cas for b in ca.blobs}
    assert plan.num_dispatches == len(keys) == 4
    for device_out in (False, True):
        with ops.count_dispatches() as calls:
            api.decompress_many(cas, CPU, device_out=device_out)
        assert len(calls) == plan.num_dispatches
        assert sum(c["num_chunks"] for c in calls) == plan.num_chunks
        assert {c["backend"] for c in calls} == {"cuda"}


# --------------------------------------------------------------------------
# epilogue
# --------------------------------------------------------------------------


def test_epilogue_matches_reference_device_path():
    rng = np.random.default_rng(4)
    arr = np.repeat(rng.integers(0, 16, 500).astype(np.uint8),
                    rng.integers(1, 9, 500))
    epi_kw = dict(out_dtype="float32", scale_key="s", zero_key="z")
    operands = {"s": np.float32(0.0625), "z": np.uint8(8)}
    [got] = api.decompress_many([api.compress(arr, "rle_v1", CHUNK)], CPU,
                                device_out=True,
                                epilogue=harness.Epilogue(**epi_kw),
                                epilogue_operands=operands)
    [want] = ref_api.decompress_many(
        [ref_api.compress(arr, "rle_v1", CHUNK)], REF, device_out=True,
        epilogue=RefEpilogue(**epi_kw), epilogue_operands=operands)
    want = np.asarray(want)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)          # same op order: exact
    assert np.array_equal(
        got.numpy(), (arr.astype(np.float32) - np.float32(8)) * np.float32(0.0625))


def test_epilogue_on_plane_split_array_raises():
    ca = api.compress(np.arange(100, dtype=np.int64), "rle_v2", CHUNK)
    assert len(ca.blobs) == 2
    with pytest.raises(ValueError, match="plane-decomposed"):
        api.decompress_many([ca], CPU, device_out=True,
                            epilogue=harness.Epilogue(out_dtype="float32"))


def test_epilogue_needs_device_out():
    ca = api.compress(np.arange(10, dtype=np.uint8), "rle_v1", CHUNK)
    with pytest.raises(ValueError, match="device_out"):
        api.decompress_many([ca], CPU, epilogue=harness.Epilogue(out_dtype="int32"))


# --------------------------------------------------------------------------
# device selection and the parts not ported yet
# --------------------------------------------------------------------------


def test_no_device_means_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    ca = api.compress(np.arange(10, dtype=np.uint8), "rle_v1", CHUNK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decompress_many([ca], device_out=True)
    # the service path raises in the caller's thread, before any future
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decompress_many([ca])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decompress(ca)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CodagEngine()


def test_engine_and_device_must_agree():
    ca = api.compress(np.arange(10, dtype=np.uint8), "rle_v1", CHUNK)
    with pytest.raises(ValueError, match="engine decodes on"):
        api.decompress_many([ca], CPU, device="meta")


@pytest.mark.parametrize("kw", [{"mesh": None}, {"out_shardings": None}])
def test_unported_paths_raise(kw):
    """``mesh=`` and ``out_shardings=`` run on a mesh whose members share
    one device (``tests/test_torch_sharded.py``) and on a mesh over a
    world's ranks (``tests/test_torch_spmd_decode.py``); over distinct
    devices in one process they raise, pointing to ``launch.mesh.spawn``."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    spread = mesh_lib.Mesh([torch.device("cpu"), torch.device("meta")],
                           ("data",))
    kw = {"mesh": spread} if "mesh" in kw else \
        {"out_shardings": sharding.NamedSharding(spread, sharding.P())}
    ca = api.compress(np.arange(1000, dtype=np.uint32), "rle_v2", CHUNK)
    with pytest.raises(NotImplementedError, match="launch.mesh.spawn"):
        api.decompress_many([ca], CPU, device_out=True, **kw)


def test_unported_codec_names_its_roadmap_item():
    """Every codec of the reference is ported now: all seven resolve, and an
    unknown name still raises, listing the registered ones."""
    names = ("rle_v1", "rle_v2", "tdeflate", "bitpack", "dbp", "huffman",
             "lzss")
    for name in names:
        assert registry.get(name).name == name
    with pytest.raises(ValueError, match="unknown codec") as err:
        registry.get("nope")
    assert all(name in str(err.value) for name in names)


# --------------------------------------------------------------------------
# the one dispatch site and the transfer funnel
# --------------------------------------------------------------------------


def _ops_decode_calls(module):
    """AST walk: calls to ops.decode in a module."""
    hits = []
    for node in ast.walk(ast.parse(inspect.getsource(module))):
        f = getattr(node, "func", None)
        if (isinstance(node, ast.Call) and isinstance(f, ast.Attribute)
                and f.attr == "decode" and isinstance(f.value, ast.Name)
                and f.value.id == "ops"):
            hits.append(f"{module.__name__}:{node.lineno}")
    return hits


def test_no_ops_decode_call_sites_outside_plan():
    for mod in (engine_mod, api):
        assert _ops_decode_calls(mod) == [], mod.__name__
    assert len(_ops_decode_calls(plan_mod)) == 1


def test_staged_plan_runs_without_host_transfers():
    cols = _columns(5)[:4]
    cas = api.compress_many([a for a, _ in cols], [c for _, c in cols], CHUNK)
    plan = plan_mod.DecodePlan.build([b for ca in cas for b in ca.blobs])
    with transfers.count_host_transfers() as c:
        plan.stage(CPU.device)
    assert c["h2d"] >= 3 * plan.num_dispatches and c["d2h"] == 0
    operands = {"z": np.uint8(1)}
    epi = harness.Epilogue(zero_key="z", out_dtype="int32")
    plan.execute_device(CPU, epilogue=epi, epilogue_operands=operands)
    with transfers.no_host_transfers():
        with transfers.count_host_transfers() as c:
            outs = plan.execute_device(CPU)
            plan.execute_device(CPU, epilogue=epi,
                                epilogue_operands=dict(operands))
        with pytest.raises(RuntimeError, match="no_host_transfers"):
            plan.execute(CPU)
    assert c == {"d2h": 0, "bytes": 0, "h2d": 0, "h2d_bytes": 0}
    for (a, _), o in zip(cols, outs):
        _equal(o.numpy(), a)
    with transfers.count_host_transfers() as c:
        plan.execute(CPU)
    assert c["d2h"] == plan.num_dispatches


# --------------------------------------------------------------------------
# the service path (engine-less host decodes) and staging
# --------------------------------------------------------------------------


def test_engine_less_host_decode_goes_through_the_default_service():
    """No engine and host output: the port's default service on the CPU
    and the reference's default service decode the same arrays with the
    same dispatches (one per group, one window), equal to the inputs."""
    from repro.kernels import ops as ref_ops
    from repro_torch.core import server

    cols = _columns(7)
    arrays, codecs = [a for a, _ in cols], [c for _, c in cols]
    cas = api.compress_many(arrays, codecs, CHUNK)
    ref_cas = ref_api.compress_many(arrays, codecs, CHUNK)
    svc = server.default_service("cpu")
    windows = svc.stats().windows
    with ops.count_dispatches() as calls:
        outs = api.decompress_many(cas, device="cpu")
    with ref_ops.count_dispatches() as ref_calls:
        ref_outs = ref_api.decompress_many(ref_cas)
    assert svc.stats().windows == windows + 1
    assert len(calls) == len(ref_calls) == plan_mod.DecodePlan.build(
        [b for ca in cas for b in ca.blobs]).num_dispatches
    for a, o, r in zip(arrays, outs, ref_outs):
        _equal(o, a)
        _equal(o, np.asarray(r))


@pytest.mark.parametrize("kw,match", [
    (dict(engine=CPU, service=object()), "engine= OR service="),
    (dict(device_out=True, epilogue=harness.Epilogue(out_dtype="int32")),
     "service path"),
    (dict(mesh=object()), "service path"),
])
def test_service_path_refusals(kw, match):
    """As in the reference: an engine with a service, and an epilogue or a
    mesh on the service path, raise ValueError."""
    from repro_torch.core import server
    kw = dict(kw)
    kw.setdefault("service", server.default_service("cpu"))
    ca = api.compress(np.arange(10, dtype=np.uint8), "rle_v1", CHUNK)
    with pytest.raises(ValueError, match=match):
        api.decompress_many([ca], **kw)


def test_staging_pads_once_and_counts_exactly():
    """``format.to_device`` stages comp padded to the 128-byte lane width
    (at least 8 zero bytes a row) in one copy; each array is one counted
    upload of its staged bytes: comp, comp_lens, out_lens, then extras."""
    cols = _columns(9)
    cas = api.compress_many([a for a, _ in cols], [c for _, c in cols], CHUNK)
    for blob in (b for ca in cas for b in ca.blobs):
        blob.comp.flags.writeable = False     # read-only input is copied
        with transfers.count_host_transfers() as c:
            dev = fmt.to_device(blob, "cpu")
        cols_want = -(-(blob.comp.shape[1] + 8) // 128) * 128
        want_bytes = (blob.num_chunks * cols_want + 8 * blob.num_chunks
                      + sum(v.nbytes for v in blob.extras.values()))
        assert c == {"d2h": 0, "bytes": 0, "h2d": 3 + len(blob.extras),
                     "h2d_bytes": want_bytes}
        comp = dev["comp"].numpy()
        assert comp.shape == (blob.num_chunks, cols_want)
        assert np.array_equal(comp[:, :blob.comp.shape[1]], blob.comp)
        assert not comp[:, blob.comp.shape[1]:].any()


def test_to_device_cols_refuses_to_cut_rows():
    a = np.ones((2, 5), np.uint8)
    for bad, cols in ((a, 4), (np.ones(5, np.uint8), 7)):
        with pytest.raises(ValueError, match="columns"):
            transfers.to_device(bad, "cpu", cols=cols)
    got = transfers.to_device(a, "cpu", cols=7).numpy()
    assert got.shape == (2, 7) and got[:, :5].all() and not got[:, 5:].any()


def test_to_device_rows_pads_the_first_axis_once():
    """``rows=`` appends zero rows (with ``cols=``, zero columns as well)
    in one counted upload of the padded shape; it never cuts rows."""
    a = np.arange(1, 11, dtype=np.int32).reshape(2, 5)
    with transfers.count_host_transfers() as c:
        got = transfers.to_device(a, "cpu", rows=4, cols=8).numpy()
        vec = transfers.to_device(a[:, 0], "cpu", rows=3).numpy()
    assert c["h2d"] == 2 and c["h2d_bytes"] == (4 * 8 + 3) * 4
    assert got.shape == (4, 8) and np.array_equal(got[:2, :5], a)
    assert not got[2:].any() and not got[:, 5:].any()
    assert np.array_equal(vec, [1, 6, 0])
    with pytest.raises(ValueError, match="rows"):
        transfers.to_device(a, "cpu", rows=1)
