"""The port's checkpoint (``repro_torch.checkpoint``) against the reference's,
on the CPU.

Each case of ``tests/test_checkpoint.py`` and the checkpoint cases of
``tests/test_store.py`` and ``tests/test_device_resident.py`` run on the
port with a CPU engine; where a case counts launches or store fetches, the
reference's restore of the same state runs beside it and the counts must
be equal.  Then the byte contract: the same state saved by both packages
gives the same ``manifest.json`` text, ``.npy`` bytes and blob fields, for
every codec, and the port restores every directory the reference wrote,
bf16 leaves included, in a process that never loads JAX or the reference.
"""
import dataclasses
import gc
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.core import store as ref_bs
from repro.kernels import ops as ref_ops
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import api, plan as plan_mod, registry, transfers
from repro_torch.core import server as srv
from repro_torch.core import store as bs
from repro_torch.core import tuning
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
CPU = CodagEngine(EngineConfig(device="cpu"))
CODECS = ("none", "rle_v2", "tdeflate", "bitpack")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": _t(rng.normal(size=(64, 32)).astype(np.float32)),
            "b": torch.arange(10, dtype=torch.int32),
            "nested": {"m": torch.ones(128) * 3}}


def _runs(n_layers, values, reps):
    return {f"layer{i}": _t(np.repeat(np.arange(values, dtype=np.int32),
                                      reps))
            for i in range(n_layers)}


def _assert_same(got, want):
    flat_g, flat_w = ckpt._flatten(got), ckpt._flatten(want)
    assert list(flat_g) == list(flat_w)
    for k in flat_w:
        g, w = flat_g[k], torch.as_tensor(flat_w[k])
        assert isinstance(g, torch.Tensor), (k, type(g))
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        assert torch.equal(g.cpu(), w.cpu()), k


def _np(state):
    """The same state as the reference's numpy leaves (bf16 through
    ml_dtypes)."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return jax.tree.map(conv, state)


# --------------------------------------------------------------------------
# tests/test_checkpoint.py
# --------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    s = _state()
    ckpt.save(str(tmp_path), 5, s)
    assert ckpt.latest_step(str(tmp_path)) == 5
    got = ckpt.restore(str(tmp_path), 5, s)
    _assert_same(got, s)
    assert all(t.device.type == "cpu" for t in ckpt._flatten(got).values())


def test_async_save(tmp_path):
    s = _state()
    t = ckpt.save(str(tmp_path), 1, s, async_=True)
    assert t is not None
    t.join(timeout=30)
    assert not t.is_alive()
    got = ckpt.restore(str(tmp_path), 1, s)
    assert torch.equal(got["w"], s["w"])


def test_async_save_snapshots_before_returning(tmp_path):
    """The host copy is taken in the calling thread: an in-place update
    after ``save`` returns does not reach the checkpoint."""
    s = _state()
    want = s["w"].clone()
    t = ckpt.save(str(tmp_path), 1, s, async_=True)
    s["w"].add_(1.0)
    t.join(timeout=30)
    assert torch.equal(ckpt.restore(str(tmp_path), 1, s)["w"], want)


@pytest.mark.parametrize("codec", ["rle_v2", "tdeflate"])
def test_compressed_checkpoint(tmp_path, codec):
    s = {"ints": _t(np.repeat(np.arange(50, dtype=np.int32), 40)),
         "f32": torch.ones(2048)}
    ckpt.save(str(tmp_path), 2, s, codec=codec)
    got = ckpt.restore(str(tmp_path), 2, s, engine=CPU)
    _assert_same(got, s)


def test_compressed_restore_is_batched(tmp_path):
    """Restoring N compressed tensors fuses one decode launch per codec
    group, every launch lowered through the plan; the reference's restore
    of the same state makes the same dispatches."""
    s = _runs(6, 40, 60)
    ckpt.save(str(tmp_path / "port"), 3, s, codec="rle_v2")
    ref_ckpt.save(str(tmp_path / "ref"), 3, _np(s), codec="rle_v2")
    for window, want in ((None, 1), (2, 3)):
        with plan_mod.count_lowered() as lowered, \
                ops.count_dispatches() as calls:
            got = ckpt.restore(str(tmp_path / "port"), 3, s, engine=CPU,
                               decode_window=window)
        _assert_same(got, s)
        with ref_ops.count_dispatches() as ref_calls:
            ref_ckpt.restore(str(tmp_path / "ref"), 3, _np(s),
                             decode_window=window)
        assert len(calls) == len(ref_calls) == want
        assert len(lowered) == len(calls)
        assert [c["num_chunks"] for c in calls] == \
            [c["num_chunks"] for c in ref_calls]


def test_restore_through_service(tmp_path):
    """restore(service=) decodes every compressed leaf through one
    DecompressionService: bit-exact, and all same-group leaves share one
    launch, issued by the service worker."""
    s = _runs(6, 40, 60)
    ckpt.save(str(tmp_path), 4, s, codec="rle_v2")
    with srv.DecompressionService(CPU, cache_bytes=0,
                                  bucket_shapes=False) as svc:
        with ops.count_dispatches() as calls:
            got = ckpt.restore(str(tmp_path), 4, s, service=svc)
        stats = svc.stats()
        _assert_same(ckpt.restore(str(tmp_path), 4, s, service=svc,
                                  device_out=True), s)
    _assert_same(got, s)
    assert len(calls) == 1
    assert stats.blobs == 6 and stats.dispatches == 1

    # engine= and service= pick different decode owners; both is an error
    with srv.DecompressionService(CPU) as svc2:
        with pytest.raises(ValueError, match="not both"):
            ckpt.restore(str(tmp_path), 4, s, service=svc2, engine=CPU)


def test_retention(tmp_path):
    s = _state()
    for step in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), step, s, keep=2)
    assert sorted(ckpt.all_steps(str(tmp_path))) == [4, 5]


def test_elastic_restore_names_its_roadmap_item(tmp_path):
    """The elastic restore (``shardings=``) runs on a mesh whose members
    share one device (``tests/test_torch_sharded.py``) and on a mesh over a
    world's ranks (``tests/test_torch_spmd_decode.py``); onto a mesh over
    distinct devices in one process it raises, pointing to
    ``launch.mesh.spawn``, on the decode path and on the placement
    path."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    s = _state()
    ckpt.save(str(tmp_path), 3, s, codec="rle_v2")
    spread = mesh_lib.Mesh([torch.device("cpu"), torch.device("meta")],
                           ("data",))
    shs = {k: sharding.NamedSharding(spread, sharding.P()) for k in s}
    for device_out in (False, True):
        with pytest.raises(NotImplementedError, match="launch.mesh.spawn"):
            ckpt.restore(str(tmp_path), 3, s, shardings=shs, engine=CPU,
                         device_out=device_out)


# --------------------------------------------------------------------------
# tests/test_store.py: streaming restore and regressions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["rle_v1", "rle_v2", "dbp", "bitpack",
                                   "tdeflate", "huffman", "lzss"])
def test_streaming_restore_bit_exact_every_codec(tmp_path, codec):
    """restore(store=) window-streams each codec's checkpoint bit-exactly
    against the plain restore, with the reference's store counts."""
    rng = np.random.default_rng(3)
    c = registry.get(codec)
    s = {"a": _t(c.demo_data(4096, rng)), "b": _t(c.demo_data(2048, rng)),
         "small": torch.arange(7, dtype=torch.int32)}  # stays uncompressed
    ckpt.save(str(tmp_path / "port"), 1, s, codec=codec)
    ref_ckpt.save(str(tmp_path / "ref"), 1, _np(s), codec=codec)
    plain = ckpt.restore(str(tmp_path / "port"), 1, s, engine=CPU)
    _assert_same(plain, s)
    with bs.filesystem_store(tmp_path / "port",
                             host_budget_bytes=1 << 20) as st:
        streamed = ckpt.restore(str(tmp_path / "port"), 1, s, store=st,
                                decode_window=1, engine=CPU)
        stats = st.stats()
    with ref_bs.filesystem_store(tmp_path / "ref",
                                 host_budget_bytes=1 << 20) as st:
        ref_ckpt.restore(str(tmp_path / "ref"), 1, _np(s), store=st,
                         decode_window=1)
        ref_stats = st.stats()
    assert stats.backend_fetches == ref_stats.backend_fetches >= 1
    _assert_same(streamed, plain)


def test_streaming_restore_exceeds_host_budget(tmp_path):
    """A checkpoint larger than the store's host budget restores anyway:
    windows page in, decode, and release under the watermark."""
    s = {f"l{i}": _t(np.repeat(np.arange(80, dtype=np.int32), 40))
         for i in range(6)}
    ckpt.save(str(tmp_path), 2, s, codec="rle_v2")
    blob_bytes = sum(p.stat().st_size
                     for p in (tmp_path / "step_2").glob("*.blob"))
    with bs.filesystem_store(tmp_path,
                             host_budget_bytes=blob_bytes // 2) as st:
        got = ckpt.restore(str(tmp_path), 2, s, store=st, decode_window=2,
                           engine=CPU)
        stats = st.stats()
    _assert_same(got, s)
    assert stats.backend_fetches == 6
    # every entry was demoted: by release (consumed windows) or by the
    # watermark racing ahead of it under the halved budget
    assert stats.host_released + stats.host_evictions == 6
    assert stats.host_bytes == 0 and stats.host_entries == 0


def test_restore_loads_blobs_lazily_per_window(tmp_path, monkeypatch):
    """Blob loads interleave with decode windows even without a store."""
    s = {f"l{i}": _t(np.repeat(np.arange(50, dtype=np.int32), 40))
         for i in range(6)}
    ckpt.save(str(tmp_path), 1, s, codec="rle_v2")

    events = []
    real_load = ckpt._load_blob
    monkeypatch.setattr(ckpt, "_load_blob",
                        lambda p: (events.append("load"), real_load(p))[1])
    real_many = api.decompress_many

    def spy_many(cas, *a, **kw):
        events.append("decode")
        return real_many(cas, *a, **kw)

    monkeypatch.setattr(api, "decompress_many", spy_many)
    got = ckpt.restore(str(tmp_path), 1, s, decode_window=2, engine=CPU)
    _assert_same(got, s)
    # 3 windows of 2: load, load, decode repeated, NOT all 6 loads up front
    first_decode = events.index("decode")
    assert events.count("load") == 6 and events.count("decode") == 3
    assert sum(1 for e in events[:first_decode] if e == "load") == 2


def test_all_steps_ignores_foreign_names(tmp_path):
    s = {"w": torch.ones(512)}
    ckpt.save(str(tmp_path), 3, s)
    (tmp_path / "step_final").mkdir()          # foreign dir
    (tmp_path / "step_7.tmp").mkdir()          # crashed save debris
    (tmp_path / "step_9").write_text("a file, not a checkpoint")
    assert ckpt.all_steps(str(tmp_path)) == [3]
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_retention_never_deletes_newer_steps(tmp_path):
    """An overlapped (slow) save of an OLDER step finishing last must not
    retire the newer checkpoint that published meanwhile."""
    s = {"w": torch.ones(512)}
    for step in (10, 11, 12):
        ckpt.save(str(tmp_path), step, s, keep=2)
    assert sorted(ckpt.all_steps(str(tmp_path))) == [11, 12]
    ckpt.save(str(tmp_path), 5, s, keep=1)
    steps = sorted(ckpt.all_steps(str(tmp_path)))
    assert 12 in steps and 11 in steps


def test_checkpoint_restore_device(tmp_path):
    """``device_out=True`` on a CPU engine: every leaf a tensor of its
    saved dtype on the engine's device, equal to the saved state, with no
    device->host crossing."""
    rng = np.random.default_rng(9)
    state = {"w": _t(rng.normal(size=(64, 64)).astype(np.float32)),
             "m": _t(rng.integers(0, 200, (128, 32)).astype(np.int32)),
             "small": torch.tensor(1.5, dtype=torch.float32)}
    ckpt.save(str(tmp_path), 3, state, codec="rle_v2")
    with transfers.count_host_transfers() as c:
        out = ckpt.restore(str(tmp_path), 3, state, device_out=True,
                           engine=CPU)
    assert c["d2h"] == 0
    _assert_same(out, state)


def test_restore_without_an_engine_needs_the_card(tmp_path):
    """A compressed restore with no engine decodes on the card and raises
    without one; an uncompressed host restore decodes nothing and needs
    none."""
    s = _runs(2, 40, 60)
    ckpt.save(str(tmp_path / "c"), 1, s, codec="rle_v2")
    ckpt.save(str(tmp_path / "u"), 1, s)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.restore(str(tmp_path / "c"), 1, s)
    _assert_same(ckpt.restore(str(tmp_path / "u"), 1, s), s)


# --------------------------------------------------------------------------
# the byte contract with the reference
# --------------------------------------------------------------------------


def _contract_state():
    """Dict keys given out of order, a list, a tuple, a 0-d leaf, bf16
    under and over 1 KiB, int8, int32, int64 (plane-decomposed by the RLE
    codecs), float32."""
    rng = np.random.default_rng(11)
    bf = lambda n: _t(rng.normal(size=n).astype(np.float32)).to(
        torch.bfloat16)
    return {
        "z": {"small_bf16": bf(8), "big_bf16": bf((32, 24))},
        "opt": [_t(rng.integers(-100, 100, 2000).astype(np.int8)),
                torch.tensor(7, dtype=torch.int32)],
        "a": (_t(np.repeat(np.arange(50, dtype=np.int32), 40)),
              _t(np.repeat(np.arange(30, dtype=np.int64) << 35, 20))),
        "f32": _t(rng.normal(size=700).astype(np.float32)),
    }


def _fields(blob):
    return {f.name: getattr(blob, f.name) for f in dataclasses.fields(blob)}


def _assert_equal_fields(got, want, where):
    assert got.keys() == want.keys(), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_equal_fields(g, w, (where, k))
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), (where, k)
        else:
            assert type(g) is type(w) and g == w, (where, k, g, w)


@pytest.mark.parametrize("codec", CODECS)
def test_save_writes_the_reference_directory(tmp_path, codec, monkeypatch):
    """The same state saved by both packages: equal ``manifest.json``
    text, equal file names, equal ``.npy`` bytes (bf16 under 1 KiB with the
    reference's ``<V2`` header) and equal blob fields."""
    monkeypatch.setattr(tuning, "device_kind", lambda: "cpu")
    s = _contract_state()
    ckpt.save(str(tmp_path / "port"), 1, s, codec=codec)
    ref_ckpt.save(str(tmp_path / "ref"), 1, _np(s), codec=codec)
    port, ref = tmp_path / "port" / "step_1", tmp_path / "ref" / "step_1"
    assert (port / "manifest.json").read_text() == \
        (ref / "manifest.json").read_text()
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(port)) == names
    n_blobs = 0
    for name in names:
        if name.endswith(".npy"):
            assert (port / name).read_bytes() == (ref / name).read_bytes()
        elif name.endswith(".blob"):
            n_blobs += 1
            with open(ref / name, "rb") as f:
                want = pickle.load(f)
            got = ckpt._load_blob(port / name)
            assert type(got) is api.CompressedArray
            assert (got.orig_dtype, tuple(got.orig_shape)) == \
                (want.orig_dtype, tuple(want.orig_shape))
            assert len(got.blobs) == len(want.blobs)
            for g, w in zip(got.blobs, want.blobs):
                _assert_equal_fields(_fields(g), _fields(w), name)
    assert n_blobs == (0 if codec == "none" else 5)


_RESTORE_REF_DIRS = """
import json, sys
import numpy as np, torch
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import store as bs
from repro_torch.core.engine import CodagEngine, EngineConfig
cpu = CodagEngine(EngineConfig(device="cpu"))
root = sys.argv[1]
like = json.loads(open(root + "/like.json").read())
want = {k: np.load(root + "/want/" + k.replace("/", "__") + ".npy")
        for k in ckpt._flatten(like)}
for d in sys.argv[2:]:
    outs = [ckpt.restore(d, 1, like, engine=cpu),
            ckpt.restore(d, 1, like, engine=cpu, device_out=True)]
    with bs.filesystem_store(d, host_budget_bytes=1 << 12) as st:
        outs.append(ckpt.restore(d, 1, like, engine=cpu, store=st,
                                 decode_window=2))
    for out in outs:
        for k, t in ckpt._flatten(out).items():
            got = t.reshape(-1).view(torch.uint8).numpy()
            assert np.array_equal(got, want[k].reshape(-1).view(np.uint8)), \\
                (d, k)
            assert list(t.shape) == list(want[k].shape), (d, k)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print("restored", len(sys.argv) - 2)
"""


def test_port_restores_reference_directories_without_jax(tmp_path):
    """The reference writes one directory per codec; a process that
    imports only the port restores each through ``_load_blob`` (host and
    ``device_out``) and through ``store=``, equal byte for byte to the
    saved leaves, and never loads JAX or the reference."""
    s = _contract_state()
    dirs = []
    for codec in CODECS:
        d = tmp_path / codec
        ref_ckpt.save(str(d), 1, _np(s), codec=codec)
        dirs.append(str(d))
    (tmp_path / "want").mkdir()
    for k, t in ckpt._flatten(s).items():
        bits = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
        np.save(tmp_path / "want" / (k.replace("/", "__") + ".npy"),
                bits.numpy())
    (tmp_path / "like.json").write_text(
        json.dumps(jax.tree.map(lambda _: 0, _np(s))))
    proc = subprocess.run(
        [sys.executable, "-c", _RESTORE_REF_DIRS, str(tmp_path), *dirs],
        capture_output=True, text=True, cwd=ROOT, timeout=300, check=False,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"restored {len(CODECS)}" in proc.stdout


def test_blob_unpickler_admits_blobs_only(tmp_path):
    """``_load_blob`` and the store's default loads construct compressed
    blobs and numpy arrays, and refuse any other class."""
    ca = api.compress(np.repeat(np.arange(9, dtype=np.uint32), 300),
                      "rle_v2", 1024)
    path = tmp_path / "x.blob"
    path.write_bytes(pickle.dumps(ca))
    got = ckpt._load_blob(path)
    _assert_equal_fields(_fields(got.blobs[0]), _fields(ca.blobs[0]), "x")
    path.write_bytes(pickle.dumps(gc.collect))
    with pytest.raises(pickle.UnpicklingError, match="not a compressed"):
        ckpt._load_blob(path)
    be = bs.MemoryBackend()
    be.put("evil", pickle.dumps(os.system))
    with bs.TieredBlobStore(be) as st:
        with pytest.raises(bs.StoreError, match="not a compressed"):
            st.get("evil")
