"""The port's decode bodies and kernel wrapper against the reference.

Every port backend (``torch``, ``oracle``, ``scalar``, and ``cuda``, which
on a CPU tensor runs its plain version) must equal the reference's ``xla``
and ``oracle`` backends bit for bit, for rle_v1 and rle_v2 at widths
1/2/4, on tables holding the edge rows the CUDA kernel must get right: an
empty chunk, a one-element tail, a 16386-long run, delta wraparound and
literal runs at odd byte offsets.  Two tiny cases also run the reference's
Pallas kernel in interpret mode.  The inputs come from a numpy seed.
"""
import numpy as np
import pytest
import torch

from repro.core import encoders as ref_enc
from repro.core import format as ref_fmt
from repro.core import streams as ref_st
from repro.kernels import ops as ref_ops
from repro.kernels.harness import Epilogue as RefEpilogue
from repro_torch.core import encoders as enc
from repro_torch.core import format as fmt
from repro_torch.core import streams as st
from repro_torch.kernels import cuda_build, cuda_rle, harness, ops

CODECS = ("rle_v1", "rle_v2")
WIDTHS = (1, 2, 4)
DT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _runs(rng, n, dtype, top=50, max_run=40):
    vals = rng.integers(0, top, max(4, n // 10)).astype(dtype)
    return np.resize(np.repeat(vals, rng.integers(1, max_run, len(vals))), n)


def _edge_arrays(width, chunk_elems, seed=0):
    rng = np.random.default_rng(seed)
    dt = DT[width]
    top = 1 << (8 * width)
    odd = np.concatenate([
        np.concatenate([rng.integers(0, top, 5, dtype=np.uint64).astype(dt),
                        np.full(3, 7, dt)]) for _ in range(40)])
    wrap = ((top - 20 + 7 * np.arange(300, dtype=np.int64)) % top).astype(dt)
    return [
        _runs(rng, 3 * chunk_elems, dt),              # plain runs + literals
        np.zeros(0, dt),                              # an empty chunk
        _runs(rng, chunk_elems + 1, dt),              # a one-element tail
        wrap,                                         # delta wraparound
        odd,                                          # literals at odd offsets
        rng.integers(0, top, 2 * chunk_elems, dtype=np.uint64).astype(dt),
    ]


def _table(codec, width, arrays, chunk_bytes):
    ours = fmt.concat_blobs([fmt.blob_from_reference(
        ref_fmt.dataclasses.asdict(ref_enc.compress(a, codec, chunk_bytes)))
        for a in arrays])
    return ours


def _reference(table, codec, backend, **kw):
    """The reference package's decode of a port table (same bytes)."""
    ref_blob = ref_fmt.CompressedBlob(**ref_fmt.dataclasses.asdict(table))
    out = ref_ops.decode(ref_blob.to_device(), codec=codec, width=table.width,
                         chunk_elems=table.chunk_elems, backend=backend, **kw)
    return np.asarray(out)


def _ours(table, codec, backend, epilogue=None, extra=None):
    dev = {**fmt.to_device(table, "cpu"), **(extra or {})}
    return ops.decode(dev, codec=codec, width=table.width,
                      chunk_elems=table.chunk_elems, backend=backend,
                      epilogue=epilogue).numpy()


# --------------------------------------------------------------------------
# stream reads
# --------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_stream_reads_match_reference(width):
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, 40, dtype=np.uint8)
    pos = np.array([0, 1, 5, 17, 36, 37, 38, 39, 40, 90], np.int32)
    t_data, t_pos = torch.from_numpy(data), torch.from_numpy(pos.astype(np.int64))
    assert np.array_equal(st.read_byte_at(t_data, t_pos).numpy(),
                          np.asarray(ref_st.read_byte_at(data, pos)))
    want = np.asarray(ref_st.gather_values(data, pos, width))
    assert np.array_equal(st.gather_values(t_data, t_pos, width).numpy(), want)
    for p in pos:
        got = st.read_value_at(t_data, torch.tensor(int(p)), width)
        assert int(got) == int(ref_st.read_value_at(data, int(p), width))
    # a table: each row clamps to its own last byte
    table = torch.from_numpy(np.stack([data, data[::-1].copy()]))
    rows = torch.from_numpy(np.stack([pos, pos[::-1].copy()]).astype(np.int64))
    got = st.gather_values(table, rows, width).numpy()
    assert np.array_equal(got[0], want)
    assert np.array_equal(
        got[1], np.asarray(ref_st.gather_values(data[::-1].copy(),
                                                pos[::-1].copy(), width)))


# --------------------------------------------------------------------------
# bodies vs the reference backends
# --------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("codec", CODECS)
def test_bodies_equal_reference_on_edge_rows(codec, width):
    table = _table(codec, width, _edge_arrays(width, 256), 256 * width)
    want = _reference(table, codec, "xla")
    assert np.array_equal(_reference(table, codec, "oracle"), want)
    for backend in ("torch", "cuda", "oracle", "scalar"):
        got = _ours(table, codec, backend)
        assert got.dtype == want.dtype, backend
        assert np.array_equal(got, want), backend
    # and the decode is the input
    assert 0 in table.out_lens and 1 in table.out_lens
    flat = np.concatenate(_edge_arrays(width, 256))
    rows = [want[i, :n] for i, n in enumerate(table.out_lens)]
    assert np.array_equal(np.concatenate(rows), flat)


@pytest.mark.parametrize("width", WIDTHS)
def test_long_run_16386(width):
    """rle_v2's longest group, a 16386-element run, inside one chunk."""
    arr = np.concatenate([np.full(16386, 9, DT[width]),
                          np.arange(5, dtype=DT[width])])
    table = _table("rle_v2", width, [arr], 16400 * width)
    assert table.comp[0, 0] >> 6 == 3              # a long-run header
    want = _reference(table, "rle_v2", "xla")
    for backend in ("torch", "cuda", "oracle"):
        assert np.array_equal(_ours(table, "rle_v2", backend), want), backend
    assert np.array_equal(want[0, :arr.size], arr)


@pytest.mark.parametrize("codec,width", [("rle_v1", 1), ("rle_v2", 4)])
def test_plain_kernel_version_equals_reference_pallas(codec, width):
    """Two tiny cases against the reference's Pallas kernel (interpret)."""
    rng = np.random.default_rng(11)
    arrays = [_runs(rng, 100, DT[width]), np.zeros(0, DT[width])]
    table = _table(codec, width, arrays, 64 * width)
    want = _reference(table, codec, "pallas", interpret=True)
    assert np.array_equal(_ours(table, codec, "cuda"), want)


def test_group_cap_extends_last_group_as_reference():
    """With more groups than ``max_groups`` the reference's lane->group map
    gives the lanes past the last parsed group to that group; the plain
    body (the kernel's twin) does the same."""
    # 200 alternating literal singles: 200 groups in a 16-element chunk
    comp = np.zeros((1, 512), np.uint8)
    comp[0, 0:400:2] = 255                         # rle_v1: 1 literal
    comp[0, 1:400:2] = np.arange(200) % 256
    table = fmt.CompressedBlob(
        codec="rle_v1", width=1, chunk_elems=16, total_elems=16,
        orig_dtype="uint8", orig_shape=(16,), comp=comp,
        comp_lens=np.array([400], np.int32), out_lens=np.array([16], np.int32))
    want = _reference(table, "rle_v1", "xla")
    assert np.array_equal(_ours(table, "rle_v1", "cuda"), want)


# --------------------------------------------------------------------------
# the kernel's 32-group batches and shared ring (hand-built rows)
# --------------------------------------------------------------------------

RING_OFFSETS = (512, 1024, 4096)


def _hand_table(codec, width, rows, chunk_elems):
    """One blob a row (bytes), each out_len its element count."""
    return fmt.concat_blobs([fmt.CompressedBlob(
        codec=codec, width=width, chunk_elems=chunk_elems, total_elems=n,
        orig_dtype=str(np.dtype(DT[width])), orig_shape=(n,),
        comp=np.frombuffer(row, np.uint8)[None].copy(),
        comp_lens=np.array([len(row)], np.int32),
        out_lens=np.array([n], np.int32)) for row, n in rows])


def _ring_rows(codec, width):
    """A header, a run value or a literal group across each ring offset,
    then 40 short groups; and 50 runs of 3 elements back to back."""
    rng = np.random.default_rng(width)
    v = lambda n: rng.integers(0, 1 << (8 * width), n,  # noqa: E731
                               dtype=np.uint64)
    if codec == "rle_v1":
        kinds = [(1, [("run", 5, 77)]), (3, [("lit", v(128))])]
        tail = [("run", 3, x) for x in v(20)] + [("lit", v(1))] * 20
        threes = [("run", 3, x) for x in v(50)]
    elif codec == "rle_v2":
        kinds = [(1, [("long", 1000, 5)]), (width, [("delta", 20, 9, 3)]),
                 (5, [("lit", v(64))])]
        tail = [("run", 3, x) for x in v(20)] + [("lit", v(1))] * 20
        threes = [("run", 3, x) for x in v(50)]
    else:
        kinds = [(1, [("dbp", 13, 7, v(100) % 8192)]),
                 (3 + width, [("dbp", 32, 7, v(256))])]
        tail = threes = [("dbp", 2, x, [1, 2, 3]) for x in v(50)]
    groups = [[("fill", o - back)] + g + tail
              for o in RING_OFFSETS for back, g in kinds] + [threes]
    return [enc.encode_rle_groups(codec, g, width) for g in groups]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("codec", ["rle_v1", "rle_v2", "dbp"])
def test_ring_and_batch_rows_equal_reference(codec, width):
    """Groups across the 512-, 1,024- and 4,096-byte offsets, and 50 runs
    of 3 elements, through every port body and the reference."""
    rows = _ring_rows(codec, width)
    table = _hand_table(codec, width, [(r, len(w)) for r, w in rows], 8192)
    want = _reference(table, codec, "xla")
    assert np.array_equal(_reference(table, codec, "oracle"), want)
    for backend in ("torch", "cuda", "oracle", "scalar"):
        assert np.array_equal(_ours(table, codec, backend), want), backend
    for i, (_, vals) in enumerate(rows):
        assert np.array_equal(want[i, :len(vals)], vals.astype(DT[width]))


@pytest.mark.parametrize("chunk,cap", [(56, 32), (58, 33)])
@pytest.mark.parametrize("codec", ["rle_v1", "rle_v2"])
def test_group_cap_lands_at_the_batch_edge(codec, chunk, cap):
    """The ``max_groups`` cap at group 32 (the last of the kernel's first
    batch) and 33 (the first of its second): the last admitted group covers
    every lane up to out_len, as the reference's lane->group map does."""
    from repro_torch.kernels import rle_v1, rle_v2
    spec = {"rle_v1": rle_v1, "rle_v2": rle_v2}[codec]
    assert spec.max_groups(chunk) == cap
    rng = np.random.default_rng(chunk)
    comp = rng.integers(0, 256, (3, 200, 2)).astype(np.uint8)
    comp[:, :, 0] = 255 if codec == "rle_v1" else 2 << 6   # one literal
    table = fmt.CompressedBlob(
        codec=codec, width=1, chunk_elems=chunk, total_elems=3 * chunk,
        orig_dtype="uint8", orig_shape=(3 * chunk,), comp=comp.reshape(3, -1),
        comp_lens=np.full(3, 400, np.int32),
        out_lens=np.array([chunk, cap + 1, cap - 1], np.int32))
    want = _reference(table, codec, "xla")
    assert np.array_equal(_ours(table, codec, "cuda"), want)
    assert np.array_equal(_ours(table, codec, "torch"), want)
    # past the cap, the last group's literal offset keeps counting: lane
    # cap reads the next group's header byte
    assert want[0, cap - 1] == comp[0, cap - 1, 1]
    assert want[0, cap] == comp[0, cap, 0]


@pytest.mark.parametrize("width", WIDTHS)
def test_dbp_wide_and_malformed_groups_equal_reference(width):
    """A group of 256 32-bit fields; groups no encoder writes: 256 fields
    of 40 bits, and of 255 bits whose payload runs past the row's end."""
    rng = np.random.default_rng(width)
    wide, vals = enc.encode_rle_groups(
        "dbp", [("dbp", 32, 5, rng.integers(0, 1 << 32, 256,
                                            dtype=np.uint64))], width)
    rows = [(wide, 256)]
    for bits, nbytes in ((40, 1400), (255, 900)):
        rows.append((bytes([bits, 255]) + bytes(
            rng.integers(0, 256, width + nbytes, dtype=np.uint8)), 300))
    table = _hand_table("dbp", width, rows, 512)
    want = _reference(table, "dbp", "xla")
    for backend in ("torch", "cuda"):
        assert np.array_equal(_ours(table, "dbp", backend), want), backend
    assert np.array_equal(want[0, :256], vals.astype(DT[width]))


# --------------------------------------------------------------------------
# epilogue
# --------------------------------------------------------------------------

EPILOGUES = [
    ("view_int8", dict(view_dtype="int8"), {}),
    ("widen_int32", dict(out_dtype="int32"), {}),
    ("dequant_f32", dict(out_dtype="float32", scale_key="s", zero_key="z"),
     {"s": np.float32(0.173), "z": np.uint8(3)}),
    ("zero_only", dict(zero_key="z"), {"z": np.uint8(100)}),
]


@pytest.mark.parametrize("name,kw,operands", EPILOGUES,
                         ids=[e[0] for e in EPILOGUES])
def test_epilogue_matches_reference(name, kw, operands):
    rng = np.random.default_rng(13)
    table = _table("rle_v1", 1, [rng.integers(0, 256, 900).astype(np.uint8)],
                   256)
    ref_blob = ref_fmt.CompressedBlob(**ref_fmt.dataclasses.asdict(table))
    want = np.asarray(ref_ops.decode(
        {**ref_blob.to_device(), **operands}, codec="rle_v1", width=1,
        chunk_elems=table.chunk_elems, backend="xla",
        epilogue=RefEpilogue(**kw)))
    extra = {k: torch.from_numpy(np.asarray(v)) for k, v in operands.items()}
    got = _ours(table, "rle_v1", "torch", harness.Epilogue(**kw), extra)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)      # same op order: exact


def test_epilogue_fn_runs_last():
    table = _table("rle_v2", 4, [np.arange(50, dtype=np.uint32)], 512)
    epi = harness.Epilogue(out_dtype="int64", fn=lambda out, dev: out * 2)
    got = _ours(table, "rle_v2", "torch", epi)
    assert np.array_equal(got[0, :50], 2 * np.arange(50))


# --------------------------------------------------------------------------
# the kernel wrapper
# --------------------------------------------------------------------------


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    table = _table("rle_v2", 2, _edge_arrays(2, 128), 256)
    dev = fmt.to_device(table, "cpu")
    before = (cuda_rle.LAUNCHES, dict(cuda_rle.CODEC_LAUNCHES))
    got = cuda_rle.decode("rle_v2", dev["comp"], dev["out_lens"],
                          chunk_elems=128, width=2)
    plain = cuda_rle.plain("rle_v2", dev["comp"], dev["out_lens"],
                           chunk_elems=128, width=2)
    assert torch.equal(got, plain) and got.dtype == torch.uint16
    assert (cuda_rle.LAUNCHES, cuda_rle.CODEC_LAUNCHES) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "lens_dtype", "contig",
                                 "codec", "width"])
def test_wrapper_checks_its_inputs(bad):
    comp = torch.zeros((3, 128), dtype=torch.uint8)
    lens = torch.zeros(3, dtype=torch.int32)
    codec, width = "rle_v1", 4
    if bad == "dtype":
        comp = comp.to(torch.int32)
    elif bad == "shape":
        comp = comp.reshape(-1)
    elif bad == "lens_dtype":
        lens = lens.to(torch.int64)
    elif bad == "contig":
        comp = torch.zeros((128, 3), dtype=torch.uint8).t()
    elif bad == "codec":
        codec = "tdeflate"
    else:
        width = 8
    with pytest.raises(ValueError):
        cuda_rle.decode(codec, comp, lens, chunk_elems=32, width=width)


def test_kernel_build_is_lazy():
    """Importing the wrapper built nothing: no nvcc here, and none needed."""
    assert not cuda_rle.LIB.loaded
    assert cuda_rle.LIB.source.exists()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


def test_scalar_backend_refuses_card_tensors():
    table = _table("rle_v1", 1, [np.arange(10, dtype=np.uint8)], 64)
    dev = fmt.to_device(table, "cpu")
    dev["comp"] = dev["comp"].to("meta")
    with pytest.raises(NotImplementedError, match="all_thread=False"):
        ops.decode(dev, codec="rle_v1", width=1, chunk_elems=64,
                   backend="scalar")
