"""The frozen yardstick: the codec copies against the committed golden
vectors, their plain decoders, the Table IV generators, and the roofline's
byte count.  CPU only; nothing here imports the program."""
import base64
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from bench import blobs, roofline
from bench.data import table4
from bench.table import Column, Query, seed_stream, shares

ROOT = Path(__file__).resolve().parents[2]
CODECS = ("rle_v1", "rle_v2", "tdeflate")


def vectors(codec):
    with open(ROOT / "tests" / "vectors" / f"{codec}.json") as f:
        payload = json.load(f)
    assert payload["codec"] == codec
    return payload["vectors"]


def vector_array(vec):
    raw = base64.b64decode(vec["data_b64"])
    return np.frombuffer(raw, np.dtype(vec["dtype"])).reshape(vec["shape"])


def digest(blob: dict) -> str:
    """Content hash of a blob's fields (the golden vectors' ``blob_digest``
    formula)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{blob['codec']}|{blob['width']}|{blob['chunk_elems']}|"
             f"{blob['total_elems']}|{blob['orig_dtype']}|"
             f"{tuple(blob['orig_shape'])}".encode())
    h.update(np.ascontiguousarray(blob["comp_lens"], np.int64).tobytes())
    h.update(np.ascontiguousarray(blob["out_lens"], np.int64).tobytes())
    h.update(np.ascontiguousarray(blob["comp"]).tobytes())
    for k in sorted(blob["extras"]):
        v = np.ascontiguousarray(blob["extras"][k])
        h.update(f"|{k}|{v.dtype}|{v.shape}|".encode())
        h.update(v.tobytes())
    return h.hexdigest()


def encode(arr, codec, chunk_bytes):
    return [blobs.assemble(head, [blobs.encode_job((codec, head["width"], c))
                                  for c in chunks])
            for head, chunks in (blobs.chunk_jobs(a, codec, chunk_bytes)
                                 for a in blobs.planes(arr, codec))]


@pytest.mark.parametrize("codec", CODECS)
def test_frozen_encoder_matches_golden_vectors(codec):
    """Each frozen encoder writes, byte for byte, the blob the committed
    golden vector pins (its content digest and chunk count)."""
    for vec in vectors(codec):
        stored = encode(vector_array(vec), codec, vec["chunk_bytes"])
        assert len(stored) == 1, vec["name"]
        assert stored[0]["comp"].shape[0] == vec["num_chunks"], vec["name"]
        assert digest(stored[0]) == vec["blob_digest"], vec["name"]


@pytest.mark.parametrize("codec", CODECS)
def test_plain_decoder_round_trips_golden_inputs(codec):
    for vec in vectors(codec):
        arr = vector_array(vec)
        got = blobs.decode_plain(encode(arr, codec, vec["chunk_bytes"])[0])
        assert got.dtype == arr.dtype and np.array_equal(got, arr), \
            vec["name"]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dataset", sorted(table4.DTYPES))
def test_table4_column_round_trips(codec, dataset):
    """Every Table IV dataset under every codec: the stored arrays (two
    u32 planes for a 64-bit column under an RLE codec) decode and join
    back to the column."""
    arr = table4.make(dataset, seed_stream(7, 1), 2 * 4096)
    stored = encode(arr, codec, 4096)
    split = arr.dtype.itemsize == 8 and codec != "tdeflate"
    assert len(stored) == (2 if split else 1)
    parts = [blobs.decode_plain(b) for b in stored]
    got = blobs.join_planes(parts, str(arr.dtype))
    assert got.dtype == arr.dtype
    assert np.array_equal(got.view(np.uint8), arr.view(np.uint8))


@pytest.mark.parametrize("dataset", sorted(table4.DTYPES))
def test_table4_generators_are_seeded(dataset):
    a = table4.make(dataset, seed_stream(2**31 + 5, 3), 8192)
    b = table4.make(dataset, seed_stream(2**31 + 5, 3), 8192)
    c = table4.make(dataset, seed_stream(2**31 + 6, 3), 8192)
    assert a.nbytes == 8192 and a.dtype == table4.DTYPES[dataset]
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_seed_stream_takes_large_and_negative_seeds():
    for s in (0, -1, 2**31 + 7, 2**64 + 3, -(2**40)):
        x = seed_stream(s, 1).integers(0, 1 << 30, 4)
        assert np.array_equal(x, seed_stream(s, 1).integers(0, 1 << 30, 4))
    assert not np.array_equal(seed_stream(1, 0).integers(0, 1 << 30, 4),
                              seed_stream(1, 1).integers(0, 1 << 30, 4))


def test_shares_fill_the_table_exactly():
    cfg = {"table_chunks": 16384}
    per_row = [2, 1, 1, 1, 1, 2] * 2
    rows = shares(cfg, per_row)
    assert sum(r * c for r, c in zip(rows, per_row)) == 16384
    assert max(r * c for r, c in zip(rows, per_row)) - \
        min(r * c for r, c in zip(rows, per_row)) <= 4


def test_take_rows_copies_each_listed_row():
    arr = table4.make("TC2", seed_stream(3, 0), 8 * 4096)
    lo, hi = encode(arr, "rle_v2", 4096)
    idx = np.array([3, 0, 0, 2])
    got = [blobs.decode_plain(blobs.take_rows(b, idx)) for b in (lo, hi)]
    joined = blobs.join_planes(got, "uint64")
    want = arr.reshape(4, -1)[idx].reshape(-1)
    assert np.array_equal(joined, want)


def test_roofline_bytes_count_payload_and_output():
    """A query's least bytes are its chunks' payloads (code-length headers
    included, padding not) plus its decoded bytes, counted here apart
    from ``Column`` and ``Query``."""
    cols = []
    for i, (ds, codec) in enumerate((("MC0", "rle_v1"), ("CD2", "tdeflate"),
                                     ("TPT", "rle_v2"))):
        arr = table4.make(ds, seed_stream(9, i), 4 * 4096)
        cols.append(Column(name=f"{ds}.{codec}", dataset=ds, codec=codec,
                           base=arr, base_blobs=encode(arr, codec, 4096),
                           rows=5))
    idx = [np.array([0, 1, 1, 0]), np.array([3]), np.arange(3)]
    q = Query(list(zip(cols, idx)))
    payload = out = 0
    for c, rows in zip(cols, idx):
        for b in c.base_blobs:
            for r in rows:
                payload += int(b["comp_lens"][r])
                payload += sum(int(np.asarray(v[r]).nbytes)
                               for k, v in b["extras"].items()
                               if k.startswith("hdr_"))
        out += len(rows) * c.base.nbytes // c.base_rows
    assert q.payload_bytes == payload
    assert q.user_bytes == out
    assert roofline.least_bytes(q) == payload + out
    assert roofline.least_seconds(q) == pytest.approx(
        (payload + out) / 3.35e12)
