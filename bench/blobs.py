"""The blob layout the benchmark hands the program, frozen.

A copy of the CODAG chunked container's host layout as ``api.compress``
writes it when this benchmark was written: an array is cut into chunks of
``chunk_bytes``, each chunk is encoded alone, and a blob is a dense
``(num_chunks, max_comp_bytes)`` uint8 matrix plus per-chunk lengths and
extras.  An 8-byte array goes to a codec with ``PLANE_SPLIT_64`` as two
blobs, its low and high u32 planes; a byte codec (``BYTE_STREAM``) chunks
the array in its own width and codes each chunk's bytes.

A blob is a dict of plain fields (numpy arrays and Python values), the
form ``repro_torch.core.format.blob_from_reference`` takes.  Nothing here
imports the program.
"""
from __future__ import annotations

import importlib
from typing import List, Sequence

import numpy as np

DEV_DTYPE = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def codec_module(name: str):
    """The frozen codec ``bench/codecs/<name>.py``."""
    return importlib.import_module(f"bench.codecs.{name}")


def bytes_view(arr: np.ndarray):
    """``arr`` flattened to the device lanes: (values, width); 8-byte
    elements are viewed as u32 pairs."""
    a = np.ascontiguousarray(arr)
    width = a.dtype.itemsize
    if width == 8:
        a = a.view(np.uint32)
        width = 4
    if width not in DEV_DTYPE:
        raise ValueError(f"unsupported element width {width}")
    return a.reshape(-1).view(DEV_DTYPE[width]), width


def planes(arr: np.ndarray, codec: str) -> List[np.ndarray]:
    """The arrays a column is stored as: itself, or the lo/hi u32 planes of
    an 8-byte column under a plane-splitting codec."""
    if arr.dtype.itemsize == 8 and codec_module(codec).PLANE_SPLIT_64:
        u64 = arr.reshape(-1).view(np.uint64)
        return [(u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (u64 >> np.uint64(32)).astype(np.uint32)]
    return [arr]


def chunk_jobs(arr: np.ndarray, codec: str, chunk_bytes: int):
    """(blob header, chunks): the chunks of one stored array, each as the
    encoder takes it."""
    flat, width = bytes_view(arr)
    chunk_elems = max(1, chunk_bytes // width)
    n = flat.shape[0]
    num_chunks = max(1, -(-n // chunk_elems))
    chunks = [flat[i * chunk_elems:min((i + 1) * chunk_elems, n)]
              for i in range(num_chunks)]
    head = {"codec": codec, "width": width, "chunk_elems": chunk_elems,
            "total_elems": n, "orig_dtype": str(arr.dtype),
            "orig_shape": tuple(arr.shape)}
    if codec_module(codec).BYTE_STREAM:
        chunks = [np.ascontiguousarray(c).view(np.uint8) for c in chunks]
        head.update(width=1, chunk_elems=chunk_elems * width,
                    total_elems=sum(int(c.shape[0]) for c in chunks))
    return head, chunks


def assemble(head: dict, encoded: Sequence[tuple]) -> dict:
    """A blob's fields from its header and its chunks' ``(payload,
    extras)``."""
    n, ce = head["total_elems"], head["chunk_elems"]
    max_len = max(len(e[0]) for e in encoded) if encoded else 1
    comp = np.zeros((len(encoded), max_len), np.uint8)
    comp_lens = np.zeros(len(encoded), np.int32)
    out_lens = np.zeros(len(encoded), np.int32)
    for i, (payload, _) in enumerate(encoded):
        comp[i, :len(payload)] = np.frombuffer(payload, np.uint8)
        comp_lens[i] = len(payload)
        out_lens[i] = min(ce, n - i * ce)
    extras = codec_module(head["codec"]).blob_extras([e[1] for e in encoded])
    return {**head, "comp": comp, "comp_lens": comp_lens,
            "out_lens": out_lens, "extras": extras}


def encode_job(job) -> tuple:
    """One chunk's ``(payload, extras)``; ``job`` is (codec, width, chunk)."""
    codec, width, chunk = job
    return codec_module(codec).encode_chunk(chunk, width)


def take_rows(blob: dict, rows: np.ndarray) -> dict:
    """A blob made of ``blob``'s rows in the order ``rows`` lists them (a
    row may repeat).  Every row must be a full chunk; the result is a
    stored array of ``len(rows)`` chunks, each copy at its own place."""
    ce = blob["chunk_elems"]
    if not np.all(blob["out_lens"] == ce):
        raise ValueError("only full chunks can be listed again")
    total = len(rows) * ce
    extras = {k: v[rows] for k, v in blob["extras"].items()}
    elems = total * blob["width"] // np.dtype(blob["orig_dtype"]).itemsize
    return {**blob, "total_elems": total, "orig_shape": (elems,),
            "comp": blob["comp"][rows], "comp_lens": blob["comp_lens"][rows],
            "out_lens": blob["out_lens"][rows], "extras": extras}


def decode_plain(blob: dict) -> np.ndarray:
    """The plain decode of a blob with its codec's reference decoder: the
    stored array, in its own dtype."""
    mod = codec_module(blob["codec"])
    parts = []
    for i in range(blob["comp"].shape[0]):
        row = {k: v[i] for k, v in blob["extras"].items()}
        payload = blob["comp"][i, :blob["comp_lens"][i]].tobytes()
        parts.append(mod.decode_chunk(payload, row, blob["width"],
                                      int(blob["out_lens"][i])))
    flat = (np.concatenate(parts) if parts
            else np.zeros(0, DEV_DTYPE[blob["width"]]))
    flat = np.ascontiguousarray(flat[:blob["total_elems"]])
    return flat.view(np.dtype(blob["orig_dtype"])).reshape(
        blob["orig_shape"])


def join_planes(parts: List[np.ndarray], dtype: str) -> np.ndarray:
    """The stored arrays of one column joined back into the column."""
    if len(parts) == 1:
        return parts[0]
    lo, hi = (p.reshape(-1).astype(np.uint64) for p in parts)
    return (lo | (hi << np.uint64(32))).view(np.dtype(dtype))
