"""CODAG chunked container format (CJC), host side and device side.

The byte format is the contract shared with the JAX package ``repro``
(``repro/core/format.py``): the uncompressed stream is split into fixed-size
chunks, each chunk is compressed independently, and the device layout is a
dense ``(num_chunks, max_comp_bytes)`` uint8 matrix plus per-chunk length
vectors, so one warp can walk one chunk row with plain strided offsets.

The host half (``CompressedBlob`` and the numpy helpers) is a copy of the
reference; the device half (:func:`to_device`, :func:`reassemble_rows_device`,
:func:`device_view`, :func:`combine_planes_device`) works on torch tensors.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import registry, transfers

DEFAULT_CHUNK_BYTES = 128 * 1024  # 128 KiB, same as the paper's evaluation

RLE_V1 = "rle_v1"
RLE_V2 = "rle_v2"
TDEFLATE = "tdeflate"
BITPACK = "bitpack"
DBP = "dbp"
HUFFMAN = "huffman"
LZSS = "lzss"

# Widths supported on device. 8-byte dtypes are viewed as two 4-byte lanes
# (runs of u64 are runs of the u32 pair view, so RLE still applies).
SUPPORTED_WIDTHS = (1, 2, 4)

TORCH_DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8, "int8": torch.int8,
    "uint16": torch.uint16, "int16": torch.int16, "float16": torch.float16,
    "uint32": torch.uint32, "int32": torch.int32, "float32": torch.float32,
    "uint64": torch.uint64, "int64": torch.int64, "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or its name; "bfloat16", which
    numpy lacks, by name)."""
    name = dtype if dtype == "bfloat16" else str(np.dtype(dtype))
    if name not in TORCH_DTYPE:
        raise ValueError(f"no torch dtype for {name}")
    return TORCH_DTYPE[name]


def _as_bytes_view(arr: np.ndarray) -> tuple[np.ndarray, int, np.dtype]:
    """Flatten ``arr`` into a (bytes_view, elem_width, device_dtype) triple."""
    a = np.ascontiguousarray(arr)
    width = a.dtype.itemsize
    if width == 8:  # view u64/f64/i64 as u32 pairs
        a = a.view(np.uint32)
        width = 4
    if width not in SUPPORTED_WIDTHS:
        raise ValueError(f"unsupported element width {width}")
    dev_dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]
    return a.reshape(-1).view(dev_dtype), width, np.dtype(dev_dtype)


@dataclasses.dataclass
class CompressedBlob:
    """Host-side compressed container (numpy)."""

    codec: str
    width: int                    # bytes per element (1/2/4)
    chunk_elems: int              # uncompressed elements per full chunk
    total_elems: int              # total uncompressed elements
    orig_dtype: str               # dtype string of the original array
    orig_shape: tuple             # original shape (for reconstruction)
    comp: np.ndarray              # (num_chunks, max_comp_bytes) uint8
    comp_lens: np.ndarray         # (num_chunks,) int32 — valid bytes per row
    out_lens: np.ndarray          # (num_chunks,) int32 — elements per chunk
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_chunks(self) -> int:
        return int(self.comp.shape[0])

    @property
    def compressed_bytes(self) -> int:
        """True compressed payload size (index + per-chunk bytes), no padding."""
        extra = sum(int(v.nbytes) for k, v in self.extras.items()
                    if k.startswith("hdr_"))
        return int(self.comp_lens.sum()) + extra

    @property
    def uncompressed_bytes(self) -> int:
        return self.total_elems * self.width

    @property
    def ratio(self) -> float:
        """Compression ratio as reported in the paper (comp/uncomp, Table V)."""
        return self.compressed_bytes / max(1, self.uncompressed_bytes)


def blob_from_reference(fields: Dict[str, Any]) -> CompressedBlob:
    """Build a blob from a reference-package blob given as plain values.

    ``fields`` is ``dataclasses.asdict`` of a ``repro`` blob (numpy arrays
    and Python values).  The two packages share the byte format, so a blob
    encoded by either decodes identically in both.
    """
    names = {f.name for f in dataclasses.fields(CompressedBlob)}
    if set(fields) != names:
        raise ValueError(f"blob fields {sorted(fields)} != {sorted(names)}")
    return CompressedBlob(
        codec=str(fields["codec"]),
        width=int(fields["width"]),
        chunk_elems=int(fields["chunk_elems"]),
        total_elems=int(fields["total_elems"]),
        orig_dtype=str(fields["orig_dtype"]),
        orig_shape=tuple(int(d) for d in fields["orig_shape"]),
        comp=np.ascontiguousarray(fields["comp"], np.uint8),
        comp_lens=np.asarray(fields["comp_lens"], np.int32),
        out_lens=np.asarray(fields["out_lens"], np.int32),
        extras={k: np.asarray(v) for k, v in fields["extras"].items()})


def to_device(blob: CompressedBlob, device,
              pad_comp_to: Optional[int] = None,
              rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Stage a blob's device layout on ``device`` (the reference's
    ``CompressedBlob.to_device`` layout, as torch tensors).

    Rows are zero-padded by at least 8 bytes, to at least ``pad_comp_to``
    columns, and rounded up to a multiple of 128, so header peeks and
    literal reads past a row's last valid byte land in zeros.  ``rows``
    appends zero-length chunks (zero rows, zero ``comp_lens`` /
    ``out_lens`` and per-chunk extras; :func:`pad_table_rows` on the host).
    The padding is written as the rows are copied into the staging buffer
    (``transfers.to_device(rows=, cols=)``), so the compressed bytes are
    copied on the host once.  Every upload goes through the
    ``transfers.to_device`` funnel.  A bit codec's ``comp_words`` is a
    uint32 view of the staged ``comp``, so its bytes cross once.
    """
    want = max(blob.comp.shape[1] + 8, pad_comp_to or 0)
    want = int(np.ceil(want / 128) * 128)  # lane-align
    rows = None if rows == blob.num_chunks else rows
    dev = {"comp": transfers.to_device(blob.comp, device, rows=rows,
                                       cols=want)}
    host = {"comp_lens": blob.comp_lens.astype(np.int32),
            "out_lens": blob.out_lens.astype(np.int32)}
    shared = registry.get(blob.codec).shared_extras
    host.update(blob.extras)
    for k, v in host.items():
        per_chunk = k not in shared and v.shape[:1] == (blob.num_chunks,)
        dev[k] = transfers.to_device(v, device,
                                     rows=rows if per_chunk else None)
    if registry.get(blob.codec).needs_words:
        dev["comp_words"] = dev["comp"].view(torch.uint32)
    return dev


def group_key(blob: CompressedBlob) -> tuple:
    """Batching key: blobs with equal keys share one decode dispatch."""
    bits = registry.get(blob.codec).static_bits(blob)
    return (blob.codec, blob.width, blob.chunk_elems, bits)


def concat_blobs(blobs: list[CompressedBlob]) -> CompressedBlob:
    """Merge same-key blobs into one flat chunk table.

    The rows of the result are the chunks of every input blob in order, so
    one decode launch treats each chunk as an independent stream; callers
    scatter the ``(total_chunks, chunk_elems)`` output back per blob by row
    ranges.  Every merged row is padded to the group-wide max row length.
    """
    if not blobs:
        raise ValueError("concat_blobs needs at least one blob")
    key = group_key(blobs[0])
    for b in blobs[1:]:
        if group_key(b) != key:
            raise ValueError(f"group key mismatch: {group_key(b)} != {key}")
    if len(blobs) == 1:
        return blobs[0]
    max_len = max(b.comp.shape[1] for b in blobs)
    total_chunks = sum(b.num_chunks for b in blobs)
    comp = np.zeros((total_chunks, max_len), np.uint8)
    row = 0
    for b in blobs:
        comp[row:row + b.num_chunks, : b.comp.shape[1]] = b.comp
        row += b.num_chunks
    extras: Dict[str, np.ndarray] = {}
    shared = registry.get(blobs[0].codec).shared_extras
    for k, v0 in blobs[0].extras.items():
        if k in shared:      # group-wide scalars (e.g. bitpack_bits)
            extras[k] = v0
        else:                # per-chunk tables: stack rows
            extras[k] = np.concatenate([b.extras[k] for b in blobs], axis=0)
    total_elems = sum(b.total_elems for b in blobs)
    return CompressedBlob(
        codec=blobs[0].codec,
        width=blobs[0].width,
        chunk_elems=blobs[0].chunk_elems,
        total_elems=int(total_elems),
        orig_dtype=blobs[0].orig_dtype,
        orig_shape=(int(total_elems),),
        comp=comp,
        comp_lens=np.concatenate([b.comp_lens for b in blobs]).astype(np.int32),
        out_lens=np.concatenate([b.out_lens for b in blobs]).astype(np.int32),
        extras=extras,
    )


def pad_table_rows(table: CompressedBlob, target_rows: int) -> CompressedBlob:
    """Pad a chunk table to ``target_rows`` with zero-length trailing chunks.

    Padding rows have ``comp_lens == out_lens == 0``, so every decode body
    exits at once on them, and they trail the real rows, so callers'
    row-range scatter is unaffected.
    """
    rows = table.num_chunks
    if target_rows < rows:
        raise ValueError(f"cannot pad {rows} rows down to {target_rows}")
    if target_rows == rows:
        return table
    pad = target_rows - rows
    comp = np.zeros((target_rows, table.comp.shape[1]), np.uint8)
    comp[:rows] = table.comp
    shared = registry.get(table.codec).shared_extras
    extras = {}
    for k, v in table.extras.items():
        if k in shared or v.shape[:1] != (rows,):
            extras[k] = v                    # group-wide scalar/table
        else:                                # per-chunk rows: pad with zeros
            extras[k] = np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
    return dataclasses.replace(
        table, comp=comp,
        comp_lens=np.concatenate(
            [table.comp_lens, np.zeros(pad, np.int32)]).astype(np.int32),
        out_lens=np.concatenate(
            [table.out_lens, np.zeros(pad, np.int32)]).astype(np.int32),
        extras=extras)


def table_rows(table: CompressedBlob, lo: int, hi: int) -> CompressedBlob:
    """Rows ``[lo, hi)`` of a chunk table, the rows past its end
    zero-length (:func:`pad_table_rows`): one mesh member's block of a
    padded group table.  Per-chunk tables are sliced with the rows, shared
    ones kept; every row keeps the table's width, so each decodes as it
    does in the whole table."""
    n = table.num_chunks
    take = slice(min(lo, n), min(hi, n))
    shared = registry.get(table.codec).shared_extras
    extras = {k: v if k in shared or v.shape[:1] != (n,) else v[take]
              for k, v in table.extras.items()}
    part = dataclasses.replace(
        table, comp=table.comp[take], comp_lens=table.comp_lens[take],
        out_lens=table.out_lens[take], extras=extras)
    return pad_table_rows(part, hi - lo)


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length() if n > 1 else 1


def bucket_shape(table: CompressedBlob,
                 cols_floor: Optional[int] = None) -> Tuple[int, int]:
    """The pow2 ``(rows, cols)`` bucket of a merged chunk table's ``comp``
    (:func:`pad_table_to_bucket`'s shape).  ``cols_floor=None`` consults
    the tuned-defaults table for the table's (codec, width) on the current
    device kind (``core.tuning``), else 128."""
    if cols_floor is None:
        from repro_torch.core import tuning
        cols_floor = tuning.bucket_cols_floor(table.codec, table.width)
    floor = 128 if cols_floor is None else int(cols_floor)
    return (_next_pow2(table.num_chunks),
            max(floor, _next_pow2(int(table.comp.shape[1]))))


def pad_table_to_bucket(table: CompressedBlob,
                        cols_floor: Optional[int] = None) -> CompressedBlob:
    """Pad a merged chunk table to power-of-two row/column buckets.

    Rows are padded with zero-length chunks (:func:`pad_table_rows`) and
    columns with zero bytes, so a long-lived caller (the service's window
    loop) sees a few table shapes per group key.  The reference buckets to
    bound its jit cache; the port has no per-shape compile, so here the
    buckets only shape the table, kept for parity with the reference.
    ``DecodePlan.build(bucket=True)`` does not call this: it records
    :func:`bucket_shape` and pads while staging, with no host copy.

    ``cols_floor`` is the minimum column bucket: explicit values win;
    ``None`` consults the tuned-defaults table (:func:`bucket_shape`), and
    with no entry the floor is 128.
    """
    rows, target_cols = bucket_shape(table, cols_floor)
    padded = pad_table_rows(table, rows)
    cols = int(padded.comp.shape[1])
    if target_cols == cols:
        return padded
    comp = np.zeros((padded.num_chunks, target_cols), np.uint8)
    comp[:, :cols] = padded.comp
    return dataclasses.replace(padded, comp=comp)


def blob_digest(blob: CompressedBlob) -> str:
    """Content hash of a compressed blob — equal digests decode identically
    (the golden vectors' committed encoder fingerprint)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{blob.codec}|{blob.width}|{blob.chunk_elems}|"
             f"{blob.total_elems}|{blob.orig_dtype}|{blob.orig_shape}"
             .encode())
    h.update(np.ascontiguousarray(blob.comp_lens, np.int64).tobytes())
    h.update(np.ascontiguousarray(blob.out_lens, np.int64).tobytes())
    h.update(np.ascontiguousarray(blob.comp).tobytes())
    for k in sorted(blob.extras):
        v = np.ascontiguousarray(blob.extras[k])
        h.update(f"|{k}|{v.dtype}|{v.shape}|".encode())
        h.update(v.tobytes())
    return h.hexdigest()


def combine_planes(outs: list, orig_dtype: str, orig_shape: tuple) -> np.ndarray:
    """Recombine decoded plane blobs (host): one blob is returned as is, two
    are the lo/hi uint32 planes of an 8-byte dtype."""
    if len(outs) == 1:
        return outs[0]
    lo, hi = outs
    u64 = (lo.reshape(-1).astype(np.uint64)
           | (hi.reshape(-1).astype(np.uint64) << np.uint64(32)))
    return u64.view(np.dtype(orig_dtype)).reshape(orig_shape)


def chunk_array(arr: np.ndarray, chunk_bytes: int = DEFAULT_CHUNK_BYTES):
    """Split ``arr`` into fixed-size element chunks (last may be short)."""
    flat, width, dev_dtype = _as_bytes_view(arr)
    chunk_elems = max(1, chunk_bytes // width)
    n = flat.shape[0]
    num_chunks = max(1, (n + chunk_elems - 1) // chunk_elems)
    chunks = [flat[i * chunk_elems : min((i + 1) * chunk_elems, n)]
              for i in range(num_chunks)]
    return chunks, chunk_elems, width, dev_dtype


def build_blob(
    codec: str,
    arr: np.ndarray,
    encoded: list[bytes],
    chunk_elems: int,
    width: int,
    extras: Optional[Dict[str, np.ndarray]] = None,
    total_elems: Optional[int] = None,
) -> CompressedBlob:
    """Assemble the rectangular layout from per-chunk byte strings."""
    if total_elems is None:
        flat, _, _ = _as_bytes_view(arr)
        total_elems = flat.shape[0]
    n = total_elems
    num_chunks = len(encoded)
    max_len = max(len(e) for e in encoded) if encoded else 1
    comp = np.zeros((num_chunks, max_len), np.uint8)
    comp_lens = np.zeros((num_chunks,), np.int32)
    out_lens = np.zeros((num_chunks,), np.int32)
    for i, e in enumerate(encoded):
        comp[i, : len(e)] = np.frombuffer(e, np.uint8)
        comp_lens[i] = len(e)
        out_lens[i] = min(chunk_elems, n - i * chunk_elems)
    return CompressedBlob(
        codec=codec,
        width=width,
        chunk_elems=chunk_elems,
        total_elems=int(n),
        orig_dtype=str(arr.dtype),
        orig_shape=tuple(arr.shape),
        comp=comp,
        comp_lens=comp_lens,
        out_lens=out_lens,
        extras=extras or {},
    )


def reassemble(blob: CompressedBlob, chunks_out: np.ndarray) -> np.ndarray:
    """Stitch decoded (num_chunks, chunk_elems) back to the original array."""
    flat = np.ascontiguousarray(chunks_out.reshape(-1)[: blob.total_elems])
    return flat.view(np.dtype(blob.orig_dtype)).reshape(blob.orig_shape)


def reassemble_indices(blob: CompressedBlob) -> Optional[np.ndarray]:
    """Precomputed gather for device reassembly, or ``None`` when trivial.

    Output position ``p`` reads ``chunks_out.reshape(-1)[idx[p]]``.  For the
    standard layout (every chunk full except a trailing tail) the decode
    matrix is already contiguous and a reshape+trim suffices.
    """
    out_lens = np.asarray(blob.out_lens, np.int64)
    n = len(out_lens)
    expect = np.clip(blob.total_elems - np.arange(n) * blob.chunk_elems,
                     0, blob.chunk_elems)
    if np.array_equal(out_lens, expect):
        return None               # contiguous: reshape(-1)[:total] is exact
    dest = np.concatenate([[0], np.cumsum(out_lens)])   # per-row dest offsets
    if dest[-1] != blob.total_elems:
        raise ValueError(f"out_lens sum {dest[-1]} != total {blob.total_elems}")
    p = np.arange(blob.total_elems, dtype=np.int64)
    row = np.searchsorted(dest, p, side="right") - 1
    return (row * blob.chunk_elems + (p - dest[row])).astype(np.int32)


# --------------------------------------------------------------------------
# Device-side reassembly: a decoded blob is born, reassembled and consumed
# on the device, with no host round trip.
# --------------------------------------------------------------------------


def device_view(flat: torch.Tensor, dtype, shape=None) -> torch.Tensor:
    """Device analog of ``flat.view(dtype).reshape(shape)``: a bitcast of a
    1-D tensor.  Widening views regroup consecutive elements."""
    od = torch_dtype(dtype)
    if flat.dtype != od:
        k = od.itemsize // flat.element_size()
        if k > 1 and flat.shape[0] % k:
            raise ValueError(f"{flat.shape[0]} {flat.dtype} elements do not "
                             f"view evenly as {od}")
        flat = flat.view(od)
    return flat.reshape(shape if shape is not None else (-1,))


def reassemble_rows_device(table: torch.Tensor, *, row0: int, num_chunks: int,
                           total_elems: int, orig_dtype: str,
                           orig_shape: tuple, indices=None,
                           transformed: bool = False) -> torch.Tensor:
    """Row-range reassembly from a decoded ``(group_chunks, chunk_elems)``
    table: slice the blob's rows, stitch them into its original array.

    ``indices``: the staged gather from :func:`reassemble_indices`, or None
    for the contiguous reshape+trim path, whose result is a view of
    ``table`` (no copy).  ``transformed=True`` marks epilogue output: values
    and dtype are the epilogue's, so only the trim + reshape apply.
    """
    flat = table[row0:row0 + num_chunks].reshape(-1)
    if indices is None:
        flat = flat[:total_elems]
    elif not total_elems:
        flat = flat[:0]
    else:
        # torch gathers no unsigned type wider than a byte: move the bits
        # through the signed type of the same width
        signed = _SIGNED.get(flat.dtype, flat.dtype)
        flat = flat.view(signed).index_select(0, indices).view(flat.dtype)
    if transformed:
        n = int(np.prod(orig_shape)) if orig_shape else 1
        return flat.reshape(orig_shape if n == total_elems else (-1,))
    return device_view(flat, orig_dtype, orig_shape)


def reassemble_device(blob: CompressedBlob, chunks_out: torch.Tensor, *,
                      indices=None, transformed: bool = False
                      ) -> torch.Tensor:
    """Device analog of :func:`reassemble`: stitch the decoded
    ``(num_chunks, chunk_elems)`` tensor back to the original array without
    leaving its device (bit-exact against the host path).

    ``indices``: the gather of :func:`reassemble_indices`, staged
    beforehand (a tensor on ``chunks_out``'s device) or as a host array; by
    default it is derived here from the blob's host metadata.  A host
    array is uploaded through ``transfers.to_device``.
    """
    if indices is None:
        indices = reassemble_indices(blob)
    if indices is not None and not isinstance(indices, torch.Tensor):
        indices = transfers.to_device(indices, chunks_out.device)
    return reassemble_rows_device(
        chunks_out, row0=0, num_chunks=blob.num_chunks,
        total_elems=blob.total_elems, orig_dtype=blob.orig_dtype,
        orig_shape=tuple(blob.orig_shape), indices=indices,
        transformed=transformed)


def combine_planes_device(outs: list, orig_dtype: str,
                          orig_shape: tuple) -> torch.Tensor:
    """Device analog of :func:`combine_planes`: the lo/hi uint32 planes of
    an 8-byte dtype are joined in int64 and bitcast to the original type."""
    if len(outs) == 1:
        return outs[0]
    lo, hi = (o.reshape(-1).to(torch.int64) for o in outs)
    joined = lo | (hi << 32)
    return joined.view(torch_dtype(orig_dtype)).reshape(orig_shape)
