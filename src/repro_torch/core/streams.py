"""The paper's input_stream / output_stream (Tables I and II), on tensors.

The counterpart of ``repro/core/streams.py``, batched over chunk rows:

  * byte reads ``read_byte_at`` / ``read_value_at`` / ``gather_values``:
    ``data`` is one row ``(C,)`` or a table ``(n, C)`` of uint8;
  * bit reads ``peek_bits`` / ``skip_bits`` over an LSB-first word table
    (:func:`words_int64` of the staged uint32 view);
  * output writes ``write_from`` (a literal run from a side buffer) and the
    overlap-safe ``memcpy`` (Alg. 2) into an ``(n, capacity)`` buffer;
  * ``lockstep``, the loop of the plain bodies that step every row at once.

Positions hold offsets with the row on their leading axis.  Reads reproduce
``jnp.take(..., mode="clip")``: an offset past the row reads its last byte
or word, which is zero padding in the device layout (``format.to_device``).
Windows reproduce ``lax.dynamic_slice``: a negative start counts from the
buffer's end (it is increased by the buffer's length once), then every
start is clamped so the window fits the buffer.

Values are computed in int64 and masked to 32 bits: CPU torch has no
shifts, sums or comparisons on uint32.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def _take(data: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``data[row, clip(pos)]`` as int64; ``pos`` is (n, ...) for an (n, C)
    table, any shape for a single row."""
    pos = pos.clamp(0, data.shape[-1] - 1)
    if data.dim() == 1:
        return data[pos].to(torch.int64)
    flat = pos.reshape(pos.shape[0], -1)
    return torch.gather(data, 1, flat).to(torch.int64).reshape(pos.shape)


def read_byte_at(data: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return _take(data, pos)


def read_value_at(data: torch.Tensor, pos: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Assemble a little-endian fixed-width value (width in {1,2,4})."""
    return gather_values(data, pos, width)


def gather_values(data: torch.Tensor, byte_offs: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Assemble little-endian ``width``-byte values at byte offsets; every
    lane reads its own value (the shared literal gather of Phase 2)."""
    v = _take(data, byte_offs)
    for i in range(1, width):
        v = v | (_take(data, byte_offs + i) << (8 * i))
    return v & MASK32


# --------------------------------------------------------------------------
# bit reads over an LSB-first uint32 word table (Table I)
# --------------------------------------------------------------------------


def words_int64(words: torch.Tensor) -> torch.Tensor:
    """A uint32 word table as int64 values in [0, 2^32): CPU torch gathers
    no uint32."""
    return words.view(torch.int32).to(torch.int64) & MASK32


def peek_bits(words: torch.Tensor, pos: torch.Tensor, n) -> torch.Tensor:
    """The next ``n`` (<= 32, int or tensor) bits at bit ``pos``: the 32-bit
    funnel of words ``pos >> 5`` and the next one (each clipped to the row),
    masked.  ``words`` comes from :func:`words_int64`."""
    w = pos >> 5
    off = pos & 31
    lo = _take(words, w) >> off
    hi = torch.where(off > 0, (_take(words, w + 1) << ((32 - off) & 31))
                     & MASK32, 0)
    return (lo | hi) & ((1 << n) - 1)


def skip_bits(pos: torch.Tensor, n) -> torch.Tensor:
    return pos + n


# --------------------------------------------------------------------------
# output writes into an (n, capacity) buffer (Table II)
# --------------------------------------------------------------------------


def _window(buf: torch.Tensor, start: torch.Tensor, size: int):
    """Columns ``[start, start+size)`` of each row, placed as
    ``lax.dynamic_slice`` places them: a negative start plus the row's
    length, then clamped so the window fits.  Returns (start, columns)."""
    start = torch.where(start < 0, start + buf.shape[1], start)
    start = start.clamp(0, buf.shape[1] - size)
    return start, start[:, None] + torch.arange(size, device=buf.device)


def write_values(buf, pos, new, length, active, max_len):
    """Write ``new[:, :length]`` at ``pos`` for the active rows, through a
    ``max_len`` window placed as :func:`_window` places it (the blend write
    of ``lax.dynamic_update_slice``); returns ``(buf, pos + length)``."""
    start, cols = _window(buf, pos, max_len)
    cur = torch.gather(buf, 1, cols)
    keep = active[:, None] & (torch.arange(max_len, device=buf.device)
                              < length[:, None])
    buf.scatter_(1, cols, torch.where(keep, new.to(buf.dtype), cur))
    return buf, torch.where(active, pos + length, pos)


def write_from(buf: torch.Tensor, pos: torch.Tensor, src: torch.Tensor,
               src_start: torch.Tensor, length: torch.Tensor,
               active: torch.Tensor, max_len: int):
    """Copy ``length`` elements of side buffer ``src`` from ``src_start`` to
    ``pos`` (literal runs).  Updates ``buf`` in place for the active rows;
    returns ``(buf, pos)``."""
    _, cols = _window(src, src_start, max_len)
    return write_values(buf, pos, torch.gather(src, 1, cols), length, active,
                  max_len)


def memcpy(buf: torch.Tensor, pos: torch.Tensor, offset: torch.Tensor,
           length: torch.Tensor, active: torch.Tensor, max_len: int):
    """Alg. 2: copy ``length`` elements from ``offset`` back in the output
    itself.  When ``length > offset`` the source is the circular window
    ``[pos-offset, pos)`` (modulo-indexed gather).  The window is read
    before the write and placed as :func:`_window` places it, so element
    ``i`` reads ``buf[start + min(i % offset, max_len-1)]``; a reference
    before the row's start thus reads near the buffer's end (zeros) unless
    ``offset`` exceeds the buffer's length.  Updates ``buf`` in place for
    the active rows; returns ``(buf, pos)``."""
    start, _ = _window(buf, pos - offset, max_len)
    idx = torch.arange(max_len, device=buf.device)
    idxm = torch.where(offset[:, None] > 0,
                       idx % offset.clamp(min=1)[:, None], idx)
    src = start[:, None] + idxm.clamp(max=max_len - 1)
    return write_values(buf, pos, torch.gather(buf, 1, src), length, active,
                  max_len)


# --------------------------------------------------------------------------
# the lockstep loop of the plain bodies
# --------------------------------------------------------------------------

# steps of a lockstep loop one CUDA graph holds (the host checks for an
# active row once a replay)
GRAPH_STEPS = 32


def lockstep(step, state: tuple) -> tuple:
    """Run ``state, active = step(state)`` until a step has no active row;
    returns the last state.

    ``step`` must leave every row it reports inactive as it was, so a step
    with no active row changes nothing and the steps run past the last
    active one do not change the result.  ``state`` holds the per-row
    tensors ``step`` replaces; the tables it writes in place it closes
    over.  On the CPU the host checks ``active`` after every step.  On a
    card a step is many small launches, bound by the host's launch cost:
    :data:`GRAPH_STEPS` steps are captured once as a CUDA graph and
    replayed, the host checking the last step's ``active`` between
    replays."""
    state, active = step(state)
    if not active.is_cuda:
        while bool(active.any()):
            state, active = step(state)
        return state
    if not bool(active.any()):
        return state
    static = tuple(t.clone() for t in state)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = static
        for _ in range(GRAPH_STEPS):
            got, active = step(got)
        for dst, src in zip(static, got):
            dst.copy_(src)
        more = active.any()
    while True:
        graph.replay()
        if not bool(more):
            return static
