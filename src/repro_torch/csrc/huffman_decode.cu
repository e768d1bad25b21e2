// Gap-array canonical Huffman decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `huffman._pallas` (src/repro/kernels/huffman.py:
// 237) -> `harness._generic_pallas` (src/repro/kernels/harness.py:359,
// pl.pallas_call at :409) running huffman's `_body` (:170) ->
// `_decode_lockstep` (:142), with the per-chunk inputs of `_chunk_inputs`
// (:262).
//
// What it computes, per chunk row.  The row starts with a gap table: entry
// g (5 bytes at byte 5g) holds the u32 LE bit offset of segment g's first
// symbol, read as int32 (the reference's `.astype(jnp.int32)`).  Segment g
// covers output lanes [32g, 32g + 32).  From its offset, 32 steps each peek
// 12 bits (LSB first, from the 32-bit funnel of words pos>>5 and pos>>5 + 1,
// each word index clipped to the row, as `jnp.take(mode="clip")`), look up
// (symbol, code length) in the chunk's 4096-entry LUT, write the symbol's
// low byte to lane 32g + t and advance the cursor by the code length.  A
// LUT entry of length 0 (an unused code) leaves the cursor where it is.
// Gap-table bytes are read clipped to the row's last byte.  Lanes at or
// past min(out_len, chunk_elems) are zero, as the reference's final
// `where(idx < out_len, ..., 0)`.
//
// Design.  The TPU kernel steps every segment of a chunk in lockstep as
// one vector.  Here one CTA owns one chunk and each of its threads walks
// whole segments, 32 steps each, with no communication: every segment is
// independent.  The chunk's two LUTs (i16 symbols, i8 lengths, 12 KiB as
// staged) are packed into one u16 per entry (symbol low byte, length) in
// 8 KiB of shared memory, so a step is two word loads (L1 hits: nearby
// segments share words), one shared-memory load and an add.  A thread keeps
// its segment's 32 output bytes in registers and writes them as two 16-byte
// stores when the row stride allows it.  Only segments that hold a lane
// below out_len read anything: a row with out_len 0 has no gap table and
// only writes zeros.
//
// Bound: bytes.  The compressed row, the LUTs and out_len read once, plus
// the output row written once, over 3.35 TB/s.  Each segment is a chain of
// 32 dependent steps, so the kernel leans on many resident threads to hide
// the latency of each step's word loads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSub = 32;               // symbols per segment
constexpr int kGap = 5;                // gap entry bytes
constexpr int kCodeBits = 12;          // MAX_CODE_BITS
constexpr int kLut = 1 << kCodeBits;   // LUT entries per chunk

__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint8_t* __restrict__ comp, int64_t ncols,
                      const uint32_t* __restrict__ words, int64_t nw,
                      const int16_t* __restrict__ lut_sym,
                      const int8_t* __restrict__ lut_bits,
                      const int32_t* __restrict__ out_lens,
                      int64_t chunk_elems, uint8_t* __restrict__ out) {
  __shared__ uint16_t s_lut[kLut];     // (length << 8) | symbol low byte
  const int64_t row = blockIdx.x;
  const int64_t out_len = out_lens[row];
  int64_t limit = out_len < chunk_elems ? out_len : chunk_elems;
  if (limit < 0) limit = 0;
  const int64_t nseg = (chunk_elems + kSub - 1) / kSub;
  const int64_t live = (limit + kSub - 1) / kSub;  // segments with a lane
                                                   // below out_len
  if (live > 0) {  // uniform across the block
    const int16_t* sym = lut_sym + row * kLut;
    const int8_t* bits = lut_bits + row * kLut;
    for (int i = threadIdx.x; i < kLut; i += blockDim.x)
      s_lut[i] = static_cast<uint16_t>(
          static_cast<uint8_t>(sym[i]) |
          (static_cast<uint16_t>(static_cast<uint8_t>(bits[i])) << 8));
  }
  __syncthreads();

  const uint8_t* crow = comp + row * ncols;
  const uint32_t* wrow = words + row * nw;
  uint8_t* dst = out + row * chunk_elems;
  const bool vec = (chunk_elems & 15) == 0;  // 16-byte aligned segments
  for (int64_t g = threadIdx.x; g < nseg; g += blockDim.x) {
    uint32_t packed[kSub / 4];
#pragma unroll
    for (int i = 0; i < kSub / 4; ++i) packed[i] = 0;
    const int64_t base = g * kSub;
    if (g < live) {
      uint32_t off = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int64_t at = g * kGap + b;
        at = at < ncols ? at : ncols - 1;
        off |= static_cast<uint32_t>(crow[at]) << (8 * b);
      }
      int64_t pos = static_cast<int32_t>(off);
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        int64_t i0 = pos >> 5;
        int64_t i1 = i0 + 1;
        i0 = i0 < 0 ? 0 : (i0 < nw ? i0 : nw - 1);
        i1 = i1 < 0 ? 0 : (i1 < nw ? i1 : nw - 1);
        const uint32_t sh = static_cast<uint32_t>(pos & 31);
        const uint32_t v =
            (__ldg(wrow + i0) >> sh) | (sh ? __ldg(wrow + i1) << (32 - sh) : 0u);
        const uint16_t e = s_lut[v & (kLut - 1)];
        if (base + t < limit)
          packed[t >> 2] |= static_cast<uint32_t>(e & 0xFF) << (8 * (t & 3));
        pos += static_cast<int8_t>(e >> 8);
      }
    }
    if (vec && base + kSub <= chunk_elems) {
      uint4* o = reinterpret_cast<uint4*>(dst + base);
      o[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      o[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    } else {
      for (int t = 0; t < kSub && base + t < chunk_elems; ++t)
        dst[base + t] = static_cast<uint8_t>(packed[t >> 2] >> (8 * (t & 3)));
    }
  }
}

}  // namespace

// Decode n huffman chunk rows into `out` ((n, chunk_elems) uint8) on
// `stream`.  `comp` is the (n, ncols) byte table (the gap tables), `words`
// the same rows as (n, nw) uint32 words, the LUTs (n, 4096) as staged (i16
// symbols, i8 code lengths), `out_lens` (n,) int32.  Returns the CUDA error
// of the launch (0 on success).  Allocates nothing and does not synchronise.
extern "C" int codag_huffman_decode(const void* comp, int64_t n,
                                    int64_t ncols, const void* words,
                                    int64_t nw, const void* lut_sym,
                                    const void* lut_bits,
                                    const void* out_lens, int64_t chunk_elems,
                                    void* out, void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (ncols <= 0 || nw <= 0 || n > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  huffman_decode_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), ncols,
      static_cast<const uint32_t*>(words), nw,
      static_cast<const int16_t*>(lut_sym),
      static_cast<const int8_t*>(lut_bits),
      static_cast<const int32_t*>(out_lens), chunk_elems,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
