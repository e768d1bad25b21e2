// Gap-array canonical Huffman decode for Hopper (sm_90a), the decode
// epilogue applied in the stores.
//
// Replaces the TPU kernel `huffman._pallas` (src/repro/kernels/huffman.py:
// 237) -> `harness._generic_pallas` (src/repro/kernels/harness.py:359,
// pl.pallas_call at :409) running huffman's `_body` (:170) ->
// `_decode_lockstep` (:142), with the per-chunk inputs of `_chunk_inputs`
// (:262), and the `Epilogue` the reference fuses into the same dispatch
// (harness.py:190-194).
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
// `where(idx < out_len, ..., 0)`; the epilogue (`epilogue.cuh`) then maps
// every lane, zero or not, to the output type.
//
// Bound: bytes (the compressed row, the LUTs and out_len read once, the
// output written once).  Each segment is a chain of 32 dependent steps, so
// the design keeps global memory off the chain and many chains resident:
//   - a CTA of 128 threads owns a chunk and walks its segments in batches
//     of 256, two a thread (`huffman.THREADS`, `huffman.BATCH`); a thread
//     interleaves its two chains, so one chain's shared-memory latency
//     hides behind the other's;
//   - each batch's payload words are staged into shared memory with
//     coalesced 16-byte `cp.async` copies, double-buffered: the next
//     batch's tile is in flight while this batch decodes.  A tile runs from
//     the batch's first offset to 15 words past the next batch's (the row's
//     end for the last), at most 2,048 words; words past the row's end are
//     filled with its last word, which is what the clipped reads give.  The
//     gap offsets a batch needs are read a batch ahead;
//   - a segment's chain peeks through a funnel of two words in registers,
//     with a third loaded ahead from the tile, so a step waits only for its
//     LUT load: 32 steps of at most 12 bits, the 12-bit peek and the word
//     ahead span at most 15 words from offset >> 5, so residency is decided
//     once a segment, before its chain starts.  A segment whose window is
//     not in the tile (a negative offset, one past the row, a malformed gap
//     table), or any segment of a chunk whose LUT holds a code length
//     outside 0..12, takes a checked chain with the clipped global reads of
//     the reference instead;
//   - the LUT (i16 symbols, i8 lengths as staged) is packed into one u16 an
//     entry, 8 KiB of shared memory; with 2 x 8 KiB of tiles that is 24 KiB
//     a CTA, so nine CTAs (and 2,304 chains) fit an SM and 1,024 chunks run
//     in one wave;
//   - a segment's 32 bytes stay packed in registers and leave through the
//     epilogue in 16-byte stores.
// Only segments that hold a lane below out_len read anything: a row with
// out_len 0 reads nothing and writes the epilogue of zero.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 128;          // = huffman.THREADS
constexpr int kBatch = 2 * kThreads;   // segments a batch (= huffman.BATCH)
constexpr int kSub = 32;               // symbols per segment
constexpr int kGap = 5;                // gap entry bytes
constexpr int kCodeBits = 12;          // MAX_CODE_BITS
constexpr int kLut = 1 << kCodeBits;   // LUT entries per chunk
constexpr int kTile = 2048;            // staged words a batch (8 KiB)
constexpr int kWin = 15;               // words a resident chain may touch
constexpr int kMinBlocks = 9;
constexpr size_t kSmem = kLut * sizeof(uint16_t) + 2 * kTile * sizeof(uint32_t);

__device__ __forceinline__ int32_t gap_offset(const uint8_t* __restrict__ crow,
                                              int64_t ncols, int64_t g) {
  uint32_t off = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int64_t at = g * kGap + b;
    at = at < ncols ? at : ncols - 1;
    off |= static_cast<uint32_t>(crow[at]) << (8 * b);
  }
  return static_cast<int32_t>(off);
}

struct Tile {
  int64_t base;   // first staged word (a multiple of 4)
  int cnt;        // staged words
};

// A batch's tile, from the offsets of its first segment (`o`) and of the
// next batch's (`o_next`; `last` for the last batch): from the word of `o`
// (0 if it is negative), rounded down to 4, to kWin words past the word of
// `o_next` (the row's end, and kWin past it, for the last batch), at most
// kTile words.
__device__ __forceinline__ Tile tile_of(int32_t o, int32_t o_next, bool last,
                                        int64_t nw) {
  const int64_t base = o < 0 ? 0 : static_cast<int64_t>(o >> 5) & ~int64_t{3};
  const int64_t end =
      last ? nw + kWin : static_cast<int64_t>(o_next >> 5) + kWin + 1;
  int64_t cnt = (end - base + 3) & ~int64_t{3};
  cnt = cnt < 0 ? 0 : (cnt > kTile ? kTile : cnt);
  return {base, static_cast<int>(cnt)};
}

// Start the copy of a tile into `t`: 16-byte cp.async where the row is
// aligned and the words lie in it, 4-byte cp.async for an unaligned row,
// and the row's last word, stored directly, past its end.
__device__ __forceinline__ void issue_tile(uint32_t* t,
                                           const uint32_t* __restrict__ rw,
                                           int64_t nw, Tile tl, bool vec) {
  for (int i = threadIdx.x * 4; i < tl.cnt; i += kThreads * 4) {
    const int64_t w = tl.base + i;
    if (vec && w + 4 <= nw) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(t + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(rw + w));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (w + j < nw) {
          const unsigned d =
              static_cast<unsigned>(__cvta_generic_to_shared(t + i + j));
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                       "l"(rw + w + j));
        } else {
          t[i + j] = __ldg(rw + nw - 1);
        }
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_tiles() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A chain's cursor over a staged tile: the bit offset `sh` into w0, the
// word after it (w1) and the one after that (w2, loaded ahead so that no
// step waits for shared memory but the LUT's)
struct Cursor {
  uint32_t w0, w1, w2;
  uint32_t sh;
  int next;     // tile index of the word after w2
};

__device__ __forceinline__ Cursor cursor_at(const uint32_t* t, uint32_t lp) {
  const int w = lp >> 5;
  return {t[w], t[w + 1], t[w + 2], lp & 31, w + 3};
}

// One step: peek 12 bits, look up (symbol, length); the cursor advances by
// the length (0..12), taking in the next word when it crosses one.
__device__ __forceinline__ uint32_t step(Cursor& c, const uint32_t* t,
                                         const uint16_t* lut) {
  const uint32_t e = lut[__funnelshift_r(c.w0, c.w1, c.sh) & (kLut - 1)];
  c.sh += e >> 8;
  if (c.sh >= 32) {
    c.sh -= 32;
    c.w0 = c.w1;
    c.w1 = c.w2;
    c.w2 = t[c.next++];
  }
  return e & 0xFF;
}

__device__ __forceinline__ void chain_shared(const uint32_t* t,
                                             const uint16_t* lut,
                                             uint32_t lp, uint32_t (&pk)[8]) {
  Cursor c = cursor_at(t, lp);
#pragma unroll
  for (int k = 0; k < kSub; ++k) pk[k >> 2] |= step(c, t, lut) << (8 * (k & 3));
}

__device__ __forceinline__ void chain_shared2(const uint32_t* t,
                                              const uint16_t* lut,
                                              uint32_t la, uint32_t lb,
                                              uint32_t (&pa)[8],
                                              uint32_t (&pb)[8]) {
  Cursor a = cursor_at(t, la);
  Cursor b = cursor_at(t, lb);
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    pa[k >> 2] |= step(a, t, lut) << (8 * (k & 3));
    pb[k >> 2] |= step(b, t, lut) << (8 * (k & 3));
  }
}

// The reference's chain on the row in global memory: both peek words
// clipped to [0, nw), the cursor moved by the length as a signed byte.
__device__ __forceinline__ void chain_global(const uint32_t* __restrict__ wrow,
                                          int64_t nw, const uint16_t* lut,
                                          int64_t pos, uint32_t (&pk)[8]) {
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    int64_t i0 = pos >> 5;
    int64_t i1 = i0 + 1;
    i0 = i0 < 0 ? 0 : (i0 < nw ? i0 : nw - 1);
    i1 = i1 < 0 ? 0 : (i1 < nw ? i1 : nw - 1);
    const uint32_t sh = static_cast<uint32_t>(pos & 31);
    const uint32_t v =
        (__ldg(wrow + i0) >> sh) | (sh ? __ldg(wrow + i1) << (32 - sh) : 0u);
    const uint16_t e = lut[v & (kLut - 1)];
    pk[k >> 2] |= static_cast<uint32_t>(e & 0xFF) << (8 * (k & 3));
    pos += static_cast<int8_t>(e >> 8);
  }
}

// Zero the lanes of a segment at or past `lim` (lanes below out_len)
__device__ __forceinline__ void clear_from(uint32_t (&pk)[8], int64_t lim) {
  if (lim >= kSub) return;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int64_t keep = lim - 4 * q;   // bytes of word q to keep
    if (keep <= 0) pk[q] = 0;
    else if (keep < 4) pk[q] &= (1u << (8 * keep)) - 1u;
  }
}

// Segment g's 32 lanes through the epilogue to `orow`, 16 bytes a store
template <typename O>
__device__ __forceinline__ void store_segment(uint8_t* orow, int64_t g,
                                              int chunk_elems,
                                              const uint32_t (&pk)[8],
                                              const epi::Store<O>& st,
                                              bool aligned) {
  constexpr int OS = sizeof(O);
  constexpr int kE = 16 / OS;
  const int64_t base = g * kSub;
#pragma unroll
  for (int c = 0; c < kSub; c += kE) {
    const int64_t valid64 = chunk_elems - (base + c);
    if (valid64 <= 0) break;
    const int valid = valid64 < kE ? static_cast<int>(valid64) : kE;
    uint32_t v[4] = {0, 0, 0, 0};
    bool done = false;
    if constexpr (OS == 1) {
      if (st.ident) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = pk[c / 4 + q];
        done = true;
      }
    }
    if (!done) {
#pragma unroll
      for (int k = 0; k < kE; ++k)
        epi::pack<OS>(v, k,
                      st((pk[(c + k) >> 2] >> (8 * ((c + k) & 3))) & 0xFF));
    }
    epi::store<OS>(orow + (base + c) * OS, v, valid, aligned);
  }
}

template <typename O>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
huffman_decode_kernel(const uint8_t* __restrict__ comp, int64_t ncols,
                      const uint32_t* __restrict__ words, int64_t nw,
                      const int16_t* __restrict__ lut_sym,
                      const int8_t* __restrict__ lut_bits,
                      const int32_t* __restrict__ out_lens,
                      int chunk_elems, void* __restrict__ out,
                      epi::Args ea) {
  extern __shared__ uint4 smem_raw[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem_raw);
  uint32_t* tiles = reinterpret_cast<uint32_t*>(s_lut + kLut);
  const int64_t row = blockIdx.x;
  const int64_t out_len = out_lens[row];
  int64_t limit = out_len < chunk_elems ? out_len : chunk_elems;
  if (limit < 0) limit = 0;
  const int nseg = (chunk_elems + kSub - 1) / kSub;
  const int live = static_cast<int>((limit + kSub - 1) / kSub);
  const int nb_live = (live + kBatch - 1) / kBatch;
  const int nb_all = (nseg + kBatch - 1) / kBatch;
  const uint8_t* crow = comp + row * ncols;
  const uint32_t* wrow = words + row * nw;
  const bool vec = (nw & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(words) & 15) == 0;

  // the offsets of batches b + 1 and b + 2's first segments, and of this
  // thread's two segments of batch b, are read a batch ahead, so no batch
  // waits on device memory for them
  auto first_off = [&](int b) -> int32_t {
    return b < nb_live ? gap_offset(crow, ncols,
                                    static_cast<int64_t>(b) * kBatch) : 0;
  };
  auto seg_off = [&](int g) -> int32_t {
    return g < live ? gap_offset(crow, ncols, g) : 0;
  };
  Tile cur{0, 0};
  int32_t off1 = 0, off2 = 0, oa = 0, ob = 0;
  int ok = 1;
  if (live > 0) {  // uniform across the block
    cur = tile_of(first_off(0), first_off(1), nb_live == 1, nw);
    issue_tile(tiles, wrow, nw, cur, vec);   // in flight during the LUT
    off1 = first_off(1);
    off2 = first_off(2);
    oa = seg_off(threadIdx.x);
    ob = seg_off(threadIdx.x + kThreads);
    const int16_t* sym = lut_sym + row * kLut;
    const int8_t* bits = lut_bits + row * kLut;
    for (int i = threadIdx.x; i < kLut; i += kThreads) {
      const int8_t nb = bits[i];
      ok &= nb >= 0 && nb <= kCodeBits;
      s_lut[i] = static_cast<uint16_t>(
          static_cast<uint8_t>(sym[i]) |
          (static_cast<uint16_t>(static_cast<uint8_t>(nb)) << 8));
    }
  }
  const bool lut_ok = __syncthreads_and(ok);

  const epi::Store<O> st(ea);
  uint8_t* orow = static_cast<uint8_t*>(out) +
                  row * static_cast<int64_t>(chunk_elems) * sizeof(O);
  const bool aligned =
      ((static_cast<int64_t>(chunk_elems) * sizeof(O)) & 15) == 0;
  for (int b = 0; b < nb_all; ++b) {
    const bool staged = b < nb_live;   // uniform
    const uint32_t* t = tiles + (b & 1) * kTile;
    const Tile tl = cur;
    if (staged) {
      if (b + 1 < nb_live) {
        cur = tile_of(off1, off2, b + 2 >= nb_live, nw);
        issue_tile(tiles + ((b + 1) & 1) * kTile, wrow, nw, cur, vec);
        off1 = off2;
        off2 = first_off(b + 3);
        wait_tiles<1>();
      } else {
        wait_tiles<0>();
      }
      __syncthreads();
    }
    const int ga = b * kBatch + threadIdx.x;
    const int gb = ga + kThreads;
    const int32_t na = seg_off(ga + kBatch);
    const int32_t nb = seg_off(gb + kBatch);
    uint32_t pa[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint32_t pb[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (ga < live) {
      const int64_t hi = tl.base + tl.cnt - kWin;
      const bool ra = lut_ok && oa >= 0 && (oa >> 5) >= tl.base &&
                      (oa >> 5) <= hi;
      const bool rb = lut_ok && gb < live && ob >= 0 &&
                      (ob >> 5) >= tl.base && (ob >> 5) <= hi;
      const uint32_t la = static_cast<uint32_t>(oa - tl.base * 32);
      const uint32_t lb = static_cast<uint32_t>(ob - tl.base * 32);
      if (ra && rb) {
        chain_shared2(t, s_lut, la, lb, pa, pb);
      } else {
        if (ra) chain_shared(t, s_lut, la, pa);
        else chain_global(wrow, nw, s_lut, oa, pa);
        if (rb) chain_shared(t, s_lut, lb, pb);
        else if (gb < live) chain_global(wrow, nw, s_lut, ob, pb);
      }
      clear_from(pa, limit - static_cast<int64_t>(ga) * kSub);
      clear_from(pb, limit - static_cast<int64_t>(gb) * kSub);
    }
    if (ga < nseg) store_segment<O>(orow, ga, chunk_elems, pa, st, aligned);
    if (gb < nseg) store_segment<O>(orow, gb, chunk_elems, pb, st, aligned);
    oa = na;
    ob = nb;
    if (staged) __syncthreads();   // this tile is refilled two batches on
  }
}

template <typename O>
int launch(const void* comp, int64_t n, int64_t ncols, const void* words,
            int64_t nw, const void* lut_sym, const void* lut_bits,
            const void* out_lens, int chunk_elems, void* out,
            const epi::Args& ea, cudaStream_t s) {
  static bool carveout = [] {
    // as much shared memory as the SM has, so nine CTAs fit
    cudaFuncSetAttribute(huffman_decode_kernel<O>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return true;
  }();
  (void)carveout;
  huffman_decode_kernel<O><<<static_cast<unsigned>(n), kThreads, kSmem, s>>>(
      static_cast<const uint8_t*>(comp), ncols,
      static_cast<const uint32_t*>(words), nw,
      static_cast<const int16_t*>(lut_sym),
      static_cast<const int8_t*>(lut_bits),
      static_cast<const int32_t*>(out_lens), chunk_elems, out, ea);
  return 0;
}

}  // namespace

// Decode n huffman chunk rows into `out` ((n, chunk_elems) of the output
// type) on `stream`.  `comp` is the (n, ncols) byte table (the gap tables),
// `words` the same rows as (n, nw) uint32 words, the LUTs (n, 4096) as
// staged (i16 symbols, i8 code lengths), `out_lens` (n,) int32; `out_code`
// the output dtype's code and `src_code`, `zero`, `zero_code`, `scale`,
// `scale_code` the epilogue (`epilogue.cuh`; null operands are absent).
// Returns the CUDA error of the launch (0 on success).  Allocates nothing
// and does not synchronise.
extern "C" int codag_huffman_decode(const void* comp, int64_t n,
                                    int64_t ncols, const void* words,
                                    int64_t nw, const void* lut_sym,
                                    const void* lut_bits,
                                    const void* out_lens, int64_t chunk_elems,
                                    void* out, int out_code, int src_code,
                                    const void* zero, int zero_code,
                                    const void* scale, int scale_code,
                                    void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (ncols <= 0 || nw <= 0 || n > 0x7FFFFFFF || chunk_elems > 0x3FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const epi::Args ea{src_code, zero, zero_code, scale, scale_code};
  return EPI_DISPATCH(out_code, launch, comp, n, ncols, words, nw, lut_sym,
                      lut_bits, out_lens, static_cast<int>(chunk_elems), out,
                      ea, static_cast<cudaStream_t>(stream));
}
