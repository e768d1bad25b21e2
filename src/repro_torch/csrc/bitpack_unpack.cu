// bitpack unpack for Hopper (sm_90a): 16-byte output vectors, the decode
// epilogue applied in the stores.
//
// Replaces the TPU kernel `bitpack.unpack_pallas` (src/repro/kernels/
// bitpack.py:55, pl.pallas_call at :65; reached through the codec's
// `_pallas` override, :104), whose tiles run `unpack_tile` (:33), and the
// `Epilogue` the reference fuses into the same dispatch (src/repro/kernels/
// harness.py:190-194).
//
// What it computes: element i of a chunk row sits at bit i*bits, LSB first,
// in the row's uint32 words.  Its value is the 32-bit funnel of words
// w = bitpos >> 5 and w + 1 (each index clipped to the row's last word, as
// `jnp.take(mode="clip")`), shifted by bitpos & 31 and masked to `bits`,
// then cast to the width type.  Like the reference, lanes at or past a
// row's out_len are not zeroed: they read the row's zero padding.  The
// epilogue (`epilogue.cuh`) then maps each value to the output type.
//
// Bound: bytes.  No element depends on another, so the kernel must read the
// packed words once and write n * chunk_elems output elements; a few integer
// operations an element are far below the card's rate.  Design:
//   - geometry from the work: a block is 256 threads and a tile of
//     256 * vpt output vectors of one row, 16 bytes each (16 / sizeof(O)
//     elements), vpt (1..4) a thread, neighbouring threads on neighbouring
//     vectors; the grid is n * tiles_per_row blocks (`bitpack.
//     launch_geometry` computes both).  The row and tile come from blockIdx
//     once a thread, so no element pays a 64-bit division; offsets inside a
//     row are 32-bit.
//   - fast path, where bits divides 32 and a vector spans >= 16 bits
//     (`unpack_fast<O, BITS>`): no field straddles a word, and a thread's
//     span is SB = 16 / sizeof(O) * BITS / 8 aligned bytes, loaded with one
//     to four 16-byte loads (a 4-bit u8 vector, the weight path: 2 words),
//     all of a thread's vectors' loads issued before the first store; the
//     fields come out at static shifts.
//   - general path (`unpack_tiled<O>`): the block loads its tile's words
//     into shared memory with coalesced 16-byte loads (clipped to the row's
//     last word), then each thread walks its vector's fields through a
//     two-word funnel, one shared load a word.
//   - every vector leaves in one 16-byte store; a row whose byte length is
//     not a multiple of 16, or its partial last vector, takes per-element
//     stores, and a word row whose stride is not 16-byte aligned takes
//     4-byte loads.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;    // = bitpack.THREADS

__device__ __forceinline__ uint32_t field_mask(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
}

// Words [wb, wb + cnt) of a row into `s` (index clipped to nw - 1).
__device__ __forceinline__ void load_tile(uint32_t* s,
                                          const uint32_t* __restrict__ rw,
                                          int64_t nw, int64_t wb, int cnt,
                                          bool vec) {
  const int groups = (cnt + 3) >> 2;
  for (int gi = threadIdx.x; gi < groups; gi += kThreads) {
    const int64_t gw = wb + 4 * gi;
    if (vec && gw + 4 <= nw) {
      *reinterpret_cast<uint4*>(s + 4 * gi) =
          __ldg(reinterpret_cast<const uint4*>(rw + gw));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t w = gw + j;
        s[4 * gi + j] = __ldg(rw + (w < nw ? w : nw - 1));
      }
    }
  }
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
unpack_tiled(const uint32_t* __restrict__ words, int64_t nw,
             int chunk_elems, int bits, int tiles_per_row, int vpt,
             void* __restrict__ out, epi::Args ea) {
  extern __shared__ uint4 smem_raw[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem_raw);
  constexpr int OS = sizeof(O);
  constexpr int kE = 16 / OS;
  const uint32_t row = blockIdx.x / static_cast<uint32_t>(tiles_per_row);
  const uint32_t tile = blockIdx.x - row * tiles_per_row;
  const uint32_t tile_elems = kThreads * kE * vpt;
  const uint32_t e_tile = tile * tile_elems;
  // the tile's words: from its first field's word (rounded down to 4) to
  // two past its last field's, for every vector of the tile, full or not
  const int64_t wb = static_cast<int64_t>(
      (static_cast<uint64_t>(e_tile) * bits) >> 5) & ~int64_t{3};
  const int64_t wl = static_cast<int64_t>(
      (static_cast<uint64_t>(e_tile + tile_elems) * bits + 31) >> 5) + 2;
  const uint32_t* rw = words + static_cast<int64_t>(row) * nw;
  const bool vec = (nw & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  load_tile(s, rw, nw, wb, static_cast<int>(wl - wb), vec);
  __syncthreads();

  const epi::Store<O> st(ea);
  const uint32_t mask = field_mask(bits);
  const bool aligned = ((static_cast<int64_t>(chunk_elems) * OS) & 15) == 0;
  uint8_t* orow = static_cast<uint8_t*>(out) +
                  static_cast<int64_t>(row) * chunk_elems * OS;
  for (int j = 0; j < vpt; ++j) {
    const uint32_t e0 = e_tile + (j * kThreads + threadIdx.x) * kE;
    if (e0 >= static_cast<uint32_t>(chunk_elems)) break;
    const uint32_t lb = static_cast<uint32_t>(
        static_cast<uint64_t>(e0) * bits - static_cast<uint64_t>(wb) * 32);
    int w = lb >> 5;
    uint32_t off = lb & 31;
    uint32_t lo = s[w], hi = s[w + 1];
    uint32_t pk[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      epi::pack<OS>(pk, k, st(__funnelshift_r(lo, hi, off) & mask));
      off += bits;
      if (off >= 32) {
        off -= 32;
        lo = hi;
        hi = s[++w + 1];
      }
    }
    epi::store<OS>(orow + static_cast<int64_t>(e0) * OS, pk,
                   min(kE, chunk_elems - static_cast<int>(e0)), aligned);
  }
}

// vectors a thread on the fast path: as many as keep its words in at most
// 16 registers, up to 4 (the same rule as bitpack.launch_geometry)
__host__ __device__ constexpr int fast_vpt(int words) {
  return words >= 16 ? 1 : words >= 8 ? 2 : 4;
}

template <typename O, int BITS>
__global__ void __launch_bounds__(kThreads)
unpack_fast(const uint32_t* __restrict__ words, int64_t nw, int chunk_elems,
            int tiles_per_row, void* __restrict__ out, epi::Args ea) {
  constexpr int OS = sizeof(O);
  constexpr int kE = 16 / OS;
  constexpr int kSpan = kE * BITS;                  // bits a vector
  constexpr int kWords = kSpan >= 32 ? kSpan / 32 : 1;
  constexpr int kVpt = fast_vpt(kWords);
  constexpr uint32_t kMask = BITS >= 32 ? 0xFFFFFFFFu : (1u << BITS) - 1u;
  static_assert(32 % BITS == 0 && kSpan >= 16, "fast path geometry");
  const uint32_t row = blockIdx.x / static_cast<uint32_t>(tiles_per_row);
  const uint32_t tile = blockIdx.x - row * tiles_per_row;
  const uint32_t* rw = words + static_cast<int64_t>(row) * nw;
  const bool vec = (nw & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  // every vector's words first, so all of a thread's loads are in flight
  uint32_t w[kVpt][kWords];
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    const uint32_t e0 = ((tile * kVpt + j) * kThreads + threadIdx.x) * kE;
    const uint64_t bit0 = static_cast<uint64_t>(e0) * BITS;
    const int64_t w0 = static_cast<int64_t>(bit0 >> 5);
    const bool direct = vec && w0 + kWords <= nw;
    if constexpr (kWords >= 4) {
      if (direct) {
#pragma unroll
        for (int q = 0; q < kWords; q += 4) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(rw + w0 + q));
          w[j][q] = v.x; w[j][q + 1] = v.y; w[j][q + 2] = v.z;
          w[j][q + 3] = v.w;
        }
      }
    } else if constexpr (kWords == 2) {
      if (direct) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(rw + w0));
        w[j][0] = v.x; w[j][1] = v.y;
      }
    }
    if (kWords == 1 || !direct) {
#pragma unroll
      for (int q = 0; q < kWords; ++q)
        w[j][q] = __ldg(rw + (w0 + q < nw ? w0 + q : nw - 1));
    }
    if (kSpan < 32) w[j][0] >>= (bit0 & 31);        // a half word
  }
  const epi::Store<O> st(ea);
  const bool aligned = ((static_cast<int64_t>(chunk_elems) * OS) & 15) == 0;
  uint8_t* orow = static_cast<uint8_t*>(out) +
                  static_cast<int64_t>(row) * chunk_elems * OS;
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    const uint32_t e0 = ((tile * kVpt + j) * kThreads + threadIdx.x) * kE;
    if (e0 >= static_cast<uint32_t>(chunk_elems)) break;
    uint32_t pk[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      constexpr int kPer = 32 / BITS;               // fields a word
      epi::pack<OS>(pk, k,
                    st((w[j][k / kPer] >> ((k % kPer) * BITS)) & kMask));
    }
    epi::store<OS>(orow + static_cast<int64_t>(e0) * OS, pk,
                   min(kE, chunk_elems - static_cast<int>(e0)), aligned);
  }
}

// the fast path's BITS for `bits`, or 0 where the general path runs (the
// same rule as bitpack.launch_geometry)
int fast_bits(int bits, int os) {
  const int e = 16 / os;
  return (32 % bits == 0 && e * bits >= 16) ? bits : 0;
}

// Launch the kernel for this geometry; cudaErrorInvalidValue where the
// geometry is not one this source launches.
template <typename O>
int launch(const void* words, int64_t nw, int chunk_elems, int bits,
           int tiles_per_row, int vpt, unsigned blocks, void* out,
           const epi::Args& ea, cudaStream_t s) {
  constexpr int OS = sizeof(O);
  const auto* w = static_cast<const uint32_t*>(words);
  switch (fast_bits(bits, OS)) {
#define CODAG_FAST(B)                                                        \
  case B:                                                                    \
    if constexpr ((16 / OS) * B >= 16) {                                     \
      constexpr int kWords = (16 / OS) * B >= 32 ? (16 / OS) * B / 32 : 1;   \
      if (vpt != fast_vpt(kWords)) break; /* not the caller's geometry */    \
      unpack_fast<O, B><<<blocks, kThreads, 0, s>>>(w, nw, chunk_elems,      \
                                                    tiles_per_row, out, ea); \
    }                                                                        \
    return 0;
    CODAG_FAST(1) CODAG_FAST(2) CODAG_FAST(4) CODAG_FAST(8) CODAG_FAST(16)
    CODAG_FAST(32)
#undef CODAG_FAST
    default: {
      const int e = 16 / OS;
      const size_t smem =
          4 * (static_cast<size_t>(kThreads) * vpt * e * bits / 32 + 12);
      if (smem > 48 * 1024) break;
      unpack_tiled<O><<<blocks, kThreads, smem, s>>>(
          w, nw, chunk_elems, bits, tiles_per_row, vpt, out, ea);
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Unpack n rows of `words` ((n, nw) uint32, row stride nw) into `out`
// ((n, chunk_elems) of the output type) on `stream`, in n * tiles_per_row
// blocks of 256 threads, `vpt` 16-byte vectors a thread
// (`bitpack.launch_geometry`).  `width` is the decoded element's byte
// width; `out_code` the output dtype's code and `src_code`, `zero`,
// `zero_code`, `scale`, `scale_code` the epilogue (`epilogue.cuh`; null
// operands are absent).  Returns the CUDA error of the launch (0 on
// success).  Allocates nothing and does not synchronise.
extern "C" int codag_bitpack_unpack(int width, const void* words, int64_t n,
                                    int64_t nw, int64_t chunk_elems, int bits,
                                    int64_t tiles_per_row, int vpt, void* out,
                                    int out_code, int src_code,
                                    const void* zero, int zero_code,
                                    const void* scale, int scale_code,
                                    void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  const int64_t blocks = n * tiles_per_row;
  if (nw <= 0 || bits < 1 || bits > 32 || chunk_elems > 0x3FFFFFFF ||
      tiles_per_row <= 0 || blocks > 0x7FFFFFFF || vpt < 1 || vpt > 4 ||
      (width != 1 && width != 2 && width != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const epi::Args ea{src_code, zero, zero_code, scale, scale_code};
  return EPI_DISPATCH(out_code, launch, words, nw,
                      static_cast<int>(chunk_elems), bits,
                      static_cast<int>(tiles_per_row), vpt,
                      static_cast<unsigned>(blocks), out, ea,
                      static_cast<cudaStream_t>(stream));
}
