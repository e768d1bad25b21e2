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
//   - short rows share a block on the fast path: where a row fills at most
//     half of a block's 256 * vpt vector slots, a block takes rows_per_block
//     whole rows (slot g: row g / vectors-a-row, its vector g % vectors-a-
//     row), so a table of 128-element rows (the int8 gradient wire, one
//     quantization block a row) runs full blocks instead of one row's 32
//     vectors in each;
//   - the epilogue's zero and scale may be one value a chunk row (the wire's
//     per-block scale, `epilogue.cuh`): a thread reads its vector's row's;
//   - every vector leaves in one 16-byte store; a row whose byte length is
//     not a multiple of 16, or its partial last vector, takes per-element
//     stores, and a word row whose stride is not 16-byte aligned takes
//     4-byte loads.
// A second entry, `codag_bitpack_reduce`, decodes a gathered table of
// several members' rows and folds the member axis in its stores (the
// collective plane's dequant -> member sum or mean; `reduce_members`
// below).
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

  const epi::Store<O> st(ea, row);
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
unpack_fast(const uint32_t* __restrict__ words, int64_t n, int64_t nw,
            int chunk_elems, int tiles_per_row, int rows_per_block,
            void* __restrict__ out, epi::Args ea) {
  constexpr int OS = sizeof(O);
  constexpr int kE = 16 / OS;
  constexpr int kSpan = kE * BITS;                  // bits a vector
  constexpr int kWords = kSpan >= 32 ? kSpan / 32 : 1;
  constexpr int kVpt = fast_vpt(kWords);
  constexpr uint32_t kMask = BITS >= 32 ? 0xFFFFFFFFu : (1u << BITS) - 1u;
  static_assert(32 % BITS == 0 && kSpan >= 16, "fast path geometry");
  // each of the thread's vectors: its row and first element (chunk_elems
  // or more: no vector)
  int64_t vrow[kVpt];
  uint32_t ve0[kVpt];
  if (rows_per_block == 1) {
    const uint32_t row = blockIdx.x / static_cast<uint32_t>(tiles_per_row);
    const uint32_t tile = blockIdx.x - row * tiles_per_row;
#pragma unroll
    for (int j = 0; j < kVpt; ++j) {
      vrow[j] = row;
      ve0[j] = ((tile * kVpt + j) * kThreads + threadIdx.x) * kE;
    }
  } else {
    const uint32_t vpr = (chunk_elems + kE - 1) / kE;   // vectors a row
#pragma unroll
    for (int j = 0; j < kVpt; ++j) {
      const uint32_t g = j * kThreads + threadIdx.x;
      const uint32_t r = g / vpr;
      vrow[j] = static_cast<int64_t>(blockIdx.x) * rows_per_block + r;
      ve0[j] = r < static_cast<uint32_t>(rows_per_block) && vrow[j] < n
                   ? (g - r * vpr) * kE
                   : static_cast<uint32_t>(chunk_elems);
    }
  }
  const bool vec = (nw & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  // every vector's words first, so all of a thread's loads are in flight
  uint32_t w[kVpt][kWords];
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    if (ve0[j] >= static_cast<uint32_t>(chunk_elems)) continue;
    const uint32_t* rw = words + vrow[j] * nw;
    const uint64_t bit0 = static_cast<uint64_t>(ve0[j]) * BITS;
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
  // the operands of the thread's first row (a slot past the table's last
  // row reads the last row's, and stores nothing); rows that share a block
  // read their own where an operand has one a row
  epi::Store<O> st(ea, vrow[0] < n ? vrow[0] : n - 1);
  const bool per_vector = rows_per_block > 1 && epi::Store<O>::by_row(ea);
  const bool aligned = ((static_cast<int64_t>(chunk_elems) * OS) & 15) == 0;
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    const uint32_t e0 = ve0[j];
    if (e0 >= static_cast<uint32_t>(chunk_elems)) continue;
    if (per_vector) st.set_row(ea, vrow[j]);
    uint8_t* orow = static_cast<uint8_t*>(out) + vrow[j] * chunk_elems * OS;
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
int launch(const void* words, int64_t n, int64_t nw, int chunk_elems,
           int bits, int tiles_per_row, int vpt, int rows_per_block,
           unsigned blocks, void* out, const epi::Args& ea, cudaStream_t s) {
  constexpr int OS = sizeof(O);
  const auto* w = static_cast<const uint32_t*>(words);
  const int64_t row_vectors = (chunk_elems + 16 / OS - 1) / (16 / OS);
  switch (fast_bits(bits, OS)) {
#define CODAG_FAST(B)                                                        \
  case B:                                                                    \
    if constexpr ((16 / OS) * B >= 16) {                                     \
      constexpr int kWords = (16 / OS) * B >= 32 ? (16 / OS) * B / 32 : 1;   \
      if (vpt != fast_vpt(kWords)) break; /* not the caller's geometry */    \
      if (rows_per_block > 1 &&                                              \
          (tiles_per_row != 1 ||                                             \
           rows_per_block * row_vectors > int64_t{kThreads} * vpt))          \
        break;                /* the block's slots must hold its rows */     \
      unpack_fast<O, B><<<blocks, kThreads, 0, s>>>(                         \
          w, n, nw, chunk_elems, tiles_per_row, rows_per_block, out, ea);    \
    }                                                                        \
    return 0;
    CODAG_FAST(1) CODAG_FAST(2) CODAG_FAST(4) CODAG_FAST(8) CODAG_FAST(16)
    CODAG_FAST(32)
#undef CODAG_FAST
    default: {
      if (rows_per_block != 1) break;   // the tiled path takes a row a tile
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

// The member reduce of the collective plane (`codag_bitpack_reduce`): the
// receive path of a compressed all-reduce.  The table holds `members`
// members' rows one member after another (member m's row r at m * nb + r,
// `plan.gather_member_tables`); out is (nb, chunk_elems) float32:
//   out[r, c] = sum over m = 0 .. members-1 of epi(field(m * nb + r, c)),
//   divided by `members` when `mean`,
// where epi is the launch's epilogue (`epilogue.cuh`: for the int8 wire,
// (u8 - 127) * s[m * nb + r], a float32 subtract then a float32 multiply,
// each rounded).  The members add in order, each add rounded
// (`__fadd_rn`, never contracted into an FMA with the multiply), from
// member 0's value; the mean is a true division (`__fdiv_rn`).  This is
// the reference's `Epilogue(fn=_member_reduce(n, mean))` (src/repro/
// distributed/collectives.py:144-156) applied in the stores, and the
// port's plain version `harness.MemberReduce` adds in the same order, so
// the two agree bit for bit; the per-member dequantized rows never exist.
// Like `unpack_fast`, the kernel reads no out_lens: a row whose out_lens
// a ragged gather zeroed (a member's padding row) contributes the
// dequantized values of the words it holds, as the reference's unpack and
// the plain version do (rows of zero words on the int8 wire each add
// (0 - 127) * s).
// Geometry: a thread takes 16 consecutive outputs of a row (four 16-byte
// float32 vectors), so for 8-bit fields it reads one 16-byte load of each
// member's words and 8 threads cover a 128-element row; a block is 256
// threads in row order.  BITS divides 32, so the fields lie in whole words
// at static shifts.  A thread loads up to 4 members' words (16 words in
// all) before it converts and adds them.  Bound: bytes (each member's
// words and operands read once, the float32 output written once).
template <int BITS>
__global__ void __launch_bounds__(kThreads)
reduce_members(const uint32_t* __restrict__ words, int64_t nb, int members,
               int64_t nw, int chunk_elems, bool mean, bool small,
               float* __restrict__ out, epi::Args ea) {
  constexpr int kT = 16;                         // outputs a thread
  constexpr int kSpan = kT * BITS;               // bits a thread
  constexpr int kWords = kSpan >= 32 ? kSpan / 32 : 1;
  constexpr int kPer = 32 / BITS;                // fields a word
  constexpr uint32_t kMask = BITS >= 32 ? 0xFFFFFFFFu : (1u << BITS) - 1u;
  constexpr int kBatch = kWords >= 16 ? 1 : kWords >= 8 ? 2 : 4;
  static_assert(32 % BITS == 0, "fields in whole words");
  const uint32_t tpr = (chunk_elems + kT - 1) / kT;      // threads a row
  int64_t r;
  uint32_t t;
  if (small) {             // fewer than 2^32 threads: 32-bit division
    const uint32_t g = blockIdx.x * kThreads + threadIdx.x;
    if (g >= static_cast<uint64_t>(nb) * tpr) return;
    r = g / tpr;
    t = g - static_cast<uint32_t>(r) * tpr;
  } else {
    const uint64_t g = static_cast<uint64_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
    if (g >= static_cast<uint64_t>(nb) * tpr) return;
    r = static_cast<int64_t>(g / tpr);
    t = static_cast<uint32_t>(g - static_cast<uint64_t>(r) * tpr);
  }
  const uint32_t e0 = t * kT;
  const uint64_t bit0 = static_cast<uint64_t>(e0) * BITS;
  const int64_t w0 = static_cast<int64_t>(bit0 >> 5);
  // 16-byte (or 8-byte) loads where the thread's words are whole and
  // aligned; else one clipped load a word
  const bool direct = w0 + kWords <= nw && (nw & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  epi::Store<float> st(ea, r);
  float acc[kT];
  for (int m0 = 0; m0 < members; m0 += kBatch) {
    uint32_t w[kBatch][kWords];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (m0 + j >= members) break;
      const uint32_t* rw =
          words + (static_cast<int64_t>(m0 + j) * nb + r) * nw;
      if constexpr (kWords >= 4) {
        if (direct) {
#pragma unroll
          for (int q = 0; q < kWords; q += 4) {
            const uint4 v =
                __ldg(reinterpret_cast<const uint4*>(rw + w0 + q));
            w[j][q] = v.x; w[j][q + 1] = v.y; w[j][q + 2] = v.z;
            w[j][q + 3] = v.w;
          }
          continue;
        }
      } else if constexpr (kWords == 2) {
        if (direct) {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(rw + w0));
          w[j][0] = v.x; w[j][1] = v.y;
          continue;
        }
      }
#pragma unroll
      for (int q = 0; q < kWords; ++q)
        w[j][q] = __ldg(rw + (w0 + q < nw ? w0 + q : nw - 1));
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int m = m0 + j;
      if (m >= members) break;
      if (kSpan < 32) w[j][0] >>= (bit0 & 31);   // the thread's part word
      st.set_row(ea, static_cast<int64_t>(m) * nb + r);
#pragma unroll
      for (int k = 0; k < kT; ++k) {
        const float x = __uint_as_float(
            st((w[j][k / kPer] >> ((k % kPer) * BITS)) & kMask));
        acc[k] = m == 0 ? x : __fadd_rn(acc[k], x);
      }
    }
  }
  float* orow = out + r * chunk_elems;
  const bool aligned = (chunk_elems & 3) == 0;
#pragma unroll
  for (int v = 0; v < kT / 4; ++v) {
    const int e = static_cast<int>(e0) + 4 * v;
    if (e >= chunk_elems) break;
    uint32_t pk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a = acc[4 * v + k];
      pk[k] = __float_as_uint(
          mean ? __fdiv_rn(a, static_cast<float>(members)) : a);
    }
    epi::store<4>(orow + e, pk, min(4, chunk_elems - e), aligned);
  }
}

}  // namespace

// Unpack n rows of `words` ((n, nw) uint32, row stride nw) into `out`
// ((n, chunk_elems) of the output type) on `stream`, in
// ceil(n / rows_per_block) * tiles_per_row blocks of 256 threads, `vpt`
// 16-byte vectors a thread (`bitpack.launch_geometry`; rows_per_block > 1
// only on the fast path, with one tile a row).  `width` is the decoded
// element's byte width; `out_code` the output dtype's code and `src_code`,
// `zero`, `zero_code`, `scale`, `scale_code`, `zero_stride`, `scale_stride`
// the epilogue (`epilogue.cuh`; null operands are absent, a stride of 1
// reads one operand a chunk row).  Returns the CUDA error of the launch (0
// on success).  Allocates nothing and does not synchronise.
extern "C" int codag_bitpack_unpack(int width, const void* words, int64_t n,
                                    int64_t nw, int64_t chunk_elems, int bits,
                                    int64_t tiles_per_row, int vpt,
                                    int rows_per_block, void* out,
                                    int out_code, int src_code,
                                    const void* zero, int zero_code,
                                    const void* scale, int scale_code,
                                    int64_t zero_stride, int64_t scale_stride,
                                    void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (rows_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks =
      (n + rows_per_block - 1) / rows_per_block * tiles_per_row;
  if (nw <= 0 || bits < 1 || bits > 32 || chunk_elems > 0x3FFFFFFF ||
      tiles_per_row <= 0 || blocks > 0x7FFFFFFF || vpt < 1 || vpt > 4 ||
      zero_stride < 0 || scale_stride < 0 ||
      (width != 1 && width != 2 && width != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  epi::Args ea{src_code, zero, zero_code, scale, scale_code};
  ea.zero_stride = zero_stride;
  ea.scale_stride = scale_stride;
  return EPI_DISPATCH(out_code, launch, words, n, nw,
                      static_cast<int>(chunk_elems), bits,
                      static_cast<int>(tiles_per_row), vpt, rows_per_block,
                      static_cast<unsigned>(blocks), out, ea,
                      static_cast<cudaStream_t>(stream));
}

// Fold the member axis of a gathered table in the stores: `words` holds
// members * nb rows ((members * nb, nw) uint32, member m's row r at
// m * nb + r); `out` gets (nb, chunk_elems) float32, each element the sum
// over the members, in member order, of its field's epilogue value, over
// `members` when `mean` is nonzero (`reduce_members` above).  `bits` must
// divide 32; `src_code`, `zero`, `zero_code`, `scale`, `scale_code`,
// `zero_stride`, `scale_stride` are the float32 epilogue as for
// `codag_bitpack_unpack` (a stride of 1 reads one operand a gathered row).
// Returns the CUDA error of the launch (0 on success).  Allocates nothing
// and does not synchronise.
extern "C" int codag_bitpack_reduce(const void* words, int64_t nb,
                                    int members, int64_t nw,
                                    int64_t chunk_elems, int bits, int mean,
                                    void* out, int src_code,
                                    const void* zero, int zero_code,
                                    const void* scale, int scale_code,
                                    int64_t zero_stride, int64_t scale_stride,
                                    void* stream) {
  if (nb <= 0 || chunk_elems <= 0) return 0;
  if (members < 1 || nw <= 0 || chunk_elems > 0x3FFFFFFF ||
      zero_stride < 0 || scale_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = nb * ((chunk_elems + 15) / 16);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  epi::Args ea{src_code, zero, zero_code, scale, scale_code};
  ea.zero_stride = zero_stride;
  ea.scale_stride = scale_stride;
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<float*>(out);
  const bool small = blocks * kThreads <= int64_t{0xFFFFFFFF};
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const int ce = static_cast<int>(chunk_elems);
  switch (bits) {
#define CODAG_REDUCE(B)                                                      \
  case B:                                                                    \
    reduce_members<B><<<grid, kThreads, 0, s>>>(w, nb, members, nw, ce,      \
                                                mean != 0, small, o, ea);    \
    break;
    CODAG_REDUCE(1) CODAG_REDUCE(2) CODAG_REDUCE(4) CODAG_REDUCE(8)
    CODAG_REDUCE(16) CODAG_REDUCE(32)
#undef CODAG_REDUCE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
