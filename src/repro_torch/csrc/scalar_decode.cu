// Single-thread decoding for Hopper (sm_90a): the paper's §V-E baseline,
// `EngineConfig(all_thread=False)`.
//
// Replaces no Pallas kernel.  In the reference the single-thread backend is
// `jax.vmap` of each codec's `body_scalar` (src/repro/kernels/harness.py:
// 345-355), compiled by XLA: one chunk a vector lane, one output element a
// loop step.  Here it is the same on the card: ONE THREAD A CHUNK, each
// thread writing one element of its row per step through plain global
// loads and stores.  Each entry copies the port's plain scalar body, which
// is the kernel's twin and is held to the reference's `body_scalar` on the
// CPU:
//   * `codag_scalar_rle`: rle_v1, rle_v2, dbp (`harness.scalar_chunk`): a
//     group's header is parsed when the previous group is spent, then each
//     element is expressed from its fields; no `max_groups` cap;
//   * `codag_scalar_tdeflate` (`tdeflate.decode_scalar`): one output byte a
//     step; a match copies byte by byte through a back-reference cursor
//     clipped to [0, chunk_elems + 16), so a negative source reads byte 0;
//   * `codag_scalar_lzss` (`lzss.decode_scalar`): one element a step; a
//     match element reads element clip(i - dist) of the row, which is 0 where
//     it is not written yet (a zero distance, or element 0);
//   * `codag_scalar_huffman` (`huffman.decode_scalar`): one symbol a step
//     from gap entry 0's offset (a u32 read as int32); the rest of the gap
//     table is not read, and a code length of 0 leaves the cursor in place;
//   * `codag_scalar_bitpack` (`bitpack.unpack_scalar`): element i from bit
//     i * bits.
// Every byte or word read clips to the row (`mode="clip"`), and every entry
// zeroes its row's elements at or past min(out_len, chunk_elems).
//
// Design: none beyond the baseline's; it is not meant to be fast.  Its time
// against the all-thread kernels, at the same stream count, is the number
// the paper's comparison needs.  A CTA holds `threads` chunks (the wrapper,
// `kernels/scalar.py`, takes ceil(n / SMs) rounded up to a power of two,
// at most 32), so a table spreads over every SM: 2,048 chunks are 128
// CTAs of 16 threads.  Each thread's stores go to its own row, so a warp's
// store touches one sector a lane; matches read back what the thread wrote
// (plain loads, never the non-coherent path).
//
// Bound: bytes, as for the all-thread kernels (compressed bytes, out_lens
// and LUTs read once, the output written once); it is latency-bound.
#include <cstdint>
#include <cuda_runtime.h>

#include "rle_codecs.cuh"

namespace {

constexpr int kLut = 4096;                // 12-bit code LUTs a chunk
constexpr int64_t kTdeflatePad = 16;      // the scalar body's buffer slack

template <int W> struct Elem;
template <> struct Elem<1> { using T = uint8_t; };
template <> struct Elem<2> { using T = uint16_t; };
template <> struct Elem<4> { using T = uint32_t; };

__device__ __forceinline__ int64_t clip(int64_t p, int64_t n) {
  return p < 0 ? 0 : (p < n ? p : n - 1);
}

// A compressed row through plain global loads (the reader of
// `rle_codecs.cuh`): nothing is resident, so every read is checked.
struct Row {
  const uint8_t* row;
  int64_t ncols;

  __device__ __forceinline__ uint32_t at(int64_t p) const {
    return __ldg(row + clip(p, ncols));
  }
  template <bool kChecked>
  __device__ __forceinline__ uint32_t byte(int64_t p) const { return at(p); }
  template <bool kChecked, int W>
  __device__ __forceinline__ uint32_t value(int64_t p) const {
    uint32_t v = at(p);
#pragma unroll
    for (int i = 1; i < W; ++i) v |= at(p + i) << (8 * i);
    return v;
  }
  __device__ __forceinline__ uint64_t window(int64_t p) const {
    return value<true, 4>(p) | static_cast<uint64_t>(at(p + 4)) << 32;
  }
  __device__ __forceinline__ bool holds(int64_t) const { return false; }
  __device__ __forceinline__ int64_t begin() const { return 0; }
};

// The next n (<= 32) bits at bit pos of an LSB-first word row: the funnel of
// words pos >> 5 and the next one, each clipped to the row.
__device__ __forceinline__ uint32_t peek(const uint32_t* w, int64_t nw,
                                         int64_t pos, int n) {
  const int64_t wi = pos >> 5;
  const uint32_t off = static_cast<uint32_t>(pos & 31);
  const uint32_t lo = __ldg(w + clip(wi, nw)) >> off;
  const uint32_t hi = off ? __ldg(w + clip(wi + 1, nw)) << (32 - off) : 0u;
  const uint32_t mask = n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
  return (lo | hi) & mask;
}

__device__ __forceinline__ int64_t limit_of(const int32_t* out_lens,
                                            int64_t row, int64_t ce) {
  const int64_t len = out_lens[row];
  return len < 0 ? 0 : (len < ce ? len : ce);
}

template <typename T>
__device__ __forceinline__ void zero_tail(T* dst, int64_t from, int64_t ce) {
  for (int64_t i = from; i < ce; ++i) dst[i] = 0;
}

template <int CODEC, int W>
__global__ void scalar_rle(const uint8_t* __restrict__ comp, int64_t c,
                           const int32_t* __restrict__ out_lens, int64_t n,
                           int64_t ce, typename Elem<W>::T* __restrict__ out) {
  using T = typename Elem<W>::T;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n) return;
  const Row r{comp + row * c, c};
  T* dst = out + row * ce;
  const int64_t out_len = out_lens[row];
  int64_t pos = 0;
  int rem = 0, k = 0;
  rle::Group g{0, 0, 0, 0};
  // the body writes element min(i, ce - 1) of every step up to out_len
  for (int64_t i = 0; i < out_len; ++i) {
    if (rem == 0) {
      int len, adv;
      rle::span_of<CODEC, W>(r, pos, len, adv);
      g = rle::group_at<CODEC, W>(r, pos);
      rem = len;
      k = 0;
      pos += adv;
    }
    dst[i < ce ? i : ce - 1] = static_cast<T>(
        rle::element<CODEC, W, true>(r, g.meta, g.off, g.base, g.delta, k));
    ++k;
    --rem;
  }
  zero_tail(dst, limit_of(out_lens, row, ce), ce);
}

__global__ void scalar_tdeflate(
    const uint32_t* __restrict__ words, int64_t n, int64_t nw,
    const int16_t* __restrict__ lsym, const int8_t* __restrict__ lbits,
    const int16_t* __restrict__ dsym, const int8_t* __restrict__ dbits,
    const int32_t* __restrict__ len_extra, const int32_t* __restrict__ len_base,
    const int32_t* __restrict__ dist_extra,
    const int32_t* __restrict__ dist_base,
    const int32_t* __restrict__ out_lens, int64_t ce, uint8_t* out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n) return;
  const uint32_t* w = words + row * nw;
  const int16_t* ls = lsym + row * kLut;
  const int8_t* lb = lbits + row * kLut;
  const int16_t* ds = dsym + row * kLut;
  const int8_t* db = dbits + row * kLut;
  uint8_t* dst = out + row * ce;
  const int64_t limit = limit_of(out_lens, row, ce);
  const int64_t cap = ce + kTdeflatePad;
  int64_t pos = 0, opos = 0, rem = 0, src = 0;
  bool is_m = false;
  while (opos < limit) {
    const bool need = rem == 0;
    uint8_t lit = 0;
    if (need) {   // the token at pos (tdeflate._token)
      const uint32_t v = peek(w, nw, pos, 12);
      const int64_t sym = ls[v], nb = lb[v];
      const int lc = static_cast<int>(sym - 257 < 0 ? 0
                                      : (sym - 257 > 28 ? 28 : sym - 257));
      int64_t pm = pos + nb;
      const int eb = len_extra[lc];
      const int64_t length = len_base[lc] + peek(w, nw, pm, eb);
      pm += eb;
      const uint32_t dv = peek(w, nw, pm, 12);
      const int64_t d = ds[dv];
      const int dc = static_cast<int>(d < 0 ? 0 : (d > 29 ? 29 : d));
      pm += db[dv];
      const int deb = dist_extra[dc];
      const int64_t dist = dist_base[dc] + peek(w, nw, pm, deb);
      const bool is_lit = sym < 256 && nb > 0;
      const bool is_eob = sym == 256 || nb == 0;
      const bool is_match = sym > 256 && nb > 0;
      rem = is_lit ? 1 : length;
      is_m = is_match;
      src = is_match ? opos - dist : 0;
      pos = is_match ? pm + deb : pos + nb;
      if (is_eob) break;
      lit = static_cast<uint8_t>(sym & 0xFF);
    }
    // the byte at the cursor; one not written yet is zero
    const int64_t j = src < 0 ? 0 : (src < cap ? src : cap - 1);
    const uint8_t copy = j < opos ? dst[j] : 0;
    dst[opos] = is_m || !need ? copy : lit;
    ++opos;
    --rem;
    ++src;
  }
  zero_tail(dst, opos, ce);
}

template <int W>
__global__ void scalar_lzss(const uint8_t* __restrict__ comp, int64_t n,
                            int64_t c, const int32_t* __restrict__ out_lens,
                            int64_t ce, typename Elem<W>::T* out) {
  using T = typename Elem<W>::T;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n) return;
  const Row r{comp + row * c, c};
  T* dst = out + row * ce;
  const int64_t limit = limit_of(out_lens, row, ce);
  int64_t pos = 0, rem = 0, src = 0;
  bool is_m = false;
  for (int64_t i = 0; i < limit; ++i) {
    if (rem == 0) {   // the token at pos (lzss._token)
      const uint32_t ctl = r.at(pos);
      is_m = ctl >= 128;
      rem = is_m ? ctl - 128 + 2 : ctl + 1;
      src = is_m ? i - r.value<true, 2>(pos + 1) : pos + 1;
      pos += is_m ? 3 : 1 + rem * W;
    }
    T v;
    if (is_m) {
      const int64_t j = clip(src, ce);
      v = j < i ? dst[j] : T(0);
    } else {
      v = static_cast<T>(r.value<true, W>(src));
    }
    dst[i] = v;
    --rem;
    src += is_m ? 1 : W;
  }
  zero_tail(dst, limit, ce);
}

__global__ void scalar_huffman(const uint8_t* __restrict__ comp, int64_t n,
                               int64_t c, const uint32_t* __restrict__ words,
                               int64_t nw, const int16_t* __restrict__ hsym,
                               const int8_t* __restrict__ hbits,
                               const int32_t* __restrict__ out_lens,
                               int64_t ce, uint8_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n) return;
  const Row r{comp + row * c, c};
  const uint32_t* w = words + row * nw;
  const int16_t* hs = hsym + row * kLut;
  const int8_t* hb = hbits + row * kLut;
  uint8_t* dst = out + row * ce;
  const int64_t limit = limit_of(out_lens, row, ce);
  // gap entry 0's bit offset, a u32 read as int32
  int64_t pos = static_cast<int32_t>(r.value<true, 4>(0));
  for (int64_t i = 0; i < limit; ++i) {
    const uint32_t v = peek(w, nw, pos, 12);
    dst[i] = static_cast<uint8_t>(hs[v] & 0xFF);
    pos += hb[v];
  }
  zero_tail(dst, limit, ce);
}

template <int W>
__global__ void scalar_bitpack(const uint32_t* __restrict__ words, int64_t n,
                               int64_t nw,
                               const int32_t* __restrict__ out_lens,
                               int64_t ce, int bits,
                               typename Elem<W>::T* __restrict__ out) {
  using T = typename Elem<W>::T;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n) return;
  const uint32_t* w = words + row * nw;
  T* dst = out + row * ce;
  const int64_t limit = limit_of(out_lens, row, ce);
  for (int64_t i = 0; i < limit; ++i)
    dst[i] = static_cast<T>(peek(w, nw, i * bits, bits));
  zero_tail(dst, limit, ce);
}

dim3 grid_of(int64_t n, int threads) {
  return dim3(static_cast<unsigned>((n + threads - 1) / threads));
}

bool bad_launch(int64_t n, int threads) {
  return threads < 1 || threads > 1024 || (n + threads - 1) / threads >
                                              0x7FFFFFFF;
}

}  // namespace

// Every entry decodes n chunk rows with one thread a row, `threads` a CTA,
// on `stream`, into `out` ((n, chunk_elems) of the width type, uint8 for
// tdeflate and huffman).  Tables are row-major with the row strides given
// (c bytes, nw words; LUTs of 4096 entries a row; tdeflate's four deflate
// tables of 29, 29, 30 and 30 int32).  Each returns the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for a codec, width or
// geometry it does not take), allocates nothing and does not synchronise.
extern "C" int codag_scalar_rle(int codec, int width, const void* comp,
                                int64_t c, const void* out_lens, int64_t n,
                                int64_t chunk_elems, void* out, int threads,
                                void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (c <= 0 || bad_launch(n, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const uint8_t*>(comp);
  const auto* lens = static_cast<const int32_t*>(out_lens);
#define CODAG_SCALAR_RLE(C, W)                                               \
  case C * 8 + W:                                                            \
    scalar_rle<C, W><<<grid_of(n, threads), threads, 0, s>>>(                \
        cp, c, lens, n, chunk_elems,                                         \
        static_cast<Elem<W>::T*>(out));                                      \
    break;
  switch (codec * 8 + width) {
    CODAG_SCALAR_RLE(rle::kRleV1, 1) CODAG_SCALAR_RLE(rle::kRleV1, 2)
    CODAG_SCALAR_RLE(rle::kRleV1, 4) CODAG_SCALAR_RLE(rle::kRleV2, 1)
    CODAG_SCALAR_RLE(rle::kRleV2, 2) CODAG_SCALAR_RLE(rle::kRleV2, 4)
    CODAG_SCALAR_RLE(rle::kDbp, 1) CODAG_SCALAR_RLE(rle::kDbp, 2)
    CODAG_SCALAR_RLE(rle::kDbp, 4)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CODAG_SCALAR_RLE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int codag_scalar_tdeflate(
    const void* words, int64_t n, int64_t nw, const void* lsym,
    const void* lbits, const void* dsym, const void* dbits,
    const void* len_extra, const void* len_base, const void* dist_extra,
    const void* dist_base, const void* out_lens, int64_t chunk_elems,
    void* out, int threads, void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (nw <= 0 || bad_launch(n, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  scalar_tdeflate<<<grid_of(n, threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n, nw,
      static_cast<const int16_t*>(lsym), static_cast<const int8_t*>(lbits),
      static_cast<const int16_t*>(dsym), static_cast<const int8_t*>(dbits),
      static_cast<const int32_t*>(len_extra),
      static_cast<const int32_t*>(len_base),
      static_cast<const int32_t*>(dist_extra),
      static_cast<const int32_t*>(dist_base),
      static_cast<const int32_t*>(out_lens), chunk_elems,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int codag_scalar_lzss(int width, const void* comp, int64_t n,
                                 int64_t c, const void* out_lens,
                                 int64_t chunk_elems, void* out, int threads,
                                 void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (c <= 0 || bad_launch(n, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const uint8_t*>(comp);
  const auto* lens = static_cast<const int32_t*>(out_lens);
  switch (width) {
    case 1:
      scalar_lzss<1><<<grid_of(n, threads), threads, 0, s>>>(
          cp, n, c, lens, chunk_elems, static_cast<uint8_t*>(out));
      break;
    case 2:
      scalar_lzss<2><<<grid_of(n, threads), threads, 0, s>>>(
          cp, n, c, lens, chunk_elems, static_cast<uint16_t*>(out));
      break;
    case 4:
      scalar_lzss<4><<<grid_of(n, threads), threads, 0, s>>>(
          cp, n, c, lens, chunk_elems, static_cast<uint32_t*>(out));
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int codag_scalar_huffman(const void* comp, int64_t n, int64_t c,
                                    const void* words, int64_t nw,
                                    const void* hsym, const void* hbits,
                                    const void* out_lens, int64_t chunk_elems,
                                    void* out, int threads, void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (c <= 0 || nw <= 0 || bad_launch(n, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  scalar_huffman<<<grid_of(n, threads), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), n, c,
      static_cast<const uint32_t*>(words), nw,
      static_cast<const int16_t*>(hsym), static_cast<const int8_t*>(hbits),
      static_cast<const int32_t*>(out_lens), chunk_elems,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int codag_scalar_bitpack(int width, const void* words, int64_t n,
                                    int64_t nw, const void* out_lens,
                                    int64_t chunk_elems, int bits, void* out,
                                    int threads, void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (nw <= 0 || bits < 1 || bits > 32 || bad_launch(n, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* lens = static_cast<const int32_t*>(out_lens);
  switch (width) {
    case 1:
      scalar_bitpack<1><<<grid_of(n, threads), threads, 0, s>>>(
          w, n, nw, lens, chunk_elems, bits, static_cast<uint8_t*>(out));
      break;
    case 2:
      scalar_bitpack<2><<<grid_of(n, threads), threads, 0, s>>>(
          w, n, nw, lens, chunk_elems, bits, static_cast<uint16_t*>(out));
      break;
    case 4:
      scalar_bitpack<4><<<grid_of(n, threads), threads, 0, s>>>(
          w, n, nw, lens, chunk_elems, bits, static_cast<uint32_t*>(out));
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
