// bitpack unpack for Hopper (sm_90a): one thread per output element.
//
// Replaces the TPU kernel `bitpack.unpack_pallas` (src/repro/kernels/
// bitpack.py:55, pl.pallas_call at :65; reached through the codec's
// `_pallas` override, :104), whose tiles run `unpack_tile` (:33).
//
// What it computes: element i of a chunk row sits at bit i*bits, LSB first,
// in the row's uint32 words.  Its value is the 32-bit funnel of words
// w = bitpos >> 5 and w + 1 (each index clipped to the row's last word, as
// `jnp.take(mode="clip")`), shifted by bitpos & 31 and masked to `bits`,
// then cast to the width type.  Like the reference, lanes at or past a
// row's out_len are not zeroed: they read the row's zero padding.
//
// Bound: bytes.  There is no sequential dependence at all, so the kernel
// must read the packed words once and write n * chunk_elems * width bytes;
// a few integer operations per element are far below the card's rate.
// Design: a grid-stride loop over the flat n * chunk_elems outputs, so
// neighbouring threads write neighbouring outputs (coalesced stores) and
// read the same or neighbouring words (the word row is bits/32 of the
// output, served from L1/L2).  No shared memory; 64-bit offsets.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;   // grid-stride covers the rest

template <typename T>
__global__ void __launch_bounds__(kThreads)
bitpack_unpack_kernel(const uint32_t* __restrict__ words, int64_t n,
                      int64_t nw, int64_t chunk_elems, int bits,
                      T* __restrict__ out) {
  const int64_t total = n * chunk_elems;
  const uint32_t mask = bits >= 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < total; idx += stride) {
    const int64_t row = idx / chunk_elems;
    const int64_t bitpos = (idx - row * chunk_elems) * bits;
    const int64_t w = bitpos >> 5;
    const uint32_t off = static_cast<uint32_t>(bitpos & 31);
    const uint32_t* rw = words + row * nw;
    const uint32_t w0 = __ldg(rw + (w < nw ? w : nw - 1));
    const uint32_t w1 = __ldg(rw + (w + 1 < nw ? w + 1 : nw - 1));
    const uint32_t v = (w0 >> off) | (off ? w1 << (32 - off) : 0u);
    out[idx] = static_cast<T>(v & mask);
  }
}

template <typename T>
void launch(const void* words, int64_t n, int64_t nw, int64_t chunk_elems,
            int bits, void* out, cudaStream_t stream) {
  const int64_t total = n * chunk_elems;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bitpack_unpack_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      static_cast<const uint32_t*>(words), n, nw, chunk_elems, bits,
      static_cast<T*>(out));
}

}  // namespace

// Unpack n rows of `words` ((n, nw) uint32, row stride nw) into `out`
// ((n, chunk_elems) of the width type) on `stream`.  Returns the CUDA error
// of the launch (0 on success).  Allocates nothing and does not synchronise.
extern "C" int codag_bitpack_unpack(int width, const void* words, int64_t n,
                                    int64_t nw, int64_t chunk_elems, int bits,
                                    void* out, void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (nw <= 0 || bits < 1 || bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: launch<uint8_t>(words, n, nw, chunk_elems, bits, out, s); break;
    case 2: launch<uint16_t>(words, n, nw, chunk_elems, bits, out, s); break;
    case 4: launch<uint32_t>(words, n, nw, chunk_elems, bits, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
