// Warp-per-chunk element-granular LZSS decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `lzss._pallas` (src/repro/kernels/lzss.py:245) ->
// `harness._generic_pallas` (src/repro/kernels/harness.py:359,
// pl.pallas_call at :409) running lzss's `_body` (:123).
//
// What it computes, per chunk row, with `width` (1, 2 or 4) bytes per
// element.  Tokens are parsed from byte 0 while the output count is below
// out_len and fewer than chunk_elems + 4 tokens were read (`max_tokens`).
// A control byte c < 128 is a literal run of c + 1 elements whose values
// follow, little-endian; c >= 128 is a match of c - 126 elements whose u16
// LE distance follows.  Every byte read is clipped to the row's last byte,
// as `read_byte_at` with `mode="clip"`.  Lanes at or past min(out_len,
// chunk_elems) are zero.
//
// A match's value is what the reference's pointer doubling resolves: lane
// idx of a match points to max(idx - dist, 0), a literal lane to itself,
// and each lane takes the literal bytes of the fixed point its chain ends
// at (litbyte = the token's byte offset + 1 + k * width, k = idx - start).
// Derived from `_body`, for a match of `length` elements at output start s:
//   - dist == 0: every lane is its own fixed point and reads the bytes at
//     its own litbyte (the distance bytes and what follows them);
//   - otherwise lane idx steps back by dist while it stays in this match and
//     idx - dist >= 0, i.e. while idx >= max(s, dist).  Where it lands, q:
//       q < s   (an earlier token's lane): the value already written there;
//                when s >= dist this is s - dist + (k mod dist), so an
//                overlapping match (dist < length) needs no rounds;
//       q >= s  (q < dist: the next step reaches before the row's start):
//                the chain goes to lane 0, whose value is out[0] when s > 0,
//                and, when s == 0 (this match is the row's first token and
//                lane 0 its own fixed point), the bytes at this token's
//                litbyte for k = 0.
// Lanes past the last parsed token never matter: parsing runs until the
// count reaches out_len, and chains only point backwards.
//
// Design (the paper's own, §IV; the shape of tdeflate_decode.cu without the
// Huffman tables).  The TPU kernel builds per-token tables and runs
// ceil(log2 chunk_elems) rounds of pointer doubling over the whole chunk in
// VMEM; at the 128 KiB chunk those tables and pointer arrays take several
// hundred KB, more than a CTA's shared memory.  Here one warp owns one chunk
// and writes its output row straight to global memory.  Its 32 lanes parse
// each token together (uniform loads, uniform control flow).  A literal run
// of L <= 128 elements is written by the lanes together, lane j taking
// elements j, j + 32, ...; a match's lanes each compute their source lane
// directly (above), after a __syncwarp() that makes the earlier tokens'
// elements visible.  Every source lies before the match's start, so the
// lanes of one match never wait on each other.
//
// Bound: bytes.  The compressed row and out_len read once, plus the output
// row written once, over 3.35 TB/s.  The kernel is latency-bound by its
// serial token chain: each token's control byte depends on the previous
// token's length.  Only the many resident warps overlap the chains.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lzss_decode_kernel(const uint8_t* __restrict__ comp, int64_t n,
                   int64_t ncols, const int32_t* __restrict__ out_lens,
                   int64_t chunk_elems, T* __restrict__ out,
                   int32_t* __restrict__ tokens) {
  constexpr int kWidth = static_cast<int>(sizeof(T));
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const uint8_t* crow = comp + row * ncols;
  T* dst = out + row * chunk_elems;
  const int64_t out_len = out_lens[row];
  int64_t limit = out_len < chunk_elems ? out_len : chunk_elems;
  if (limit < 0) limit = 0;
  const int64_t max_tokens = chunk_elems + 4;

  auto byte_at = [&](int64_t p) -> uint32_t {
    return __ldg(crow + (p < ncols ? p : ncols - 1));
  };
  auto value_at = [&](int64_t p) -> T {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < kWidth; ++b) v |= byte_at(p + b) << (8 * b);
    return static_cast<T>(v);
  };

  int64_t pos = 0, cnt = 0, ntok = 0;
  while (cnt < out_len && ntok < max_tokens) {
    const uint32_t c = byte_at(pos);
    const int64_t litoff = pos + 1;
    ++ntok;
    if (c < 128) {  // literal run
      const int64_t length = c + 1;
      for (int64_t j = lane; j < length && cnt + j < limit; j += 32)
        dst[cnt + j] = value_at(litoff + j * kWidth);
      pos += 1 + length * kWidth;
      cnt += length;
      continue;
    }
    const int64_t length = c - 128 + 2;
    const int64_t dist = byte_at(pos + 1) | (byte_at(pos + 2) << 8);
    __syncwarp();  // the earlier tokens' elements are visible to every lane
    const int64_t s = cnt;
    const int64_t m = s > dist ? s : dist;
    for (int64_t j = lane; j < length && s + j < limit; j += 32) {
      const int64_t idx = s + j;
      T v;
      if (dist == 0) {
        v = value_at(litoff + j * kWidth);
      } else {
        const int64_t q = idx < m ? idx : idx - ((idx - m) / dist + 1) * dist;
        if (q < s)
          v = dst[q];
        else
          v = s == 0 ? value_at(litoff) : dst[0];
      }
      dst[idx] = v;
    }
    pos += 3;
    cnt += length;
  }
  for (int64_t i = (cnt < limit ? cnt : limit) + lane; i < chunk_elems;
       i += 32)
    dst[i] = 0;
  if (tokens != nullptr && lane == 0) tokens[row] = static_cast<int32_t>(ntok);
}

template <typename T>
int launch(const void* comp, int64_t n, int64_t ncols, const void* out_lens,
           int64_t chunk_elems, void* out, void* tokens, void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  lzss_decode_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), n, ncols,
      static_cast<const int32_t*>(out_lens), chunk_elems,
      static_cast<T*>(out), static_cast<int32_t*>(tokens));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decode n lzss chunk rows of `width`-byte elements into `out` ((n,
// chunk_elems) of that width) on `stream`.  `comp` is the (n, ncols) byte
// table, `out_lens` (n,) int32.  `tokens`, if not null, receives each row's
// token count.  Returns the CUDA error of the launch (0 on success).
// Allocates nothing and does not synchronise.
extern "C" int codag_lzss_decode(int width, const void* comp, int64_t n,
                                 int64_t ncols, const void* out_lens,
                                 int64_t chunk_elems, void* out, void* tokens,
                                 void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (ncols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (width) {
    case 1:
      return launch<uint8_t>(comp, n, ncols, out_lens, chunk_elems, out,
                             tokens, stream);
    case 2:
      return launch<uint16_t>(comp, n, ncols, out_lens, chunk_elems, out,
                              tokens, stream);
    case 4:
      return launch<uint32_t>(comp, n, ncols, out_lens, chunk_elems, out,
                              tokens, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
