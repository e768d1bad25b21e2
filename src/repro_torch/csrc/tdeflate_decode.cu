// Warp-per-chunk tdeflate (Deflate-semantics) decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `harness._generic_pallas` (src/repro/kernels/
// harness.py:359, pl.pallas_call at :409) running tdeflate's `_body`
// (src/repro/kernels/tdeflate.py:219) -> `decode_chunk` (:50), with the
// per-chunk inputs of `_chunk_inputs` (:210) and the broadcast deflate
// tables of its `consts` (:252).
//
// What it computes, per chunk row: parse Huffman tokens from an LSB-first
// bit stream over the row's uint32 words (each word index clipped to the
// row's last word).  A token peeks 12 bits and looks up (symbol, code bits)
// in the chunk's own litlen LUT.  Symbol 256, or a code of 0 bits, stops
// the parse; a symbol below 256 is a literal byte; a symbol above 256 is a
// match, whose length is LEN_BASE + extra bits and whose distance comes from
// the distance LUT, DIST_BASE and extra bits.  The parse also stops when
// the output count reaches out_len.  A match copies `length` bytes from
// `dist` back, through the circular window of Alg. 2: byte i of the copy is
// out[p - dist + (i % dist)], right when length > dist.  A match that
// reaches before the row's start reads what the reference's window reads:
// `lax.dynamic_slice` adds the buffer's length (chunk_elems + 272) to a
// negative start and clamps it to [0, chunk_elems], and byte i reads
// buf[start + min(i % dist, 271)] from before the copy: an earlier output
// byte or, at or past the current position, zero.  (At the 128 KiB chunk
// every distance is below the buffer's length, so such a match reads
// zeros.)  Writes stop at min(out_len, chunk_elems); the rest of the row is
// zero, as the reference's final `where(idx < out_len, ..., 0)`.  The
// reference's command cap (`max_cmds = out_len // 2 + 4`) cannot bind
// before the output count reaches out_len: every command covers at least
// one byte, a match at least three, and literal runs merge, so at most
// out_len / 2 + 2 commands are ever recorded.  It is not modelled.
//
// Design (the paper's own, §IV).  The TPU kernel parses the whole chunk into
// a command list and a literal side buffer in VMEM, then executes the
// commands.  At the 128 KiB chunk those buffers and the output window take
// several hundred KB per chunk, which no CTA's shared memory holds at useful
// occupancy.  So nothing is staged: one warp owns one chunk and writes its
// output row straight to global memory.  Its 32 lanes parse each token
// together, with uniform loads and uniform control flow (every lane reads
// the same words and LUT entries, which the hardware broadcasts); a literal
// is written by lane 0; a match is copied by all lanes, `i = lane, lane +
// 32, ...`, after a __syncwarp() that makes the previous tokens' bytes
// visible.  Every byte a copy reads was written by an earlier token (or is
// a zero), so the lanes of one copy never wait on each other.  The deflate
// tables (472 bytes) sit in shared memory; the LUTs are read as staged (i16
// symbols, i8 code lengths, 24,576 bytes per chunk) through the read-only
// cache.
//
// Bound: the bytes bound is the compressed row, the four LUTs and out_len
// read once, plus the output row written once, over 3.35 TB/s.  The kernel
// is really bound by its serial token chain: each token is a few dependent
// loads (word, LUT entry, extra bits, distance LUT entry), so a warp's time
// is its token count times that latency, and only the many resident warps
// overlap the chains.  Literal runs written across lanes, LUTs in shared
// memory and several chunks per warp are the later work that shortens it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kCodeBits = 12;          // MAX_CODE_BITS
constexpr int kLut = 1 << kCodeBits;   // LUT entries per chunk
constexpr int kWin = 272;              // CMD_WIN, the reference's copy window
constexpr int kLenCodes = 29;
constexpr int kDistCodes = 30;

struct BitReader {
  const uint32_t* words;
  int64_t nw;

  // the next n (<= 16) bits at bit `pos`
  __device__ __forceinline__ uint32_t peek(int64_t pos, int n) const {
    const int64_t i = pos >> 5;
    const uint32_t off = static_cast<uint32_t>(pos & 31);
    const uint32_t w0 = __ldg(words + (i < nw ? i : nw - 1));
    const uint32_t w1 = __ldg(words + (i + 1 < nw ? i + 1 : nw - 1));
    const uint32_t v = (w0 >> off) | (off ? w1 << (32 - off) : 0u);
    return v & ((1u << n) - 1u);
  }
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tdeflate_decode_kernel(const uint32_t* __restrict__ words, int64_t n,
                       int64_t nw, const int16_t* __restrict__ lut_lsym,
                       const int8_t* __restrict__ lut_lbits,
                       const int16_t* __restrict__ lut_dsym,
                       const int8_t* __restrict__ lut_dbits,
                       const int32_t* __restrict__ len_extra,
                       const int32_t* __restrict__ len_base,
                       const int32_t* __restrict__ dist_extra,
                       const int32_t* __restrict__ dist_base,
                       const int32_t* __restrict__ out_lens,
                       int64_t chunk_elems, uint8_t* __restrict__ out,
                       int32_t* __restrict__ tokens) {
  __shared__ int32_t s_len_extra[kLenCodes], s_len_base[kLenCodes];
  __shared__ int32_t s_dist_extra[kDistCodes], s_dist_base[kDistCodes];
  for (int i = threadIdx.x; i < kDistCodes; i += blockDim.x) {
    if (i < kLenCodes) {
      s_len_extra[i] = len_extra[i];
      s_len_base[i] = len_base[i];
    }
    s_dist_extra[i] = dist_extra[i];
    s_dist_base[i] = dist_base[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const BitReader bits{words + row * nw, nw};
  const int16_t* lsym = lut_lsym + row * kLut;
  const int8_t* lbits = lut_lbits + row * kLut;
  const int16_t* dsym = lut_dsym + row * kLut;
  const int8_t* dbits = lut_dbits + row * kLut;
  uint8_t* dst = out + row * chunk_elems;
  const int64_t out_len = out_lens[row];
  int64_t limit = out_len < chunk_elems ? out_len : chunk_elems;
  if (limit < 0) limit = 0;

  int64_t pos = 0, cnt = 0, ntok = 0;
  while (cnt < out_len) {
    const uint32_t v = bits.peek(pos, kCodeBits);
    const int sym = __ldg(lsym + v);
    const int nb = __ldg(lbits + v);
    if (sym == 256 || nb == 0) break;  // EOB, or an invalid code
    pos += nb;
    ++ntok;
    if (sym < 256) {
      if (lane == 0 && cnt < limit) dst[cnt] = static_cast<uint8_t>(sym);
      cnt += 1;
      continue;
    }
    int lc = sym - 257;
    lc = lc < 0 ? 0 : (lc > kLenCodes - 1 ? kLenCodes - 1 : lc);
    const int eb = s_len_extra[lc];
    const int64_t length = s_len_base[lc] + bits.peek(pos, eb);
    pos += eb;
    const uint32_t dv = bits.peek(pos, kCodeBits);
    int dc = __ldg(dsym + dv);
    dc = dc < 0 ? 0 : (dc > kDistCodes - 1 ? kDistCodes - 1 : dc);
    pos += __ldg(dbits + dv);
    const int deb = s_dist_extra[dc];
    const int64_t dist = s_dist_base[dc] + bits.peek(pos, deb);
    pos += deb;

    __syncwarp();  // the earlier tokens' bytes are visible to every lane
    int64_t src = cnt - dist;         // the window's start, as placed by
    if (src < 0) src += chunk_elems + kWin;  // lax.dynamic_slice
    src = src < 0 ? 0 : (src > chunk_elems ? chunk_elems : src);
    for (int64_t i = lane; i < length && cnt + i < limit; i += 32) {
      const int64_t k = i % dist;
      const int64_t j = src + (k < kWin - 1 ? k : kWin - 1);
      // bytes at or past cnt are not written yet: zero, as in the reference
      dst[cnt + i] = j < cnt && j < limit ? dst[j] : 0;
    }
    cnt += length;
  }
  for (int64_t i = (cnt < limit ? cnt : limit) + lane; i < chunk_elems;
       i += 32)
    dst[i] = 0;
  if (tokens != nullptr && lane == 0) tokens[row] = static_cast<int32_t>(ntok);
}

}  // namespace

// Decode n tdeflate chunk rows into `out` ((n, chunk_elems) uint8) on
// `stream`.  `words` is (n, nw) uint32; the four LUTs are (n, 4096) as
// staged (i16 symbols, i8 code lengths); the four deflate tables are int32
// (29, 29, 30, 30 entries).  `tokens`, if not null, receives each row's
// count of literal and match tokens.  Returns the CUDA error of the launch
// (0 on success).  Allocates nothing and does not synchronise.
extern "C" int codag_tdeflate_decode(
    const void* words, int64_t n, int64_t nw, const void* lut_lsym,
    const void* lut_lbits, const void* lut_dsym, const void* lut_dbits,
    const void* len_extra, const void* len_base, const void* dist_extra,
    const void* dist_base, const void* out_lens, int64_t chunk_elems,
    void* out, void* tokens, void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (nw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  tdeflate_decode_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n, nw,
      static_cast<const int16_t*>(lut_lsym),
      static_cast<const int8_t*>(lut_lbits),
      static_cast<const int16_t*>(lut_dsym),
      static_cast<const int8_t*>(lut_dbits),
      static_cast<const int32_t*>(len_extra),
      static_cast<const int32_t*>(len_base),
      static_cast<const int32_t*>(dist_extra),
      static_cast<const int32_t*>(dist_base),
      static_cast<const int32_t*>(out_lens), chunk_elems,
      static_cast<uint8_t*>(out), static_cast<int32_t*>(tokens));
  return static_cast<int>(cudaGetLastError());
}
