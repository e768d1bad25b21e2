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
// Design.  The TPU kernel parses the whole chunk into a command list and a
// literal side buffer in VMEM, then executes the commands.  At the 128 KiB
// chunk those buffers take several hundred KB a chunk, which no CTA's
// shared memory holds at useful occupancy, so one warp owns one chunk and
// writes its row straight to global memory.  The warp's time is its serial
// token chain, so the design keeps global loads off that chain:
//
//  * Bits in registers, codes looked up at every bit offset.  Lane l holds
//    word base + l of the row (`cur`) and base + 32 + l (`nxt`), each index
//    clipped to the row's last word as before: 2,048 bits, loaded 128
//    coalesced bytes at a time, the next 32 words ~1,000 bits before they
//    are needed.  The chain of token starts is serial, but the litlen
//    lookup of a code at a known start is not: lane l looks up the code
//    that would start at bit wp + l and at wp + 32 + l (its bits read with
//    shuffles).  The chain then walks the real token starts through those
//    64 offsets, one uniform `__shfl_sync` a literal, and looks the next 64
//    up where it leaves them.  A match reads its length and distance fields
//    with one uniform 64-bit peek (three shuffles).
//  * LUTs in shared memory, packed.  At the chunk's start the warp reads
//    its staged LUTs with 16-byte loads and packs each entry into one u16,
//    `sym | nbits << 9`: the symbol canonical for what the parse does with
//    it (a literal's byte, 256, or a litlen symbol clamped at 285, the
//    clamp of `lc`; a distance symbol clamped to [0, 29]) and the code
//    length's low 7 bits (the encoder's are <= 12).  The litlen LUT keeps
//    all 4,096 entries (8 KiB); the distance LUT keeps a first level of
//    1,024 (2 KiB), indexed by the peek's low 10 bits, where the 4 entries
//    that share them agree; where they do not (a code longer than 10
//    bits), the entry says so and the parse reads the staged LUT at the
//    full 12-bit index.  Exact for any LUT.  The length and distance
//    tables sit beside them as (base, extra) pairs: one shared load each.
//  * Batches of 32 tokens, then the writes.  The warp parses up to 32
//    tokens, lane t keeping token t's output offset, literal byte or
//    (length, distance, window start).  Then the lanes write the batch's
//    output span byte-parallel, 4 x 32 bytes in flight at a time: each byte
//    finds its token from the batch's token starts (`__reduce_or_sync`,
//    `__ballot_sync`) and takes the literal, or loads its source byte, for
//    every match whose reads all lie before the batch's first byte.  Only
//    matches that read bytes of their own batch then run in token order,
//    all lanes copying, each after a `__syncwarp()` that makes the earlier
//    bytes visible.
//
// The decode epilogue (`epilogue.cuh`).  A match copies earlier output
// bytes, so with an epilogue whose output is not the raw bytes the kernel
// keeps the raw row where its matches read it, in a scratch matrix of the
// launch, and once the row is final the warp writes its epilogue in one
// vectorised pass (`epi::warp_row`), off the token chain; without one (or
// for an epilogue that only views the bytes) it stores as before, with no
// extra writes.
//
// Residency: 8 warps (chunks) a CTA, 8 x 10 KiB of LUTs, 2 CTAs an SM:
// 16 chunks an SM, 2,112 on 132 SMs, so 2,048 chunks run in one wave.
//
// Bound: the bytes bound is the compressed row, the four LUTs and out_len
// read once, plus the output row written once, over 3.35 TB/s.  The kernel
// stays bound by the token chain: a shuffle a literal; a shuffle, a peek
// and three dependent shared loads a match; six shuffles and a shared load
// every 64 bits.
//
// Assumed, as by every encoder's output: the length and distance tables
// are the deflate ones (bases >= 1, extra bits <= 16) and code lengths are
// not negative.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kCodeBits = 12;          // MAX_CODE_BITS
constexpr int kLut = 1 << kCodeBits;   // LUT entries per chunk
constexpr int kWin = 272;              // CMD_WIN, the reference's copy window
constexpr int kLenCodes = 29;
constexpr int kDistCodes = 30;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kDistFirst = 1 << 10;  // first level of the distance LUT
constexpr uint16_t kLong = 0xFFFF;    // a first-level entry that needs 12 bits
constexpr int kSmem = kWarpsPerBlock * (kLut + kDistFirst) * 2;

// litlen LUT entry (staged i16 symbol, i8 code length) -> packed u16
__device__ __forceinline__ uint32_t pack_litlen(int sym, int nbits) {
  sym = sym < 256 ? (sym & 0xFF) : (sym > 285 ? 285 : sym);
  return static_cast<uint32_t>(sym) | static_cast<uint32_t>(nbits & 0x7F) << 9;
}

__device__ __forceinline__ uint32_t pack_dist(int sym, int nbits) {
  sym = sym < 0 ? 0 : (sym > kDistCodes - 1 ? kDistCodes - 1 : sym);
  return static_cast<uint32_t>(sym) | static_cast<uint32_t>(nbits & 0x7F) << 9;
}

// one staged LUT pair (i16 symbols, i8 code lengths) into packed u16s
template <bool kLitlen>
__device__ __forceinline__ void load_lut(const int16_t* sym,
                                         const int8_t* bits, uint16_t* lut,
                                         int lane) {
  const uint4* s8 = reinterpret_cast<const uint4*>(sym);
  const uint2* b8 = reinterpret_cast<const uint2*>(bits);
#pragma unroll 4
  for (int i = lane; i < kLut / 8; i += 32) {
    const uint4 sv = __ldg(s8 + i);
    const uint2 bv = __ldg(b8 + i);
    const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
    uint32_t out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t bw = e < 2 ? bv.x : bv.y;
      const int sh = 16 * (e & 1);
      const int s0 = static_cast<int16_t>(sw[e] & 0xFFFF);
      const int s1 = static_cast<int16_t>(sw[e] >> 16);
      const int b0 = static_cast<int8_t>(bw >> sh);
      const int b1 = static_cast<int8_t>(bw >> (sh + 8));
      out[e] = kLitlen ? pack_litlen(s0, b0) | pack_litlen(s1, b1) << 16
                       : pack_dist(s0, b0) | pack_dist(s1, b1) << 16;
    }
    reinterpret_cast<uint4*>(lut)[i] = make_uint4(out[0], out[1], out[2],
                                                  out[3]);
  }
}

// The warp's bits (see the note): stream word k is word min(k, nw - 1) of
// the row; lane l holds word base + l in `cur` and base + 32 + l in `nxt`.
// Bit positions are 32-bit (rows have fewer than 2^26 words).
struct Bits {
  const uint32_t* words;
  int nw, base, lane;
  uint32_t cur, nxt;

  __device__ __forceinline__ uint32_t load(int i) const {
    uint32_t w = __ldg(words + (i < nw ? i : nw - 1));
    asm volatile("" : "+r"(w));   // kept in a register, never reloaded
    return w;
  }
  // slide the window so that bit `pos` lies in `cur` (`nxt` was loaded 32
  // words before it is needed)
  __device__ __forceinline__ void cover(int pos) {
    const int j = (pos >> 5) - base;
    if (j < 32) return;
    if (j >= 64) {   // a jump past the window: reload it
      base = pos >> 5;
      cur = load(base + lane);
    } else {
      base += 32;
      cur = nxt;
    }
    nxt = load(base + 32 + lane);
  }
  // window word j (0 <= j < 64), each lane its own j
  __device__ __forceinline__ uint32_t word(int j) const {
    const uint32_t a = __shfl_sync(kFull, cur, j & 31);
    const uint32_t b = __shfl_sync(kFull, nxt, j & 31);
    return j < 32 ? a : b;
  }
  // the 64 bits at bit p (the same p in every lane)
  __device__ __forceinline__ uint64_t peek(int p) const {
    const int j = (p >> 5) - base, off = p & 31;
    const uint64_t w0 = __shfl_sync(kFull, j < 32 ? cur : nxt, j & 31);
    const uint64_t w1 = __shfl_sync(kFull, j < 31 ? cur : nxt, (j + 1) & 31);
    const uint64_t w2 = __shfl_sync(kFull, j < 30 ? cur : nxt, (j + 2) & 31);
    return off ? (w1 << 32 | w0) >> off | w2 << (64 - off) : w1 << 32 | w0;
  }
  // the 32 bits at bit p, and at bit p + 32 (each lane its own p)
  __device__ __forceinline__ void peek2(int p, uint32_t& b0,
                                        uint32_t& b1) const {
    const int j = (p >> 5) - base;
    const uint32_t w0 = word(j), w1 = word(j + 1), w2 = word(j + 2);
    b0 = __funnelshift_r(w0, w1, p & 31);
    b1 = __funnelshift_r(w1, w2, p & 31);
  }
};

// n bits of b at bit at (at + n <= 64)
__device__ __forceinline__ uint32_t field(uint64_t b, int at, int n) {
  return n ? static_cast<uint32_t>(b >> at) & ((1u << n) - 1u) : 0u;
}

struct Tables {
  const uint16_t* lut_l;   // packed litlen LUT (4,096 entries)
  const uint16_t* lut_d;   // packed distance LUT, first level (1,024)
  const int16_t* dsym;     // the staged distance LUT, for kLong entries
  const int8_t* dbits;
  const int2* len;         // (base, extra) per length code
  const int2* dist;        // (base, extra) per distance code

  __device__ __forceinline__ uint32_t dist_entry(uint32_t v) const {
    const uint32_t e = lut_d[v & (kDistFirst - 1)];
    return e != kLong ? e : pack_dist(__ldg(dsym + v), __ldg(dbits + v));
  }
};

// S: the store (`epi::Raw`, or `epi::Store<O>` for a fused epilogue), T the
// unsigned type of its output.  With a fused epilogue the decoded bytes,
// which later matches read, go to `raw` (a scratch matrix of the launch) and
// their epilogue to `eout`; without one `raw` is the output and `eout` is
// not used.
template <typename S, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 2)
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
                       int64_t chunk_elems, uint8_t* __restrict__ raw,
                       T* __restrict__ eout, epi::Args ea,
                       int32_t* __restrict__ tokens) {
  constexpr bool kEpi = !std::is_same<S, epi::Raw>::value;
  extern __shared__ __align__(16) uint16_t s_luts[];
  __shared__ int2 s_len[kLenCodes], s_dist[kDistCodes];
  for (int i = threadIdx.x; i < kDistCodes; i += blockDim.x) {
    if (i < kLenCodes) s_len[i] = make_int2(len_base[i], len_extra[i]);
    s_dist[i] = make_int2(dist_base[i], dist_extra[i]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + wib;
  if (row >= n) return;  // uniform across the warp
  uint16_t* lut_l = s_luts + wib * (kLut + kDistFirst);
  uint16_t* lut_d = lut_l + kLut;
  const int16_t* dsym = lut_dsym + row * kLut;
  const int8_t* dbits = lut_dbits + row * kLut;
  // the distance LUT's first level: entry v (10 bits) where the 4 entries
  // v + 1024 k agree, else kLong; built in the litlen LUT's place
  load_lut<false>(dsym, dbits, lut_l, lane);
  __syncwarp();
  for (int v = lane; v < kDistFirst; v += 32) {
    const uint16_t e = lut_l[v];
    const bool same = lut_l[v + kDistFirst] == e &&
                      lut_l[v + 2 * kDistFirst] == e &&
                      lut_l[v + 3 * kDistFirst] == e;
    lut_d[v] = same ? e : kLong;
  }
  __syncwarp();
  load_lut<true>(lut_lsym + row * kLut, lut_lbits + row * kLut, lut_l, lane);
  __syncwarp();

  const Tables tabs{lut_l, lut_d, dsym, dbits, s_len, s_dist};
  Bits bits{words + row * nw, static_cast<int>(nw), 0, lane, 0, 0};
  bits.cur = bits.load(lane);
  bits.nxt = bits.load(32 + lane);
  uint8_t* dst = raw + row * chunk_elems;
  T* edst = eout + row * chunk_elems;
  const S st(ea);
  const int64_t out_len = out_lens[row];
  int64_t limit64 = out_len < chunk_elems ? out_len : chunk_elems;
  const int limit = static_cast<int>(limit64 < 0 ? 0 : limit64);

  // the litlen LUT entries of the tokens that would start at each of the 64
  // bits from wp: lane l holds those at wp + l (e0) and wp + 32 + l (e1)
  int pos = 0, wp = 0;
  uint32_t e0, e1;
  auto window = [&](int p) {
    bits.cover(p);
    wp = p;
    uint32_t b0, b1;
    bits.peek2(p + lane, b0, b1);
    e0 = lut_l[b0 & (kLut - 1)];
    e1 = lut_l[b1 & (kLut - 1)];
  };
  window(0);

  // 32-bit output count: cnt < olen <= 2^31 - 1 before a token, and a
  // token adds at most a deflate length
  const uint32_t olen = static_cast<uint32_t>(out_len > 0 ? out_len : 0);
  uint32_t cnt = 0;
  int64_t ntok = 0;
  bool stop = false;
  while (!stop && cnt < olen) {
    // ---- parse up to 32 tokens; lane t keeps token t ----------------------
    const int bs = static_cast<int>(cnt);   // the batch's first byte
    int t_c = 0, t_len = 0, t_lit = -1, t_d = 1;
    int nt = 0;
    while (nt < 32 && cnt < olen) {
      int o = pos - wp;
      if (o >= 64) {
        window(pos);
        o = 0;
      }
      const uint32_t e = __shfl_sync(kFull, o < 32 ? e0 : e1, o & 31);
      const int sym = e & 0x1FF, nb = e >> 9;
      if (sym == 256 || nb == 0) {  // EOB, or an invalid code
        stop = true;
        break;
      }
      pos += nb;
      int len = 1, lit = sym, dist = 1;
      if (sym > 256) {   // a match: its fields, one peek where they fit
        const int2 lt = tabs.len[sym - 257];
        uint64_t b = bits.peek(pos);
        len = lt.x + static_cast<int>(field(b, 0, lt.y));
        const int at = lt.y;
        const uint32_t ed = tabs.dist_entry(field(b, at, kCodeBits));
        const int2 dt = tabs.dist[ed & 0x1FF];
        int at2 = at + (ed >> 9);
        if (at2 + dt.y > 64) {
          pos += at2;
          at2 = 0;
          b = bits.peek(pos);
        }
        dist = dt.x + static_cast<int>(field(b, at2, dt.y));
        pos += at2 + dt.y;
        lit = -1;
      }
      if (lane == nt) {
        t_c = static_cast<int>(cnt);
        t_len = len;
        t_lit = lit;
        t_d = dist;
      }
      cnt += len;
      ++nt;
    }
    ntok += nt;
    if (nt == 0) break;

    // ---- write the batch's span [bs, be) ------------------------------------
    const int be = static_cast<int>(cnt < static_cast<uint32_t>(limit)
                                        ? cnt
                                        : limit);
    const bool mine = lane < nt;
    // a match's window start, as lax.dynamic_slice places it
    int64_t s0 = static_cast<int64_t>(t_c) - t_d;
    if (s0 < 0) s0 += chunk_elems + kWin;
    const int t_src = static_cast<int>(s0 < 0 ? 0 : (s0 > chunk_elems
                                                         ? chunk_elems
                                                         : s0));
    // a match reading a byte of this batch (j >= bs) waits for the rest;
    // it reads only j < min(t_c, limit)
    bool dep = false;
    if (mine && t_lit < 0) {
      const int m = min(t_len, min(t_d, kWin));
      const int64_t hi = min(static_cast<int64_t>(t_src) + m - 1,
                             static_cast<int64_t>(t_c) - 1);
      dep = hi >= bs;
    }
    const uint32_t t_flags = (t_lit & 0x1FF) | (dep ? 1u << 9 : 0u) |
                             (t_lit < 0 ? 1u << 10 : 0u);
    for (int p0 = bs; p0 < be; p0 += 128) {
      int pos[4];
      uint32_t val[4];
      bool put[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q0 = p0 + 32 * r;   // uniform
        const uint32_t bit =
            mine && t_c >= q0 && t_c - q0 < 32 ? 1u << (t_c - q0) : 0u;
        const uint32_t starts = __reduce_or_sync(kFull, bit);
        const int before = __popc(__ballot_sync(kFull, mine && t_c < q0));
        const int o =
            (before + __popc(starts & (kFull >> (31 - lane))) - 1) & 31;
        const int oc = __shfl_sync(kFull, t_c, o);
        const int osrc = __shfl_sync(kFull, t_src, o);
        const int od = __shfl_sync(kFull, t_d, o);
        const uint32_t of = __shfl_sync(kFull, t_flags, o);
        pos[r] = q0 + lane;
        put[r] = pos[r] < be && !(of >> 9 & 1);
        val[r] = of & 0xFF;
        if (put[r] && (of >> 10 & 1)) {
          const int i = pos[r] - oc;
          const int k = i < od ? i : i % od;
          const int j = osrc + (k < kWin - 1 ? k : kWin - 1);
          val[r] = j < oc && j < limit ? dst[j] : 0;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (put[r]) dst[pos[r]] = static_cast<uint8_t>(val[r]);
    }
    // the matches that read their own batch, in token order
    for (uint32_t dm = __ballot_sync(kFull, dep); dm; dm &= dm - 1) {
      const int t = __ffs(dm) - 1;
      __syncwarp();   // the earlier bytes are visible to every lane
      const int c = __shfl_sync(kFull, t_c, t);
      const int len = __shfl_sync(kFull, t_len, t);
      const int d = __shfl_sync(kFull, t_d, t);
      const int src = __shfl_sync(kFull, t_src, t);
      for (int i = lane; i < len && c + i < limit; i += 32) {
        const int k = i < d ? i : i % d;
        const int j = src + (k < kWin - 1 ? k : kWin - 1);
        // bytes at or past c are not written yet: zero, as in the reference
        dst[c + i] = j < c && j < limit ? dst[j] : 0;
      }
    }
    __syncwarp();   // this batch's bytes are visible to the next batch
  }
  const int64_t end = cnt < static_cast<uint32_t>(limit) ? cnt : limit;
  if constexpr (kEpi) {
    // the finished row's epilogue, the bytes past the stream as zeros (the
    // scratch row's tail is never read)
    __syncwarp();
    epi::warp_row<static_cast<int>(sizeof(T))>(st, dst, edst, end,
                                               chunk_elems, lane);
  } else {
    for (int64_t i = end + lane; i < chunk_elems; i += 32) dst[i] = 0;
  }
  if (tokens != nullptr && lane == 0) tokens[row] = static_cast<int32_t>(ntok);
}

template <typename S, typename T>
int launch(const void* words, int64_t n, int64_t nw, const void* lut_lsym,
           const void* lut_lbits, const void* lut_dsym, const void* lut_dbits,
           const void* len_extra, const void* len_base,
           const void* dist_extra, const void* dist_base,
           const void* out_lens, int64_t chunk_elems, void* raw, void* out,
           const epi::Args& ea, void* tokens, cudaStream_t stream) {
  auto* kernel = tdeflate_decode_kernel<S, T>;
  static bool configured[64] = {};   // the attributes are per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return static_cast<int>(err);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err == cudaSuccess)   // two CTAs an SM need its whole shared memory
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  kernel<<<grid, block, kSmem, stream>>>(
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
      static_cast<uint8_t*>(raw), static_cast<T*>(out), ea,
      static_cast<int32_t*>(tokens));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decode n tdeflate chunk rows into `out` ((n, chunk_elems) of the output
// type) on `stream`.  `words` is (n, nw) uint32; the four LUTs are (n,
// 4096) as staged (i16 symbols, i8 code lengths; 16- and 8-byte aligned);
// the four deflate tables are int32 (29, 29, 30, 30 entries); nw < 2^26 -
// 64 and chunk_elems < 2^31 - 1024.  `out_code` is the output dtype's code
// and `src_code`, `zero`, `zero_code`, `scale`, `scale_code` the epilogue
// (`epilogue.cuh`; null operands are absent).  With no operands and
// `out_code == src_code` the kernel writes the decoded bytes to `out`;
// otherwise `raw`, an (n, chunk_elems) uint8 scratch matrix, takes them
// (later matches read them there) and `out` their epilogue.  `tokens`, if
// not null, receives each row's count of literal and match tokens.  Returns
// the CUDA error of the launch (0 on success).  Allocates nothing and does
// not synchronise.
extern "C" int codag_tdeflate_decode(
    const void* words, int64_t n, int64_t nw, const void* lut_lsym,
    const void* lut_lbits, const void* lut_dsym, const void* lut_dbits,
    const void* len_extra, const void* len_base, const void* dist_extra,
    const void* dist_base, const void* out_lens, int64_t chunk_elems,
    void* out, void* raw, void* tokens, int out_code, int src_code,
    const void* zero, int zero_code, const void* scale, int scale_code,
    void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (nw <= 0 || nw > (1 << 26) - 64 || chunk_elems > 0x7FFFFC00 ||
      (reinterpret_cast<uintptr_t>(lut_lsym) & 15) ||
      (reinterpret_cast<uintptr_t>(lut_dsym) & 15) ||
      (reinterpret_cast<uintptr_t>(lut_lbits) & 7) ||
      (reinterpret_cast<uintptr_t>(lut_dbits) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  const epi::Args ea{src_code, zero, zero_code, scale, scale_code};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi::plain_store(out_code, ea))
    return launch<epi::Raw, uint8_t>(
        words, n, nw, lut_lsym, lut_lbits, lut_dsym, lut_dbits, len_extra,
        len_base, dist_extra, dist_base, out_lens, chunk_elems, out, out, ea,
        tokens, s);
  if (raw == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return epi::dispatch(out_code, [&](auto tag) {
    using O = typename decltype(tag)::type;
    return launch<epi::Store<O>,
                  typename epi::Bits<static_cast<int>(sizeof(O))>::T>(
        words, n, nw, lut_lsym, lut_lbits, lut_dsym, lut_dbits, len_extra,
        len_base, dist_extra, dist_base, out_lens, chunk_elems, raw, out, ea,
        tokens, s);
  });
}
