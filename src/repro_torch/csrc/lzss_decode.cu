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
//   So a match element with s > 0 and dist > 0 reads one earlier element,
//   its source: q when q < s, else element 0 (`source` below).
// Lanes past the last parsed token never matter: parsing runs until the
// count reaches out_len, and chains only point backwards.
//
// Design.  The TPU kernel builds per-token tables and runs ceil(log2
// chunk_elems) rounds of pointer doubling over the whole chunk in VMEM; at
// the 128 KiB chunk those tables take several hundred KB, more than a CTA's
// shared memory.  Here one warp owns one chunk.  Its time is the serial
// token chain (each control byte's offset depends on the previous token's
// length), so the design keeps global memory off that chain, as
// tdeflate_decode.cu does:
//
//  * Compressed bytes in shared memory.  Each warp keeps 4 KiB of its row
//    in a shared ring (byte p at ring[p mod 4096]): four 1 KiB blocks,
//    loaded with 16-byte coalesced loads, and the next block waits in
//    registers (two 16-byte words a lane), loaded a block ahead.  A block
//    past the row's end holds its last byte, so a read clips as `byte_at`
//    does.  The batch rules below keep every read inside the resident
//    blocks, so no read on the chain leaves shared memory.
//  * Batches of 32 tokens.  The warp walks up to 32 control bytes through
//    the ring, every lane the same walk, and writes each token's byte
//    offset and output start into a shared table (all lanes the same
//    entry, so none branches off the chain); then lane t reads token t's
//    control and distance bytes again.  A batch also ends before a token
//    that could read past the resident blocks (517 bytes, a zero-distance
//    129-element match at width 4) or whose elements would take the batch
//    past 160 elements (a 129-element match fits any batch).
//  * The batch written element-parallel through a shared stage.  All lanes
//    stride over the batch's elements; each finds its token from the 32
//    starts (`__reduce_or_sync`, `__ballot_sync`) and takes its literal
//    bytes from the ring or, for a match whose source lies before the
//    batch, loads it from the row in global memory: the earlier batches'
//    stores are visible after one `__syncwarp()`, so the batch pays one L2
//    round trip with every lane's loads in flight, and those loads stay in
//    flight while the warp parses the next batch.  A match with a source inside its own batch leaves
//    those elements for a second pass, which runs the batch's dependent
//    matches in token order, reading the stage (a source always lies
//    before its match's start).  Then the stage goes to the row, coalesced.
//
// The decode epilogue (`epilogue.cuh`).  A match loads its source from the
// row's earlier batches, so with an epilogue whose output is not the raw
// elements the kernel keeps the raw row where its matches read it, in a
// scratch matrix of the launch, and once the row is final the warp writes
// its epilogue in one vectorised pass (`epi::warp_row`), off the token
// chain; without one (or for an epilogue that only views the elements) it
// stores as before.
//
// Residency: 4 warps (chunks) a CTA, 4 x 4.8 KiB of shared memory at width
// 4.  At 1,024 chunks that is ~8 chunks an SM, one wave.
//
// Bound: bytes.  The compressed row and out_len read once, plus the output
// row written once, over 3.35 TB/s.  The kernel stays bound by the token
// chain: a shared load and a few integer operations a token.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBlockBytes = 1024;                 // a block of the ring
constexpr int kTileBlocks = 4;                    // resident blocks a warp
constexpr int kTileBytes = kBlockBytes * kTileBlocks;
constexpr int kTokenBytes = 1 + 129 * 4;          // most bytes a token reads
constexpr int kSpan = 160;                        // most elements a batch

// The warp's window on its compressed row: blocks [lo, lo + kTileBlocks)
// in the shared ring, block lo + kTileBlocks in `next` (lane l holds its
// 16-byte words l and l + 32).  Every byte index is clipped to the row.
struct Tile {
  const uint8_t* row;
  int64_t ncols;
  uint8_t* ring;
  int lane;
  bool vec;      // the row's 16-byte words are aligned
  int64_t lo;    // the first resident block
  uint4 next[2];

  __device__ __forceinline__ uint32_t global_byte(int64_t p) const {
    return __ldg(row + (p < ncols ? p : ncols - 1));
  }
  // the 16 bytes at block blk, word i
  __device__ __forceinline__ uint4 fetch(int64_t blk, int i) const {
    const int64_t p = blk * kBlockBytes + 16 * i;
    if (vec && p + 16 <= ncols)
      return __ldg(reinterpret_cast<const uint4*>(row + p));
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        w[j] |= global_byte(p + 4 * j + b) << (8 * b);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ void load_next(int64_t blk) {
    next[0] = fetch(blk, lane);
    next[1] = fetch(blk, lane + 32);
  }
  // `next` (block blk) into its slot of the ring
  __device__ __forceinline__ void put(int64_t blk) {
    uint4* r = reinterpret_cast<uint4*>(
        ring + (blk % kTileBlocks) * kBlockBytes);
    r[lane] = next[0];
    r[lane + 32] = next[1];
  }
  __device__ void init() {
    lo = 0;
    for (int b = 0; b < kTileBlocks; ++b) {
      load_next(b);
      put(b);
    }
    load_next(kTileBlocks);
    __syncwarp();
  }
  // slide the window so that byte `pos` lies in its first block (uniform;
  // the ring's earlier blocks are no longer read, once every lane is here)
  __device__ __forceinline__ void advance(int64_t pos) {
    const int64_t blk = pos / kBlockBytes;
    if (blk <= lo) return;
    __syncwarp();
    while (lo < blk) {
      put(lo + kTileBlocks);
      ++lo;
      load_next(lo + kTileBlocks);
    }
    __syncwarp();
  }
  __device__ __forceinline__ int64_t begin() const { return lo * kBlockBytes; }
  __device__ __forceinline__ int64_t end() const {
    return (lo + kTileBlocks) * kBlockBytes;
  }
  // byte p, and the width bytes at p, of the resident blocks: the batch
  // rules keep every read of the parse and the writes inside them
  __device__ __forceinline__ uint32_t byte(int64_t p) const {
    return ring[p & (kTileBytes - 1)];
  }
  template <int W>
  __device__ __forceinline__ uint32_t value(int64_t p) const {
    if (W == 1) return byte(p);
    // the two aligned words that hold bytes p .. p + 4
    const uint32_t* words = reinterpret_cast<const uint32_t*>(ring);
    const uint32_t i = static_cast<uint32_t>(p) & (kTileBytes - 1);
    const uint64_t lo8 = words[i >> 2];
    const uint64_t hi8 = words[((i >> 2) + 1) & (kTileBytes / 4 - 1)];
    const uint32_t v = static_cast<uint32_t>((hi8 << 32 | lo8) >> (8 * (i & 3)));
    return W == 4 ? v : v & 0xFFFFu;
  }
};

// the source element of a match element idx (s > 0, dist > 0; see above)
__device__ __forceinline__ uint32_t source(uint32_t idx, uint32_t s,
                                           uint32_t dist) {
  const uint32_t m = s > dist ? s : dist;
  if (idx < m) return 0u;        // q = idx >= s: the chain goes to element 0
  uint32_t r = idx - m;          // q = m - dist + (idx - m) mod dist
  if (r >= dist) r %= dist;      // only an overlapping match wraps
  const uint32_t q = m - dist + r;
  return q < s ? q : 0u;
}

// One batch of up to 32 tokens: lane t holds token t (t < nt).
struct Batch {
  int64_t bs;       // its first element
  int span;         // elements it writes: [bs, bs + span), 0 past the row
  int nt;
  int64_t base;     // the tile's start when it was parsed
  int t_s;          // the token's start, from bs
  int t_len, t_dist, t_rel;   // t_rel: its literal bytes, from base
  bool t_m, dep;    // a match; a match reading its own batch
};

// T: the width type.  S: the store (`epi::Raw`, or `epi::Store<O>` for a
// fused epilogue), E the unsigned type of its output.  With a fused
// epilogue the decoded elements, which later matches read, go to `raw` (a
// scratch matrix of the launch) and their epilogue to `eout`; without one
// `raw` is the output and `eout` is not used.
template <typename T, typename S, typename E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lzss_decode_kernel(const uint8_t* __restrict__ comp, int64_t n,
                   int64_t ncols, const int32_t* __restrict__ out_lens,
                   int64_t chunk_elems, T* __restrict__ raw,
                   E* __restrict__ eout, epi::Args ea,
                   int32_t* __restrict__ tokens) {
  constexpr int kWidth = static_cast<int>(sizeof(T));
  constexpr bool kEpi = !std::is_same<S, epi::Raw>::value;
  __shared__ __align__(16) uint8_t s_ring[kWarpsPerBlock][kTileBytes];
  __shared__ T s_stage[kWarpsPerBlock][kSpan];
  __shared__ uint32_t s_tok[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + wib;
  if (row >= n) return;  // uniform across the warp
  const bool vec = (reinterpret_cast<uintptr_t>(comp) & 15) == 0 &&
                   (ncols & 15) == 0;
  Tile tile{comp + row * ncols, ncols, s_ring[wib], lane, vec, 0, {}};
  tile.init();
  T* dst = raw + row * chunk_elems;
  E* edst = eout + row * chunk_elems;
  const S st(ea);
  T* stage = s_stage[wib];
  const int64_t out_len = out_lens[row];
  int64_t limit = out_len < chunk_elems ? out_len : chunk_elems;
  if (limit < 0) limit = 0;
  const int64_t max_tokens = chunk_elems + 4;
  int64_t pos = 0, cnt = 0, ntok = 0;

  // ---- parse up to 32 tokens ------------------------------------------------
  // Offsets from the tile's start (rel), in the ring (ri) and from bs
  // (span).  The chain is one shared load and a few integer operations a
  // token; every lane runs it and writes the same table entry (the token's
  // rel and start), so no lane branches off it.  A batch ends before a
  // token that could read past the resident blocks or take it past kSpan
  // elements.
  auto parse = [&]() -> Batch {
    tile.advance(pos);
    Batch b;
    b.bs = cnt;
    b.base = tile.begin();
    const int rel_last = static_cast<int>(tile.end() - kTokenBytes - b.base);
    const int nt_max = static_cast<int>(
        max_tokens - ntok < 32 ? max_tokens - ntok : 32);
    const int64_t left = out_len - cnt;           // > 0
    const int span_max = static_cast<int>(left < kSpan ? left : kSpan);
    const uint8_t* ring = tile.ring;
    int nt = 0, rel = static_cast<int>(pos - b.base), span = 0;
    int ri = static_cast<int>(pos & (kTileBytes - 1));
    while (nt < nt_max && span < span_max) {
      if (nt > 0 && rel > rel_last) break;
      const int c = ring[ri];
      const bool m = c >= 128;
      const int len = m ? c - 126 : c + 1;
      if (nt > 0 && span + len > kSpan) break;
      s_tok[wib][nt] = static_cast<uint32_t>(rel | span << 16);
      const int adv = m ? 3 : c * kWidth + kWidth + 1;
      rel += adv;
      ri = (ri + adv) & (kTileBytes - 1);
      span += len;
      ++nt;
    }
    pos = b.base + rel;
    cnt = b.bs + span;
    ntok += nt;
    b.nt = nt;
    const int64_t be = cnt < limit ? cnt : limit;
    b.span = b.bs < be ? static_cast<int>(be - b.bs) : 0;
    __syncwarp();
    // lane t reads token t again from the ring
    const uint32_t tk = s_tok[wib][lane];
    __syncwarp();   // the table is free for the next batch
    b.t_s = static_cast<int>(tk >> 16);
    b.t_rel = static_cast<int>(tk & 0xFFFF) + 1;
    const int c = static_cast<int>(tile.byte(b.base + b.t_rel - 1));
    b.t_m = c >= 128;
    b.t_len = b.t_m ? c - 126 : c + 1;
    b.t_dist = b.t_m ? static_cast<int>(tile.byte(b.base + b.t_rel) |
                                        tile.byte(b.base + b.t_rel + 1) << 8)
                     : 0;
    b.dep = false;
    if (lane < nt && b.t_m && b.t_dist > 0 && b.bs + b.t_s > 0) {
      const int64_t s = b.bs + b.t_s;
      const int64_t hi = b.t_dist <= s
          ? s - b.t_dist + (b.t_len < b.t_dist ? b.t_len : b.t_dist) - 1
          : s - 1;
      b.dep = hi >= b.bs;
    }
    return b;
  };

  // ---- a batch's elements, first pass: literals, and match elements whose
  // source lies before the batch (loaded from the row: the earlier batches
  // are written).  Each element finds its token among the 32 starts.  The
  // loads stay in flight while the next batch is parsed.
  T val[kSpan / 32];
  uint32_t have = 0;   // bit r: val[r] holds element 32 r + lane
  auto gather = [&](const Batch& b) {
    const bool mine = lane < b.nt;
    const uint32_t ubs = static_cast<uint32_t>(b.bs);
    const uint32_t t_pk = static_cast<uint32_t>(b.t_s) |
                          (b.t_m ? 1u << 11 : 0u) |
                          static_cast<uint32_t>(b.t_dist) << 16;
    have = 0;
#pragma unroll
    for (int r = 0; r < kSpan / 32; ++r) {
      const int q0 = 32 * r;
      const uint32_t bit =
          mine && b.t_s >= q0 && b.t_s - q0 < 32 ? 1u << (b.t_s - q0) : 0u;
      const uint32_t starts = __reduce_or_sync(kFull, bit);
      const int before = __popc(__ballot_sync(kFull, mine && b.t_s < q0));
      const int o = (before + __popc(starts & (kFull >> (31 - lane))) - 1) & 31;
      const uint32_t pk = __shfl_sync(kFull, t_pk, o);
      const int rel = __shfl_sync(kFull, b.t_rel, o);
      const int i = q0 + lane;
      val[r] = 0;
      if (i < b.span) {
        const int s = static_cast<int>(pk & 0x7FF);
        const uint32_t d = pk >> 16;
        bool ok = true;
        if (!(pk >> 11 & 1) || d == 0) {
          val[r] = static_cast<T>(tile.value<kWidth>(
              b.base + rel + static_cast<int64_t>(i - s) * kWidth));
        } else if (ubs + s == 0) {
          val[r] = static_cast<T>(tile.value<kWidth>(b.base + rel));
        } else {
          const uint32_t q = source(ubs + i, ubs + s, d);
          if (q < ubs)
            val[r] = dst[q];
          else
            ok = false;   // resolved in the second pass
        }
        if (ok) have |= 1u << r;
      }
    }
  };

  // ---- second pass: the values into the stage, the matches that read
  // their own batch in token order, then the stage to the row
  auto finish = [&](const Batch& b) {
#pragma unroll
    for (int r = 0; r < kSpan / 32; ++r)
      if (have >> r & 1) stage[32 * r + lane] = val[r];
    __syncwarp();
    const uint32_t ubs = static_cast<uint32_t>(b.bs);
    for (uint32_t dm = __ballot_sync(kFull, b.dep); dm; dm &= dm - 1) {
      const int t = __ffs(dm) - 1;
      const int s = __shfl_sync(kFull, b.t_s, t);
      const int len = __shfl_sync(kFull, b.t_len, t);
      const uint32_t d = static_cast<uint32_t>(__shfl_sync(kFull, b.t_dist, t));
      for (int k = lane; k < len && s + k < b.span; k += 32) {
        const uint32_t q = source(ubs + s + k, ubs + s, d);
        if (q >= ubs) stage[s + k] = stage[q - ubs];
      }
      __syncwarp();   // this match's elements are visible to the next
    }
    for (int i = lane; i < b.span; i += 32) dst[b.bs + i] = stage[i];
    __syncwarp();     // visible to the next batch's loads; the stage is free
  };

  // parse batch k + 1 while batch k's loads are in flight
  if (cnt < out_len && ntok < max_tokens) {
    Batch cur = parse();
    if (cur.span > 0) gather(cur);
    while (true) {
      const bool more = cnt < out_len && ntok < max_tokens;
      Batch nxt;
      if (more) nxt = parse();
      if (cur.span > 0) finish(cur);
      if (!more) break;
      cur = nxt;
      if (cur.span > 0) gather(cur);
    }
  }
  const int64_t end = cnt < limit ? cnt : limit;
  if constexpr (kEpi) {
    // the finished row's epilogue, the elements past the stream as zeros
    // (the scratch row's tail is never read)
    __syncwarp();
    epi::warp_row<static_cast<int>(sizeof(E))>(st, dst, edst, end,
                                               chunk_elems, lane);
  } else {
    for (int64_t i = end + lane; i < chunk_elems; i += 32) dst[i] = 0;
  }
  if (tokens != nullptr && lane == 0) tokens[row] = static_cast<int32_t>(ntok);
}

template <typename T, typename S, typename E>
int launch(const void* comp, int64_t n, int64_t ncols, const void* out_lens,
           int64_t chunk_elems, void* raw, void* out, const epi::Args& ea,
           void* tokens, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  lzss_decode_kernel<T, S, E><<<grid, block, 0, stream>>>(
      static_cast<const uint8_t*>(comp), n, ncols,
      static_cast<const int32_t*>(out_lens), chunk_elems,
      static_cast<T*>(raw), static_cast<E*>(out), ea,
      static_cast<int32_t*>(tokens));
  return static_cast<int>(cudaGetLastError());
}

// One width: its plain store, or the epilogue of `out_code`.
template <typename T>
int launch_width(const void* comp, int64_t n, int64_t ncols,
                 const void* out_lens, int64_t chunk_elems, void* out,
                 void* raw, int out_code, const epi::Args& ea, void* tokens,
                 cudaStream_t s) {
  if (epi::plain_store(out_code, ea))
    return launch<T, epi::Raw, T>(comp, n, ncols, out_lens, chunk_elems, out,
                                  out, ea, tokens, s);
  if (raw == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return epi::dispatch(out_code, [&](auto tag) {
    using O = typename decltype(tag)::type;
    return launch<T, epi::Store<O>,
                  typename epi::Bits<static_cast<int>(sizeof(O))>::T>(
        comp, n, ncols, out_lens, chunk_elems, raw, out, ea, tokens, s);
  });
}

}  // namespace

// Decode n lzss chunk rows of `width`-byte elements into `out` ((n,
// chunk_elems) of the output type) on `stream`.  `comp` is the (n, ncols)
// byte table, `out_lens` (n,) int32.  `out_code` is the output dtype's code
// and `src_code`, `zero`, `zero_code`, `scale`, `scale_code` the epilogue
// (`epilogue.cuh`; null operands are absent).  With no operands and
// `out_code == src_code` the kernel writes the decoded elements to `out`;
// otherwise `raw`, an (n, chunk_elems) scratch matrix of the width type,
// takes them (later matches read them there) and `out` their epilogue.
// `tokens`, if not null, receives each row's token count.  Returns the CUDA
// error of the launch (0 on success).  Allocates nothing and does not
// synchronise.
extern "C" int codag_lzss_decode(int width, const void* comp, int64_t n,
                                 int64_t ncols, const void* out_lens,
                                 int64_t chunk_elems, void* out, void* raw,
                                 void* tokens, int out_code, int src_code,
                                 const void* zero, int zero_code,
                                 const void* scale, int scale_code,
                                 void* stream) {
  if (n <= 0 || chunk_elems <= 0) return 0;
  if (ncols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const epi::Args ea{src_code, zero, zero_code, scale, scale_code};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1:
      return launch_width<uint8_t>(comp, n, ncols, out_lens, chunk_elems,
                                   out, raw, out_code, ea, tokens, s);
    case 2:
      return launch_width<uint16_t>(comp, n, ncols, out_lens, chunk_elems,
                                    out, raw, out_code, ea, tokens, s);
    case 4:
      return launch_width<uint32_t>(comp, n, ncols, out_lens, chunk_elems,
                                    out, raw, out_code, ea, tokens, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
