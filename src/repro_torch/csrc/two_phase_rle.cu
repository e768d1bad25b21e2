// Warp-per-chunk RLE v1 / RLE v2 / dbp decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `harness._generic_pallas` (src/repro/kernels/
// harness.py:359, pl.pallas_call at :409) running the body `two_phase_chunk`
// (harness.py:91) with `rle_v1.SPEC` (rle_v1.py:52), `rle_v2.SPEC`
// (rle_v2.py:64) or `dbp.SPEC` (dbp.py:116).
//
// What it computes, per chunk row: walk the group headers serially while
// `cnt < out_len && g < max_groups`, expand each group into its elements
// (rle_v1: a run of c+3 or 256-c literals; rle_v2: base + delta*k mod 2^32,
// literals, long runs up to 16386; dbp: ref + the k-th b-bit field of the
// group's payload, mod 2^32), truncate each value to the width type, and
// zero the lanes at or past `out_len`.  The result equals the reference
// two-phase body bit for bit, including the lane->group map of Phase 2: the
// last group the `max_groups` cap admits covers every lane up to `out_len`.
// Every byte read clamps to the row's last byte (`jnp.take(mode="clip")`,
// which is zero padding in the device layout).
//
// Design: the reference's two phases at warp scale.  The TPU kernel parses
// a whole chunk into group tables in VMEM and then expands every lane; at
// the 128 KiB chunk those tables take ~210 KB a chunk, which a CTA's shared
// memory cannot hold for even one resident chunk.  Here one warp owns one
// chunk and works through it 32 groups at a time:
//
//  * Compressed bytes in shared memory.  Each warp keeps 4 KiB of its row
//    in a shared ring (byte p at ring[p mod 4096]): four 1 KiB blocks,
//    loaded with 16-byte coalesced loads, and the next block waits in
//    registers (two 16-byte words a lane), loaded a block ahead.  Headers,
//    run values, deltas, literals and dbp payload windows are read from the
//    ring; a read outside the resident blocks (a dbp group with a field
//    width up to 255, whose payload reaches 8 KiB; the group the cap
//    stretches) reads global memory, clipped the same way.  Only a batch
//    that holds such a group checks its reads; every other one reads the
//    ring unchecked, a value from the two aligned words that hold it.
//  * Phase 1, 32 groups a batch.  All lanes walk up to 32 headers through
//    the ring (one shared load on the chain a group) and write each
//    group's byte offset and output start into a shared table (all lanes
//    the same entry, so none branches off the chain).  Then lane t reads
//    group t's fields: its run value or frame of reference, delta, and
//    literal or payload offset, into a second table.  A batch also ends
//    before a group whose bytes run past the resident blocks, unless it is
//    the batch's first.
//  * Phase 2, all 32 lanes expand the batch, each element computing its
//    value: base + delta * k, the k-th literal from the ring, or the dbp
//    field; stores are coalesced.  How the lanes find their group depends
//    on what the batch holds, uniformly across the warp:
//     - long groups (at least 64 elements on average: long runs, dbp's
//       128-element groups): one group at a time, all lanes striding over
//       its elements, its table entry uniform, as the reference's group-
//       serial oracle writes them;
//     - short groups: 32 consecutive elements a row, four rows at a time.
//       A row's mask of group starts is one `__reduce_or_sync`; an
//       element's group is the group of the row's first element plus the
//       starts below it, as the reference's scatter + cumsum lane->group
//       map does for the whole chunk, and a row without a start takes its
//       values from the entry every lane already holds.
//
// Residency: 8 warps (chunks) a CTA, 38 KiB of shared memory.
//
// Bound: bytes.  The function must read the compressed rows (sum of
// comp_lens) and out_lens, and write n * chunk_elems * width bytes; over
// the H100's 3.35 TB/s that is the floor.  The arithmetic per element is a
// few integer operations, far below the card's rate.
//
// Offsets are 64-bit (row * chunk_elems reaches 2^30 at 1 GiB of u8
// output); out_lens is read from device memory, so a launch needs no host
// sync.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRleV1 = 0;
constexpr int kRleV2 = 1;
constexpr int kDbp = 2;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBlockBytes = 1024;                 // a block of the ring
constexpr int kTileBlocks = 4;                    // resident blocks a warp
constexpr int kTileBytes = kBlockBytes * kTileBlocks;

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
  // the bytes p .. p + 4 of the ring (at least; low byte first), from the
  // two aligned words that hold them
  __device__ __forceinline__ uint64_t window(int64_t p) const {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(ring);
    const uint32_t i = static_cast<uint32_t>(p) & (kTileBytes - 1);
    const uint64_t lo8 = words[i >> 2];
    const uint64_t hi8 = words[((i >> 2) + 1) & (kTileBytes / 4 - 1)];
    return (hi8 << 32 | lo8) >> (8 * (i & 3));
  }
  // whether bytes p .. p + 7 are resident
  __device__ __forceinline__ bool holds(int64_t p) const {
    return static_cast<uint64_t>(p - begin()) <= kTileBytes - 8;
  }
  // byte p, and the W-byte value at p; kChecked reads outside the resident
  // blocks from global memory, else the caller knows they are resident
  template <bool kChecked>
  __device__ __forceinline__ uint32_t byte(int64_t p) const {
    if (kChecked && !holds(p)) return global_byte(p);
    return ring[p & (kTileBytes - 1)];
  }
  template <bool kChecked, int W>
  __device__ __forceinline__ uint32_t value(int64_t p) const {
    if (kChecked && !holds(p)) {
      uint32_t v = global_byte(p);
#pragma unroll
      for (int i = 1; i < W; ++i) v |= global_byte(p + i) << (8 * i);
      return v;
    }
    const uint32_t v = static_cast<uint32_t>(window(p));
    return W == 4 ? v : v & ((1u << (8 * W)) - 1u);
  }
};

// The group at pos: the elements it expands to and the bytes it takes
// (its header, values and payload).  Its header is resident.
template <int CODEC, int W>
__device__ __forceinline__ void span_of(const Tile& tile, int64_t pos,
                                        int& length, int& advance) {
  const int h = static_cast<int>(tile.byte<false>(pos));
  if (CODEC == kDbp) {
    // bits, count-1, ref (W bytes), payload of ceil(count*bits/8) bytes
    length = static_cast<int>(tile.byte<false>(pos + 1)) + 1;
    advance = 2 + W + ((length * h + 7) >> 3);
  } else if (CODEC == kRleV1) {
    const bool lit = h >= 128;
    length = lit ? 256 - h : h + 3;
    advance = 1 + (lit ? length * W : W);
  } else {
    const int mode = h >> 6, f = h & 63;
    const int nxt = static_cast<int>(tile.byte<false>(pos + 1));
    length = mode == 2 ? f + 1 : (mode == 3 ? ((f << 8) | nxt) + 3 : f + 3);
    advance = mode == 2 ? 1 + length * W
            : mode == 1 ? 1 + 2 * W
            : mode == 3 ? 2 + W : 1 + W;
  }
}

// The fields of the group at pos, as a table entry: (its start from the
// batch's first element | (lit | bits << 1) << 20, its literal or payload
// offset from the tile's start, run value / delta base / dbp frame of
// reference, delta).  A batch's starts stay below 32 * 16386 < 2^20.
template <int CODEC, int W>
__device__ __forceinline__ uint4 fields(const Tile& tile, int64_t pos,
                                        int start) {
  const uint32_t h = tile.byte<false>(pos);
  uint32_t meta = 0, base, delta = 0;
  int64_t off = pos + 1;
  if (CODEC == kDbp) {
    meta = h << 1;
    base = tile.value<false, W>(pos + 2);
    off = pos + 2 + W;
  } else if (CODEC == kRleV1) {
    meta = h >= 128 ? 1u : 0u;
    base = tile.value<false, W>(pos + 1);
  } else {
    const uint32_t mode = h >> 6;
    const int64_t val_off = pos + 1 + (mode == 3 ? 1 : 0);
    meta = mode == 2 ? 1u : 0u;
    base = tile.value<false, W>(val_off);
    if (mode == 1) delta = tile.value<false, W>(val_off + W);
  }
  return make_uint4(static_cast<uint32_t>(start) | meta << 20,
                    static_cast<uint32_t>(off - tile.begin()), base, delta);
}

// dbp element k: the 40-bit window (an unaligned u32 + one spill byte) at the
// field's byte, shifted by its bit offset, masked to `bits` (all ones from 32
// up; the mask shift is capped at 31), plus the reference, mod 2^32.
template <bool kChecked>
__device__ __forceinline__ uint32_t dbp_value(const Tile& tile, int64_t off,
                                              uint32_t bits, uint32_t base,
                                              int64_t k) {
  const int64_t bitpos = off * 8 + k * bits;
  const int64_t byte = bitpos >> 3;
  const uint32_t sh = static_cast<uint32_t>(bitpos & 7);
  uint32_t v;
  if (kChecked && !tile.holds(byte)) {
    const uint32_t lo = tile.value<true, 4>(byte) >> sh;
    v = lo | (sh ? tile.byte<true>(byte + 4) << ((32 - sh) & 31) : 0u);
  } else {
    v = static_cast<uint32_t>(tile.window(byte) >> sh);
  }
  const uint32_t nb = bits < 31 ? bits : 31;
  const uint32_t mask = bits >= 32 ? 0xFFFFFFFFu : (1u << nb) - 1u;
  return base + (v & mask);
}

// Phase 2 of a batch of short groups: elements [0, span) from out (its
// first element), from the group table `tab` (entries as `fields` makes
// them); lane t holds group t's start t_s (t < nt).  kChecked: some read
// may lie outside the resident blocks.  Rows of 32 elements, four at a
// time: bit j of a row's mask says that a group starts at q + 1 + j, so
// lane l's group is gq (the group of the row's first element) plus the
// starts below its bit, and a row whose mask is 0 lies in group gq, whose
// entry f every lane already holds.
template <int CODEC, int W, bool kChecked, typename T>
__device__ __forceinline__ void expand(const Tile& tile, const uint4* tab,
                                       T* __restrict__ out, int span, int nt,
                                       int lane, int t_s) {
  const bool mine = lane < nt;
  const int64_t base = tile.begin();
  auto value = [&](const uint4 f, int i) -> uint32_t {
    const int k = i - static_cast<int>(f.x & 0xFFFFF);
    const uint32_t meta = f.x >> 20;
    const int64_t off = base + f.y;
    if (CODEC == kDbp)
      return dbp_value<kChecked>(tile, off, meta >> 1, f.z, k);
    if (meta & 1)
      return tile.value<kChecked, W>(off + static_cast<int64_t>(k) * W);
    return f.z + f.w * static_cast<uint32_t>(k);
  };
  int gq = 0;
  uint4 f = tab[0];
  for (int q0 = 0; q0 < span; q0 += 128) {   // uniform
    uint32_t mask[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int d = t_s - (q0 + 32 * r) - 1;
      mask[r] = __reduce_or_sync(kFull,
                                 mine && d >= 0 && d < 32 ? 1u << d : 0u);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 32 * r + lane;
      if (mask[r] == 0) {
        if (i < span) out[i] = static_cast<T>(value(f, i));
      } else {
        const int o = gq + __popc(mask[r] & ((1u << lane) - 1u));
        if (i < span) out[i] = static_cast<T>(value(tab[o], i));
        gq += __popc(mask[r]);
        f = tab[gq];
      }
    }
  }
}

// Phase 2 of a batch of long groups (at least 64 elements on average):
// one group at a time, all lanes striding over its elements, the group's
// entry uniform.
template <int CODEC, int W, bool kChecked, typename T>
__device__ __forceinline__ void expand_groups(const Tile& tile,
                                              const uint4* tab,
                                              T* __restrict__ out, int span,
                                              int nt, int lane) {
  const int64_t base = tile.begin();
  uint4 g = tab[0];
  for (int t = 0; t < nt; ++t) {   // uniform
    const int s = static_cast<int>(g.x & 0xFFFFF);
    if (s >= span) break;
    const uint4 h = tab[t + 1 < nt ? t + 1 : t];
    int e = t + 1 < nt ? static_cast<int>(h.x & 0xFFFFF) : span;
    if (e > span) e = span;
    const uint32_t meta = g.x >> 20;
    const int64_t off = base + g.y;
    if (CODEC == kDbp) {
      for (int i = s + lane; i < e; i += 32)
        out[i] = static_cast<T>(
            dbp_value<kChecked>(tile, off, meta >> 1, g.z, i - s));
    } else if (meta & 1) {
      for (int i = s + lane; i < e; i += 32)
        out[i] = static_cast<T>(tile.value<kChecked, W>(
            off + static_cast<int64_t>(i - s) * W));
    } else {
      for (int i = s + lane; i < e; i += 32)
        out[i] = static_cast<T>(g.z + g.w * static_cast<uint32_t>(i - s));
    }
    g = h;
  }
}

template <int CODEC, int W, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
two_phase_rle_kernel(const uint8_t* __restrict__ comp, int64_t c,
                     const int32_t* __restrict__ out_lens, int64_t n,
                     int64_t chunk_elems, int64_t max_groups,
                     T* __restrict__ out, int32_t* __restrict__ groups) {
  __shared__ __align__(16) uint8_t s_ring[kWarpsPerBlock][kTileBytes];
  __shared__ uint2 s_hdr[kWarpsPerBlock][32];
  __shared__ uint4 s_grp[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + wib;
  if (row >= n) return;  // uniform across the warp
  const bool vec = (reinterpret_cast<uintptr_t>(comp) & 15) == 0 &&
                   (c & 15) == 0;
  Tile tile{comp + row * c, c, s_ring[wib], lane, vec, 0, {}};
  tile.init();
  T* dst = out + row * chunk_elems;
  const int64_t out_len = out_lens[row];
  int64_t limit = out_len < chunk_elems ? out_len : chunk_elems;
  if (limit < 0) limit = 0;

  int64_t pos = 0, cnt = 0, g = 0;
  while (cnt < out_len && g < max_groups) {
    tile.advance(pos);
    const int64_t bs = cnt;                       // the batch's first element
    const int64_t tile_end = tile.end();

    // ---- Phase 1: parse up to 32 groups into the warp's group table ------
    // Every lane runs the header chain (one shared load on it a group) and
    // writes the same entry, the group's offset from the tile's start and
    // its start from bs, so no lane branches off the chain.  Then lane t
    // reads group t's fields.
    const int64_t base = tile.begin();
    // a group's bytes, a dbp window's spill and the next header end inside
    // the ring (but the first group's, whose header is resident)
    const int rel_end = static_cast<int>(tile_end - base) - 12;
    const int nt_max = static_cast<int>(
        max_groups - g < 32 ? max_groups - g : 32);
    const int64_t left = out_len - bs;                      // > 0
    const int span_max = left < (1 << 30) ? static_cast<int>(left) : 1 << 30;
    int nt = 0, rel = static_cast<int>(pos - base), span = 0;
    while (nt < nt_max && span < span_max) {
      int len, adv;
      span_of<CODEC, W>(tile, base + rel, len, adv);
      if (nt > 0 && rel + adv > rel_end) break;
      s_hdr[wib][nt] = make_uint2(static_cast<uint32_t>(rel),
                                  static_cast<uint32_t>(span));
      rel += adv;
      span += len;
      ++nt;
    }
    pos = base + rel;
    cnt = bs + span;
    g += nt;

    // ---- Phase 2: expand elements [bs, be) with all lanes ------------------
    // the last group the cap admits covers every lane up to limit
    const bool capped = g == max_groups;
    const int64_t be = capped || cnt > limit ? limit : cnt;
    __syncwarp();
    if (bs >= be) continue;   // past the row's end: only the count goes on
    const uint2 hd = s_hdr[wib][lane];
    const int t_s = static_cast<int>(hd.y);
    s_grp[wib][lane] = fields<CODEC, W>(tile, base + hd.x, t_s);
    __syncwarp();
    // every read resident: the batch's bytes end inside the ring (the
    // parse keeps all but the first group's there) and no group is
    // stretched past its length by the cap
    span = static_cast<int>(be - bs);          // the elements to write
    const bool resident = !capped && pos + 12 <= tile_end;
    if (span >= 64 * nt) {
      if (resident)
        expand_groups<CODEC, W, false>(tile, s_grp[wib], dst + bs, span, nt,
                                       lane);
      else
        expand_groups<CODEC, W, true>(tile, s_grp[wib], dst + bs, span, nt,
                                      lane);
    } else if (resident) {
      expand<CODEC, W, false>(tile, s_grp[wib], dst + bs, span, nt, lane,
                              t_s);
    } else {
      expand<CODEC, W, true>(tile, s_grp[wib], dst + bs, span, nt, lane,
                             t_s);
    }
    __syncwarp();   // the ring is read to the end of this batch
  }
  for (int64_t i = limit + lane; i < chunk_elems; i += 32) dst[i] = 0;
  if (groups != nullptr && lane == 0) groups[row] = static_cast<int32_t>(g);
}

template <int CODEC, int W, typename T>
void launch(const void* comp, int64_t c, const void* out_lens, int64_t n,
            int64_t chunk_elems, int64_t max_groups, void* out, void* groups,
            cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  two_phase_rle_kernel<CODEC, W, T><<<grid, block, 0, stream>>>(
      static_cast<const uint8_t*>(comp), c,
      static_cast<const int32_t*>(out_lens), n, chunk_elems, max_groups,
      static_cast<T*>(out), static_cast<int32_t*>(groups));
}

}  // namespace

// Decode n chunk rows of `comp` ((n, c) uint8, row stride c) into `out`
// ((n, chunk_elems) of the width type) on `stream`.  `groups`, if not null,
// receives each row's group count.  Returns the CUDA error of the launch (0
// on success).  Allocates nothing and does not synchronise.
extern "C" int codag_two_phase_rle(int codec, int width, const void* comp,
                                   int64_t c, const void* out_lens, int64_t n,
                                   int64_t chunk_elems, int64_t max_groups,
                                   void* out, void* groups, void* stream) {
  if (n <= 0) return 0;
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (codec * 8 + width) {
    case kRleV1 * 8 + 1: launch<kRleV1, 1, uint8_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, groups, s); break;
    case kRleV1 * 8 + 2: launch<kRleV1, 2, uint16_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, groups, s); break;
    case kRleV1 * 8 + 4: launch<kRleV1, 4, uint32_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, groups, s); break;
    case kRleV2 * 8 + 1: launch<kRleV2, 1, uint8_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, groups, s); break;
    case kRleV2 * 8 + 2: launch<kRleV2, 2, uint16_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, groups, s); break;
    case kRleV2 * 8 + 4: launch<kRleV2, 4, uint32_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, groups, s); break;
    case kDbp * 8 + 1: launch<kDbp, 1, uint8_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, groups, s); break;
    case kDbp * 8 + 2: launch<kDbp, 2, uint16_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, groups, s); break;
    case kDbp * 8 + 4: launch<kDbp, 4, uint32_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, groups, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
