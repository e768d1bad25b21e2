// Warp-per-chunk RLE v1 / RLE v2 decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `harness._generic_pallas` (src/repro/kernels/
// harness.py:359, pl.pallas_call at :409) running the body `two_phase_chunk`
// (harness.py:91) with `rle_v1.SPEC` (rle_v1.py:52) or `rle_v2.SPEC`
// (rle_v2.py:64).
//
// What it computes, per chunk row: walk the group headers serially while
// `cnt < out_len && g < max_groups`, expand each group into its elements
// (rle_v1: a run of c+3 or 256-c literals; rle_v2: base + delta*k mod 2^32,
// literals, long runs up to 16386), truncate each value to the width type,
// and zero the lanes at or past `out_len`.  The result equals the reference
// two-phase body bit for bit, including the lane->group map of Phase 2: the
// last group the `max_groups` cap admits covers every lane up to `out_len`.
//
// Design (the paper's own, §IV).  The TPU kernel parses a chunk into group
// tables in VMEM and then expands every lane; at the 128 KiB chunk those
// tables take ~210 KB per chunk, which a CTA's 227 KB of shared memory
// cannot hold for even one resident chunk.  So no tables: one warp owns one
// chunk, walks its headers (every lane reads the same header bytes, a
// broadcast load with uniform control flow), and its 32 lanes write the
// group's elements `cnt + lane, cnt + lane + 32, ...` straight to global
// memory, coalesced.  No shared memory, no producer/consumer split; 8 warps
// per CTA keep up to 64 warps resident per SM, and the hardware scheduler
// interleaves their serial header parses to hide each one's load latency.
//
// Bound: bytes.  The function must read the compressed rows (sum of
// comp_lens) and out_lens, and write n * chunk_elems * width bytes; over
// the H100's 3.35 TB/s that is the floor.  The arithmetic per element is a
// few integer operations, far below the card's rate.
//
// Hazards handled here: literal values sit at unaligned byte offsets, so
// they are assembled byte by byte; every read clamps to the row's last byte
// (`jnp.take(mode="clip")`, which is zero padding in the device layout);
// offsets are 64-bit (row * chunk_elems reaches 2^30 at 1 GiB of u8 output);
// out_lens is read from device memory, so a launch needs no host sync.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRleV1 = 0;
constexpr int kRleV2 = 1;

__device__ __forceinline__ uint32_t byte_at(const uint8_t* row, int64_t c,
                                            int64_t p) {
  return row[p < c ? p : c - 1];
}

template <int W>
__device__ __forceinline__ uint32_t value_at(const uint8_t* row, int64_t c,
                                             int64_t p) {
  uint32_t v = byte_at(row, c, p);
#pragma unroll
  for (int i = 1; i < W; ++i) v |= byte_at(row, c, p + i) << (8 * i);
  return v;
}

struct Group {
  int64_t length;    // elements this group expands to
  int64_t advance;   // header + payload bytes
  int64_t litoff;    // byte offset of the first literal
  uint32_t base;     // run value / delta base
  uint32_t delta;    // 0 except rle_v2 delta groups
  bool lit;          // literal group
};

template <int CODEC, int W>
__device__ __forceinline__ Group parse(const uint8_t* row, int64_t c,
                                       int64_t pos) {
  Group g;
  g.litoff = pos + 1;
  g.delta = 0;
  const uint32_t h = byte_at(row, c, pos);
  if (CODEC == kRleV1) {
    g.lit = h >= 128;
    g.length = g.lit ? 256 - h : h + 3;
    g.advance = 1 + (g.lit ? g.length * W : W);
    g.base = value_at<W>(row, c, pos + 1);
  } else {
    const uint32_t mode = h >> 6, f = h & 63;
    const uint32_t nxt = byte_at(row, c, pos + 1);
    g.lit = mode == 2;
    g.length = mode == 2 ? f + 1 : (mode == 3 ? ((f << 8) | nxt) + 3 : f + 3);
    const int64_t val_off = pos + 1 + (mode == 3 ? 1 : 0);
    g.advance = mode == 2 ? 1 + g.length * W
              : mode == 1 ? 1 + 2 * W
              : mode == 3 ? 2 + W : 1 + W;
    g.base = value_at<W>(row, c, val_off);
    if (mode == 1) g.delta = value_at<W>(row, c, val_off + W);
  }
  return g;
}

template <int CODEC, int W, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
two_phase_rle_kernel(const uint8_t* __restrict__ comp, int64_t c,
                     const int32_t* __restrict__ out_lens, int64_t n,
                     int64_t chunk_elems, int64_t max_groups,
                     T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const uint8_t* src = comp + row * c;
  T* dst = out + row * chunk_elems;
  const int64_t out_len = out_lens[row];
  int64_t limit = out_len < chunk_elems ? out_len : chunk_elems;
  if (limit < 0) limit = 0;

  int64_t pos = 0, cnt = 0;
  for (int64_t g = 0; cnt < out_len && g < max_groups; ++g) {
    const Group gr = parse<CODEC, W>(src, c, pos);
    int64_t end = cnt + gr.length;
    if (end > limit || g + 1 == max_groups) end = limit;
    for (int64_t i = cnt + lane; i < end; i += 32) {
      const int64_t k = i - cnt;
      const uint32_t v = gr.lit
          ? value_at<W>(src, c, gr.litoff + k * W)
          : gr.base + gr.delta * static_cast<uint32_t>(k);
      dst[i] = static_cast<T>(v);
    }
    pos += gr.advance;
    cnt += gr.length;
  }
  for (int64_t i = limit + lane; i < chunk_elems; i += 32) dst[i] = 0;
}

template <int CODEC, int W, typename T>
void launch(const void* comp, int64_t c, const void* out_lens, int64_t n,
            int64_t chunk_elems, int64_t max_groups, void* out,
            cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  two_phase_rle_kernel<CODEC, W, T><<<grid, block, 0, stream>>>(
      static_cast<const uint8_t*>(comp), c,
      static_cast<const int32_t*>(out_lens), n, chunk_elems, max_groups,
      static_cast<T*>(out));
}

}  // namespace

// Decode n chunk rows of `comp` ((n, c) uint8, row stride c) into `out`
// ((n, chunk_elems) of the width type) on `stream`.  Returns the CUDA error
// of the launch (0 on success).  Allocates nothing and does not synchronise.
extern "C" int codag_two_phase_rle(int codec, int width, const void* comp,
                                   int64_t c, const void* out_lens, int64_t n,
                                   int64_t chunk_elems, int64_t max_groups,
                                   void* out, void* stream) {
  if (n <= 0) return 0;
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (codec * 8 + width) {
    case kRleV1 * 8 + 1: launch<kRleV1, 1, uint8_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, s); break;
    case kRleV1 * 8 + 2: launch<kRleV1, 2, uint16_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, s); break;
    case kRleV1 * 8 + 4: launch<kRleV1, 4, uint32_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, s); break;
    case kRleV2 * 8 + 1: launch<kRleV2, 1, uint8_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, s); break;
    case kRleV2 * 8 + 2: launch<kRleV2, 2, uint16_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, s); break;
    case kRleV2 * 8 + 4: launch<kRleV2, 4, uint32_t>(comp, c, out_lens, n, chunk_elems, max_groups, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
