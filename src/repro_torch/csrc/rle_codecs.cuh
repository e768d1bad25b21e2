// The RLE family's group parse and element expression: rle_v1, rle_v2 and
// dbp, the counterparts of the `parse` / `express` pairs of
// src/repro_torch/kernels/{rle_v1,rle_v2,dbp}.py (reference: the SPECs of
// src/repro/kernels/{rle_v1,rle_v2,dbp}.py).  Two kernels read them:
// `two_phase_rle.cu` (all-thread, through its shared-memory ring `Tile`)
// and `scalar_decode.cu` (one thread a chunk, plain global loads).
//
// A reader R over one compressed row offers:
//   byte<kChecked>(p)      the byte at p;
//   value<kChecked, W>(p)  the W-byte little-endian value at p;
//   window(p)              at least the bytes p .. p + 4, low byte first;
//   holds(p)               whether bytes p .. p + 7 may be read unchecked;
//   begin()                the offset its unchecked reads are relative to.
// Every read clips to the row's last byte (`jnp.take(mode="clip")`), which
// is zero padding in the device layout.  kChecked=false promises that the
// bytes are resident (a Tile reads its ring without a check).
#pragma once

#include <cstdint>

namespace rle {

constexpr int kRleV1 = 0;
constexpr int kRleV2 = 1;
constexpr int kDbp = 2;

// The group at pos: the elements it expands to and the bytes it takes
// (its header, values and payload).  Its header is resident.
template <int CODEC, int W, typename R>
__device__ __forceinline__ void span_of(const R& r, int64_t pos, int& length,
                                        int& advance) {
  const int h = static_cast<int>(r.template byte<false>(pos));
  if (CODEC == kDbp) {
    // bits, count-1, ref (W bytes), payload of ceil(count*bits/8) bytes
    length = static_cast<int>(r.template byte<false>(pos + 1)) + 1;
    advance = 2 + W + ((length * h + 7) >> 3);
  } else if (CODEC == kRleV1) {
    const bool lit = h >= 128;
    length = lit ? 256 - h : h + 3;
    advance = 1 + (lit ? length * W : W);
  } else {
    const int mode = h >> 6, f = h & 63;
    const int nxt = static_cast<int>(r.template byte<false>(pos + 1));
    length = mode == 2 ? f + 1 : (mode == 3 ? ((f << 8) | nxt) + 3 : f + 3);
    advance = mode == 2 ? 1 + length * W
            : mode == 1 ? 1 + 2 * W
            : mode == 3 ? 2 + W : 1 + W;
  }
}

// A group's fields: meta (lit | bits << 1), the offset of its literals or
// payload, its run value / delta base / dbp frame of reference, and its
// delta.
struct Group {
  uint32_t meta;
  int64_t off;
  uint32_t base;
  uint32_t delta;
};

template <int CODEC, int W, typename R>
__device__ __forceinline__ Group group_at(const R& r, int64_t pos) {
  const uint32_t h = r.template byte<false>(pos);
  uint32_t meta = 0, base, delta = 0;
  int64_t off = pos + 1;
  if (CODEC == kDbp) {
    meta = h << 1;
    base = r.template value<false, W>(pos + 2);
    off = pos + 2 + W;
  } else if (CODEC == kRleV1) {
    meta = h >= 128 ? 1u : 0u;
    base = r.template value<false, W>(pos + 1);
  } else {
    const uint32_t mode = h >> 6;
    const int64_t val_off = pos + 1 + (mode == 3 ? 1 : 0);
    meta = mode == 2 ? 1u : 0u;
    base = r.template value<false, W>(val_off);
    if (mode == 1) delta = r.template value<false, W>(val_off + W);
  }
  return Group{meta, off, base, delta};
}

// dbp element k: the 40-bit window (an unaligned u32 + one spill byte) at the
// field's byte, shifted by its bit offset, masked to `bits` (all ones from 32
// up; the mask shift is capped at 31), plus the reference, mod 2^32.
template <bool kChecked, typename R>
__device__ __forceinline__ uint32_t dbp_value(const R& r, int64_t off,
                                              uint32_t bits, uint32_t base,
                                              int64_t k) {
  const int64_t bitpos = off * 8 + k * bits;
  const int64_t byte = bitpos >> 3;
  const uint32_t sh = static_cast<uint32_t>(bitpos & 7);
  uint32_t v;
  if (kChecked && !r.holds(byte)) {
    const uint32_t lo = r.template value<true, 4>(byte) >> sh;
    v = lo | (sh ? r.template byte<true>(byte + 4) << ((32 - sh) & 31) : 0u);
  } else {
    v = static_cast<uint32_t>(r.window(byte) >> sh);
  }
  const uint32_t nb = bits < 31 ? bits : 31;
  const uint32_t mask = bits >= 32 ? 0xFFFFFFFFu : (1u << nb) - 1u;
  return base + (v & mask);
}

// Element k of a group whose literals or payload start at off: the dbp
// field, the k-th literal, or base + delta * k mod 2^32.
template <int CODEC, int W, bool kChecked, typename R>
__device__ __forceinline__ uint32_t element(const R& r, uint32_t meta,
                                            int64_t off, uint32_t base,
                                            uint32_t delta, int k) {
  if (CODEC == kDbp) return dbp_value<kChecked>(r, off, meta >> 1, base, k);
  if (meta & 1)
    return r.template value<kChecked, W>(off + static_cast<int64_t>(k) * W);
  return base + delta * static_cast<uint32_t>(k);
}

}  // namespace rle
