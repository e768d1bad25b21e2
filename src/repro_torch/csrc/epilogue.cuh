// The decode epilogue, applied in every decode kernel's stores (sm_90a).
//
// The counterpart of the reference's `Epilogue` (src/repro/kernels/
// harness.py:180-215), which runs inside the decode dispatch so that no raw
// uint matrix is materialized, and the device side of the port's
// `harness.fused_epilogue` (src/repro_torch/kernels/harness.py), which
// decides which epilogues come here and passes an `Args`.
//
// Per element, in the reference's order and with the rounding torch's own
// ops on the card give (`Epilogue.apply`):
//   1. view_dtype: the decoded value's bits read as another type of the
//      same itemsize (`src`);
//   2. out_dtype: a value cast to the output type O, as torch's `.to()`:
//      integers wrap to O's width (sign- or zero-extended from `src` first);
//      an integer becomes a float by a round-to-nearest int -> float32
//      conversion and then, for bf16 and fp16, a second rounding, as
//      c10::BFloat16 / c10::Half are built from a float; a float widens to
//      float32 exactly.  A float never becomes an integer here (the decision
//      function leaves that cast to torch);
//   3. (x - zero) * scale in O.  float32: a rounded subtract, then a
//      rounded multiply (`__fsub_rn`, `__fmul_rn`: nothing contracts into an
//      FMA).  bf16 and fp16: each op in float32, rounded to O after it, as
//      torch computes them in its float "opmath" type.  Integers: mod
//      2^(8 * sizeof(O)), as torch's integer ops wrap.
// The zero and scale operands are device tensors read through a pointer, a
// dtype code and a row stride: one element for the whole table (stride 0),
// or one a chunk row (stride 1: an (n_chunks, 1) operand, a kernel that
// declares it, bitpack's), each read once a thread for the row it stores and
// cast to O as torch's `.to(O)` casts it.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace epi {

// dtype codes, the same as `harness.DTYPE_CODES`
enum Code : int {
  kU8 = 0, kI8 = 1, kU16 = 2, kI16 = 3, kU32 = 4, kI32 = 5,
  kF32 = 6, kBF16 = 7, kF16 = 8, kI64 = 9, kF64 = 10, kBool = 11,
};

// What the host passes: the source code (the raw width's unsigned code, or
// the view dtype's), and each operand as a device pointer (null: absent)
// with its dtype code and its stride in elements from one chunk row's value
// to the next (0: one value for every row; a kernel that is not given a row
// reads row 0).
struct Args {
  int src;
  const void* zero;
  int zero_code;
  const void* scale;
  int scale_code;
  int64_t zero_stride = 0;
  int64_t scale_stride = 0;
};

// Bytes of an element of dtype `code`
__host__ __device__ __forceinline__ int code_size(int code) {
  return code == kI64 || code == kF64 ? 8
         : code == kU32 || code == kI32 || code == kF32 ? 4
         : code == kU16 || code == kI16 || code == kBF16 || code == kF16 ? 2
         : 1;
}

// Row `row`'s element of an operand of dtype `code` and row stride `stride`
__device__ __forceinline__ const void* row_elem(const void* p, int code,
                                                int64_t stride, int64_t row) {
  return static_cast<const char*>(p) + row * stride * code_size(code);
}

template <typename O> struct Traits;
template <> struct Traits<uint8_t> { static constexpr bool kFloat = false; };
template <> struct Traits<uint16_t> { static constexpr bool kFloat = false; };
template <> struct Traits<uint32_t> { static constexpr bool kFloat = false; };
template <> struct Traits<float> {
  static constexpr bool kFloat = true;
  static constexpr int kCode = kF32;
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr bool kFloat = true;
  static constexpr int kCode = kBF16;
};
template <> struct Traits<__half> {
  static constexpr bool kFloat = true;
  static constexpr int kCode = kF16;
};

// float32 -> O, rounded to nearest even (O a float type); O's bits
template <typename O> __device__ __forceinline__ uint32_t round_to(float f);
template <> __device__ __forceinline__ uint32_t round_to<float>(float f) {
  return __float_as_uint(f);
}
template <>
__device__ __forceinline__ uint32_t round_to<__nv_bfloat16>(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
template <> __device__ __forceinline__ uint32_t round_to<__half>(float f) {
  return __half_as_ushort(__float2half_rn(f));
}

// O's bits -> float32, exactly
template <typename O> __device__ __forceinline__ float widen(uint32_t b);
template <> __device__ __forceinline__ float widen<float>(uint32_t b) {
  return __uint_as_float(b);
}
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(uint32_t b) {
  return __uint_as_float(b << 16);
}
template <> __device__ __forceinline__ float widen<__half>(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

__device__ __forceinline__ bool is_float_code(int c) {
  return c == kF32 || c == kBF16 || c == kF16 || c == kF64;
}

// One operand, cast to O as torch's `.to(O)` casts it; O's bits.
template <typename O>
__device__ __forceinline__ uint32_t operand(const void* p, int code) {
  int64_t i = 0;
  double d = 0.0;
  switch (code) {
    case kU8: case kBool: i = *static_cast<const uint8_t*>(p); break;
    case kI8: i = *static_cast<const int8_t*>(p); break;
    case kU16: i = *static_cast<const uint16_t*>(p); break;
    case kI16: i = *static_cast<const int16_t*>(p); break;
    case kU32: i = *static_cast<const uint32_t*>(p); break;
    case kI32: i = *static_cast<const int32_t*>(p); break;
    case kI64: i = *static_cast<const int64_t*>(p); break;
    case kF32: d = *static_cast<const float*>(p); break;
    case kBF16:
      d = __bfloat162float(*static_cast<const __nv_bfloat16*>(p));
      break;
    case kF16: d = __half2float(*static_cast<const __half*>(p)); break;
    case kF64: d = *static_cast<const double*>(p); break;
    default: break;
  }
  if constexpr (Traits<O>::kFloat) {
    // torch: integer -> float32 rounded; float64 -> float32 rounded; then
    // float32 -> O rounded (bf16 / fp16 are built from a float)
    const float f = is_float_code(code) ? __double2float_rn(d)
                                        : __ll2float_rn(i);
    return round_to<O>(f);
  } else {
    return static_cast<uint32_t>(static_cast<uint64_t>(i));
  }
}

// The epilogue of one launch; `operator()` maps a decoded value (its bits in
// the low bytes of `raw`) to O's bits.  What depends on the launch alone
// (how the source is read, the operands as float32) is decided once a
// thread here, so a store runs a short chain: a shift pair that reads the
// source's integer value, one conversion, then the subtract and the
// multiply, each under a flag that is the same for every thread.
template <typename O>
struct Store {
  int src;
  bool zero, scale;
  bool ident;     // an integer O of the source's size, no zero or scale:
                  // the output bits are the decoded bits
  bool same;      // a float O of the source's own type: the bits as they are
  bool fsrc;      // a float source of another float type
  bool sgn;       // an integer source: signed
  bool big;       // an integer source: 32-bit unsigned
  int shl;        // an integer source: 32 minus its bits
  uint32_t z, s;  // the operands, O's bits
  float zf, sf;   // a float O: the operands as float32 (exact)

  // the epilogue of chunk row `row` (its operands' values where they have
  // one a row)
  __device__ __forceinline__ explicit Store(const Args& a, int64_t row = 0)
      : src(a.src), zero(a.zero != nullptr), scale(a.scale != nullptr),
        ident(false), same(false), fsrc(false), sgn(false), big(false),
        shl(0), z(0), s(1), zf(0.0f), sf(1.0f) {
    set_row(a, row);
    const int size = src <= kI8 ? 1 : src <= kI16 ? 2 : 4;
    fsrc = src == kF32 || src == kBF16 || src == kF16;
    sgn = src == kI8 || src == kI16 || src == kI32;
    big = src == kU32;
    shl = 32 - 8 * size;
    if constexpr (Traits<O>::kFloat) {
      same = src == Traits<O>::kCode;
    } else {
      ident = !zero && !scale && size == static_cast<int>(sizeof(O));
    }
  }

  // Whether the operands differ from row to row
  static __device__ __forceinline__ bool by_row(const Args& a) {
    return (a.zero != nullptr && a.zero_stride != 0) ||
           (a.scale != nullptr && a.scale_stride != 0);
  }

  // Read chunk row `row`'s operands
  __device__ __forceinline__ void set_row(const Args& a, int64_t row) {
    if (zero)
      z = operand<O>(row_elem(a.zero, a.zero_code, a.zero_stride, row),
                     a.zero_code);
    if (scale)
      s = operand<O>(row_elem(a.scale, a.scale_code, a.scale_stride, row),
                     a.scale_code);
    if constexpr (Traits<O>::kFloat) {
      zf = widen<O>(z);
      sf = widen<O>(s);
    }
  }

  // the integer value of `raw` read as `src`, in 32 bits (sign- or
  // zero-extended from the source's size)
  __device__ __forceinline__ uint32_t ivalue(uint32_t raw) const {
    const uint32_t t = raw << shl;
    return sgn ? static_cast<uint32_t>(static_cast<int32_t>(t) >> shl)
               : t >> shl;
  }

  __device__ __forceinline__ uint32_t operator()(uint32_t raw) const {
    if constexpr (Traits<O>::kFloat) {
      uint32_t x;
      if (same) {
        x = raw;                  // the same type: the bits as they are
      } else if (fsrc) {
        const float f = src == kF32 ? __uint_as_float(raw)
                        : src == kBF16 ? __uint_as_float(raw << 16)
                        : __half2float(__ushort_as_half(
                              static_cast<unsigned short>(raw)));
        x = round_to<O>(f);
      } else {
        const uint32_t v = ivalue(raw);
        x = round_to<O>(big ? __uint2float_rn(v)
                            : __int2float_rn(static_cast<int32_t>(v)));
      }
      if (zero) x = round_to<O>(__fsub_rn(widen<O>(x), zf));
      if (scale) x = round_to<O>(__fmul_rn(widen<O>(x), sf));
      return x;
    } else {
      constexpr uint32_t kMask =
          sizeof(O) == 4 ? 0xFFFFFFFFu : (1u << (8 * sizeof(O))) - 1u;
      return ((ivalue(raw) - z) * s) & kMask;
    }
  }
};

// Pack element k of a 16-byte vector of O's (bits `b`) into `pk`
template <int OS>
__device__ __forceinline__ void pack(uint32_t (&pk)[4], int k, uint32_t b) {
  if constexpr (OS == 4) {
    pk[k] = b;
  } else {
    pk[k * OS / 4] |= b << (8 * ((k * OS) & 3));
  }
}

// Element k of a packed vector, O's bits
template <int OS>
__device__ __forceinline__ uint32_t unpack(const uint32_t (&pk)[4], int k) {
  if constexpr (OS == 4) return pk[k];
  else return (pk[k * OS / 4] >> (8 * ((k * OS) & 3))) &
         ((1u << (8 * OS)) - 1u);
}

// Write the first `valid` of a packed vector's 16 / OS elements to `dst`:
// one 16-byte store when all are valid and `dst` is aligned, else one store
// an element.
template <int OS>
__device__ __forceinline__ void store(void* dst, const uint32_t (&pk)[4],
                                      int valid, bool aligned) {
  constexpr int kE = 16 / OS;
  if (aligned && valid == kE) {
    *static_cast<uint4*>(dst) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    if (k < valid) {
      const uint32_t b = unpack<OS>(pk, k);
      if constexpr (OS == 1) static_cast<uint8_t*>(dst)[k] =
          static_cast<uint8_t>(b);
      else if constexpr (OS == 2) static_cast<uint16_t*>(dst)[k] =
          static_cast<uint16_t>(b);
      else static_cast<uint32_t*>(dst)[k] = b;
    }
  }
}

// The store of a launch without an epilogue: the decoded value as it is (the
// store truncates it to the width type), so that instance compiles to the
// kernel's plain stores.
struct Raw {
  __device__ __forceinline__ explicit Raw(const Args&) {}
  __device__ __forceinline__ uint32_t operator()(uint32_t raw) const {
    return raw;
  }
};

// The unsigned type that holds an output of OS bytes
template <int OS> struct Bits;
template <> struct Bits<1> { using T = uint8_t; };
template <> struct Bits<2> { using T = uint16_t; };
template <> struct Bits<4> { using T = uint32_t; };

// `n` raw elements at `p` into registers: 16-, 8- or 4-byte loads (`p`
// aligned to the smaller of 16 and the bytes loaded).
template <typename R, int N>
__device__ __forceinline__ void load_raw(const R* p, R (&x)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(R));
  static_assert(kBytes % 4 == 0, "whole 32-bit words");
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[q];
      memcpy(reinterpret_cast<char*>(x) + 16 * q, &w, 16);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    memcpy(x, &w, 8);
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    memcpy(x, &w, 4);
  }
}

// One warp's epilogue pass over its finished row, for a kernel whose matches
// read the raw row (kept in a scratch matrix): out[i] = st(raw[i]) for
// i < end, and st(0) up to n.  It runs once the row is final (after a
// `__syncwarp()`), off the decode's serial chain.  A lane converts 16-byte
// output vectors, each from one vector load of raw elements, and loads kU
// vectors (~128 bytes of raw elements) before it converts and stores them,
// so that many loads are in flight: the row was written by this launch and
// is read from L2, and one load at a time left the pass latency-bound.
// Unaligned rows take one element a lane.  `raw` is read through plain
// loads (it was written in this launch).
template <int OS, typename St, typename R>
__device__ __forceinline__ void warp_row(const St& st, const R* raw,
                                         void* out, int64_t end, int64_t n,
                                         int lane) {
  constexpr int kE = 16 / OS;               // elements a vector
  constexpr int kRawBytes = kE * static_cast<int>(sizeof(R));
  constexpr int kRawAlign = kRawBytes < 16 ? kRawBytes : 16;
  constexpr int kU = 128 / kRawBytes < 2 ? 2
                     : 128 / kRawBytes > 16 ? 16 : 128 / kRawBytes;
  using E = typename Bits<OS>::T;
  E* o = static_cast<E*>(out);
  const uint32_t zero = st(0u);
  int64_t i = lane;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(raw) & (kRawAlign - 1)) == 0) {
    const int64_t nv = n / kE;
    const int64_t nfull = (end < n ? end : n) / kE;  // vectors before end
    int64_t v = lane;
    for (; v + 32 * (kU - 1) < nfull; v += 32 * kU) {
      R x[kU][kE];
#pragma unroll
      for (int u = 0; u < kU; ++u) load_raw(raw + (v + 32 * u) * kE, x[u]);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        uint32_t pk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < kE; ++k) pack<OS>(pk, k, st(x[u][k]));
        *reinterpret_cast<uint4*>(o + (v + 32 * u) * kE) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
      }
    }
    for (; v < nv; v += 32) {
      const int64_t i0 = v * kE;
      uint32_t pk[4] = {0u, 0u, 0u, 0u};
      if (i0 + kE <= end) {
        R x[kE];
        load_raw(raw + i0, x);
#pragma unroll
        for (int k = 0; k < kE; ++k) pack<OS>(pk, k, st(x[k]));
      } else {
#pragma unroll
        for (int k = 0; k < kE; ++k)
          pack<OS>(pk, k, i0 + k < end ? st(raw[i0 + k]) : zero);
      }
      *reinterpret_cast<uint4*>(o + i0) = make_uint4(pk[0], pk[1], pk[2],
                                                     pk[3]);
    }
    i = nv * kE + lane;
  }
  for (; i < n; i += 32) o[i] = static_cast<E>(i < end ? st(raw[i]) : zero);
}

// Whether a launch stores the decoded bits as they are: no operands and an
// output of the source's own type (the host passes that for a launch
// without an epilogue, and for an epilogue that only views the bits).
inline bool plain_store(int out_code, const Args& a) {
  return a.zero == nullptr && a.scale == nullptr && out_code == a.src;
}

template <typename O> struct Tag { using type = O; };

// `f(Tag<O>{})` (which returns 0 or a CUDA error of its own) for the output
// type of `code`, as EPI_DISPATCH; for a launch whose instance is named by
// more template arguments than the output type.
template <typename F>
int dispatch(int code, F&& f) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (code) {
    case kU8: case kI8: err = f(Tag<uint8_t>{}); break;
    case kU16: case kI16: err = f(Tag<uint16_t>{}); break;
    case kU32: case kI32: err = f(Tag<uint32_t>{}); break;
    case kF32: err = f(Tag<float>{}); break;
    case kBF16: err = f(Tag<__nv_bfloat16>{}); break;
    case kF16: err = f(Tag<__half>{}); break;
    default: break;
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace epi

// Call `LAUNCH<O>(args...)` (which returns 0 or a CUDA error of its own)
// for the output type of `code` (the output dtype's code; integer outputs
// share the unsigned type of their size).  Evaluates to the CUDA error
// (cudaErrorInvalidValue for an unknown code).
#define EPI_DISPATCH(code, LAUNCH, ...)                                      \
  ([&]() -> int {                                                            \
    int err_ = static_cast<int>(cudaErrorInvalidValue);                      \
    switch (code) {                                                          \
      case epi::kU8: case epi::kI8: err_ = LAUNCH<uint8_t>(__VA_ARGS__);     \
        break;                                                               \
      case epi::kU16: case epi::kI16: err_ = LAUNCH<uint16_t>(__VA_ARGS__);  \
        break;                                                               \
      case epi::kU32: case epi::kI32: err_ = LAUNCH<uint32_t>(__VA_ARGS__);  \
        break;                                                               \
      case epi::kF32: err_ = LAUNCH<float>(__VA_ARGS__); break;              \
      case epi::kBF16: err_ = LAUNCH<__nv_bfloat16>(__VA_ARGS__); break;     \
      case epi::kF16: err_ = LAUNCH<__half>(__VA_ARGS__); break;             \
      default: break;                                                        \
    }                                                                        \
    return err_ ? err_ : static_cast<int>(cudaGetLastError());              \
  }())
