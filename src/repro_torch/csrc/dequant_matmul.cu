// Fused int8-dequant matmul for Hopper (sm_90a): y = x @ (q * s).
//
// Replaces the TPU kernel `dequant_matmul.dequant_matmul` (src/repro/
// kernels/dequant_matmul.py:53, pl.pallas_call at :62, body `_kernel` :37).
//
// What it computes: x is (M, K) float32 or bfloat16, q is (K, N) int8, s is
// (1, N) float32.  y[m][n] = s[n] * sum_k x[m][k] * q[k][n], summed in
// float32, written in x's type (bfloat16 rounded to nearest even).  The
// memory system reads one byte per weight: float weights only ever exist in
// registers or a tile of shared memory.  The sum order differs from the
// reference's (one dot per 128-deep tile), which the tests' tolerances
// state.
//
// Two entry points; the wrapper picks one by dtype and shape alone
// (`kernels/dequant_matmul._launch_plan`).
//
// `codag_dequant_matmul_wgmma` (bfloat16 x, K % 8 == 0, N % 16 == 0: the
// strides TMA can describe) runs on the tensor cores, in the mixed-input
// shape CUTLASS uses on Hopper.  It computes y^T = q^T . x^T: the int8
// weight tile is the 64-row A operand of `wgmma`, read from shared memory
// by each thread and converted to bfloat16 in registers (exact: an int8 is
// a bfloat16), and the activation tile is the B operand, read by `wgmma`
// from shared memory (x is K-contiguous, the K-major layout `wgmma` wants).
// So the token count M is the MMA's N: a CTA covers 128 weight columns (two
// consumer warpgroups of 64) by BM tokens, BM = 8..64 for a batch below 64
// tokens and 128 otherwise.  One producer warp keeps a ring of 6 stages of
// (x: BM x 64 bf16, q: 64 x 128 int8) in flight with TMA (128-byte
// swizzle) behind `mbarrier`s.  A warpgroup's A-operand rows are mapped to
// weight columns so that a thread's two rows are adjacent columns: one
// 16-bit load gives both, and the swizzle makes the loads of a warp
// conflict-free.  The int8 -> bf16 conversion is integer and float-add
// work (no conversion unit), into one of two register buffers, so a
// stage's conversion overlaps the previous stage's MMAs.  s[n] is applied
// in float32 in the epilogue.  When the output tiles alone leave half the
// SMs or more idle (a decode batch), K is split across CTAs: each writes
// float32 partial sums to a workspace the wrapper allocates, and a second
// kernel sums them in split order and scales: deterministic, no atomics.
//
// `codag_dequant_matmul` (float32 x, or shapes TMA cannot describe) is the
// tiled SIMT GEMM of the first port: a 128 x 128 tile of y per CTA, 256
// threads each an 8 x 8 register micro-tile, K in steps of 32 through 33
// KiB of shared memory, every edge masked.
//
// Bound: at a decode batch (M = 128) bytes, the int8 weights read once; at a
// prefill chunk (M = 2048) operations, 2*M*N*K over the tensor cores' bf16
// rate (989 TFLOP/s dense on an H100 SXM).  The SIMT path runs on the
// float32 FMA units (67 TFLOP/s) and cannot reach the second bound.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kTM = 8, kTN = 8;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPadM = kBM + 4;  // x tile row stride: 4-way store conflicts,
                                // 16-byte aligned float4 reads

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                      const float* __restrict__ s, T* __restrict__ y,
                      int64_t M, int64_t N, int64_t K) {
  __shared__ __align__(16) float xs[kBK][kPadM];
  __shared__ __align__(16) float ws[kBK][kBN];
  __shared__ float ss[kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;

  for (int c = tid; c < kBN; c += kThreads)
    ss[c] = n0 + c < N ? s[n0 + c] : 0.f;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's tiles are consumed; ss is set
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;  // coalesced along K
      const int64_t m = m0 + r, k = k0 + c;
      xs[c][r] = m < M && k < K ? to_float(x[m * K + k]) : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;  // coalesced along N
      const int64_t k = k0 + r, n = n0 + c;
      ws[r][c] = k < K && n < N
                     ? static_cast<float>(q[k * N + n]) * ss[c]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * kTM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[kk][ty * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[kk][tx * kTN + 4]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t m = m0 + ty * kTM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t n = n0 + tx * kTN + j;
      if (n < N) y[m * N + n] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* q, const void* s, void* y, int64_t M,
           int64_t N, int64_t K, void* stream) {
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  dequant_matmul_kernel<T><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<T*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (M, N) = x (M, K) @ (q (K, N) int8 * s (1, N) float32), on `stream`.
// `dtype` 0: x and y are float32; 1: bfloat16.  All operands contiguous.
// Returns the CUDA error of the launch (0 on success).  Allocates nothing
// and does not synchronise.
extern "C" int codag_dequant_matmul(int dtype, const void* x, const void* q,
                                    const void* s, void* y, int64_t M,
                                    int64_t N, int64_t K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || (N + kBN - 1) / kBN > 0x7FFFFFFF || (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(x, q, s, y, M, N, K, stream);
    case 1:
      return launch<__nv_bfloat16>(x, q, s, y, M, N, K, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// the tensor-core path
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBN = 128;          // weight columns a CTA: 2 warpgroups x 64
constexpr int kBK = 64;           // K a stage: one 128-byte row of bf16 x
constexpr int kStages = 6;
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kQTile = kBK * kBN;          // 8 KiB of int8 weights a stage
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(n)
      : "memory");
}

// box (c0 innermost, c1) of `map` into shared memory at dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// int8 byte `i` of w, stored as w ^ 0x80 (0..255), as an exact float:
// 2^23 + u minus 2^23 + 128
__device__ __forceinline__ float byte_float(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) -
         8388736.f;
}

// two floats that are bfloat16 values (|v| <= 128, integers) as bf16x2:
// their upper halves, exact
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// two floats rounded to nearest even as bf16x2
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// D (64 x N, float32) += A (64 x 16 bf16, registers) . B (16 x N bf16, the
// shared-memory tile of `desc`)
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : F4(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : F4(0), F4(4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : F4(0), F4(4), F4(8), F4(12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20),
          F4(24), F4(28)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20),
          F4(24), F4(28), F4(32), F4(36), F4(40), F4(44),
          F4(48), F4(52), F4(56), F4(60)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

#undef F4

template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
dequant_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_q,
                            const float* __restrict__ s,
                            __nv_bfloat16* __restrict__ y,
                            float* __restrict__ ws, int M, int N,
                            int k_tiles, int splits) {
  constexpr int kXTile = BM * kBK * 2;
  constexpr int kStage = kXTile + kQTile;   // a multiple of 1024
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // 128-byte swizzled tiles start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int kt0 = static_cast<int>(static_cast<int64_t>(split) * k_tiles /
                                   splits);
  const int kt1 = static_cast<int>(static_cast<int64_t>(split + 1) *
                                   k_tiles / splits);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {   // the producer warp
    if (threadIdx.x == kConsumers) {
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        uint8_t* xs = smem + st * kStage;
        mbar_expect_tx(&full[st], kStage);
        tma_load(xs, &tm_x, &full[st], kt * kBK, m0);
        tma_load(xs + kXTile, &tm_q, &full[st], n0, kt * kBK);
      }
    }
    return;
  }

  // consumer warpgroup `wg` owns weight columns 64 wg .. 64 wg + 63 of the
  // tile; its warp `warp` rows 16 warp .. +15 of the A operand.  A row
  // g (and g + 8) of the warp is weight column 16 warp + 2 g (and + 1), so
  // a thread's two rows are one 16-bit load; the accumulator's rows follow.
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int chunk = wgi * 4 + warp;   // 16-byte chunk of the q tile's row

  float d[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) d[i] = 0.f;

  // Stage i: convert its weights into one of two register buffers and
  // start its 4 MMAs; then wait for stage i - 1's MMAs (which read the
  // other buffer) and release that stage to the producer.  So a stage's
  // conversion overlaps the previous stage's MMAs.
  uint32_t a0[4][4], a1[4][4];
  auto run = [&](int i, uint32_t(&a)[4][4]) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const uint8_t* xs = smem + st * kStage;
    const uint8_t* qs = xs + kXTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // k rows r and r + 1
        const int r = 16 * kk + 2 * t + 8 * h;
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(
            qs + r * 128 + ((chunk ^ (r & 7)) << 4) + 2 * g);
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(
            qs + (r + 1) * 128 + ((chunk ^ ((r + 1) & 7)) << 4) + 2 * g);
        // bytes: (row g, k r), (row g+8, k r), (row g, k r+1), (g+8, r+1)
        const uint32_t w = (lo | hi << 16) ^ 0x80808080u;
        a[kk][2 * h] = bf16x2(byte_float(w, 0), byte_float(w, 2));
        a[kk][2 * h + 1] = bf16x2(byte_float(w, 1), byte_float(w, 3));
      }
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<BM>::mma(d, a[kk], smem_desc(xs + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
  };
  const int n_stages = kt1 - kt0;
  for (int i = 0; i < n_stages; i += 2) {
    run(i, a0);
    if (i + 1 < n_stages) run(i + 1, a1);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // accumulator d[4j + v]: weight column nw + (v >> 1), token 8j + 2t + (v & 1)
  const int nw = n0 + 64 * wgi + 16 * warp + 2 * g;
  if (nw >= N) return;   // N % 16 == 0: nw + 1 < N too
  if (ws == nullptr) {
    const float s0 = s[nw], s1 = s[nw + 1];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int m = m0 + 8 * j + 2 * t;
      if (m < M)
        *reinterpret_cast<uint32_t*>(y + static_cast<int64_t>(m) * N + nw) =
            bf16x2_rn(d[4 * j] * s0, d[4 * j + 2] * s1);
      if (m + 1 < M)
        *reinterpret_cast<uint32_t*>(y + static_cast<int64_t>(m + 1) * N +
                                     nw) =
            bf16x2_rn(d[4 * j + 1] * s0, d[4 * j + 3] * s1);
    }
  } else {
    float* part = ws + static_cast<int64_t>(split) * M * N;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int m = m0 + 8 * j + 2 * t;
      if (m < M)
        *reinterpret_cast<float2*>(part + static_cast<int64_t>(m) * N + nw) =
            make_float2(d[4 * j], d[4 * j + 2]);
      if (m + 1 < M)
        *reinterpret_cast<float2*>(part + static_cast<int64_t>(m + 1) * N +
                                   nw) = make_float2(d[4 * j + 1],
                                                     d[4 * j + 3]);
    }
  }
}

// y = s * (sum of the `splits` partial (M, N) sums in ws, in split order)
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ s,
                     __nv_bfloat16* __restrict__ y, int64_t mn, int N,
                     int splits) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * 4;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 4;
       i < mn; i += step) {
    float4 acc = *reinterpret_cast<const float4*>(ws + i);
    for (int p = 1; p < splits; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(ws + p * mn + i);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(s + i % N);
    uint2 out;
    out.x = bf16x2_rn(acc.x * sc.x, acc.y * sc.y);
    out.y = bf16x2_rn(acc.z * sc.z, acc.w * sc.w);
    *reinterpret_cast<uint2*>(y + i) = out;
  }
}

template <int BM>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_q, const float* s,
           __nv_bfloat16* y, float* ws, int M, int N, int k_tiles,
           int splits, cudaStream_t stream) {
  constexpr int kSmem = kStages * (BM * kBK * 2 + kQTile) + 1024;
  auto kernel = dequant_matmul_wgmma_kernel<BM>;
  static bool configured[kMaxDevices] = {};   // the attribute is per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return static_cast<int>(err);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>(splits));
  kernel<<<grid, kThreads, kSmem, stream>>>(tm_x, tm_q, s, y, ws, M, N,
                                            k_tiles, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// y (M, N) bf16 = x (M, K) bf16 @ (q (K, N) int8 * s (1, N) float32) on the
// tensor cores, on `stream`.  `bm` (8, 16, 32, 64 or 128) is the tokens a
// CTA covers; `splits` > 1 splits K across CTAs and needs `ws`, a float32
// (splits, M, N) workspace (null otherwise).  Needs K % 8 == 0, N % 16 ==
// 0 and 16-byte aligned x and q.  Returns the CUDA error of the launches (0
// on success).  Allocates nothing and does not synchronise.
extern "C" int codag_dequant_matmul_wgmma(const void* x, const void* q,
                                          const void* s, void* y, void* ws,
                                          int64_t M, int64_t N, int64_t K,
                                          int bm, int splits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int64_t k_tiles = (K + wg::kBK - 1) / wg::kBK;
  if (K <= 0 || K % 8 || N % 16 || M > 0x7FFFFFFF || N > 0x7FFFFFFF ||
      K > 0x7FFFFFFF || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(q) & 15) ||
      (reinterpret_cast<uintptr_t>(s) & 15) || splits < 1 ||
      splits > k_tiles || splits > 65535 || (splits > 1) != (ws != nullptr) ||
      (bm != 8 && bm != 16 && bm != 32 && bm != 64 && bm != 128) ||
      (M + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_q;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t x_dim[2] = {static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t x_stride[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t x_box[2] = {wg::kBK, static_cast<cuuint32_t>(bm)};
  const cuuint64_t q_dim[2] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(K)};
  const cuuint64_t q_stride[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t q_box[2] = {wg::kBN, wg::kBK};
  if (cuTensorMapEncodeTiled(
          &tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
          x_dim, x_stride, x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      cuTensorMapEncodeTiled(
          &tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q),
          q_dim, q_stride, q_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sp = static_cast<const float*>(s);
  auto* out = static_cast<__nv_bfloat16*>(y);
  float* part = static_cast<float*>(ws);
  const auto st = static_cast<cudaStream_t>(stream);
  using Launch = int (*)(const CUtensorMap&, const CUtensorMap&,
                         const float*, __nv_bfloat16*, float*, int, int, int,
                         int, cudaStream_t);
  const Launch fn = bm == 8    ? wg::launch<8>
                    : bm == 16 ? wg::launch<16>
                    : bm == 32 ? wg::launch<32>
                    : bm == 64 ? wg::launch<64>
                               : wg::launch<128>;
  const int err = fn(tm_x, tm_q, sp, out, part, static_cast<int>(M),
                     static_cast<int>(N), static_cast<int>(k_tiles), splits,
                     st);
  if (err || splits == 1) return err;
  const int64_t mn = M * N;
  const int64_t blocks = (mn / 4 + 255) / 256;
  wg::splitk_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                                   : 4096),
                             256, 0, st>>>(part, sp, out, mn,
                                           static_cast<int>(N), splits);
  return static_cast<int>(cudaGetLastError());
}
