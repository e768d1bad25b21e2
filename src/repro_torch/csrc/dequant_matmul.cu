// Fused int8-dequant matmul for Hopper (sm_90a): y = x @ (q * s).
//
// Replaces the TPU kernel `dequant_matmul.dequant_matmul` (src/repro/
// kernels/dequant_matmul.py:53, pl.pallas_call at :62, body `_kernel` :37).
//
// What it computes: x is (M, K) float32 or bfloat16, q is (K, N) int8, s is
// (1, N) float32.  Each weight is dequantized as float(q[k][n]) * s[n] when
// its tile is loaded, x is widened to float32, the products are summed in
// float32, and y (M, N) is written in x's type (bfloat16 rounded to nearest
// even).  The memory system reads one byte per weight: the float weights
// only ever exist a tile at a time, in shared memory.
//
// Design: a tiled SIMT GEMM, the simple first version.  Each CTA computes a
// 128 x 128 tile of y with 256 threads, each an 8 x 8 register micro-tile,
// and loops over K in steps of 32.  Per step, the x tile (128 x 32, stored
// K-major so a thread reads its 8 rows as two float4s) and the dequantized
// weight tile (32 x 128) go into 33 KiB of shared memory; the scales of the
// CTA's 128 columns are loaded once.  Global loads are coalesced along the
// contiguous axis of each operand and guarded, so any M, N and K work (the
// wrapper keeps the reference's divisibility contract).  The sum order
// differs from the reference's (one dot per 128-deep tile), which the tests'
// tolerances state.
//
// Bound: at a decode batch (M = 128) bytes, the int8 weights read once; at a
// prefill chunk (M = 2048) operations, 2*M*N*K over the tensor cores' bf16
// rate.  This kernel runs on the float32 FMA units (67 TFLOP/s on an H100
// SXM), not the tensor cores, so it cannot reach the second bound; `wgmma`
// with TMA-fed tiles is the later work that can.
#include <cstdint>
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
