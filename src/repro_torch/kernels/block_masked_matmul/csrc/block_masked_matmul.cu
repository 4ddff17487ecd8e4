// Block-masked matmul for Hopper (sm_90a): y = x @ (w * col_mask[None, :] * row_mask[:, None]).
//
// Replaces the TPU kernel repro/kernels/block_masked_matmul/block_masked_matmul.py:block_masked_matmul.
// x (M, K), w (K, N) row-major, float32 or bfloat16; masks float32 (NULL = all ones); y (M, N) in x's
// type, accumulated in float32 registers with IEEE fp32 FMAs (no TF32, no tensor cores).
//
// Bound on the H100: the serving GEMMs are compute-bound (K >= 128 gives well over the card's ~20
// fp32 FLOP/byte balance point), so the kernel reuses each loaded element across a 4x4 register tile
// per thread from 64x64 shared-memory tiles. Like the TPU kernel's pl.when, a block whose 64 output
// columns are all masked skips every K step and writes exact zeros, and a 16-deep K step whose rows are
// all masked is skipped. The fine masks are applied to w on its load into shared memory, so partly
// masked tiles stay exact. Ragged M, K and N edges are masked on load and store, so any shape launches.
// wgmma, TMA and pipelining are left for later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr int TM = BM / 16, TN = BN / 16;  // 4x4 outputs per thread on a 16x16 thread grid

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bmm_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ cm,
           const float* __restrict__ rm, T* __restrict__ y, int M, int K, int N) {
  __shared__ float xs[BK][BM + 4];  // x tile stored transposed: xs[k][m]
  __shared__ float ws[BK][BN + 4];
  __shared__ float cms[BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int live = 0;
  if (tid < BN) {
    const int n = n0 + tid;
    const float c = n < N ? (cm ? cm[n] : 1.f) : 0.f;
    cms[tid] = c;
    live = c != 0.f;
  }
  const bool nlive = __syncthreads_or(live);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (nlive) {
    for (int k0 = 0; k0 < K; k0 += BK) {
      if (rm) {  // uniform branch: skip a K step whose rows are all masked
        int kl = 0;
        if (tid < BK) kl = (k0 + tid < K) && rm[k0 + tid] != 0.f;
        if (!__syncthreads_or(kl)) continue;
      }
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i % BK, m = m0 + r, k = k0 + c;
        xs[c][r] = (m < M && k < K) ? to_f(x[(int64_t)m * K + k]) : 0.f;
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int r = i / BN, c = i % BN, k = k0 + r, n = n0 + c;
        float v = 0.f;
        if (k < K && n < N) {
          v = to_f(w[(int64_t)k * N + n]) * cms[c];
          if (rm) v *= rm[k];
        }
        ws[r][c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[(int64_t)m * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int bmm_launch(const void* x, const void* w, const void* cm, const void* rm, void* y,
                          int M, int K, int N, int bf16, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    bmm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(cm), static_cast<const float*>(rm),
        static_cast<__nv_bfloat16*>(y), M, K, N);
  } else {
    bmm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(cm),
        static_cast<const float*>(rm), static_cast<float*>(y), M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
