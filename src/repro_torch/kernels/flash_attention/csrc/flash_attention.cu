// Streaming-softmax (flash) attention for Hopper (sm_90a), one head per batch row.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py:flash_attention_bhsd.
// q (BH, Sq, hd), k and v (BH, Skv, hd), row-major, float32 or bfloat16, hd <= 256 (any value, e.g.
// 144 after pruning); o (BH, Sq, hd) in q's type. Scores are scaled by hd^-0.5; causal and sliding
// window masks set scores to -1e30 as the TPU kernel does; m, l and the output accumulator are fp32
// and the denominator is clamped at 1e-30.
//
// Bound on the H100: at the U-Net's S=256, hd=256 the work is ~4*S*S*hd FLOPs over 4*S*hd elements
// moved, i.e. compute-bound in principle; this first kernel uses fp32 FMAs from shared memory and is
// bound by shared-memory reads instead. One block of 8 warps owns 32 query rows and loops over
// 32-key tiles of K and V held in shared memory (dynamic, up to ~99 KB at hd=256, so the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize). A key tile is exactly one warp wide: lane j scores key
// j for the warp's four rows, so the row max and sum are warp shuffles and P never touches shared
// memory. Each lane keeps the output accumulator for 8 head-dim columns (lane + 32c) of its warp's
// four rows in registers. Key tiles no query of the block can reach under causal/window are skipped,
// as pl.when does on the TPU. Ragged S is masked on load and store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int BQ = 32, BKV = 32, WARPS = 8, THREADS = WARPS * 32, ROWS = BQ / WARPS;
constexpr int HD_MAX = 256, HC = HD_MAX / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// odd row stride: lanes reading one column of 32 different rows hit 32 different banks
__host__ __device__ inline int row_stride(int hd) { return hd | 1; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Sq, int Skv, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = row_stride(hd);
  float* qs = smem;             // [BQ][ld]
  float* ks = qs + BQ * ld;     // [BKV][ld]
  float* vs = ks + BKV * ld;    // [BKV][ld]
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = q + (int64_t)bh * Sq * hd;
  const T* kb = k + (int64_t)bh * Skv * hd;
  const T* vb = v + (int64_t)bh * Skv * hd;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    qs[r * ld + c] = q0 + r < Sq ? to_f(qb[(int64_t)(q0 + r) * hd + c]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][HC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  for (int k0 = 0; k0 < Skv; k0 += BKV) {
    if (causal && k0 > q_last) break;
    if (window > 0 && k0 + BKV - 1 < q0 - window + 1) continue;
    __syncthreads();  // the previous tile's readers are done (and qs is written)
    for (int i = tid; i < BKV * hd; i += THREADS) {
      const int r = i / hd, c = i % hd;
      const bool in = k0 + r < Skv;
      ks[r * ld + c] = in ? to_f(kb[(int64_t)(k0 + r) * hd + c]) : 0.f;
      vs[r * ld + c] = in ? to_f(vb[(int64_t)(k0 + r) * hd + c]) : 0.f;
    }
    __syncthreads();

    const int kpos = k0 + lane;
    const bool key_in = kpos < Skv;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = warp + WARPS * r, qpos = q0 + row;
      const float* qr = qs + row * ld;
      const float* kr = ks + lane * ld;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      bool ok = true;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      if (!ok) s = NEG_INF;
      float mx = key_in ? s : NEG_INF;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p = key_in ? expf(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < HC; ++c) acc[r][c] *= alpha;
      for (int j = 0; j < BKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vr = vs + j * ld;
#pragma unroll
        for (int c = 0; c < HC; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) acc[r][c] = fmaf(pj, vr[d], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp + WARPS * r;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = o + ((int64_t)bh * Sq + qpos) * hd;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) orow[d] = from_f<T>(acc[r][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv, int hd,
           int causal, int window, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)(BQ + 2 * BKV) * row_stride(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_kernel<T><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, hd, causal, window, 1.f / sqrtf((float)hd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int BH,
                                 int Sq, int Skv, int hd, int causal, int window, int bf16,
                                 void* stream) {
  if (hd < 1 || hd > HD_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, BH, Sq, Skv, hd, causal, window, s)
              : launch<float>(q, k, v, o, BH, Sq, Skv, hd, causal, window, s);
}
