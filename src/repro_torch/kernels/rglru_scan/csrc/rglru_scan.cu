// Linear recurrence h_t = a_t * h_{t-1} + b_t, h_{-1} = 0, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rglru_scan/rglru_scan.py:rglru_scan. a, b and h are (B, S,
// W) row-major, float32 or bfloat16 (one type for all); the state is float32 and h has a's type.
// Each step is a multiply and then an add, each rounded on its own (__fmul_rn, __fadd_rn: never a
// fused multiply-add), as the TPU kernel's `a[t] * h + b[t]` and the plain PyTorch version compute
// it, so the kernel gives the plain version's output bit for bit. Any S and W: unlike the TPU
// kernel, no block length has to divide S.
//
// Bound on the H100: bytes. Each element of a and b is read once and each of h written once, for
// one multiply-add: 3*B*S*W*itemsize bytes over 3.35 TB/s, 0.120 ms at the prefill shape (2, 4096,
// 4096) in fp32. The recurrence is sequential in t and independent across (b, w), so one thread
// owns one channel and keeps its state in a register, and the TPU's sequential grid over sequence
// blocks becomes that thread's loop over t. Neighbouring threads own neighbouring w, so each warp's
// load or store of a step is one contiguous segment (128 bytes in fp32). The chain of dependent
// operations is short; what costs is memory latency, so a thread loads the next U = 32 steps of a
// and b into registers before it runs their chain: 64 loads in flight per thread instead of one
// round trip per step.
//
// What it leaves on the table: the grid is ceil(W / 64) x B blocks of 64 threads, 128 blocks at the
// prefill shape, so at most one block per SM and the bytes in flight, not the bandwidth, set the
// time: 0.448 ms there on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md), 3.7x the bound. The redesign is an S-chunked two-pass scan (each block scans a chunk of t for a tile of
// channels, a second pass carries the chunk-end states), queued in ROADMAP B.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int THREADS = 64, U = 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h, int S,
                  int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int64_t base = (int64_t)blockIdx.y * S * W + w;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;
  float state = 0.f;
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = to_f(ap[(int64_t)(t + u) * W]);
      bv[u] = to_f(bp[(int64_t)(t + u) * W]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
      hp[(int64_t)(t + u) * W] = from_f<T>(state);
    }
  }
  for (; t < S; ++t) {
    state = __fadd_rn(__fmul_rn(to_f(ap[(int64_t)t * W]), state), to_f(bp[(int64_t)t * W]));
    hp[(int64_t)t * W] = from_f<T>(state);
  }
}

}  // namespace

extern "C" int rglru_scan_launch(const void* a, const void* b, void* h, int B, int S, int W,
                                 int bf16, void* stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    rglru_scan_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(h), S, W);
  } else {
    rglru_scan_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(h), S, W);
  }
  return static_cast<int>(cudaGetLastError());
}
