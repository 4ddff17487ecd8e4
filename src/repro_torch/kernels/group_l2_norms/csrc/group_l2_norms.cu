// Per-group sums of squares for Hopper (sm_90a): (K, G*C) float32 -> (G,) float32, where group g
// owns the contiguous columns [g*C, (g+1)*C).
//
// Replaces the TPU kernel repro/kernels/group_l2_norms/group_l2_norms.py:group_l2_norms.
//
// Bound on the H100: bytes (one FMA per 4-byte element read), so the design is about reading w once,
// coalesced. Pass 1: a block of 32x8 threads owns 32 neighbouring columns and a slab of ROWS rows;
// each warp reads 32 consecutive floats of a row (128 bytes), each thread sums its column over its
// rows, and the 8 row-partials are summed in a fixed order in shared memory, giving one partial per
// (slab, column). Pass 2: one thread per group sums its C columns' partials over the slabs in a fixed
// order. No atomics, so repeated runs give bitwise-identical scores, which the rank-based pruning
// masks rely on. With C = 1 (every U-Net member) neighbouring groups are neighbouring columns.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int COLS = 32, RTHREADS = 8, ROWS = 128;

__global__ void __launch_bounds__(COLS * RTHREADS)
col_partials(const float* __restrict__ w, float* __restrict__ partial, int K, int N) {
  __shared__ float red[RTHREADS][COLS];
  const int n = blockIdx.x * COLS + threadIdx.x;
  const int r0 = blockIdx.y * ROWS;
  const int r1 = min(r0 + ROWS, K);
  float s = 0.f;
  if (n < N)
    for (int r = r0 + threadIdx.y; r < r1; r += RTHREADS) {
      const float x = w[(int64_t)r * N + n];
      s = fmaf(x, x, s);
    }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < RTHREADS; ++i) t += red[i][threadIdx.x];
    partial[(int64_t)blockIdx.y * N + n] = t;
  }
}

__global__ void group_sums(const float* __restrict__ partial, float* __restrict__ out, int slabs,
                           int N, int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int C = N / G;
  float t = 0.f;
  for (int sl = 0; sl < slabs; ++sl)
    for (int c = 0; c < C; ++c) t += partial[(int64_t)sl * N + g * C + c];
  out[g] = t;
}

}  // namespace

// partial: caller-allocated scratch of ceil(K / 128) * N floats
extern "C" int group_l2_launch(const void* w, void* partial, void* out, int K, int N, int G,
                               void* stream) {
  if (G < 1 || N % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slabs = (K + ROWS - 1) / ROWS;
  col_partials<<<dim3((N + COLS - 1) / COLS, slabs), dim3(COLS, RTHREADS), 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(partial), K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  group_sums<<<(G + 127) / 128, 128, 0, s>>>(static_cast<const float*>(partial),
                                            static_cast<float*>(out), slabs, N, G);
  return static_cast<int>(cudaGetLastError());
}
