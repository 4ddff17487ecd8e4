// Block-masked matmul for Hopper (sm_90a): y = x @ (B * col_mask[None, :] * row_mask[:, None]),
// where B is w (K, N) or, with trans_b, w.T read in place from a row-major w (N, K). A client axis
// batches C independent products of one shape in one launch: x (C, M, K), w (C, K, N) (or (C, N, K)),
// y (C, M, N), the masks shared by every client (the vectorized round engine's per-client GEMMs).
//
// Replaces the TPU kernel repro/kernels/block_masked_matmul/block_masked_matmul.py:block_masked_matmul.
// x (M, K) row-major, float32 or bfloat16; masks float32 (NULL = all ones); y (M, N) in x's type,
// accumulated in float32 registers with IEEE fp32 FMAs (no TF32, no tensor cores: the port's
// training and serving paths run fp32 and their parity checks hold fp32 sums).
//
// What bounds it on the H100. Every main-path shape has K >= 27 and an arithmetic intensity far above
// the card's fp32 balance point (67 TFLOP/s over 3.35 TB/s is 20 FLOP/byte), so the bound is the FMA
// rate. In practice the large training shapes (M = 8192-32768) are limited by shared-memory reads
// per FMA, and the small ones (M = 8-512 with K up to 4608, serving's M = 8) by how few output tiles
// there are to spread over 132 SMs and by the host's cost per launch.
//
// What the design does about it:
// - Register tiles of 8x8 per thread: each k row a thread reads 8 values of x and 8 of B from shared
//   memory as four 16-byte loads and does 64 FMAs with them. Block tiles of 128 or 64 rows by 128
//   or 64 columns, chosen per shape by the wrapper's plan (ops.py:plan). The 64x64 tile runs four
//   thread groups that split each 32-row k step between them and are summed in group order at the
//   end, so a shape with few output tiles still gets 256 threads a block without a second launch.
//   Registers (-Xptxas=-v): 128 for the 128x128 and 64x64 tiles (256 threads, 2 blocks an SM),
//   147-168 for 128x64 and 64x128 (128 threads); no spills.
// - A ring of cp.async stages (3 of 8 rows; 2 of 32 for the 64x64 tile): the next tiles are in
//   flight while this one is multiplied. x (and w when read transposed) is K-contiguous and is
//   transposed on its way into shared memory by 4-byte copies; w row-major is copied 16 bytes at a
//   time when N % 4 == 0 and the base is 16-byte aligned, else 4 bytes. Ragged M, K and N edges are
//   zero-filled by the copy (src-size 0), so any shape launches. bf16 inputs take the same tiles,
//   converted to fp32 on a synchronous load (no launched path runs bf16 yet).
// - Split-K for shapes whose output tiles cannot fill the SMs: slice z of the grid walks its own
//   range of k steps and writes an fp32 partial tile to a workspace; a second kernel sums the slices
//   in slice order (no atomics), so the result is the same bits on every run.
// - The client axis shares grid z with the split: z = client * splits + slice. Each client's blocks
//   run the single-client code on the client's slices of x, w and y (the forward advances the
//   pointers once; the dx launch, at its register cap, takes row offsets into x as (C*M, K) and so
//   on), and its partials sit in its own (splits, M, N) planes of the workspace, so a client's
//   output is the same bits as a one-client launch of the same plan on its slice.
// - Masks skip work as the TPU kernel's pl.when does: a block whose columns are all masked writes
//   zeros without reading K; a k step whose rows are all masked is never loaded (each thread walks
//   the same list of live steps); partly masked tiles are multiplied by the masks in shared memory,
//   (w * col) * row as the plain version rounds it, before they are used.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BK = 8, PAD = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4- and 16-byte async copies; a copy with ok == false fills zeros and reads nothing
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A BM x BN output tile. KG groups of (BM / 8) * (BN / 8) threads each own the whole tile's 8x8
// register tiles over their own BK rows of each DEPTH = KG * BK deep stage, and are summed in group
// order at the end: KG = 4 gives the 64x64 tile 256 threads, for shapes with few output tiles.
template <int BM, int BN, int KG>
struct Tiles {
  static constexpr int GROUP = (BM / 8) * (BN / 8), THREADS = KG * GROUP, DEPTH = KG * BK;
  static constexpr int STAGES = KG > 1 ? 2 : 3;  // 35 KB of static shared memory either way
  float a[STAGES][DEPTH][BM + PAD];  // x tile, transposed: a[k][m]
  float b[STAGES][DEPTH][BN + PAD];  // B tile: b[k][n]
  float cm[BN];
};

// A K-contiguous operand (x, or w read as w.T), rows r0.. of a (R, K) row-major matrix, into
// dst[k][r]: thread t copies element (r = t / DEPTH + i * (THREADS / DEPTH), k = t % DEPTH).
template <typename T, int ROWS, int DEPTH, int THREADS, int LD>
__device__ __forceinline__ void load_kmajor(float (*dst)[LD], const T* src, int r0, int R, int k0,
                                            int K, int tid) {
  constexpr int STEP = THREADS / DEPTH;
  const int k = k0 + tid % DEPTH;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const int rl = tid / DEPTH + i * STEP, r = r0 + rl;
    const bool ok = r < R && k < K;
    const T* p = ok ? src + (int64_t)r * K + k : src;
    if constexpr (std::is_same<T, float>::value) {
      cp4(&dst[tid % DEPTH][rl], p, ok);
    } else {
      dst[tid % DEPTH][rl] = ok ? to_f(*p) : 0.f;
    }
  }
}

// w (K, N) row-major, rows k0.. and columns n0.. into dst[k][n]
template <typename T, int BN, int DEPTH, int THREADS, int LD>
__device__ __forceinline__ void load_nmajor(float (*dst)[LD], const T* w, int k0, int K, int n0,
                                            int N, bool vec, int tid) {
  if (std::is_same<T, float>::value && vec) {
    constexpr int CHUNKS = DEPTH * BN / 4;
    for (int i = tid; i < CHUNKS; i += THREADS) {
      const int kl = i / (BN / 4), nl = (i % (BN / 4)) * 4, k = k0 + kl, n = n0 + nl;
      const bool ok = k < K && n < N;  // N % 4 == 0: a chunk is all in or all out
      cp16(&dst[kl][nl], reinterpret_cast<const float*>(ok ? w + (int64_t)k * N + n : w), ok);
    }
  } else {
    for (int i = tid; i < DEPTH * BN; i += THREADS) {
      const int kl = i / BN, nl = i % BN, k = k0 + kl, n = n0 + nl;
      const bool ok = k < K && n < N;
      const T* p = ok ? w + (int64_t)k * N + n : w;
      if constexpr (std::is_same<T, float>::value) {
        cp4(&dst[kl][nl], p, ok);
      } else {
        dst[kl][nl] = ok ? to_f(*p) : 0.f;
      }
    }
  }
}

// a k step of DEPTH rows is live unless every row is masked
template <int DEPTH>
__device__ __forceinline__ bool step_live(const float* rm, int s, int K) {
  if (!rm) return true;
  for (int i = 0; i < DEPTH; ++i) {
    const int k = s * DEPTH + i;
    if (k < K && rm[k] != 0.f) return true;
  }
  return false;
}
template <int DEPTH>
__device__ __forceinline__ int next_live(const float* rm, int s, int s_end, int K) {
  while (s < s_end && !step_live<DEPTH>(rm, s, K)) ++s;
  return s;
}

// grid (M tiles, N tiles, clients * splits); z = client * splits + slice, and slice covers k steps of
// DEPTH rows [slice * per, min((slice + 1) * per, steps)) of that client's product. splits == 1 writes
// y; otherwise the slice writes its fp32 partial (M, N) tile to ws[client][slice].
// Resident blocks per SM as ops.py:SLOTS counts them: registers capped at 128 for 256 threads,
// 170 for 128 or 64.
template <typename T, int BM, int BN, int KG, bool TRANS_B>
__global__ void __launch_bounds__(Tiles<BM, BN, KG>::THREADS,
                                  Tiles<BM, BN, KG>::THREADS == 256
                                      ? 2 : 384 / Tiles<BM, BN, KG>::THREADS)
bmm_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ cm,
           const float* __restrict__ rm, T* __restrict__ y, float* __restrict__ ws, int M, int K,
           int N, int per, int vec, int splits) {
  using Tl = Tiles<BM, BN, KG>;
  constexpr int THREADS = Tl::THREADS, DEPTH = Tl::DEPTH, STAGES = Tl::STAGES, TX = BN / 8;
  __shared__ __align__(16) Tl sm;
  const int tid = threadIdx.x, g = tid / Tl::GROUP, gt = tid % Tl::GROUP;
  const int tx = gt % TX, ty = gt / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int client = blockIdx.z / splits, slice = blockIdx.z - client * splits;
  // The client's operands. Read transposed (dx), its first row of x and y, seen as (C*M, K) and
  // (C*M, N), and of w, seen as (C*N, K): row offsets, because advanced pointers held 64-bit
  // registers through the main loop and spilled the 128x128 dx tile at its 128-register cap. The
  // forward advances the three pointers once instead: row offsets through its w loads cost the
  // one-client forward 2-8% (tools/matmul_ab.py), advanced pointers nothing.
  const int xr = TRANS_B ? client * M : 0, wr = TRANS_B ? client * N : 0;
  if constexpr (!TRANS_B) {
    x += (int64_t)client * M * K;
    w += (int64_t)client * K * N;
    y += (int64_t)client * M * N;
  }
  const int steps = (K + DEPTH - 1) / DEPTH;
  const int s_begin = slice * per, s_end = min(s_begin + per, steps);

  int live = 0;
  for (int i = tid; i < BN; i += THREADS) {
    const int n = n0 + i;
    const float c = n < N ? (cm ? cm[n] : 1.f) : 0.f;
    sm.cm[i] = c;
    live |= c != 0.f;
  }
  const bool nlive = __syncthreads_or(live);
  const bool masked = cm || rm;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nlive) {
    int next = next_live<DEPTH>(rm, s_begin, s_end, K);  // the next step to load
    int loaded[STAGES];                                   // the step each stage holds
    auto load = [&](int stage, int s) {
      load_kmajor<T, BM, DEPTH, THREADS, BM + PAD>(sm.a[stage], x, xr + m0, xr + M, s * DEPTH, K,
                                                   tid);
      if constexpr (TRANS_B) {
        load_kmajor<T, BN, DEPTH, THREADS, BN + PAD>(sm.b[stage], w, wr + n0, wr + N, s * DEPTH, K,
                                                     tid);
      } else {
        load_nmajor<T, BN, DEPTH, THREADS, BN + PAD>(sm.b[stage], w, wr + s * DEPTH, wr + K, n0, N,
                                                     vec, tid);
      }
      loaded[stage] = s;
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      loaded[st] = -1;
      if (next < s_end) {
        load(st, next);
        next = next_live<DEPTH>(rm, next + 1, s_end, K);
      }
      cp_commit();  // empty groups keep the wait counts uniform
    }
    loaded[STAGES - 1] = -1;
    for (int it = 0;; ++it) {
      const int cur = it % STAGES;
      cp_wait<STAGES - 2>();
      __syncthreads();  // stage cur has landed; stage (it - 1) % STAGES is free
      if (loaded[cur] < 0) break;
      {
        const int ld = (it + STAGES - 1) % STAGES;
        loaded[ld] = -1;
        if (next < s_end) {
          load(ld, next);
          next = next_live<DEPTH>(rm, next + 1, s_end, K);
        }
        cp_commit();
      }
      if (masked) {  // fine masks on w as loaded: (w * col) * row
        const int k0 = loaded[cur] * DEPTH;
        for (int i = tid; i < DEPTH * BN; i += THREADS) {
          const int kl = i / BN, nl = i % BN, k = k0 + kl;
          float v = sm.b[cur][kl][nl] * sm.cm[nl];
          if (rm) v *= k < K ? rm[k] : 0.f;
          sm.b[cur][kl][nl] = v;
        }
        __syncthreads();
      }
#pragma unroll
      for (int kk = g * BK; kk < g * BK + BK; ++kk) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[cur][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[cur][kk][BM / 2 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[cur][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[cur][kk][BN / 2 + tx * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  if constexpr (KG > 1) {  // group 0 adds groups 1, 2, ... in order, through the stage memory
    cp_wait<0>();
    float* red = &sm.a[0][0][0];
    static_assert(sizeof(sm.a) >= sizeof(float) * BM * BN, "no room to sum the groups");
    for (int g2 = 1; g2 < KG; ++g2) {
      __syncthreads();
      if (g == g2) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) red[(ty * 8 + i) * BN + tx * 8 + j] = acc[i][j];
      }
      __syncthreads();
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += red[(ty * 8 + i) * BN + tx * 8 + j];
      }
    }
    if (g != 0) return;
  }

  const bool split = splits > 1;
  float* wsz = split ? ws + (int64_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      if (n >= N) continue;
      const float* v = &acc[i][4 * h];
      if ((split || std::is_same<T, float>::value) && N % 4 == 0) {  // 16-byte aligned rows
        float* dst = split ? wsz + (int64_t)m * N + n
                           : reinterpret_cast<float*>(y + (int64_t)(xr + m) * N + n);
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j >= N) break;
          if (split) {
            wsz[(int64_t)m * N + n + j] = v[j];
          } else {
            y[(int64_t)(xr + m) * N + n + j] = from_f<T>(v[j]);
          }
        }
      }
    }
  }
}

// y[c] = sum over the slices of ws[c] (clients, splits, n), in slice order; grid y is the client
template <typename T>
__global__ void splitk_sum_kernel(const float* __restrict__ ws, T* __restrict__ y, int64_t n,
                                  int splits) {
  const float* wc = ws + (int64_t)blockIdx.y * splits * n;
  T* yc = y + (int64_t)blockIdx.y * n;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = wc[i];
    for (int z = 1; z < splits; ++z) s += wc[(int64_t)z * n + i];
    yc[i] = from_f<T>(s);
  }
}

template <typename T, int BM, int BN, int KG>
int launch(const void* x, const void* w, const float* cm, const float* rm, void* y, float* ws,
           int C, int M, int K, int N, int trans_b, int splits, int per, int vec, cudaStream_t s) {
  using Tl = Tiles<BM, BN, KG>;
  const int64_t steps = (K + Tl::DEPTH - 1) / Tl::DEPTH;
  if (C < 1 || splits < 1 || per < 1 || (int64_t)C * splits > 65535 ||
      (int64_t)splits * per < steps || (splits > 1 && !ws) ||
      (splits > 1 && (int64_t)(splits - 1) * per >= steps))  // a slice would be empty
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, C * splits);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (trans_b) {
    bmm_kernel<T, BM, BN, KG, true><<<grid, Tl::THREADS, 0, s>>>(xt, wt, cm, rm, yt, ws, M, K, N,
                                                                 per, vec, splits);
  } else {
    bmm_kernel<T, BM, BN, KG, false><<<grid, Tl::THREADS, 0, s>>>(xt, wt, cm, rm, yt, ws, M, K, N,
                                                                  per, vec, splits);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t n = (int64_t)M * N;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  splitk_sum_kernel<T><<<dim3(blocks, C), 256, 0, s>>>(ws, yt, n, splits);
  return static_cast<int>(cudaGetLastError());
}

// the tiles ops.py:plan chooses from; 64x64 runs four K groups (ops.py:KGROUPS)
template <typename T>
int launch_tile(int bm, int bn, const void* x, const void* w, const float* cm, const float* rm,
                void* y, float* ws, int C, int M, int K, int N, int trans_b, int splits, int per,
                int vec, cudaStream_t s) {
#define BMM_TILE(BM_, BN_, KG_)                                                                 \
  if (bm == BM_ && bn == BN_)                                                                 \
    return launch<T, BM_, BN_, KG_>(x, w, cm, rm, y, ws, C, M, K, N, trans_b, splits, per, vec, s);
  BMM_TILE(128, 128, 1)
  BMM_TILE(128, 64, 1)
  BMM_TILE(64, 128, 1)
  BMM_TILE(64, 64, 4)
#undef BMM_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C clients (C * splits <= 65535, C * max(M, K, N) < 2^31); bm x bn blocks (128 or 64 each); splits > 1 needs ws of
// C * splits * M * N floats; per: k steps per slice (of 8 rows, 32 for the 64x64 tile), with every
// slice non-empty; vec: 16-byte copies of w (every client's rows 16-byte aligned)
extern "C" int bmm_launch(const void* x, const void* w, const void* cm, const void* rm, void* y,
                          void* ws, int C, int M, int K, int N, int bf16, int trans_b, int bm,
                          int bn, int splits, int per, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cm);
  const float* r = static_cast<const float*>(rm);
  float* wsf = static_cast<float*>(ws);
  return bf16 ? launch_tile<__nv_bfloat16>(bm, bn, x, w, c, r, y, wsf, C, M, K, N, trans_b,
                                           splits, per, vec, s)
              : launch_tile<float>(bm, bn, x, w, c, r, y, wsf, C, M, K, N, trans_b, splits, per,
                                   vec, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
