// Streaming-softmax (flash) attention for Hopper (sm_90a), one head per batch row.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py:flash_attention_bhsd.
// q (BH, Sq, hd), k and v (BH, Skv, hd), row-major, float32 or bfloat16, any hd in 1..256 (144 after
// pruning); o (BH, Sq, hd) in q's type. Scores are scaled by hd^-0.5; causal and sliding-window masks
// set scores to -1e30 as the TPU kernel does; m, l and the output accumulator are fp32 and the
// denominator is clamped at 1e-30. Key tiles that no query of a block can reach under causal/window
// are never loaded, as pl.when skips them. Two kernels, chosen by the wrapper (ops.py:variant):
//
// 1. bf16 with hd % 8 == 0 (the LM prefill: BH 32, S 4096, hd 256, causal, window 2048): tensor cores.
//    Bound: 4 * pairs * hd FLOPs over 4 * S * hd * 2 bytes puts it deep in compute (~1000 FLOP/byte at
//    the prefill shape), so the limit is how fast the products reach wgmma. A block is two consumer
//    warpgroups, 64 query rows each (BQ = 128). Q is loaded once by TMA; K and V tiles of BKV = 64
//    keys arrive by TMA (cp.async.bulk.tensor, 3-D maps over (hd, S, BH) so each head's ragged S edge
//    is zero-filled) into a ring of two stages, each completed on its own mbarrier, so tile j + 1 loads
//    while tile j is multiplied. hd is cut into 64-column chunks of 128-byte rows with the 128-byte
//    swizzle that the wgmma descriptors read; columns past hd (hd = 144: 192 loaded) are TMA's
//    out-of-bounds zeros, never a copy. S = Q K^T is m64n64k16 wgmma from shared memory (K-major
//    both); P is rounded to bf16 in registers (its accumulator layout is the A-fragment layout) and
//    O += P V is register-A wgmma with V read in its row-major (BKV, hd) layout through the
//    transposed-B (MN-major) descriptor. l sums the fp32 P. Registers per thread: O is NC x 32
//    fp32 (128 at hd = 256), S 32, P 16; -Xptxas=-v reports 198 at hd = 256 (102 at hd <= 64), no
//    spills, so no producer warp or setmaxnreg: thread 0 issues the TMA loads and the two
//    warpgroups, 64 rows each, both compute. TMA needs 16-byte row strides, so bf16 with
//    hd % 8 != 0 (hd = 100: 200-byte rows) takes kernel 2 instead.
// 2. fp32 (training, U-Net serving, lm_consistency), and bf16 that kernel 1 cannot take: register-tiled
//    SIMT on IEEE fp32 FMAs, no TF32 (the port's numerics). Bound at the training shape (32, 256, 256,
//    256) is the fp32 FMA rate (67 TFLOP/s). A block of 128 threads owns BQ = 64 query rows; K and V
//    tiles of BKV = 32 keys are double-buffered with cp.async (16-byte copies when hd % 4 == 0, zero
//    fill past S). Each thread owns a 4x4 micro-tile of S (rows tq + 16i, keys tk + 8j: each 16-byte
//    load of Q and K feeds 16 FMAs) and a 4 x 4*NCH micro-tile of O on the same rows, so the softmax
//    row state is shared; P goes through shared memory between the two products. Shared memory at
//    hd = 256: Q 66.5 KB + two stages of K and V 133 KB + P 8.7 KB = 208 KB of 227. Registers
//    (-Xptxas=-v): 244 at hd = 256 (fp32), 96-226 below; no fp32 spills (bf16 at 161-192 spills
//    60 bytes).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "../../common/csrc/tma.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The key-tile range [t_begin, t_end) that some query of [q0, q0 + bq) can reach.
__device__ __forceinline__ void tile_range(int q0, int bq, int Sq, int Skv, int causal, int window,
                                           int bkv, int& t_begin, int& t_end) {
  const int q_last = min(q0 + bq, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  t_begin = k_lo / bkv;
  t_end = (k_hi + bkv - 1) / bkv;
}

// a score in log2 units, or NEG where masked, or -inf past the keys (no weight at all)
__device__ __forceinline__ float masked_score(float s, int qpos, int kpos, int Skv, int causal,
                                              int window, float scale_log2) {
  if (kpos >= Skv) return -INFINITY;
  const bool ok = (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
  return ok ? s * scale_log2 : NEG;
}

// ------------------------------------------------------------------------------------------------
// kernel 2: register-tiled SIMT
// ------------------------------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64, BKV = 32, THREADS = 128;

__host__ __device__ constexpr int ld(int nch) { return nch * 32 + 4; }
__host__ __device__ constexpr int smem_floats(int nch) {
  return (BQ + 4 * BKV) * ld(nch) + BKV * (BQ + 4);
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

// rows [r0, r0 + rows) of a (S, hd) matrix into dst[r][0..hd), zeros past S
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ldd, const T* src, int r0, int rows,
                                          int S, int hd, bool vec, int tid) {
  if (std::is_same<T, float>::value && vec) {
    const int cpr = hd / 4;
    for (int i = tid; i < rows * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 4;
      const bool ok = r0 + r < S;
      cp16(dst + r * ldd + c,
           reinterpret_cast<const float*>(ok ? src + (int64_t)(r0 + r) * hd + c : src), ok);
    }
  } else {
    for (int i = tid; i < rows * hd; i += THREADS) {
      const int r = i / hd, c = i % hd;
      const bool ok = r0 + r < S;
      const T* p = ok ? src + (int64_t)(r0 + r) * hd + c : src;
      if constexpr (std::is_same<T, float>::value) {
        cp4(dst + r * ldd + c, p, ok);
      } else {
        dst[r * ldd + c] = ok ? to_f(*p) : 0.f;
      }
    }
  }
}

template <typename T, int NCH>
__global__ void __launch_bounds__(THREADS)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int Sq, int Skv, int hd, int causal, int window,
                  float scale_log2, int vec) {
  constexpr int LD = ld(NCH), PLD = BQ + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [BQ][LD]
  float* ks = qs + BQ * LD;               // [2][BKV][LD]
  float* vs = ks + 2 * BKV * LD;          // [2][BKV][LD]
  float* ps = vs + 2 * BKV * LD;          // [BKV][PLD]: P transposed
  const int tid = threadIdx.x, tq = tid / 8, tk = tid % 8;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const T* qb = q + (int64_t)bh * Sq * hd;
  const T* kb = k + (int64_t)bh * Skv * hd;
  const T* vb = v + (int64_t)bh * Skv * hd;

  // the columns [hd, 32 NCH) that the products read stay zero
  for (int i = tid; i < (BQ + 4 * BKV) * (NCH * 32 - hd); i += THREADS) {
    const int r = i / (NCH * 32 - hd), c = hd + i % (NCH * 32 - hd);
    smem[r * LD + c] = 0.f;
  }
  int t_begin, t_end;
  tile_range(q0, BQ, Sq, Skv, causal, window, BKV, t_begin, t_end);
  load_rows<T>(qs, LD, qb, q0, BQ, Sq, hd, vec, tid);
  if (t_begin < t_end) {
    load_rows<T>(ks, LD, kb, t_begin * BKV, BKV, Skv, hd, vec, tid);
    load_rows<T>(vs, LD, vb, t_begin * BKV, BKV, Skv, hd, vec, tid);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  float acc[4][NCH][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {  // the other stage was freed by the last iteration's final barrier
      load_rows<T>(ks + (st ^ 1) * BKV * LD, LD, kb, (t + 1) * BKV, BKV, Skv, hd, vec, tid);
      load_rows<T>(vs + (st ^ 1) * BKV * LD, LD, vb, (t + 1) * BKV, BKV, Skv, hd, vec, tid);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* kt = ks + st * BKV * LD;
    const float* vt = vs + st * BKV * LD;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < NCH * 32; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (tq + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(kt + (tk + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tq + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(s[i][j], qpos, t * BKV + tk + 8 * j, Skv, causal, window,
                               scale_log2);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mx);
        sum += p;
        ps[(tk + 8 * j) * PLD + tq + 16 * i] = p;
      }
      l[i] = l[i] * alpha + sum;  // this thread's keys; the row's 8 threads are summed at the end
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BKV; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[kk * PLD + tq + 16 * i];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(vt + kk * LD + c * 32 + tk * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(p[i], b.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p[i], b.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(p[i], b.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(p[i], b.w, acc[i][c][3]);
        }
      }
    }
    __syncthreads();  // stage st and ps are free
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int qpos = q0 + tq + 16 * i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    T* orow = o + ((int64_t)bh * Sq + qpos) * hd;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = c * 32 + tk * 4;
      if (std::is_same<T, float>::value && vec && col < hd) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv, acc[i][c][2] * inv,
                        acc[i][c][3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < hd) orow[col + e] = from_f<T>(acc[i][c][e] * inv);
      }
    }
  }
}

template <typename T, int NCH>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv, int hd,
           int causal, int window, int vec, cudaStream_t s) {
  constexpr size_t smem = sizeof(float) * smem_floats(NCH);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_simt_kernel<T, NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_simt_kernel<T, NCH><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, hd, causal, window, LOG2E / sqrtf((float)hd), vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv, int hd,
             int causal, int window, int vec, cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, BH, Sq, Skv, hd, causal, window, vec, s);
    case 2: return launch<T, 2>(q, k, v, o, BH, Sq, Skv, hd, causal, window, vec, s);
    case 3: return launch<T, 3>(q, k, v, o, BH, Sq, Skv, hd, causal, window, vec, s);
    case 4: return launch<T, 4>(q, k, v, o, BH, Sq, Skv, hd, causal, window, vec, s);
    case 5: return launch<T, 5>(q, k, v, o, BH, Sq, Skv, hd, causal, window, vec, s);
    case 6: return launch<T, 6>(q, k, v, o, BH, Sq, Skv, hd, causal, window, vec, s);
    case 7: return launch<T, 7>(q, k, v, o, BH, Sq, Skv, hd, causal, window, vec, s);
    case 8: return launch<T, 8>(q, k, v, o, BH, Sq, Skv, hd, causal, window, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt

// ------------------------------------------------------------------------------------------------
// kernel 1: bf16 on wgmma, fed by TMA
// ------------------------------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128, BKV = 64, THREADS = 256, CHUNK = 64;  // CHUNK bf16 = one 128-byte row
using bf16 = __nv_bfloat16;

template <int NC>
struct Smem {  // every tile 1024-byte aligned, as the 128-byte swizzle needs
  bf16 q[NC][BQ * CHUNK];
  bf16 k[2][NC][BKV * CHUNK];
  bf16 v[2][NC][BKV * CHUNK];
  uint64_t full_q, full[2];
};

// wgmma shared-memory descriptor, 128-byte swizzle: 8-row groups 1024 bytes apart (the only stride
// these tiles use: K-major operands are one 64-column chunk wide, V's MN extent is one chunk)
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

#define WG_D "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
             "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT(d)                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, fp32) (+)= A (64 x 16, K-major, smem) . B (16 x 64, K-major, smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 64, fp32) += A (64 x 16, bf16 registers) . B (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int NC>
constexpr size_t smem_bytes() { return sizeof(Smem<NC>) + 1024; }

template <int NC>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int Sq, int Skv,
                int hd, int causal, int window, float scale_log2) {
  extern __shared__ uint8_t raw[];
  const uint32_t base = smem_u32(raw);
  Smem<NC>& sm = *reinterpret_cast<Smem<NC>*>(raw + ((1024 - (base & 1023)) & 1023));
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  int t_begin, t_end;
  tile_range(q0, BQ, Sq, Skv, causal, window, BKV, t_begin, t_end);
  constexpr uint32_t KV_BYTES = 2 * NC * BKV * CHUNK * sizeof(bf16);

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto load_kv = [&sm, mk, mv, bh](int t, int st) {
    mbar_expect_tx(&sm.full[st], KV_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load_3d(sm.k[st][c], mk, &sm.full[st], c * CHUNK, t * BKV, bh);
      tma_load_3d(sm.v[st][c], mv, &sm.full[st], c * CHUNK, t * BKV, bh);
    }
  };
  if (tid == 0) {
    mbar_init(&sm.full_q, 1);
    mbar_init(&sm.full[0], 1);
    mbar_init(&sm.full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&sm.full_q, NC * BQ * CHUNK * sizeof(bf16));
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_load_3d(sm.q[c], &tq, &sm.full_q, c * CHUNK, q0, bh);
    if (t_begin < t_end) load_kv(t_begin, 0);
    if (t_begin + 1 < t_end) load_kv(t_begin + 1, 1);
  }
  __syncthreads();

  // accumulator layout of m64n64: register 4j + e holds row r0 (e < 2) or r0 + 8 (e >= 2) and
  // column 8j + 2 (lane % 4) + (e % 2), with r0 = 16 warp + lane / 4 in this warpgroup's 64 rows
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  const int qpos[2] = {q0 + wg * 64 + r0, q0 + wg * 64 + r0 + 8};
  float acc[NC][32], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;

  mbar_wait(&sm.full_q, 0);
  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin, st = it & 1;
    mbar_wait(&sm.full[st], (it >> 1) & 1);

    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk)
        wgmma_ss(s, desc(&sm.q[c][wg * 64 * CHUNK + kk * 16]), desc(&sm.k[st][c][kk * 16]),
                 c + kk > 0);
    wg_commit();
    wg_wait0();

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        s[4 * j + e] = masked_score(s[4 * j + e], qpos[h], t * BKV + 8 * j + c0 + e % 2, Skv,
                                    causal, window, scale_log2);
        mx[h] = fmaxf(mx[h], s[4 * j + e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    uint32_t p[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = exp2f(s[4 * j + e] - m[e / 2]);
        l[e / 2] += pe[e];  // l sums the fp32 P; P V takes P rounded to bf16
      }
      p[2 * j] = pack_bf16(pe[0], pe[1]);
      p[2 * j + 1] = pack_bf16(pe[2], pe[3]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e / 2) % 2];

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_rs(acc[c], &p[4 * kk], desc(&sm.v[st][c][kk * 16 * CHUNK]));
    wg_commit();
    wg_wait0();
    __syncthreads();  // both warpgroups are done with stage st
    if (tid == 0 && t + 2 < t_end) load_kv(t + 2, st);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c * CHUNK + 8 * j + c0;
        if (qpos[h] >= Sq || col >= hd) continue;
        bf16* dst = o + ((int64_t)bh * Sq + qpos[h]) * hd + col;
        const float a = acc[c][4 * j + 2 * h] * l[h], b = acc[c][4 * j + 2 * h + 1] * l[h];
        if (col + 1 < hd) {  // hd % 8 == 0: col is even, the pair is 4-byte aligned
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
        } else {
          *dst = __float2bfloat16(a);
        }
      }
}

// (hd, S, BH) bf16, 128-byte swizzled boxes of (64, rows, 1); out-of-bounds reads are zeros
bool make_map(CUtensorMap* map, const void* base, int hd, int S, int BH, int rows) {
  EncodeTiled enc = encode_fn();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)S * hd * 2};
  const cuuint32_t box[3] = {CHUNK, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv, int hd,
           int causal, int window, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<NC>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, hd, Sq, BH, BQ) || !make_map(&mk, k, hd, Skv, BH, BKV) ||
      !make_map(&mv, v, hd, Skv, BH, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_tc_kernel<NC><<<grid, THREADS, smem_bytes<NC>(), s>>>(
      mq, mk, mv, static_cast<bf16*>(o), Sq, Skv, hd, causal, window, LOG2E / sqrtf((float)hd));
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv, int hd,
             int causal, int window, cudaStream_t s) {
  if (hd % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);  // TMA: 16-byte row strides
  switch ((hd + CHUNK - 1) / CHUNK) {
    case 1: return launch<1>(q, k, v, o, BH, Sq, Skv, hd, causal, window, s);
    case 2: return launch<2>(q, k, v, o, BH, Sq, Skv, hd, causal, window, s);
    case 3: return launch<3>(q, k, v, o, BH, Sq, Skv, hd, causal, window, s);
    case 4: return launch<4>(q, k, v, o, BH, Sq, Skv, hd, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// kernel: 0 = register-tiled SIMT (fp32 or bf16; vec = 16-byte copies, hd % 4 == 0 and aligned),
// 1 = bf16 wgmma/TMA (hd % 8 == 0, 16-byte aligned bases)
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int BH,
                                 int Sq, int Skv, int hd, int causal, int window, int bf16,
                                 int kernel, int vec, void* stream) {
  if (hd < 1 || hd > 256 || BH < 1 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 1) {
    if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
    return tc::dispatch(q, k, v, o, BH, Sq, Skv, hd, causal, window, s);
  }
  return bf16 ? simt::dispatch<__nv_bfloat16>(q, k, v, o, BH, Sq, Skv, hd, causal, window, vec, s)
              : simt::dispatch<float>(q, k, v, o, BH, Sq, Skv, hd, causal, window, vec, s);
}
