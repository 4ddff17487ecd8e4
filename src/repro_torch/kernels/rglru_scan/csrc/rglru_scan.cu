// Linear recurrence h_t = a_t * h_{t-1} + b_t, h_{-1} = 0, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rglru_scan/rglru_scan.py:rglru_scan. a, b and h are (B, S,
// W) row-major, float32 or bfloat16 (one type for all); the state is float32 and h has a's type.
// Each step is a multiply and then an add, each rounded on its own (__fmul_rn, __fadd_rn: never a
// fused multiply-add), as the TPU kernel's `a[t] * h + b[t]` and the plain PyTorch version compute
// it, so every kernel here gives the plain version's output bit for bit. Any S and W: unlike the
// TPU kernel, no block length has to divide S.
//
// Bound on the H100: bytes. Each element of a and b is read once and each of h written once, for
// one multiply-add: 3*B*S*W*itemsize bytes over 3.35 TB/s, 0.120 ms at the prefill shape (2, 4096,
// 4096) in fp32. The recurrence is sequential in t and independent across (b, w), so one thread
// owns one channel and keeps its state in a register, and the TPU's sequential grid over sequence
// blocks becomes that thread's loop over t. The dependent chain is cheap (4096 steps x ~8 cycles,
// ~20 us); what costs is keeping enough bytes in flight to run at the memory's rate. Two kernels,
// chosen by the wrapper (ops.py:variant):
//
// 1. TMA-fed pipeline (rows of W * itemsize a multiple of 16 bytes, as TMA's strides must be; the
//    LM's W = 4096). A block is one warp owning 32 neighbouring channels of one batch row: 256
//    blocks at the prefill shape, about 2 an SM. Lane 0 keeps a ring of STAGES = 4 stages in
//    shared memory filled by TMA loads of (32 channels x TS steps) boxes of a and b (3-D maps over
//    (W, S, B): ragged S and W edges read as zeros), TS = 32 fp32 or 64 bf16 steps, so a stage is 8
//    KB and 32 KB a block is in flight (Little's law at 3.35 TB/s asks for ~26 KB an SM). Each lane
//    copies its column of stage i into registers, the warp syncs, lane 0 refills stage i with the
//    chunk STAGES ahead, and only then does the chain run: stages i+1 .. i+3 load while stage i is
//    computed. h leaves by coalesced per-step stores (one 128-byte fp32 row a step across the
//    warp). A TMA store of each finished stage measured the same at the prefill shape in fp32 on
//    an H100 at 700 W (PERF.md), so the simpler stores stay.
// 2. SIMT (rows TMA cannot address, e.g. bf16 W = 300): one thread per channel in blocks of 64,
//    loading U = 32 steps of a and b ahead of each dependent chain; the bytes in flight, not the
//    bandwidth, set its time (0.444 ms at the prefill shape, 3.7x the bound, on an H100 at 700 W).
//
// The backward (no TPU kernel has one: the reference differentiates its associative scan, and its
// Pallas scan is forward only). For the output gradient g it is the same recurrence run in reverse:
// delta_t = g_t + a_{t+1} * delta_{t+1} with delta_S = 0 (a multiply and then an add, each rounded
// on its own), db_t = delta_t and da_t = delta_t * h_{t-1} with h_{-1} = 0, h being the forward's
// output. One launch reads g, a and h once each and writes da and db: five (B, S, W) streams,
// 5*B*S*W*itemsize bytes, 0.100 ms over 3.35 TB/s at the LM training shape (1, 4096, 4096) in fp32.
// It keeps the forward's layout and walks S downwards: a_{t+1} stays in a register from the step
// before, and h_{t-1} at a chunk's first step is one extra coalesced row load. The same two kernels:
// 3. TMA-fed (rows TMA can address): three streams of (32 channels x TS steps) boxes, the chunks in
//    descending order, in a ring of BSTAGES = 3 stages (36 KB a block, under the 48 KB of static
//    shared memory); da and db leave by coalesced per-step stores.
// 4. SIMT (any W): U = 32 steps of g, a and h loaded ahead of each descending chain.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "../../common/csrc/tma.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ------------------------------------------------------------------------------------------------
// kernel 1: TMA-fed pipeline
// ------------------------------------------------------------------------------------------------
namespace tma {

constexpr int CH = 32, STAGES = 4;

// TS, the steps of a stage: a stage of a and b is 8 KB in either type
template <typename T>
__host__ __device__ constexpr int steps() { return 128 / sizeof(T); }

template <typename T>
struct Smem {
  alignas(128) T a[STAGES][steps<T>() * CH];
  alignas(128) T b[STAGES][steps<T>() * CH];
  uint64_t full[STAGES];
};

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(CH)
rglru_scan_tma(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
               T* __restrict__ h, int S, int W) {
  constexpr int TS = steps<T>();
  constexpr uint32_t STAGE_BYTES = 2 * TS * CH * sizeof(T);
  __shared__ Smem<T> sm;
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * CH, row = blockIdx.y;
  const int chunks = (S + TS - 1) / TS;
  auto load = [&](int c) {  // chunk c into its stage; lane 0 only
    const int st = c % STAGES;
    mbar_expect_tx(&sm.full[st], STAGE_BYTES);
    tma_load_3d(sm.a[st], &ma, &sm.full[st], w0, c * TS, row);
    tma_load_3d(sm.b[st], &mb, &sm.full[st], w0, c * TS, row);
  };
  if (lane == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(&sm.full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_smem();
    for (int c = 0; c < STAGES && c < chunks; ++c) load(c);
  }
  __syncwarp();

  const int w = w0 + lane;
  T* hp = h + (int64_t)row * S * W + w;
  float state = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int st = c % STAGES;
    mbar_wait(&sm.full[st], (c / STAGES) & 1);
    float av[TS], bv[TS];
#pragma unroll
    for (int u = 0; u < TS; ++u) {
      av[u] = to_f(sm.a[st][u * CH + lane]);
      bv[u] = to_f(sm.b[st][u * CH + lane]);
    }
    __syncwarp();  // every lane has read stage st
    if (lane == 0 && c + STAGES < chunks) {
      fence_async_smem();  // the generic-proxy reads before the async-proxy refill
      load(c + STAGES);
    }
    const int t0 = c * TS, n = min(TS, S - t0);
    if (w >= W) continue;
    if (n == TS) {
#pragma unroll
      for (int u = 0; u < TS; ++u) {
        state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
        hp[(int64_t)(t0 + u) * W] = from_f<T>(state);
      }
    } else {
      for (int u = 0; u < n; ++u) {
        state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
        hp[(int64_t)(t0 + u) * W] = from_f<T>(state);
      }
    }
  }
}

// (W, S, B) with boxes of (32, TS, 1), no swizzle; out-of-bounds reads are zeros
template <typename T>
bool make_map(CUtensorMap* map, const void* base, int B, int S, int W) {
  EncodeTiled enc = encode_fn();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * sizeof(T), (cuuint64_t)S * W * sizeof(T)};
  const cuuint32_t box[3] = {CH, (cuuint32_t)steps<T>(), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapDataType dt = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, dt, 3, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int W, cudaStream_t s) {
  if ((W * sizeof(T)) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  if (!make_map<T>(&ma, a, B, S, W) || !make_map<T>(&mb, b, B, S, W))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + CH - 1) / CH, B);
  rglru_scan_tma<T><<<grid, CH, 0, s>>>(ma, mb, static_cast<T*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}


// ---- backward ----------------------------------------------------------------------------------
constexpr int BSTAGES = 3;

template <typename T>
struct SmemBwd {
  alignas(128) T g[BSTAGES][steps<T>() * CH];
  alignas(128) T a[BSTAGES][steps<T>() * CH];
  alignas(128) T h[BSTAGES][steps<T>() * CH];
  uint64_t full[BSTAGES];
};

template <typename T>
__global__ void __launch_bounds__(CH)
rglru_scan_bwd_tma(const __grid_constant__ CUtensorMap mg, const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mh, const T* __restrict__ h,
                   T* __restrict__ da, T* __restrict__ db, int S, int W) {
  constexpr int TS = steps<T>();
  constexpr uint32_t STAGE_BYTES = 3 * TS * CH * sizeof(T);
  __shared__ SmemBwd<T> sm;
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * CH, row = blockIdx.y;
  const int chunks = (S + TS - 1) / TS;
  auto load = [&](int k) {  // the k-th chunk walked (chunk chunks-1-k) into its stage; lane 0 only
    const int st = k % BSTAGES, t0 = (chunks - 1 - k) * TS;
    mbar_expect_tx(&sm.full[st], STAGE_BYTES);
    tma_load_3d(sm.g[st], &mg, &sm.full[st], w0, t0, row);
    tma_load_3d(sm.a[st], &ma, &sm.full[st], w0, t0, row);
    tma_load_3d(sm.h[st], &mh, &sm.full[st], w0, t0, row);
  };
  if (lane == 0) {
    for (int st = 0; st < BSTAGES; ++st) mbar_init(&sm.full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_smem();
    for (int k = 0; k < BSTAGES && k < chunks; ++k) load(k);
  }
  __syncwarp();

  const int w = w0 + lane;
  const int64_t base = (int64_t)row * S * W + w;
  float delta = 0.f, a_next = 0.f;  // delta_{t+1} and a_{t+1}; both 0 past the last step
  for (int k = 0; k < chunks; ++k) {
    const int st = k % BSTAGES;
    mbar_wait(&sm.full[st], (k / BSTAGES) & 1);
    float gv[TS], av[TS], hv[TS];
#pragma unroll
    for (int u = 0; u < TS; ++u) {
      gv[u] = to_f(sm.g[st][u * CH + lane]);
      av[u] = to_f(sm.a[st][u * CH + lane]);
      hv[u] = to_f(sm.h[st][u * CH + lane]);
    }
    __syncwarp();  // every lane has read stage st
    if (lane == 0 && k + BSTAGES < chunks) {
      fence_async_smem();
      load(k + BSTAGES);
    }
    const int t0 = (chunks - 1 - k) * TS, n = min(TS, S - t0);
    if (w >= W) continue;
    auto step = [&](int u, float h_prev) {  // step t0 + u, h_prev = h_{t0+u-1}
      delta = __fadd_rn(__fmul_rn(a_next, delta), gv[u]);
      const int64_t i = base + (int64_t)(t0 + u) * W;
      db[i] = from_f<T>(delta);
      da[i] = from_f<T>(__fmul_rn(delta, h_prev));
      a_next = av[u];
    };
    if (n == TS) {
#pragma unroll
      for (int u = TS - 1; u > 0; --u) step(u, hv[u - 1]);
    } else {
      for (int u = n - 1; u > 0; --u) step(u, hv[u - 1]);
    }
    step(0, t0 > 0 ? to_f(h[base + (int64_t)(t0 - 1) * W]) : 0.f);  // h_{t0-1}: the chunk below
  }
}

template <typename T>
int launch_bwd(const void* g, const void* a, const void* h, void* da, void* db, int B, int S, int W,
               cudaStream_t s) {
  if ((W * sizeof(T)) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mg, ma, mh;
  if (!make_map<T>(&mg, g, B, S, W) || !make_map<T>(&ma, a, B, S, W) ||
      !make_map<T>(&mh, h, B, S, W))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + CH - 1) / CH, B);
  rglru_scan_bwd_tma<T><<<grid, CH, 0, s>>>(mg, ma, mh, static_cast<const T*>(h),
                                            static_cast<T*>(da), static_cast<T*>(db), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tma

// ------------------------------------------------------------------------------------------------
// kernel 2: SIMT, any W
// ------------------------------------------------------------------------------------------------
namespace simt {

constexpr int THREADS = 64, U = 32;

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

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int W, cudaStream_t s) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(a),
                                                static_cast<const T*>(b), static_cast<T*>(h), S,
                                                W);
  return static_cast<int>(cudaGetLastError());
}


// ---- backward ----------------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_bwd_kernel(const T* __restrict__ g, const T* __restrict__ a, const T* __restrict__ h,
                      T* __restrict__ da, T* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int64_t base = (int64_t)blockIdx.y * S * W + w;
  const T* gp = g + base;
  const T* ap = a + base;
  const T* hp = h + base;
  T* dap = da + base;
  T* dbp = db + base;
  float delta = 0.f, a_next = 0.f;  // delta_{t+1} and a_{t+1}; both 0 past the last step
  // step t: h_prev = h_{t-1}, 0 at t = 0
  auto h_prev = [&](int t) { return t > 0 ? to_f(hp[(int64_t)(t - 1) * W]) : 0.f; };
  auto step = [&](int t, float gt, float at, float hm) {
    delta = __fadd_rn(__fmul_rn(a_next, delta), gt);
    dbp[(int64_t)t * W] = from_f<T>(delta);
    dap[(int64_t)t * W] = from_f<T>(__fmul_rn(delta, hm));
    a_next = at;
  };
  int t = S;  // steps [0, t) remain; the ragged top S % U first, one by one
  for (; t % U != 0; --t)
    step(t - 1, to_f(gp[(int64_t)(t - 1) * W]), to_f(ap[(int64_t)(t - 1) * W]), h_prev(t - 1));
  for (; t > 0; t -= U) {
    const int t0 = t - U;
    float gv[U], av[U], hv[U];  // hv[u] = h_{t0+u-1}
#pragma unroll
    for (int u = 0; u < U; ++u) {
      gv[u] = to_f(gp[(int64_t)(t0 + u) * W]);
      av[u] = to_f(ap[(int64_t)(t0 + u) * W]);
      hv[u] = h_prev(t0 + u);
    }
#pragma unroll
    for (int u = U - 1; u >= 0; --u) step(t0 + u, gv[u], av[u], hv[u]);
  }
}

template <typename T>
int launch_bwd(const void* g, const void* a, const void* h, void* da, void* db, int B, int S, int W,
               cudaStream_t s) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_bwd_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<T*>(da), static_cast<T*>(db), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

}  // namespace

// kernel: 0 = SIMT (any W), 1 = TMA pipeline (W * itemsize % 16 == 0 and 16-byte aligned bases)
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h, int B, int S, int W,
                                 int bf16, int kernel, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535 || kernel < 0 || kernel > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) {
    return bf16 ? simt::launch<__nv_bfloat16>(a, b, h, B, S, W, s)
                : simt::launch<float>(a, b, h, B, S, W, s);
  }
  return bf16 ? tma::launch<__nv_bfloat16>(a, b, h, B, S, W, s)
              : tma::launch<float>(a, b, h, B, S, W, s);
}

// The backward: g, a and h (the forward's output) in; da and db out. kernel as above.
extern "C" int rglru_scan_bwd_launch(const void* g, const void* a, const void* h, void* da, void* db,
                                     int B, int S, int W, int bf16, int kernel, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535 || kernel < 0 || kernel > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) {
    return bf16 ? simt::launch_bwd<__nv_bfloat16>(g, a, h, da, db, B, S, W, s)
                : simt::launch_bwd<float>(g, a, h, da, db, B, S, W, s);
  }
  return bf16 ? tma::launch_bwd<__nv_bfloat16>(g, a, h, da, db, B, S, W, s)
              : tma::launch_bwd<float>(g, a, h, da, db, B, S, W, s);
}
