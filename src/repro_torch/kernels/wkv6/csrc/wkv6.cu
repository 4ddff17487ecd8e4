// RWKV-6's WKV recurrence and its backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference runs the recurrence as a lax.scan
// (repro/models/rwkv6.py:67 _wkv_scan) and differentiates that scan. For each batch row b and
// head h, with a (K, V) fp32 state S_{-1} given,
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T.
// r, k, w and v are (B, T, H, N) row-major fp32 (N = K = V, 32 or 64), u is (H, N), states are
// (B, H, N, N). Sums over k run in a fixed order in four interleaved partial sums (not the plain
// version's order: agreement is within fp32 rounding, not bitwise).
//
// Bound on the H100: at the prefill shape (2, 4096, 64, 64) a forward reads r, k, v and w once
// and writes out once (0.67 GB with the states, 0.20 ms at 3.35 TB/s) and does three multiply-
// adds a state element and step (12.9 GFLOP at 67 TFLOP/s, 0.19 ms): both bounds are near 0.2 ms,
// and the backward's (nine streams, six multiply-adds an element) near 0.3 ms. What costs instead
// is the recurrence: T = 4096 dependent steps per (b, h), and only B*H = 128 independent (b, h)
// on 132 SMs. The design keeps the step short and off device memory:
// - One block per (b, h), N threads; thread j owns column S[:, j] in registers for all T steps.
// - The per-token rows (r_t, k_t, w_t, v_t: N floats each) arrive in chunks of CH = 8 steps by
//   16-byte cp.async copies into a ring of NBUF = 3 chunks in shared memory: two chunks load while
//   one is computed, and the block synchronises once a chunk, not once a step.
// - Each step reads r, k, w and u as float4 broadcasts from shared memory and needs no
//   cross-thread sum: out[j] accumulates over k in the thread itself. out leaves by one coalesced
//   row store a step. S = 1 with the output state on the input state is the decode step, in place.
//
// The backward gives dr, dk, dv, dw, du (as per-(b, h) rows, summed over b by the caller) and the
// initial state's gradient from dout and d(new state), in three launches on the same stream:
// 1. wkv_bwd_dr, forward in time, thread i owning state row S[i, :]:
//      dr_t[i] = sum_j dout_t[j] S_{t-1}[i, j] + u_i k_t[i] (v_t . dout_t);
//    it writes S at each chunk's start (a checkpoint every CH steps, (B*H, ceil(T/CH), N, N)).
// 2. wkv_bwd_dkdw, in reverse, thread i owning the adjoint row G[i, :], G_{T-1} = d(new state),
//    G_{t-1} = diag(w_t) G_t + r_t dout_t^T:
//      dk_t[i] = sum_j G_t[i, j] v_t[j] + u_i r_t[i] (v_t . dout_t),
//      dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j],
//      du[i] += r_t[i] k_t[i] (v_t . dout_t),  and G_{-1} is the initial state's gradient.
//    S_{t-1} comes from replaying the chunk forward from its checkpoint into shared memory: w is
//    never divided by (it reaches exp(-exp(x)) and may underflow).
// 3. wkv_bwd_dv, in reverse, thread j owning the adjoint column G[:, j]:
//      dv_t[j] = sum_k G_t[k, j] k_t[k] + dout_t[j] (r_t . u . k_t).
// Each launch keeps one (b, h) a block and the forward's chunked staging. The checkpoints add
// 2 x B*H*T/CH*N^2*4 bytes (0.27 GB each way at (1, 4096, 64, 64)).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int CH = 8;     // steps a chunk (staging unit; the backward's checkpoint stride)
constexpr int NBUF = 3;   // chunks in the ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NBUF - 2));
}

// Rows t0 .. t0 + CH - 1 (those below T) of (b, h) in a (B, T, H, N) tensor into dst[CH][N].
template <int N>
__device__ __forceinline__ void stage(float* dst, const float* src, int b, int h, int H, int T,
                                      int t0) {
  constexpr int G = N / 4;  // 16-byte granules a row
  for (int i = threadIdx.x; i < CH * G; i += N) {
    const int row = i / G, col = i % G, t = t0 + row;
    if (t < T) cp16(dst + row * N + col * 4, src + ((size_t)(b * T + t) * H + h) * N + col * 4);
  }
}

__device__ __forceinline__ size_t row_of(int b, int t, int h, int H, int T) {
  return (size_t)(b * T + t) * H + h;
}

// The chunk a ring position holds: forward order, or reverse for the backward's reverse passes.
__device__ __forceinline__ int chunk_at(int n, int nc, bool rev) { return rev ? nc - 1 - n : n; }

// Stages NS streams of chunk (ring position) n into ring slot n % NBUF, then commits a group
// (empty past the last chunk, so every iteration commits one).
template <int N, int NS>
__device__ __forceinline__ void stage_chunk(float (*ring)[NS][CH][N], const float* const* srcs,
                                            int n, int nc, bool rev, int b, int h, int H, int T) {
  if (n < nc) {
    const int t0 = chunk_at(n, nc, rev) * CH;
#pragma unroll
    for (int s = 0; s < NS; ++s) stage<N>(&ring[n % NBUF][s][0][0], srcs[s], b, h, H, T, t0);
  }
  cp_commit();
}

// ------------------------------------------------------------------------------------------------
// forward
// ------------------------------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(N) wkv_fwd(const float* __restrict__ r,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const float* __restrict__ w,
                                             const float* __restrict__ u, const float* s_in,
                                             float* __restrict__ out, float* s_out, int T, int H) {
  __shared__ __align__(16) float ring[NBUF][4][CH][N];  // r, k, w, v
  __shared__ __align__(16) float us[N];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const int nc = (T + CH - 1) / CH;
  const float* srcs[4] = {r, k, w, v};
  us[j] = u[h * N + j];
  float s[N];
  const float* si = s_in + (size_t)bh * N * N;
#pragma unroll
  for (int q = 0; q < N; ++q) s[q] = si[q * N + j];
#pragma unroll
  for (int n = 0; n < NBUF - 1; ++n) stage_chunk<N, 4>(ring, srcs, n, nc, false, b, h, H, T);
  for (int n = 0; n < nc; ++n) {
    cp_wait_ring();
    __syncthreads();
    stage_chunk<N, 4>(ring, srcs, n + NBUF - 1, nc, false, b, h, H, T);
    const int t0 = n * CH, steps = min(CH, T - t0);
    const float(*c)[CH][N] = ring[n % NBUF];
    for (int tt = 0; tt < steps; ++tt) {
      const float vj = c[3][tt][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < N; q += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&c[0][tt][q]);
        const float4 k4 = *reinterpret_cast<const float4*>(&c[1][tt][q]);
        const float4 w4 = *reinterpret_cast<const float4*>(&c[2][tt][q]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[q]);
        float kv = k4.x * vj;
        a0 = fmaf(r4.x, fmaf(u4.x, kv, s[q]), a0);
        s[q] = fmaf(w4.x, s[q], kv);
        kv = k4.y * vj;
        a1 = fmaf(r4.y, fmaf(u4.y, kv, s[q + 1]), a1);
        s[q + 1] = fmaf(w4.y, s[q + 1], kv);
        kv = k4.z * vj;
        a2 = fmaf(r4.z, fmaf(u4.z, kv, s[q + 2]), a2);
        s[q + 2] = fmaf(w4.z, s[q + 2], kv);
        kv = k4.w * vj;
        a3 = fmaf(r4.w, fmaf(u4.w, kv, s[q + 3]), a3);
        s[q + 3] = fmaf(w4.w, s[q + 3], kv);
      }
      out[row_of(b, t0 + tt, h, H, T) * N + j] = (a0 + a1) + (a2 + a3);
    }
  }
  float* so = s_out + (size_t)bh * N * N;
#pragma unroll
  for (int q = 0; q < N; ++q) so[q * N + j] = s[q];
}

// ------------------------------------------------------------------------------------------------
// backward 1: dr and the checkpoints, forward in time, a state row a thread
// ------------------------------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(N) wkv_bwd_dr(const float* __restrict__ k,
                                                const float* __restrict__ v,
                                                const float* __restrict__ w,
                                                const float* __restrict__ u,
                                                const float* __restrict__ s_in,
                                                const float* __restrict__ dout,
                                                float* __restrict__ dr, float* __restrict__ ckpt,
                                                int T, int H) {
  __shared__ __align__(16) float ring[NBUF][4][CH][N];  // k, w, v, dout
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i = threadIdx.x;
  const int nc = (T + CH - 1) / CH;
  const float* srcs[4] = {k, w, v, dout};
  const float ui = u[h * N + i];
  float s[N];
  const float* si = s_in + ((size_t)bh * N + i) * N;
#pragma unroll
  for (int q = 0; q < N; q += 4) {
    const float4 x = *reinterpret_cast<const float4*>(si + q);
    s[q] = x.x, s[q + 1] = x.y, s[q + 2] = x.z, s[q + 3] = x.w;
  }
#pragma unroll
  for (int n = 0; n < NBUF - 1; ++n) stage_chunk<N, 4>(ring, srcs, n, nc, false, b, h, H, T);
  for (int n = 0; n < nc; ++n) {
    cp_wait_ring();
    __syncthreads();
    stage_chunk<N, 4>(ring, srcs, n + NBUF - 1, nc, false, b, h, H, T);
    float* ck = ckpt + (((size_t)bh * nc + n) * N + i) * N;  // S_{t0 - 1}, row i
#pragma unroll
    for (int q = 0; q < N; q += 4)
      *reinterpret_cast<float4*>(ck + q) = make_float4(s[q], s[q + 1], s[q + 2], s[q + 3]);
    const int t0 = n * CH, steps = min(CH, T - t0);
    const float(*c)[CH][N] = ring[n % NBUF];
    for (int tt = 0; tt < steps; ++tt) {
      const float ki = c[0][tt][i], wi = c[1][tt][i];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f, e3 = 0.f;
#pragma unroll
      for (int q = 0; q < N; q += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&c[2][tt][q]);
        const float4 d4 = *reinterpret_cast<const float4*>(&c[3][tt][q]);
        a0 = fmaf(d4.x, s[q], a0);
        a1 = fmaf(d4.y, s[q + 1], a1);
        a2 = fmaf(d4.z, s[q + 2], a2);
        a3 = fmaf(d4.w, s[q + 3], a3);
        e0 = fmaf(v4.x, d4.x, e0);
        e1 = fmaf(v4.y, d4.y, e1);
        e2 = fmaf(v4.z, d4.z, e2);
        e3 = fmaf(v4.w, d4.w, e3);
        s[q] = fmaf(wi, s[q], ki * v4.x);
        s[q + 1] = fmaf(wi, s[q + 1], ki * v4.y);
        s[q + 2] = fmaf(wi, s[q + 2], ki * v4.z);
        s[q + 3] = fmaf(wi, s[q + 3], ki * v4.w);
      }
      const float vd = (e0 + e1) + (e2 + e3);
      dr[row_of(b, t0 + tt, h, H, T) * N + i] = (a0 + a1) + (a2 + a3) + ui * ki * vd;
    }
  }
}

// ------------------------------------------------------------------------------------------------
// backward 2: dk, dw, du and the initial state's gradient, in reverse, an adjoint row a thread
// ------------------------------------------------------------------------------------------------
template <int N>
__host__ __device__ constexpr int dkdw_ring_floats() { return NBUF * 5 * CH * N; }
template <int N>
__host__ __device__ constexpr int dkdw_smem_bytes() {
  return (dkdw_ring_floats<N>() + CH * N * (N + 1)) * 4;
}

template <int N>
__global__ void __launch_bounds__(N) wkv_bwd_dkdw(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ dout,
    const float* __restrict__ dstate, const float* __restrict__ ckpt, float* __restrict__ dk,
    float* __restrict__ dw, float* __restrict__ du_rows, float* __restrict__ ds0, int T, int H) {
  extern __shared__ __align__(16) float dyn[];
  auto ring = reinterpret_cast<float(*)[5][CH][N]>(dyn);  // r, k, w, v, dout
  // the chunk's states S_{t-1}, a padded row a thread: rep[tt * N + i][j]
  float(*rep)[N + 1] = reinterpret_cast<float(*)[N + 1]>(dyn + dkdw_ring_floats<N>());
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i = threadIdx.x;
  const int nc = (T + CH - 1) / CH;
  const float* srcs[5] = {r, k, w, v, dout};
  const float ui = u[h * N + i];
  float g[N];
  const float* gi = dstate + ((size_t)bh * N + i) * N;
#pragma unroll
  for (int q = 0; q < N; q += 4) {
    const float4 x = *reinterpret_cast<const float4*>(gi + q);
    g[q] = x.x, g[q + 1] = x.y, g[q + 2] = x.z, g[q + 3] = x.w;
  }
  float du = 0.f;
#pragma unroll
  for (int n = 0; n < NBUF - 1; ++n) stage_chunk<N, 5>(ring, srcs, n, nc, true, b, h, H, T);
  for (int n = 0; n < nc; ++n) {
    cp_wait_ring();
    __syncthreads();
    stage_chunk<N, 5>(ring, srcs, n + NBUF - 1, nc, true, b, h, H, T);
    const int cidx = nc - 1 - n, t0 = cidx * CH, steps = min(CH, T - t0);
    const float(*c)[CH][N] = ring[n % NBUF];
    {  // replay the chunk from its checkpoint: rep[tt] = S_{t0 + tt - 1}, row i
      float s[N];
      const float* ck = ckpt + (((size_t)bh * nc + cidx) * N + i) * N;
#pragma unroll
      for (int q = 0; q < N; q += 4) {
        const float4 x = *reinterpret_cast<const float4*>(ck + q);
        s[q] = x.x, s[q + 1] = x.y, s[q + 2] = x.z, s[q + 3] = x.w;
      }
      for (int tt = 0; tt < steps; ++tt) {
        float* dst = rep[tt * N + i];
#pragma unroll
        for (int q = 0; q < N; ++q) dst[q] = s[q];
        const float ki = c[1][tt][i], wi = c[2][tt][i];
#pragma unroll
        for (int q = 0; q < N; ++q) s[q] = fmaf(wi, s[q], ki * c[3][tt][q]);
      }
    }
    for (int tt = steps - 1; tt >= 0; --tt) {
      const float ri = c[0][tt][i], ki = c[1][tt][i], wi = c[2][tt][i];
      const float* sp = rep[tt * N + i];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
      float e0 = 0.f, e1 = 0.f, e2 = 0.f, e3 = 0.f;
#pragma unroll
      for (int q = 0; q < N; q += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&c[3][tt][q]);
        const float4 d4 = *reinterpret_cast<const float4*>(&c[4][tt][q]);
        a0 = fmaf(g[q], v4.x, a0);
        a1 = fmaf(g[q + 1], v4.y, a1);
        a2 = fmaf(g[q + 2], v4.z, a2);
        a3 = fmaf(g[q + 3], v4.w, a3);
        b0 = fmaf(g[q], sp[q], b0);
        b1 = fmaf(g[q + 1], sp[q + 1], b1);
        b2 = fmaf(g[q + 2], sp[q + 2], b2);
        b3 = fmaf(g[q + 3], sp[q + 3], b3);
        e0 = fmaf(v4.x, d4.x, e0);
        e1 = fmaf(v4.y, d4.y, e1);
        e2 = fmaf(v4.z, d4.z, e2);
        e3 = fmaf(v4.w, d4.w, e3);
        g[q] = fmaf(wi, g[q], ri * d4.x);
        g[q + 1] = fmaf(wi, g[q + 1], ri * d4.y);
        g[q + 2] = fmaf(wi, g[q + 2], ri * d4.z);
        g[q + 3] = fmaf(wi, g[q + 3], ri * d4.w);
      }
      const float vd = (e0 + e1) + (e2 + e3);
      const size_t o = row_of(b, t0 + tt, h, H, T) * N + i;
      dk[o] = (a0 + a1) + (a2 + a3) + ui * ri * vd;
      dw[o] = (b0 + b1) + (b2 + b3);
      du = fmaf(ri * ki, vd, du);
    }
  }
  du_rows[(size_t)bh * N + i] = du;
  float* dsi = ds0 + ((size_t)bh * N + i) * N;
#pragma unroll
  for (int q = 0; q < N; q += 4)
    *reinterpret_cast<float4*>(dsi + q) = make_float4(g[q], g[q + 1], g[q + 2], g[q + 3]);
}

// ------------------------------------------------------------------------------------------------
// backward 3: dv, in reverse, an adjoint column a thread
// ------------------------------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(N) wkv_bwd_dv(const float* __restrict__ r,
                                                const float* __restrict__ k,
                                                const float* __restrict__ w,
                                                const float* __restrict__ u,
                                                const float* __restrict__ dout,
                                                const float* __restrict__ dstate,
                                                float* __restrict__ dv, int T, int H) {
  __shared__ __align__(16) float ring[NBUF][4][CH][N];  // r, k, w, dout
  __shared__ __align__(16) float us[N];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const int nc = (T + CH - 1) / CH;
  const float* srcs[4] = {r, k, w, dout};
  us[j] = u[h * N + j];
  float g[N];
  const float* gs = dstate + (size_t)bh * N * N;
#pragma unroll
  for (int q = 0; q < N; ++q) g[q] = gs[q * N + j];
#pragma unroll
  for (int n = 0; n < NBUF - 1; ++n) stage_chunk<N, 4>(ring, srcs, n, nc, true, b, h, H, T);
  for (int n = 0; n < nc; ++n) {
    cp_wait_ring();
    __syncthreads();
    stage_chunk<N, 4>(ring, srcs, n + NBUF - 1, nc, true, b, h, H, T);
    const int t0 = (nc - 1 - n) * CH, steps = min(CH, T - t0);
    const float(*c)[CH][N] = ring[n % NBUF];
    for (int tt = steps - 1; tt >= 0; --tt) {
      const float dj = c[3][tt][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f, e3 = 0.f;
#pragma unroll
      for (int q = 0; q < N; q += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&c[0][tt][q]);
        const float4 k4 = *reinterpret_cast<const float4*>(&c[1][tt][q]);
        const float4 w4 = *reinterpret_cast<const float4*>(&c[2][tt][q]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[q]);
        a0 = fmaf(g[q], k4.x, a0);
        a1 = fmaf(g[q + 1], k4.y, a1);
        a2 = fmaf(g[q + 2], k4.z, a2);
        a3 = fmaf(g[q + 3], k4.w, a3);
        e0 = fmaf(r4.x * u4.x, k4.x, e0);
        e1 = fmaf(r4.y * u4.y, k4.y, e1);
        e2 = fmaf(r4.z * u4.z, k4.z, e2);
        e3 = fmaf(r4.w * u4.w, k4.w, e3);
        g[q] = fmaf(w4.x, g[q], r4.x * dj);
        g[q + 1] = fmaf(w4.y, g[q + 1], r4.y * dj);
        g[q + 2] = fmaf(w4.z, g[q + 2], r4.z * dj);
        g[q + 3] = fmaf(w4.w, g[q + 3], r4.w * dj);
      }
      dv[row_of(b, t0 + tt, h, H, T) * N + j] = (a0 + a1) + (a2 + a3) + dj * ((e0 + e1) + (e2 + e3));
    }
  }
}

template <int N>
int launch_fwd(const float* r, const float* k, const float* v, const float* w, const float* u,
               const float* s_in, float* out, float* s_out, int B, int T, int H, cudaStream_t s) {
  wkv_fwd<N><<<B * H, N, 0, s>>>(r, k, v, w, u, s_in, out, s_out, T, H);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_bwd(const float* r, const float* k, const float* v, const float* w, const float* u,
               const float* s_in, const float* dout, const float* dstate, float* dr, float* dk,
               float* dv, float* dw, float* du_rows, float* ds0, float* ckpt, int B, int T, int H,
               cudaStream_t s) {
  wkv_bwd_dr<N><<<B * H, N, 0, s>>>(k, v, w, u, s_in, dout, dr, ckpt, T, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = dkdw_smem_bytes<N>();
  err = cudaFuncSetAttribute(wkv_bwd_dkdw<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_dkdw<N><<<B * H, N, smem, s>>>(r, k, v, w, u, dout, dstate, ckpt, dk, dw, du_rows,
                                          ds0, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_dv<N><<<B * H, N, 0, s>>>(r, k, w, u, dout, dstate, dv, T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w (B, T, H, K) fp32, u (H, K), s_in and s_out (B, H, K, K) (s_out may be s_in: the
// decode step, in place), out (B, T, H, K); K = V in {32, 64}; every pointer 16-byte aligned.
extern "C" int wkv6_fwd_launch(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* s_in, void* out, void* s_out, int B,
                               int T, int H, int K, void* stream) {
  if (B < 1 || T < 1 || H < 1 || (K != 32 && K != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* so = static_cast<float*>(s_out);
  return K == 64 ? launch_fwd<64>(f(r), f(k), f(v), f(w), f(u), f(s_in), o, so, B, T, H, s)
                 : launch_fwd<32>(f(r), f(k), f(v), f(w), f(u), f(s_in), o, so, B, T, H, s);
}

// The backward: the forward's inputs, dout (B, T, H, K) and dstate (B, H, K, K) in; dr, dk, dv,
// dw (B, T, H, K), du_rows (B, H, K) and ds0 (B, H, K, K) out; ckpt (B*H, ceil(T/chunk), K, K)
// scratch. chunk must be the source's CH.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* s_in, const void* dout,
                               const void* dstate, void* dr, void* dk, void* dv, void* dw,
                               void* du_rows, void* ds0, void* ckpt, int B, int T, int H, int K,
                               int chunk, void* stream) {
  if (B < 1 || T < 1 || H < 1 || (K != 32 && K != 64) || chunk != CH)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K == 64 ? launch_bwd<64>(f(r), f(k), f(v), f(w), f(u), f(s_in), f(dout), f(dstate),
                                  m(dr), m(dk), m(dv), m(dw), m(du_rows), m(ds0), m(ckpt), B, T,
                                  H, s)
                 : launch_bwd<32>(f(r), f(k), f(v), f(w), f(u), f(s_in), f(dout), f(dstate),
                                  m(dr), m(dk), m(dv), m(dw), m(du_rows), m(ds0), m(ckpt), B, T,
                                  H, s);
}
