// Segmented per-unit sums of squares for Hopper (sm_90a), and their gradient.
//
// Replaces the TPU kernel repro/kernels/group_l2_norms/group_l2_norms.py:group_l2_norms, which
// reduces one (K, G*C) matrix to (G,) over contiguous column chunks. The port's callers (the Omega
// regularizer and the L2 pruning scores) need that reduction for every member of every pruning
// group, ~200 parameter slices of a U-Net, so one launch here takes all of them: a member is a
// slice of a contiguous fp32 or bf16 tensor seen as (outer, L, inner) around its group axis, whose
// unit k owns a run of R = chunk * inner contiguous elements in each of the outer rows, starting at
// `start` within the row. The per-unit sums of all members of a group land in one flat fp32 output
// (Σ group sizes,). The host (ops.py) builds the table of members, work items and groups once per
// layout and keeps it on the device; only the tensors' pointers change from call to call.
//
// Bound on the H100: bytes, every member element read once (~124 MB at the CIFAR-10 U-Net's full
// width, 37 us at 3.35 TB/s). What held the first kernel back was the host: 196 launches of two
// kernels, with a movedim copy for members whose axis is not last. Here one host call runs:
//
// Pass 1 (group_l2_partials): one block of 256 threads per work item, an item being a tile of one
//   member: 32 KB of reads or fewer, so ~4,000 items at full width balance across the 132 SMs. The
//   member is read in place, in one of two layouts, each coalesced:
//   - column mode (R < 32: axis last, 1-D leaves): a row's owned span of size * R elements is
//     contiguous; 64 column threads read 4 neighbouring columns each (one 16-byte fp32 or 8-byte
//     bf16 load where the row and the span are aligned) and 4 row threads stride over the item's
//     row slab. The 4 row partials of each column are summed in order through shared memory, giving
//     one partial per (slab, column);
//   - run mode (R >= 32: conv2.w, proj.w): each warp owns one unit and reduces its run of R
//     elements in each row of the slab (16-byte loads where aligned), then the warp's lanes by a
//     fixed shuffle tree, giving one partial per (slab, unit).
// Pass 2 (group_l2_sums): one thread per unit sums its partials in member order, then slab order,
//   then column order, as the reference's per-member `out + s` does. No atomics: repeated runs give
//   bitwise-identical sums, which the rank-based pruning masks rely on.
// Backward (group_l2_bwd): d/dw = 2 * w * g[unit] on every owned element (the reference's
//   repro/models/ops.py:_group_sq_pallas_bwd applied to every member at once), over the same work
//   items, in the tensor's type; 2 * w is exact, so it equals the plain formula bit for bit.
//
// Client axis: the vectorized round engine stacks every parameter of C clients on a leading axis, and
//   one launch computes each client's sums. The table then holds C copies of every member (and of its
//   items, groups and pass-2 items), copy c reading from a 64-bit element offset of c * (elements per
//   client) into the stacked tensor and writing to units c * units + base. A copy's work is the
//   one-client work shifted, so each client's sums and gradient are the bits a one-client launch on
//   its slice gives. One pointer per stacked tensor keeps the pointer table as small as one client's.
//
// Pointers: the ~170 tensors' pointers travel by value as a kernel parameter of MAX_TENSORS
// pointers (1,920 bytes; the backward's two tables 3,840), under the 4 KB that every CUDA 12
// toolkit accepts, so no per-call copy to the device and no pinned staging buffer is needed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int MAX_TENSORS = 240;
constexpr int THREADS = 256;
constexpr int COLT = 64, ROWT = 4, TILE_COLS = COLT * 4;  // column mode: 256 columns a tile
constexpr int MREC = 18, IREC = 4, GREC = 4;             // ints per member, item, group record

struct Ptrs {
  const void* p[MAX_TENSORS];
};
struct OutPtrs {
  void* p[MAX_TENSORS];
};

// a member record (ops.py:Table writes them in this order)
struct Member {
  int tensor, bf16, run, vec, outer, rowstride, start, R, size, base, pbase, pstride, pr, nslabs,
      rows, ncols;
  int64_t off;  // the member's first element in its tensor: its client's copy (ints 16, 17: lo, hi)
};

__device__ __forceinline__ Member read_member(const int* __restrict__ desc, int m) {
  const int* r = desc + m * MREC;
  Member v;
  v.tensor = __ldg(r + 0);
  v.bf16 = __ldg(r + 1);
  v.run = __ldg(r + 2);
  v.vec = __ldg(r + 3);
  v.outer = __ldg(r + 4);
  v.rowstride = __ldg(r + 5);
  v.start = __ldg(r + 6);
  v.R = __ldg(r + 7);
  v.size = __ldg(r + 8);
  v.base = __ldg(r + 9);
  v.pbase = __ldg(r + 10);
  v.pstride = __ldg(r + 11);
  v.pr = __ldg(r + 12);
  v.nslabs = __ldg(r + 13);
  v.rows = __ldg(r + 14);
  v.ncols = __ldg(r + 15);
  v.off = (static_cast<int64_t>(__ldg(r + 17)) << 32) | static_cast<uint32_t>(__ldg(r + 16));
  return v;
}

// a tensor's base pointer advanced by a member's client offset
__device__ __forceinline__ const void* at(const void* p, const Member& m) {
  return static_cast<const char*>(p) + m.off * (m.bf16 ? 2 : 4);
}
__device__ __forceinline__ void* at(void* p, const Member& m) {
  return static_cast<char*>(p) + m.off * (m.bf16 ? 2 : 4);
}

__device__ __forceinline__ float ld1(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
// 4 neighbouring elements from i (a multiple of 4, the base 16-byte (fp32) or 8-byte (bf16) aligned)
__device__ __forceinline__ float4 ld4(const void* p, int64_t i, int bf16) {
  if (bf16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + i));
}
__device__ __forceinline__ void st1(void* p, int64_t i, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}
__device__ __forceinline__ void st4(void* p, int64_t i, float4 v, int bf16) {
  if (bf16) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
group_l2_partials(const Ptrs ptrs, const int* __restrict__ desc, const int* __restrict__ items,
                  float* __restrict__ partial) {
  __shared__ float red[ROWT][TILE_COLS];
  const int* it = items + blockIdx.x * IREC;
  const Member m = read_member(desc, __ldg(it + 0));
  const int c0 = __ldg(it + 1), slab = __ldg(it + 2);
  const int r0 = slab * m.rows, r1 = min(r0 + m.rows, m.outer);
  const void* w = at(ptrs.p[m.tensor], m);
  const int tid = threadIdx.x;
  float* out = partial + m.pbase + (int64_t)slab * m.pstride;

  if (!m.run) {  // column mode: columns [c0, c0 + 256) of the span, rows [r0, r1)
    const int tx = tid % COLT, ty = tid / COLT, col = c0 + 4 * tx;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (col < m.ncols) {
      if (m.vec) {
#pragma unroll 4
        for (int r = r0 + ty; r < r1; r += ROWT) {
          const float4 x = ld4(w, (int64_t)r * m.rowstride + m.start + col, m.bf16);
          acc[0] = fmaf(x.x, x.x, acc[0]);
          acc[1] = fmaf(x.y, x.y, acc[1]);
          acc[2] = fmaf(x.z, x.z, acc[2]);
          acc[3] = fmaf(x.w, x.w, acc[3]);
        }
      } else {
        const int nj = min(4, m.ncols - col);
#pragma unroll 2
        for (int r = r0 + ty; r < r1; r += ROWT) {
          const int64_t row = (int64_t)r * m.rowstride + m.start + col;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nj) {
              const float x = ld1(w, row + j, m.bf16);
              acc[j] = fmaf(x, x, acc[j]);
            }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][4 * tx + j] = acc[j];
    __syncthreads();
    if (c0 + tid < m.ncols) {
      float t = red[0][tid];
#pragma unroll
      for (int i = 1; i < ROWT; ++i) t += red[i][tid];
      out[c0 + tid] = t;
    }
    return;
  }

  // run mode: warp wp reduces unit c0 + wp over rows [r0, r1)
  const int wp = tid / 32, lane = tid % 32, k = c0 + wp;
  if (k >= m.size) return;
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const int64_t run = (int64_t)r * m.rowstride + m.start + (int64_t)k * m.R;
    if (m.vec) {
#pragma unroll 4
      for (int e = 4 * lane; e < m.R; e += 128) {
        const float4 x = ld4(w, run + e, m.bf16);
        acc = fmaf(x.x, x.x, acc);
        acc = fmaf(x.y, x.y, acc);
        acc = fmaf(x.z, x.z, acc);
        acc = fmaf(x.w, x.w, acc);
      }
    } else {
#pragma unroll 4
      for (int e = lane; e < m.R; e += 32) {
        const float x = ld1(w, run + e, m.bf16);
        acc = fmaf(x, x, acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[k] = acc;
}

__global__ void __launch_bounds__(THREADS)
group_l2_sums(const int* __restrict__ desc, const int* __restrict__ groups,
              const int* __restrict__ items2, const float* __restrict__ partial,
              float* __restrict__ out) {
  const int* it = items2 + blockIdx.x * IREC;
  const int* g = groups + __ldg(it + 0) * GREC;
  const int base = __ldg(g + 0), size = __ldg(g + 1), m0 = __ldg(g + 2), m1 = __ldg(g + 3);
  const int k = __ldg(it + 1) + threadIdx.x;
  if (k >= size) return;
  float acc = 0.f;
  for (int mi = m0; mi < m1; ++mi) {
    const Member m = read_member(desc, mi);
    float s = 0.f;
    for (int sl = 0; sl < m.nslabs; ++sl) {
      const float* p = partial + m.pbase + (int64_t)sl * m.pstride + (int64_t)k * m.pr;
      for (int r = 0; r < m.pr; ++r) s += p[r];
    }
    acc = mi == m0 ? s : acc + s;
  }
  out[base + k] = acc;
}

__global__ void __launch_bounds__(THREADS)
group_l2_bwd(const Ptrs ptrs, const OutPtrs grads, const int* __restrict__ desc,
             const int* __restrict__ items, const float* __restrict__ gout) {
  const int* it = items + blockIdx.x * IREC;
  const Member m = read_member(desc, __ldg(it + 0));
  const int c0 = __ldg(it + 1), slab = __ldg(it + 2);
  const int r0 = slab * m.rows, r1 = min(r0 + m.rows, m.outer);
  const void* w = at(ptrs.p[m.tensor], m);
  void* dw = at(grads.p[m.tensor], m);
  const float* g = gout + m.base;
  const int tid = threadIdx.x;

  if (!m.run) {
    const int tx = tid % COLT, ty = tid / COLT, col = c0 + 4 * tx;
    if (col >= m.ncols) return;
    if (m.vec) {  // the 4 columns may belong to up to 4 units (R = 1: one each)
      const float g0 = g[col / m.R], g1 = g[(col + 1) / m.R], g2 = g[(col + 2) / m.R],
                  g3 = g[(col + 3) / m.R];
      for (int r = r0 + ty; r < r1; r += ROWT) {
        const int64_t i = (int64_t)r * m.rowstride + m.start + col;
        const float4 x = ld4(w, i, m.bf16);
        st4(dw, i, make_float4(2.f * x.x * g0, 2.f * x.y * g1, 2.f * x.z * g2, 2.f * x.w * g3),
            m.bf16);
      }
    } else {
      const int nj = min(4, m.ncols - col);
      for (int r = r0 + ty; r < r1; r += ROWT) {
        const int64_t row = (int64_t)r * m.rowstride + m.start + col;
        for (int j = 0; j < nj; ++j)
          st1(dw, row + j, 2.f * ld1(w, row + j, m.bf16) * g[(col + j) / m.R], m.bf16);
      }
    }
    return;
  }

  const int wp = tid / 32, lane = tid % 32, k = c0 + wp;
  if (k >= m.size) return;
  const float gk = g[k];
  for (int r = r0; r < r1; ++r) {
    const int64_t run = (int64_t)r * m.rowstride + m.start + (int64_t)k * m.R;
    if (m.vec) {
      for (int e = 4 * lane; e < m.R; e += 128) {
        const float4 x = ld4(w, run + e, m.bf16);
        st4(dw, run + e, make_float4(2.f * x.x * gk, 2.f * x.y * gk, 2.f * x.z * gk, 2.f * x.w * gk),
            m.bf16);
      }
    } else {
      for (int e = lane; e < m.R; e += 32)
        st1(dw, run + e, 2.f * ld1(w, run + e, m.bf16) * gk, m.bf16);
    }
  }
}

}  // namespace

// desc: the device table [members (18 ints each) | items (4) | groups (4) | pass-2 items (4)];
// partial: scratch of the table's partial_len floats; out: (Σ group sizes,) float32
extern "C" int group_l2_fwd_launch(const void* const* tensors, int n_tensors, const int* desc,
                                   int n_members, int n_items, int n_groups, int n_items2,
                                   void* partial, void* out, void* stream) {
  if (n_tensors < 1 || n_tensors > MAX_TENSORS || n_members < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Ptrs p = {};
  for (int i = 0; i < n_tensors; ++i) p.p[i] = tensors[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* items = desc + n_members * MREC;
  const int* groups = items + n_items * IREC;
  const int* items2 = groups + n_groups * GREC;
  if (n_items > 0) {
    group_l2_partials<<<n_items, THREADS, 0, s>>>(p, desc, items, static_cast<float*>(partial));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  group_l2_sums<<<n_items2, THREADS, 0, s>>>(desc, groups, items2,
                                            static_cast<const float*>(partial),
                                            static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// grads: one gradient per tensor, in the tensor's type (zeroed by the caller where the members
// do not cover the tensor); g: the (Σ group sizes,) float32 cotangent
extern "C" int group_l2_bwd_launch(const void* const* tensors, void* const* grads, int n_tensors,
                                   const int* desc, int n_members, int n_items, const void* g,
                                   void* stream) {
  if (n_tensors < 1 || n_tensors > MAX_TENSORS || n_members < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return 0;
  Ptrs p = {};
  OutPtrs d = {};
  for (int i = 0; i < n_tensors; ++i) {
    p.p[i] = tensors[i];
    d.p[i] = grads[i];
  }
  group_l2_bwd<<<n_items, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, desc, desc + n_members * MREC, static_cast<const float*>(g));
  return static_cast<int>(cudaGetLastError());
}
