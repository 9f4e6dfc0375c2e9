// Fused 1-swap search: per row, the jointly-best (ΔL*, u*, p*) over kept u
// and pruned p, without materializing the (R, d, d) ΔL tensor.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swap_argmin.py::_kernel
// (swap_argmin_padded), which keeps a running (min, flat-index argmin) in
// VMEM across the sequential (u, p) grid. Here one block owns RB rows and
// streams the whole (u, p) space itself with the column pass shared with
// swap_topk (swap_common.cuh). Each thread keeps, per row, the best
// (ΔL, u, p) over its columns; a warp shuffle and then a shared-memory
// pass reduce them per row in a fixed order.
//
// Ties: the TPU kernel compares the int32 flat index u·d + p. This kernel
// compares (ΔL, u, p) lexicographically instead: the same order, but it
// cannot overflow or collide with the 2**30 sentinel once d² >= 2**30
// (d >= 32768; the main path's d = 14336 gives d² ≈ 2.1e8). A row with no
// feasible pair returns (+inf, 0, 0), as ref.swap_argmin_ref does.
//
// What bounds it on an H100: as swap_topk, R·d² ΔL evaluations of 5 fp32
// operations, operation-bound at the main path's widths.

#include "swap_common.cuh"

namespace {

using namespace swapk;

constexpr unsigned FULL = 0xffffffffu;

// (v1, u1, p1) < (v2, u2, p2) lexicographically.
__device__ __forceinline__ bool lex3(float v1, int u1, int p1, float v2,
                                     int u2, int p2) {
  return v1 < v2 || (v1 == v2 && (u1 < u2 || (u1 == u2 && p1 < p2)));
}

__global__ void __launch_bounds__(TP)
swap_argmin_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ w, const float* __restrict__ G,
                   float* __restrict__ best_out, int* __restrict__ u_out,
                   int* __restrict__ p_out, int R, int d) {
  __shared__ Stage st;
  __shared__ float s_v[RB][NWARP];
  __shared__ int s_u[RB][NWARP];
  __shared__ int s_p[RB][NWARP];

  const int row0 = blockIdx.x * RB;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wid = tid / 32;

  float tv[RB];
  int tu[RB], tp[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    tv[r] = INFINITY;
    tu[r] = BIG;
    tp[r] = BIG;
  }

  float bp[RB], wp[RB], best[RB];
  int bu[RB];
  for (int p0 = 0; p0 < d; p0 += TP) {
    const int p = p0 + tid;
    load_column(b, w, R, d, row0, p, bp, wp);
    column_min(a, w, G, R, d, row0, p, bp, wp, best, bu, st);
    if (p < d) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (lex3(best[r], bu[r], p, tv[r], tu[r], tp[r])) {
          tv[r] = best[r];
          tu[r] = bu[r];
          tp[r] = p;
        }
      }
    }
  }

  // per-row reduction over the block: warps, then the warp leaders
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float v = tv[r];
    int uu = tu[r], pp = tp[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, off);
      const int ou = __shfl_xor_sync(FULL, uu, off);
      const int op = __shfl_xor_sync(FULL, pp, off);
      if (lex3(ov, ou, op, v, uu, pp)) {
        v = ov;
        uu = ou;
        pp = op;
      }
    }
    if (lane == 0) {
      s_v[r][wid] = v;
      s_u[r][wid] = uu;
      s_p[r][wid] = pp;
    }
  }
  __syncthreads();
  if (tid < RB && row0 + tid < R) {
    const int r = tid;
    float v = s_v[r][0];
    int uu = s_u[r][0], pp = s_p[r][0];
    for (int q = 1; q < NWARP; ++q) {
      if (lex3(s_v[r][q], s_u[r][q], s_p[r][q], v, uu, pp)) {
        v = s_v[r][q];
        uu = s_u[r][q];
        pp = s_p[r][q];
      }
    }
    best_out[row0 + r] = v;
    u_out[row0 + r] = uu;
    p_out[row0 + r] = pp;
  }
}

}  // namespace

extern "C" {

// a, b, w: (R, d) fp32 row-major, +inf at infeasible a/b entries;
// G: (d, d) fp32 row-major, symmetric. best: (R,) fp32; u, p: (R,) int32.
// Returns cudaGetLastError() after the launch.
int swap_argmin_search(const void* a, const void* b, const void* w,
                       const void* G, void* best, void* u, void* p, int R,
                       int d, void* stream) {
  if (R < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (R + RB - 1) / RB;
  swap_argmin_kernel<<<grid, TP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(w), static_cast<const float*>(G),
      static_cast<float*>(best), static_cast<int*>(u), static_cast<int*>(p),
      R, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
