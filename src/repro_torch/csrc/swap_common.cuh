// Shared column pass of the swap-search kernels (swap_topk.cu,
// swap_argmin.cu).
//
// A block owns RB rows and walks the whole (u, p) space in a fixed order:
// p in tiles of TP columns (one column per thread), and for each tile every
// u = 0..d-1. Each thread keeps, per row, the running min over u of
//     ΔL[u, p] = (a_u + b_p) - (2 * (w_u * w_p)) * G[u, p]
// with a strict `<`, so ties go to the lowest u. G is read row-major, so a
// warp's reads of G[u, p..p+31] are coalesced; a_u and w_u for a chunk of
// UC values of u are staged in shared memory and read as broadcasts.
//
// The ΔL evaluation uses round-to-nearest intrinsics in exactly the order
// of repro_torch.core.swap_math._delta (and of the reference's
// swap_math.topk_swaps_dense), so no multiply-add is contracted into an
// FMA and the kernel equals the plain PyTorch version bit for bit.
// The library is also built with -fmad=false.
//
// Infeasible entries are +inf: a = +inf where u is not kept, b = +inf
// where p is kept. Ragged edges are masked here instead of padded: a row
// >= R, a column p >= d or a u >= d contributes a = +inf, b = +inf, w = 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace swapk {

constexpr int TP = 256;            // columns per tile = threads per block
constexpr int RB = 16;             // rows per block
constexpr int UC = 32;             // u values staged per shared chunk
constexpr int NWARP = TP / 32;     // warps per block
constexpr int BIG = 1 << 30;       // index sentinel that loses every tie

__device__ __forceinline__ float delta_l(float au, float bp, float wu,
                                         float wp, float g) {
  const float inter = __fmul_rn(__fmul_rn(2.0f, __fmul_rn(wu, wp)), g);
  return __fsub_rn(__fadd_rn(au, bp), inter);
}

// (v1, i1) < (v2, i2) lexicographically.
__device__ __forceinline__ bool lex2(float v1, int i1, float v2, int i2) {
  return v1 < v2 || (v1 == v2 && i1 < i2);
}

struct Stage {
  float a[UC][RB];
  float w[UC][RB];
};

// Per-row min over all u of ΔL for this thread's column p of the tile.
// bp/wp: b and w of the thread's column for each row (+inf / 0 if out of
// range). best/bu: outputs (+inf / 0 when no feasible u).
__device__ __forceinline__ void column_min(
    const float* __restrict__ a, const float* __restrict__ w,
    const float* __restrict__ G, int R, int d, int row0, int p,
    const float (&bp)[RB], const float (&wp)[RB], float (&best)[RB],
    int (&bu)[RB], Stage& st) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    best[r] = INFINITY;
    bu[r] = 0;
  }
  const bool pcol = p < d;
  for (int u0 = 0; u0 < d; u0 += UC) {
    __syncthreads();  // previous chunk fully consumed
    for (int e = threadIdx.x; e < UC * RB; e += TP) {
      const int uu = e % UC;
      const int r = e / UC;
      const int u = u0 + uu;
      const int row = row0 + r;
      const bool ok = u < d && row < R;
      const size_t off = (size_t)row * d + u;
      st.a[uu][r] = ok ? a[off] : INFINITY;
      st.w[uu][r] = ok ? w[off] : 0.f;
    }
    __syncthreads();
    const int n = min(UC, d - u0);
#pragma unroll 4
    for (int uu = 0; uu < n; ++uu) {
      const float g = pcol ? G[(size_t)(u0 + uu) * d + p] : 0.f;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float dl = delta_l(st.a[uu][r], bp[r], st.w[uu][r], wp[r], g);
        if (dl < best[r]) {
          best[r] = dl;
          bu[r] = u0 + uu;
        }
      }
    }
  }
}

// b and w of column p for the block's rows (masked at the edges).
__device__ __forceinline__ void load_column(const float* __restrict__ b,
                                            const float* __restrict__ w,
                                            int R, int d, int row0, int p,
                                            float (&bp)[RB],
                                            float (&wp)[RB]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int row = row0 + r;
    const bool ok = p < d && row < R;
    const size_t off = (size_t)row * d + p;
    bp[r] = ok ? b[off] : INFINITY;
    wp[r] = ok ? w[off] : 0.f;
  }
}

}  // namespace swapk
