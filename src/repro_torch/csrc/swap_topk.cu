// Fused k-best swap search: per row, the k best pruned columns p by
// min_u ΔL[u, p] (each with its argmin u), sorted by (ΔL, p).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swap_topk.py::_topk_kernel
// (swap_topk_padded). On the TPU the sequential grid carries per-p running
// minima in VMEM scratch across u-tiles and folds each finished p-tile into
// top-k lists held in the output refs. Here one block owns RB rows and
// walks the whole (u, p) space itself (swap_common.cuh), so no state
// crosses blocks, nothing is reduced with atomics and the result does not
// depend on scheduling.
//
// After each p-tile the block holds, per row, TP finished columns
// (min value, argmin u) in shared memory. Warp `wid` owns rows wid,
// wid + NWARP, ...; its lanes 0..k-1 hold that row's sorted top-k list in
// registers. A merge repeats: the warp extracts the tile's smallest
// untaken (ΔL, p) with a shuffle reduction, ranks it against the list by
// a ballot (count of smaller list entries), and shift-inserts it — the
// insertion network of the TPU kernel's _insert_sorted. Extraction is in
// ascending order, so the first candidate that ranks past the end ends the
// tile's merge.
//
// Output: vals (R, k) fp32, u and p (R, k) int32, ascending by (ΔL, p).
// Rows with fewer than k feasible pairs end in +inf entries; their indices
// are clamped into [0, d-1] like the reference wrapper (ops.py:103). On
// feasible entries the result equals swap_math.topk_swaps_chunked bit
// for bit. k <= 32 (one lane per list slot).
//
// What bounds it on an H100: R·d² ΔL evaluations of 5 fp32 operations
// each, against one read of a, b, w (R·d·4 bytes each) and of G (d²·4)
// per RB rows from L2. At the main path's widths it is operation-bound;
// the kernel is right-first, and register tiling of several columns per
// thread, wider row blocks and a tensor-core formulation are later work.

#include "swap_common.cuh"

namespace {

using namespace swapk;

constexpr int ROWS_PER_WARP = RB / NWARP;
constexpr unsigned FULL = 0xffffffffu;
constexpr int COLS_PER_LANE = TP / 32;

__global__ void __launch_bounds__(TP)
swap_topk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ w, const float* __restrict__ G,
                 float* __restrict__ vals, int* __restrict__ u_out,
                 int* __restrict__ p_out, int R, int d, int k) {
  __shared__ Stage st;
  __shared__ float s_val[RB][TP];
  __shared__ int s_u[RB][TP];

  const int row0 = blockIdx.x * RB;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wid = tid / 32;

  // sorted top-k lists: lane j < k holds slot j of each owned row
  float lv[ROWS_PER_WARP];
  int lp[ROWS_PER_WARP];
  int lu[ROWS_PER_WARP];
#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    lv[j] = INFINITY;
    lp[j] = BIG;
    lu[j] = 0;
  }

  float bp[RB], wp[RB], best[RB];
  int bu[RB];
  for (int p0 = 0; p0 < d; p0 += TP) {
    const int p = p0 + tid;
    load_column(b, w, R, d, row0, p, bp, wp);
    column_min(a, w, G, R, d, row0, p, bp, wp, best, bu, st);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      s_val[r][tid] = best[r];
      s_u[r][tid] = bu[r];
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = wid + j * NWARP;
      if (row0 + r >= R) continue;  // warp-uniform
      unsigned taken = 0;           // bit c: column lane + 32c consumed
      for (int round = 0; round < k; ++round) {
        float mv = INFINITY;
        int mp = BIG;
        int mu = 0;
#pragma unroll
        for (int cidx = 0; cidx < COLS_PER_LANE; ++cidx) {
          const int col = lane + 32 * cidx;
          const int pc = p0 + col;
          if (pc < d && !((taken >> cidx) & 1u)) {
            const float v = s_val[r][col];
            if (lex2(v, pc, mv, mp)) {
              mv = v;
              mp = pc;
              mu = s_u[r][col];
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(FULL, mv, off);
          const int op = __shfl_xor_sync(FULL, mp, off);
          const int ou = __shfl_xor_sync(FULL, mu, off);
          if (lex2(ov, op, mv, mp)) {
            mv = ov;
            mp = op;
            mu = ou;
          }
        }
        if (mp >= BIG) break;  // tile exhausted (ragged edge)
        const bool prec = lane < k && lex2(lv[j], lp[j], mv, mp);
        const int pos = __popc(__ballot_sync(FULL, prec));
        if (pos >= k) break;  // later extractions rank past the end too
        const int col = mp - p0;
        if ((col & 31) == lane) taken |= 1u << (col >> 5);
        const float sv = __shfl_up_sync(FULL, lv[j], 1);
        const int sp = __shfl_up_sync(FULL, lp[j], 1);
        const int su = __shfl_up_sync(FULL, lu[j], 1);
        if (lane == pos) {
          lv[j] = mv;
          lp[j] = mp;
          lu[j] = mu;
        } else if (lane > pos && lane < k) {
          lv[j] = sv;
          lp[j] = sp;
          lu[j] = su;
        }
      }
    }
    // the next tile's column pass syncs before it overwrites the stage,
    // but s_val/s_u are rewritten right after it: sync here too
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    const int row = row0 + wid + j * NWARP;
    if (row < R && lane < k) {
      const size_t o = (size_t)row * k + lane;
      vals[o] = lv[j];
      u_out[o] = min(lu[j], d - 1);
      p_out[o] = min(lp[j], d - 1);
    }
  }
}

}  // namespace

extern "C" {

// a, b, w: (R, d) fp32 row-major, +inf at infeasible a/b entries;
// G: (d, d) fp32 row-major, symmetric. vals: (R, k) fp32; u, p: (R, k)
// int32. 1 <= k <= 32. Returns cudaGetLastError() after the launch.
int swap_topk_search(const void* a, const void* b, const void* w,
                     const void* G, void* vals, void* u, void* p, int R,
                     int d, int k, void* stream) {
  if (k < 1 || k > 32 || R < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (R + RB - 1) / RB;
  swap_topk_kernel<<<grid, TP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(w), static_cast<const float*>(G),
      static_cast<float*>(vals), static_cast<int*>(u), static_cast<int*>(p),
      R, d, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
