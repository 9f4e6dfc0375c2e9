// Candidate-space k-swap commit: the sequential greedy accept/reject of a
// row's k searched candidate swaps, each re-scored against the correlation
// values updated by the earlier accepts of the batch
// (swap_math.commit_decisions).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/swap_topk.py::_commit_kernel (swap_commit_padded),
// which runs commit_decisions verbatim over (row_block, k) tiles.
//
// The function is sequential in the candidate index t < k <= 32 and
// independent across rows, so one warp owns one row and lane j holds the
// state of candidate j: its weights, its two correlation values cu[j] and
// cp[j], its indices and its two dead flags. At step t lane t's values are
// broadcast by shuffle, every lane computes the same ΔL_t and the same
// accept decision, and each lane updates its own candidate. A warp, not one
// thread per row, because the k-wide updates of each step then run in
// parallel and the row's k×k sub-Grams are read by k lanes at once.
//
// Bitwise equal to the plain version: built with -fmad=false, and every
// expression keeps PyTorch's evaluation order, including the multiply by
// okf = 0.0 of a rejected candidate's update (so inf/NaN propagate alike).
//
// What bounds it on an H100: nothing but launch latency at the main path's
// shapes. It reads the three (R, k, k) fp32 sub-Gram cubes and seven
// (R, k) arrays once and writes two (R, k) arrays: 4.6 MB at R = 4096,
// k = 8, about 1.4 µs at 3.35 TB/s, for O(R·k²) operations. Fusing the
// sub-Gram gather into this kernel is later work.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS_PER_BLOCK = 4;  // one warp per row
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
swap_commit_kernel(const float* __restrict__ wu, const float* __restrict__ wp,
                   const float* __restrict__ cu_in,
                   const float* __restrict__ cp_in,
                   const float* __restrict__ Suu, const float* __restrict__ Sup,
                   const float* __restrict__ Spp, const int* __restrict__ u,
                   const int* __restrict__ p, const float* __restrict__ valid,
                   float* __restrict__ acc, float* __restrict__ dl_out, int R,
                   int k, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= R) return;  // whole warps leave together
  const bool mine = lane < k;
  const size_t o = (size_t)row * k + lane;
  const size_t cube = (size_t)row * k * k;

  // lane j's candidate
  const float wu_j = mine ? wu[o] : 0.0f;
  const float wp_j = mine ? wp[o] : 0.0f;
  float cu_j = mine ? cu_in[o] : 0.0f;
  float cp_j = mine ? cp_in[o] : 0.0f;
  const int u_j = mine ? u[o] : -1;
  const int p_j = mine ? p[o] : -1;
  const float valid_j = mine ? valid[o] : 0.0f;
  float u_dead = 0.0f, p_dead = 0.0f;
  float acc_j = 0.0f, dl_j = 0.0f;

  for (int t = 0; t < k; ++t) {
    // column t of each sub-Gram at row j, and row t of Sup
    const float suu_col = mine ? Suu[cube + (size_t)lane * k + t] : 0.0f;
    const float sup_col = mine ? Sup[cube + (size_t)lane * k + t] : 0.0f;
    const float sup_row = mine ? Sup[cube + (size_t)t * k + lane] : 0.0f;
    const float spp_col = mine ? Spp[cube + (size_t)lane * k + t] : 0.0f;

    const float wu_t = __shfl_sync(FULL, wu_j, t);
    const float wp_t = __shfl_sync(FULL, wp_j, t);
    const float cu_t = __shfl_sync(FULL, cu_j, t);
    const float cp_t = __shfl_sync(FULL, cp_j, t);
    const float suu_tt = __shfl_sync(FULL, suu_col, t);
    const float sup_tt = __shfl_sync(FULL, sup_col, t);
    const float spp_tt = __shfl_sync(FULL, spp_col, t);
    const float valid_t = __shfl_sync(FULL, valid_j, t);
    const float u_dead_t = __shfl_sync(FULL, u_dead, t);
    const float p_dead_t = __shfl_sync(FULL, p_dead, t);
    const int u_t = __shfl_sync(FULL, u_j, t);
    const int p_t = __shfl_sync(FULL, p_j, t);

    // a_t = 2.0 * wu_t * cu_t + (wu_t * wu_t) * suu_tt, left to right
    const float a_t = (2.0f * wu_t) * cu_t + (wu_t * wu_t) * suu_tt;
    const float b_t = (-2.0f * wp_t) * cp_t + (wp_t * wp_t) * spp_tt;
    const float dl_t = (a_t + b_t) - (2.0f * (wu_t * wp_t)) * sup_tt;
    const bool ok = (valid_t > 0.5f) & (u_dead_t < 0.5f) & (p_dead_t < 0.5f) &
                    (dl_t < -eps);
    const float okf = ok ? 1.0f : 0.0f;

    cu_j = cu_j + okf * (wu_t * suu_col - wp_t * sup_col);
    cp_j = cp_j + okf * (wu_t * sup_row - wp_t * spp_col);
    u_dead = fmaxf(u_dead, okf * (u_j == u_t ? 1.0f : 0.0f));
    p_dead = fmaxf(p_dead, okf * (p_j == p_t ? 1.0f : 0.0f));
    if (lane == t) {
      acc_j = okf;
      dl_j = ok ? dl_t : 0.0f;
    }
  }
  if (mine) {
    acc[o] = acc_j;
    dl_out[o] = dl_j;
  }
}

}  // namespace

extern "C" {

// wu, wp, cu, cp, valid: (R, k) fp32; Suu, Sup, Spp: (R, k, k) fp32; u, p:
// (R, k) int32; all row-major and contiguous. acc, dl: (R, k) fp32.
// 1 <= k <= 32. Returns cudaGetLastError() after the launch.
int swap_commit_decide(const void* wu, const void* wp, const void* cu,
                       const void* cp, const void* Suu, const void* Sup,
                       const void* Spp, const void* u, const void* p,
                       const void* valid, void* acc, void* dl, int R, int k,
                       float eps, void* stream) {
  if (k < 1 || k > 32 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  swap_commit_kernel<<<grid, 32 * ROWS_PER_BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wu), static_cast<const float*>(wp),
      static_cast<const float*>(cu), static_cast<const float*>(cp),
      static_cast<const float*>(Suu), static_cast<const float*>(Sup),
      static_cast<const float*>(Spp), static_cast<const int*>(u),
      static_cast<const int*>(p), static_cast<const float*>(valid),
      static_cast<float*>(acc), static_cast<float*>(dl), R, k, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
