// Candidate-space k-swap commit, the whole step after the search: the
// sequential greedy accept/reject of a row's k searched candidate swaps,
// each re-scored against the correlation values updated by the earlier
// accepts of the batch (swap_math.gather_candidate_stats, then
// commit_decisions), and the accepted swaps' mask flips and full-width
// Eq. 6 update of c (swap_math.apply_commits). Two kernels of one call.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/swap_topk.py::_commit_kernel (swap_commit_padded),
// which runs commit_decisions over (row_block, k) tiles of sub-Gram cubes
// that XLA gathers before it; XLA also fuses the apply after it.
//
// 1. swap_commit_decide_kernel: one warp per row. The row's sub-Grams
//    Suu[i][j] = G[u_i, u_j], Sup[i][j] = G[u_i, p_j], Spp[i][j] =
//    G[p_i, p_j] are read straight from G into shared memory, all 3·k²
//    loads of a warp issued before any is used, in the index order the
//    cubes have (an asymmetric G reads as the plain gather does); no
//    (R, k, k) cube is written. Lane j then holds candidate j (weights,
//    correlation values, indices, dead flags); at step t lane t's values
//    are broadcast by shuffle, every lane computes the same ΔL_t and
//    decision, and each lane updates its own candidate. Bound: bytes, each
//    scattered 4-byte read of G, w or c costing its 32-byte sector:
//    (3·R·k² + 4·R·k)·32 bytes plus the (R, k) arrays, ~30 MB at R =
//    4096, k = 8.
//
// 2. swap_commit_apply_kernel: one block per row streams the row's c and
//    m once (16-byte vectors where d % 4 == 0 and the rows are aligned),
//    and for every candidate t in order evaluates c += acc_t·(w_u·G[:, u_t]
//    − w_p·G[:, p_t]) per element in PyTorch's order. When G equals Gᵀ
//    bitwise (the Gram kernel mirrors its tiles, so it does on the card)
//    G[:, u] is read as the contiguous row G[u, :]; otherwise as a column,
//    one sector per element (correct, slow). A rejected candidate adds
//    0·x: when |x| is certainly finite ((|w_u| + |w_p|)·max|G| ≤ 1e38,
//    checked per candidate against max|G| passed in) that changes c only
//    where c is −0.0 and x ≥ +0, or c is NaN (the add returns the card's
//    canonical NaN), so the kernel reads that candidate's two Gram rows
//    only at such elements; every other candidate is evaluated in full.
//    After the row's stream one thread applies the k mask flips in order
//    (m[p_t] += acc_t, then m[u_t] −= acc_t), as the plain version's
//    index_puts do. Bound: bytes, c and m read and written once (16·d per
//    row) plus 8·d per candidate evaluated in full.
//
// Bitwise equal to the plain versions: built with -fmad=false, and every
// expression keeps PyTorch's evaluation order, including the multiply by
// 0.0 of a rejected candidate's update (so inf/NaN propagate alike).

#include <cuda_runtime.h>

namespace {

constexpr int DECIDE_ROWS = 4;     // one warp per row
constexpr int APPLY_THREADS = 256;
constexpr int MAX_K = 32;
constexpr float SKIP_LIMIT = 1e38f;  // (|w_u| + |w_p|)·max|G| below this: x finite
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32 * DECIDE_ROWS)
swap_commit_decide_kernel(const float* __restrict__ w,
                          const float* __restrict__ c,
                          const float* __restrict__ G,
                          const int* __restrict__ u, const int* __restrict__ p,
                          const float* __restrict__ dl_in,
                          float* __restrict__ acc, float* __restrict__ dl_out,
                          int R, int d, int k, float eps) {
  extern __shared__ float sub[];   // per warp: Suu, Sup, Spp, k × k each
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row = blockIdx.x * DECIDE_ROWS + warp;
  if (row >= R) return;  // whole warps leave together; no block barrier
  const int kk = k * k;
  float* suu = sub + (size_t)warp * 3 * kk;
  float* sup = suu + kk;
  float* spp = sup + kk;
  const bool mine = lane < k;
  const size_t o = (size_t)row * k + lane;
  const size_t ro = (size_t)row * d;

  // lane j's candidate
  const int u_j = mine ? u[o] : 0;
  const int p_j = mine ? p[o] : 0;
  const float wu_j = mine ? w[ro + u_j] : 0.0f;
  const float wp_j = mine ? w[ro + p_j] : 0.0f;
  float cu_j = mine ? c[ro + u_j] : 0.0f;
  float cp_j = mine ? c[ro + p_j] : 0.0f;
  const float valid_j = mine && isfinite(dl_in[o]) ? 1.0f : 0.0f;

  // sub-Gram entry e = i·k + j of each cube
#pragma unroll 4
  for (int base = 0; base < kk; base += 32) {
    const int e = base + lane;
    const int i = e < kk ? e / k : 0;
    const int j = e < kk ? e - i * k : 0;
    const size_t ui = (size_t)__shfl_sync(FULL, u_j, i) * d;
    const size_t pi = (size_t)__shfl_sync(FULL, p_j, i) * d;
    const int uj = __shfl_sync(FULL, u_j, j);
    const int pj = __shfl_sync(FULL, p_j, j);
    if (e < kk) {
      suu[e] = G[ui + uj];
      sup[e] = G[ui + pj];
      spp[e] = G[pi + pj];
    }
  }
  __syncwarp();

  float u_dead = 0.0f, p_dead = 0.0f;
  float acc_j = 0.0f, dl_j = 0.0f;
  for (int t = 0; t < k; ++t) {
    // column t of each sub-Gram at row j, and row t of Sup
    const float suu_col = mine ? suu[lane * k + t] : 0.0f;
    const float sup_col = mine ? sup[lane * k + t] : 0.0f;
    const float sup_row = mine ? sup[t * k + lane] : 0.0f;
    const float spp_col = mine ? spp[lane * k + t] : 0.0f;

    const float wu_t = __shfl_sync(FULL, wu_j, t);
    const float wp_t = __shfl_sync(FULL, wp_j, t);
    const float cu_t = __shfl_sync(FULL, cu_j, t);
    const float cp_t = __shfl_sync(FULL, cp_j, t);
    const float suu_tt = suu[t * k + t];
    const float sup_tt = sup[t * k + t];
    const float spp_tt = spp[t * k + t];
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

// v + (±0.0) has other bits than v only for v = −0.0 and a NaN
__device__ __forceinline__ bool zero_add_may_change(float v) {
  return __float_as_uint(v) == 0x80000000u || v != v;
}

// G[:, col] at element e: the row G[col, e] when G is symmetric
template <bool ROWS>
__device__ __forceinline__ float gram_at(const float* __restrict__ G,
                                         size_t d, int col, int e) {
  return ROWS ? G[(size_t)col * d + e] : G[(size_t)e * d + col];
}

template <bool ROWS>
__device__ __forceinline__ float4 gram_at4(const float* __restrict__ G,
                                           size_t d, int col, int e) {
  if (ROWS) return *reinterpret_cast<const float4*>(G + (size_t)col * d + e);
  return make_float4(G[(size_t)e * d + col], G[(size_t)(e + 1) * d + col],
                     G[(size_t)(e + 2) * d + col],
                     G[(size_t)(e + 3) * d + col]);
}

struct Cand {
  int u, p;
  float wu, wp, a;
  int full;  // evaluate every element; else only where c may change
};

// one candidate's update of element e: c + a·(w_u·G[e, u] − w_p·G[e, p])
template <bool ROWS>
__device__ __forceinline__ float update(float cv, const Cand& q,
                                        const float* __restrict__ G, size_t d,
                                        int e) {
  const float gu = gram_at<ROWS>(G, d, q.u, e);
  const float gp = gram_at<ROWS>(G, d, q.p, e);
  return cv + q.a * (q.wu * gu - q.wp * gp);
}

template <bool ROWS, bool VEC>
__global__ void __launch_bounds__(APPLY_THREADS)
swap_commit_apply_kernel(const float* __restrict__ w,
                         const float* __restrict__ m,
                         const float* __restrict__ c,
                         const float* __restrict__ G,
                         const int* __restrict__ u, const int* __restrict__ p,
                         const float* __restrict__ acc,
                         float* __restrict__ m_out, float* __restrict__ c_out,
                         int d, int k, float gmax) {
  __shared__ Cand cand[MAX_K];
  const int row = blockIdx.x;
  const size_t ro = (size_t)row * d;
  if (threadIdx.x < k) {
    const int t = threadIdx.x;
    Cand q;
    q.u = u[(size_t)row * k + t];
    q.p = p[(size_t)row * k + t];
    q.wu = w[ro + q.u];
    q.wp = w[ro + q.p];
    q.a = acc[(size_t)row * k + t];
    const float lim = (fabsf(q.wu) + fabsf(q.wp)) * gmax;
    q.full = q.a != 0.0f || !(lim <= SKIP_LIMIT);
    cand[t] = q;
  }
  __syncthreads();

  const float* crow = c + ro;
  const float* mrow = m + ro;
  float* cdst = c_out + ro;
  float* mdst = m_out + ro;
  if (VEC) {
    for (int e = 4 * threadIdx.x; e < d; e += 4 * APPLY_THREADS) {
      float4 cv = *reinterpret_cast<const float4*>(crow + e);
      *reinterpret_cast<float4*>(mdst + e) =
          *reinterpret_cast<const float4*>(mrow + e);
      for (int t = 0; t < k; ++t) {
        const Cand& q = cand[t];
        if (q.full) {
          const float4 gu = gram_at4<ROWS>(G, d, q.u, e);
          const float4 gp = gram_at4<ROWS>(G, d, q.p, e);
          cv.x = cv.x + q.a * (q.wu * gu.x - q.wp * gp.x);
          cv.y = cv.y + q.a * (q.wu * gu.y - q.wp * gp.y);
          cv.z = cv.z + q.a * (q.wu * gu.z - q.wp * gp.z);
          cv.w = cv.w + q.a * (q.wu * gu.w - q.wp * gp.w);
        } else {
          if (zero_add_may_change(cv.x)) cv.x = update<ROWS>(cv.x, q, G, d, e);
          if (zero_add_may_change(cv.y))
            cv.y = update<ROWS>(cv.y, q, G, d, e + 1);
          if (zero_add_may_change(cv.z))
            cv.z = update<ROWS>(cv.z, q, G, d, e + 2);
          if (zero_add_may_change(cv.w))
            cv.w = update<ROWS>(cv.w, q, G, d, e + 3);
        }
      }
      *reinterpret_cast<float4*>(cdst + e) = cv;
    }
  } else {
    for (int e = threadIdx.x; e < d; e += APPLY_THREADS) {
      float cv = crow[e];
      mdst[e] = mrow[e];
      for (int t = 0; t < k; ++t) {
        const Cand& q = cand[t];
        if (q.full || zero_add_may_change(cv))
          cv = update<ROWS>(cv, q, G, d, e);
      }
      cdst[e] = cv;
    }
  }
  __syncthreads();  // the row's m_out is written and visible to the block
  if (threadIdx.x == 0) {
    for (int t = 0; t < k; ++t) {
      const Cand& q = cand[t];
      mdst[q.p] = mdst[q.p] + q.a;
      mdst[q.u] = mdst[q.u] - q.a;
    }
  }
}

template <bool ROWS>
cudaError_t launch_apply(bool vec, int R, cudaStream_t stream,
                         const float* w, const float* m, const float* c,
                         const float* G, const int* u, const int* p,
                         const float* acc, float* m_out, float* c_out, int d,
                         int k, float gmax) {
  if (vec)
    swap_commit_apply_kernel<ROWS, true><<<R, APPLY_THREADS, 0, stream>>>(
        w, m, c, G, u, p, acc, m_out, c_out, d, k, gmax);
  else
    swap_commit_apply_kernel<ROWS, false><<<R, APPLY_THREADS, 0, stream>>>(
        w, m, c, G, u, p, acc, m_out, c_out, d, k, gmax);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// w, m, c: (R, d) fp32; G: (d, d) fp32; u, p: (R, k) int32 in [0, d);
// dl: (R, k) fp32, the search's values (a candidate is valid iff finite);
// all row-major and contiguous. Writes acc, dls (R, k) fp32 and m_out,
// c_out (R, d) fp32. g_rows: G equals Gᵀ bitwise (read G[:, u] as a row);
// gmax: max|G| (NaN or inf where G holds one). 1 <= k <= 32. Returns the
// first cudaGetLastError() that is not cudaSuccess after the two launches.
int swap_commit(const void* w, const void* m, const void* c, const void* G,
                const void* u, const void* p, const void* dl, void* acc,
                void* dls, void* m_out, void* c_out, int R, int d, int k,
                float eps, int g_rows, float gmax, void* stream) {
  if (k < 1 || k > MAX_K || R < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = (R + DECIDE_ROWS - 1) / DECIDE_ROWS;
  const size_t smem = sizeof(float) * DECIDE_ROWS * 3 * k * k;  // <= 48 KB
  swap_commit_decide_kernel<<<grid, 32 * DECIDE_ROWS, smem, s>>>(
      static_cast<const float*>(w), static_cast<const float*>(c),
      static_cast<const float*>(G), static_cast<const int*>(u),
      static_cast<const int*>(p), static_cast<const float*>(dl),
      static_cast<float*>(acc), static_cast<float*>(dls), R, d, k, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec =
      d % 4 == 0 &&
      ((reinterpret_cast<size_t>(m) | reinterpret_cast<size_t>(c) |
        reinterpret_cast<size_t>(G) | reinterpret_cast<size_t>(m_out) |
        reinterpret_cast<size_t>(c_out)) % 16) == 0;
  auto launch = g_rows ? launch_apply<true> : launch_apply<false>;
  err = launch(vec, R, s, static_cast<const float*>(w),
               static_cast<const float*>(m), static_cast<const float*>(c),
               static_cast<const float*>(G), static_cast<const int*>(u),
               static_cast<const int*>(p), static_cast<const float*>(acc),
               static_cast<float*>(m_out), static_cast<float*>(c_out), d, k,
               gmax);
  return static_cast<int>(err);
}

}  // extern "C"
