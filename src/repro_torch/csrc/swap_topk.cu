// Fused swap searches over the (u kept, p pruned) pairs of each row, without
// materializing the (R, d, d) ΔL tensor:
//   swap_topk_search: the k best pruned columns p by min_u ΔL[u, p] (each
//     with its argmin u, ties to the lowest u), sorted by (ΔL, p);
//   swap_argmin_search: the jointly-best (ΔL*, u*, p*), ties to the
//     smallest (u, p).
//
// Replaces the Pallas TPU kernels src/repro/kernels/swap_topk.py::
// _topk_kernel (swap_topk_padded) and src/repro/kernels/swap_argmin.py::
// _kernel (swap_argmin_padded). On the TPU the sequential grid carries
// per-p running minima (top-k) or a running (min, flat index) (argmin) in
// VMEM across tiles. Here the (u, p) space is cut into blocks that run in
// parallel; both searches run the same preparation and partial walk, and a
// last kernel of the same call turns the blocks' lists into the answer:
//
// 0. swap_topk_prep_kernel writes 2 G into scratch and flags the call
//    unsafe if some |g| >= 2^127 or |w| >= 2^63. Where it is safe the walk
//    multiplies round(w_u w_p) by 2 g: the same real product as delta_l's
//    round(2 round(w_u w_p)) · g, since doubling is exact short of
//    overflow (subnormals too), so the same rounded value with one
//    operation fewer. 2 w_u is not hoisted: round(2 w_u) w_p differs from
//    2 round(w_u w_p) where the product is subnormal. An unsafe call walks
//    G itself with delta_l. Taking G in pairs of mirrored 32 x 32 tiles,
//    it also flags whether G equals Gᵀ to the bit.
// 1. swap_topk_partial_kernel: block (x, y) owns RB rows and the TP
//    columns of p-tile y, and walks every u in chunks of UC. A producer
//    warp brings each (UC x TP) tile of 2 G (or G) into a ring of STAGES
//    shared stages by TMA (four 64-column boxes, zeros past d) with full /
//    empty mbarriers, so G is read from L2 once per RB rows, and the blocks
//    on the card at one time (consecutive row blocks of one p-tile) read
//    the same tiles; consumer warps run up to STAGES - 1 chunks apart.
//    Each of the CW consumer warps owns RPW rows; per chunk and row it
//    compacts the kept u (a < +inf: ballot, popc) into a shared list of
//    (a_u, w_u, tile row) and walks only that list, unrolled by two. A
//    skipped u has a = +inf, so its ΔL is +inf (or NaN) and can never be
//    a row's min. p stays dense: lane l owns columns 4l..4l+3 and
//    128+4l..128+4l+3 of the tile, so one u costs a broadcast load of its
//    entry, two conflict-free float4 loads of its G row, and per column
//    four (unsafe: five) rounded operations and one fminf. The running
//    minimum holds the min value; which u reached it is found later, only
//    for the winners. At the end each warp extracts, per row, the k
//    smallest (min, p) of the tile (a shuffle reduction per rank) into
//    the scratch list of (row, p-tile), sorted. swap_argmin's lists hold
//    ARGMIN_K entries.
// 2. swap_topk_merge_kernel: one warp per row takes the k smallest
//    (value, p) of all p-tiles' lists, rank by rank. Top-k under the strict
//    total order (ΔL, p) with distinct p does not depend on how the
//    partial lists were formed, so this equals a top-k over all columns.
//    Then, for each finite entry, the warp walks the row's kept u upwards
//    (compacted MERGE_SPAN at a time) and stops at the first whose ΔL, by
//    delta_l on G (G[u][p] read along row p where G is symmetric, so the
//    loads are not a column's scattered sectors), equals the column's
//    minimum: the lowest-u argmin, as a strict `<` walk in ascending u
//    finds it. Its ΔL, recomputed there, is the value written, so a
//    zero's sign is that of the first u (fminf may keep either zero).
// 3. swap_argmin_select_kernel (instead of the merge): one warp per row.
//    v* = the smallest value of all its lists: the row's smallest column
//    minimum. The columns whose minimum equals v* (`==`, so +0 and -0
//    tie) are the tied set S. A tile's list is its K smallest (min, p),
//    so it holds every tied column of the tile unless its last entry is
//    v* too; then S may be incomplete (overflow). Every pair with
//    ΔL == v* lies in a column of S, so the smallest such (u, p) is found
//    by walking the kept u upwards, lanes over u, ΔL at each column of S,
//    and stopping at the first u with a hit (its smallest hit p). On
//    overflow (or more than TIE_CAP tied columns) the walk is exact
//    without S: at each kept u, upwards, lanes scan every p, and the first
//    hit wins; a fully tied row (w = 0) stops at its first kept u. The
//    value written is ΔL recomputed at (u*, p*), so a zero's sign is that
//    pair's. A row whose v* is +inf (no feasible pair) gets (+inf, 0, 0),
//    as ref.swap_argmin_ref. (u, p) are compared as a pair, never as the
//    flat index u·d + p of the TPU kernel, which overflows int32 once
//    d >= 46341 and meets its 2^30 sentinel from d = 32768.
//
// NaN: a NaN ΔL never wins. fminf keeps the running minimum over a NaN,
// and the selection's `==` never matches one. The plain versions read a
// NaN ΔL as +inf (swap_math._delta), the same rule. (The TPU kernel lets
// a NaN take its tile's minimum and then drops the tile.)
//
// Outputs. swap_topk: vals (R, k) fp32, u and p (R, k) int32, ascending
// by (ΔL, p); rows with fewer than k feasible pairs end in +inf entries
// whose indices are clamped into [0, d-1] like the reference wrapper
// (ops.py:103). swap_argmin: best (R,) fp32, u and p (R,) int32. On
// feasible entries both equal the plain versions (swap_math.
// topk_swaps_chunked, best_swap_chunked) bit for bit: the rounded
// operations keep the plain version's order and values, and the library
// is built with -fmad=false. k <= 32 (one lane per list slot).
//
// What bounds it on an H100: the ΔL evaluations, issued on 128 fp32 lanes
// per SM. Of the R·d² pairs only those with u kept and p pruned are
// feasible (R·0.24·d² at PerRow(0.6)); the walk evaluates the kept-u
// share (R·0.4·d²) at about 6 instructions a pair (four operations and a
// min, and an entry and G row load shared by 8 columns). G moves from L2
// d²·4·R/RB bytes in all; from device memory about once. The selection
// evaluates ΔL at the tied columns only until the first hit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 1 << 30;              // index sentinel that loses every tie
constexpr int UC = 64;                    // u per chunk
constexpr int UH = UC / 32;               // ...a lane's share
constexpr int CW = 16;                    // consumer warps
constexpr int RPW = 2;                    // rows per consumer warp
constexpr int RB = CW * RPW;              // rows per block
constexpr int TP = 256;                   // columns per block (p-tile)
constexpr int CPL = TP / 32;              // columns per lane
constexpr int STAGES = 2;
constexpr int BOXC = 64;                  // TMA box: 64 columns x UC rows
constexpr int BOX_BYTES = BOXC * UC * 4;  // 16 KB
constexpr int STAGE_BYTES = (TP / BOXC) * BOX_BYTES;
constexpr int LIST = UC + 1;              // a row's list and a pad entry
constexpr int THREADS = (CW + 1) * 32;    // and a producer warp
constexpr int SMEM = STAGES * STAGE_BYTES + CW * RPW * LIST * 16 + 1024;
constexpr int MERGE_WARPS = 8;
constexpr int MERGE_SPAN = 256;           // u compacted at a time
constexpr int ARGMIN_K = 4;               // swap_argmin's list length
constexpr int TIE_CAP = 64;               // tied columns a row holds
constexpr int SEL_U = 4;                  // 32 u each, walked at once
constexpr float W_SAFE = 0x1p63f;         // |w| below: |w_u w_p| < 2^126
constexpr float G_SAFE = 0x1p127f;        // |g| below: 2 g is finite
// flags: what the preparation found
constexpr int UNSAFE = 1;                 // walk G itself, not 2 G
constexpr int ASYM = 2;                   // G != Gᵀ somewhere, to the bit
static_assert(CPL == 8, "lane columns: two float4 groups 128 apart");

// ΔL in the fixed order of swap_math._delta, one rounding per operation:
// (a_u + b_p) - (2 (w_u w_p)) g
__device__ __forceinline__ float delta_l(float au, float bp, float wu,
                                         float wp, float g) {
  const float inter = __fmul_rn(__fmul_rn(2.0f, __fmul_rn(wu, wp)), g);
  return __fsub_rn(__fadd_rn(au, bp), inter);
}

// (v1, i1) < (v2, i2) lexicographically
__device__ __forceinline__ bool lex2(float v1, int i1, float v2, int i2) {
  return v1 < v2 || (v1 == v2 && i1 < i2);
}

// column q of lane `lane` in a tile: 4 lane + q for q < 4, 128 more for the
// second group
__device__ __forceinline__ int lane_col(int lane, int q) {
  return (q >> 2) * 128 + 4 * lane + (q & 3);
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// ΔL from a doubled Gram entry g2 = 2 g: round(round(w_u w_p) · 2 g) is
// round(round(2 round(w_u w_p)) · g), delta_l's product, as long as
// neither doubling overflows (x2 is exact otherwise, subnormals too), so
// the value is delta_l's to the bit with one multiply fewer
__device__ __forceinline__ float delta_l2(float au, float bp, float wu,
                                          float wp, float g2) {
  return __fsub_rn(__fadd_rn(au, bp), __fmul_rn(__fmul_rn(wu, wp), g2));
}

// ΔL in the walk, from a stage of 2 G (FOLD) or of G
template <bool FOLD>
__device__ __forceinline__ float walk_dl(float au, float bp, float wu,
                                         float wp, float g) {
  return FOLD ? delta_l2(au, bp, wu, wp, g) : delta_l(au, bp, wu, wp, g);
}

// The consumer warps' walk of every chunk: per chunk and row, the list of
// kept u, then min over it per column. FOLD: the stages hold 2 G.
template <bool FOLD>
__device__ __forceinline__ void walk(const uint8_t* ring, float4* my,
                                     const uint64_t* full, uint64_t* empty,
                                     const float* __restrict__ a,
                                     const float* __restrict__ w, int R,
                                     int d, int row0, int warp, int lane,
                                     const float (&bp)[RPW][CPL],
                                     const float (&wp)[RPW][CPL],
                                     float (&m)[RPW][CPL]) {
  const int n_ch = (d + UC - 1) / UC;
  // a and w of u = chunk start + 32 h + lane, one chunk ahead
  float na[RPW][UH], nw[RPW][UH];
  auto load_aw = [&](int c) {
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int row = row0 + warp * RPW + j;
#pragma unroll
      for (int h = 0; h < UH; ++h) {
        const int u = c * UC + 32 * h + lane;
        const bool ok = row < R && u < d;
        const size_t off = (size_t)row * d + u;
        na[j][h] = ok ? a[off] : INFINITY;
        nw[j][h] = ok ? w[off] : 0.f;
      }
    }
  };
  load_aw(0);
  // the lane's float4 of a G row in a stage: box lane / 16 (and two boxes
  // on for the second group), bytes 16 (lane % 16) of the box's row
  const uint32_t lane_off = (lane >> 4) * BOX_BYTES + (lane & 15) * 16;
  const unsigned below = (1u << lane) - 1u;

  for (int c = 0; c < n_ch; ++c) {
    // compact each row's kept u of this chunk: (a_u, w_u, byte offset of
    // G row u in the stage), in ascending u, then a pad entry
    int cnt[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      cnt[j] = 0;
#pragma unroll
      for (int h = 0; h < UH; ++h) {
        const bool keep = na[j][h] < INFINITY;
        const unsigned bal = __ballot_sync(FULL, keep);
        if (keep)
          my[j * LIST + cnt[j] + __popc(bal & below)] =
              make_float4(na[j][h], nw[j][h],
                          __int_as_float((32 * h + lane) * BOXC * 4), 0.f);
        cnt[j] += __popc(bal);
      }
      if (lane == 0)
        my[j * LIST + cnt[j]] = make_float4(0.f, 0.f, __int_as_float(0), 0.f);
    }
    __syncwarp();
    if (c + 1 < n_ch) load_aw(c + 1);

    const int s = c % STAGES;
    mbar_wait(smem_addr(&full[s]), (c / STAGES) & 1);
    const uint8_t* tile = ring + s * STAGE_BYTES + lane_off;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const float4* lj = my + j * LIST;
      float4 e = lj[0];
      float4 g0 = *reinterpret_cast<const float4*>(tile + __float_as_int(e.z));
      float4 g1 = *reinterpret_cast<const float4*>(
          tile + 2 * BOX_BYTES + __float_as_int(e.z));
#pragma unroll 2
      for (int i = 0; i < cnt[j]; ++i) {
        // the next entry and its G row load while this one is evaluated
        const float4 en = lj[i + 1];
        const float4 h0 =
            *reinterpret_cast<const float4*>(tile + __float_as_int(en.z));
        const float4 h1 = *reinterpret_cast<const float4*>(
            tile + 2 * BOX_BYTES + __float_as_int(en.z));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          m[j][q] = fminf(m[j][q], walk_dl<FOLD>(e.x, bp[j][q], e.y,
                                                 wp[j][q], comp(g0, q)));
          m[j][4 + q] = fminf(m[j][4 + q],
                              walk_dl<FOLD>(e.x, bp[j][4 + q], e.y,
                                            wp[j][4 + q], comp(g1, q)));
        }
        e = en;
        g0 = h0;
        g1 = h1;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
swap_topk_partial_kernel(const __grid_constant__ CUtensorMap tm_fold,
                         const __grid_constant__ CUtensorMap tm_raw,
                         const int* __restrict__ flags,
                         const float* __restrict__ a,
                         const float* __restrict__ b,
                         const float* __restrict__ w,
                         float* __restrict__ part_v, int* __restrict__ part_p,
                         int R, int d, int k, int npt) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float4* lists = reinterpret_cast<float4*>(ring + STAGES * STAGE_BYTES);
  __shared__ __align__(8) uint64_t full[STAGES];    // a tile has landed
  __shared__ __align__(8) uint64_t empty[STAGES];   // ...and been walked

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * RB;
  const int p0 = blockIdx.y * TP;
  const int n_ch = (d + UC - 1) / UC;
  // the doubled Gram unless some |g| or |w| is too large for it (prep)
  const bool fold = (*flags & UNSAFE) == 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CW) {
    // the producer: refill a stage once every consumer warp is done with
    // it, STAGES - 1 chunks ahead of the slowest
    if (lane == 0) {
      const CUtensorMap* tm = fold ? &tm_fold : &tm_raw;
      for (int c = 0; c < n_ch; ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) mbar_wait(smem_addr(&empty[s]), (c / STAGES - 1) & 1);
        const uint32_t dst = smem_addr(ring + s * STAGE_BYTES);
        const uint32_t bar = smem_addr(&full[s]);
        mbar_expect(bar, STAGE_BYTES);
#pragma unroll
        for (int bx = 0; bx < TP / BOXC; ++bx)
          tma_load(dst + bx * BOX_BYTES, tm, p0 + bx * BOXC, c * UC, bar);
      }
    }
    return;
  }

  // b and w of the lane's columns for each of the warp's rows (+inf / 0
  // past R or d); the running minima start at +inf
  float bp[RPW][CPL], wp[RPW][CPL], m[RPW][CPL];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = row0 + warp * RPW + j;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int p = p0 + lane_col(lane, q);
      const bool ok = row < R && p < d;
      const size_t off = (size_t)row * d + p;
      bp[j][q] = ok ? b[off] : INFINITY;
      wp[j][q] = ok ? w[off] : 0.f;
      m[j][q] = INFINITY;
    }
  }

  float4* my = lists + warp * RPW * LIST;
  if (fold)
    walk<true>(ring, my, full, empty, a, w, R, d, row0, warp, lane, bp, wp, m);
  else
    walk<false>(ring, my, full, empty, a, w, R, d, row0, warp, lane, bp, wp,
                m);

  // per row, the k smallest (min, p) of the tile, one rank per round:
  // each lane offers its smallest untaken column, a shuffle reduction
  // picks the warp's; lane r keeps rank r. Columns past d rank last.
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = row0 + warp * RPW + j;
    if (row >= R) continue;  // warp-uniform
    unsigned taken = 0;
    float kv = INFINITY;
    int kp = BIG;
    for (int r = 0; r < k; ++r) {
      float mv = INFINITY;
      int mp = BIG;
      int mq = -1;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int pc = p0 + lane_col(lane, q);
        if (pc < d && !((taken >> q) & 1u) && lex2(m[j][q], pc, mv, mp)) {
          mv = m[j][q];
          mp = pc;
          mq = q;
        }
      }
      const int mine = mp;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, mv, off);
        const int op = __shfl_xor_sync(FULL, mp, off);
        if (lex2(ov, op, mv, mp)) {
          mv = ov;
          mp = op;
        }
      }
      if (mp < BIG && mp == mine) taken |= 1u << mq;
      if (lane == r) {
        kv = mv;
        kp = mp;
      }
    }
    if (lane < k) {
      const size_t o = ((size_t)row * npt + blockIdx.y) * k + lane;
      part_v[o] = kv;
      part_p[o] = kp;
    }
  }
}

__global__ void __launch_bounds__(MERGE_WARPS * 32)
swap_topk_merge_kernel(const float* __restrict__ part_v,
                       const int* __restrict__ part_p,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ w,
                       const float* __restrict__ G, int ldg,
                       const int* __restrict__ flags,
                       float* __restrict__ vals, int* __restrict__ u_out,
                       int* __restrict__ p_out, int R, int d, int k,
                       int npt) {
  __shared__ int2 s_buf[MERGE_WARPS][MERGE_SPAN];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (row >= R) return;  // warp-uniform
  const int n = npt * k;
  // G[u][p] is read as G[p][u], along a row, where G is symmetric
  const bool sym = (*flags & ASYM) == 0;
  const float* pv = part_v + (size_t)row * n;
  const int* pp = part_p + (size_t)row * n;

  // rank r: the smallest candidate after rank r - 1's (v, p); p is
  // distinct among real columns, and the (+inf, BIG) pads tie, so a rank
  // past the real candidates is (+inf, BIG) again
  float lv = -INFINITY;
  int lp = -1;
  float kv = INFINITY;
  int kp = BIG;
  for (int r = 0; r < k; ++r) {
    float mv = INFINITY;
    int mp = BIG;
    for (int t = lane; t < n; t += 32) {
      const float v = pv[t];
      const int p = pp[t];
      if (lex2(lv, lp, v, p) && lex2(v, p, mv, mp)) {
        mv = v;
        mp = p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, mv, off);
      const int op = __shfl_xor_sync(FULL, mp, off);
      if (lex2(ov, op, mv, mp)) {
        mv = ov;
        mp = op;
      }
    }
    if (lane == r) {
      kv = mv;
      kp = mp;
    }
    lv = mv;
    lp = mp;
  }

  // the lowest kept u whose ΔL equals each finite entry's minimum. Per 256
  // u: the kept ones compacted into the warp's buffer (u, a_u), ascending,
  // then walked 32 at a time, the G loads of up to 8 entries in flight
  const size_t rd = (size_t)row * d;
  const bool live = lane < k && kv < INFINITY;
  const float kb = live ? b[rd + kp] : 0.f;
  const float kw = live ? w[rd + kp] : 0.f;
  const unsigned below = (1u << lane) - 1u;
  int2* buf = s_buf[threadIdx.x >> 5];
  float ku_v = kv;
  int ku = 0;
  unsigned pending = __ballot_sync(FULL, live);
  for (int c0 = 0; pending != 0 && c0 < d; c0 += MERGE_SPAN) {
    int nk = 0;
#pragma unroll
    for (int t = 0; t < MERGE_SPAN / 32; ++t) {
      const int u = c0 + 32 * t + lane;
      const float au = u < d ? a[rd + u] : INFINITY;
      const bool keep = au < INFINITY;
      const unsigned bal = __ballot_sync(FULL, keep);
      if (keep) buf[nk + __popc(bal & below)] = make_int2(u, __float_as_int(au));
      nk += __popc(bal);
    }
    __syncwarp();
    for (int i0 = 0; pending != 0 && i0 < nk; i0 += 32) {
      const bool valid = i0 + lane < nk;
      const int2 e = valid ? buf[i0 + lane] : make_int2(0, 0);
      const int u = e.x;
      const float au = __int_as_float(e.y);
      const float wu = valid ? w[rd + u] : 0.f;
      for (int j0 = 0; j0 < 32 && (pending >> j0) != 0; j0 += 8) {
        float g[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int pj = __shfl_sync(FULL, kp, (j0 + t) & 31);
          const size_t at = sym ? (size_t)pj * ldg + u : (size_t)u * ldg + pj;
          g[t] = valid && ((pending >> (j0 + t)) & 1u) ? G[at] : 0.f;
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = j0 + t;
          if (!((pending >> j) & 1u)) continue;  // warp-uniform
          const float vj = __shfl_sync(FULL, kv, j);
          const float bj = __shfl_sync(FULL, kb, j);
          const float wj = __shfl_sync(FULL, kw, j);
          const float dl = delta_l(au, bj, wu, wj, g[t]);
          const unsigned hit = __ballot_sync(FULL, valid && dl == vj);
          if (hit != 0) {
            const int f = __ffs(hit) - 1;
            const float df = __shfl_sync(FULL, dl, f);
            const int uf = __shfl_sync(FULL, u, f);
            if (lane == j) {
              ku = uf;
              ku_v = df;
            }
            pending &= ~(1u << j);
          }
        }
      }
    }
    __syncwarp();  // the buffer is rewritten next
  }
  if (lane < k) {
    const size_t o = (size_t)row * k + lane;
    vals[o] = ku_v;
    u_out[o] = min(ku, d - 1);
    p_out[o] = min(kp, d - 1);
  }
}

// swap_argmin's selection (step 3 of the head note): one warp per row of
// the ARGMIN_K-entry lists of all npt p-tiles.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
swap_argmin_select_kernel(const float* __restrict__ part_v,
                          const int* __restrict__ part_p,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ w,
                          const float* __restrict__ G, int ldg,
                          const int* __restrict__ flags,
                          float* __restrict__ best, int* __restrict__ u_out,
                          int* __restrict__ p_out, int R, int d, int npt) {
  __shared__ float4 s_tie[MERGE_WARPS][TIE_CAP];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (row >= R) return;  // warp-uniform
  const int n = npt * ARGMIN_K;
  const float* pv = part_v + (size_t)row * n;
  const int* pp = part_p + (size_t)row * n;
  const size_t rd = (size_t)row * d;

  float vs = INFINITY;  // v*: the lists hold no NaN (fminf drops it)
  for (int t = lane; t < n; t += 32) vs = fminf(vs, pv[t]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    vs = fminf(vs, __shfl_xor_sync(FULL, vs, off));
  float bv = INFINITY;  // (+inf, 0, 0) where no pair is feasible
  int bu = 0, bp = 0;

  if (vs < INFINITY) {  // warp-uniform
    // S: the tied columns with their b and w; overflow where a tile's
    // list ends in v* or S outgrows its buffer
    float4* tie = s_tie[threadIdx.x >> 5];
    const unsigned below = (1u << lane) - 1u;
    int ns = 0;
    bool over = false;
    for (int t0 = 0; t0 < n; t0 += 32) {
      const int t = t0 + lane;
      const bool tied = t < n && pv[t] == vs;
      over |= tied && t % ARGMIN_K == ARGMIN_K - 1;
      const unsigned bal = __ballot_sync(FULL, tied);
      const int at = ns + __popc(bal & below);
      if (tied && at < TIE_CAP) {
        const int p = pp[t];
        tie[at] = make_float4(__int_as_float(p), b[rd + p], w[rd + p], 0.f);
      }
      ns += __popc(bal);
    }
    over = __any_sync(FULL, over) || ns > TIE_CAP;
    __syncwarp();

    // the kept u upwards, SEL_U at a time (their loads in flight at
    // once); at each, ΔL at S's columns (lanes over u) or at every column
    // (lanes over p, on overflow); the first u with a hit wins with its
    // smallest hit p
    const bool sym = (*flags & ASYM) == 0;
    bool found = false;
    for (int u0 = 0; u0 < d && !found; u0 += 32 * SEL_U) {
      float al[SEL_U];
#pragma unroll
      for (int h = 0; h < SEL_U; ++h) {
        const int ul = u0 + 32 * h + lane;
        al[h] = ul < d ? a[rd + ul] : INFINITY;
      }
      if (!over) {
        float wu[SEL_U], hv[SEL_U];
        int hp[SEL_U];
#pragma unroll
        for (int h = 0; h < SEL_U; ++h) {
          wu[h] = al[h] < INFINITY ? w[rd + u0 + 32 * h + lane] : 0.f;
          hp[h] = BIG;
          hv[h] = 0.f;
        }
        for (int j = 0; j < ns; ++j) {
          const float4 e = tie[j];
          const int pj = __float_as_int(e.x);
          float g[SEL_U];
#pragma unroll
          for (int h = 0; h < SEL_U; ++h) {
            const size_t ul = u0 + 32 * h + lane;
            g[h] = al[h] < INFINITY
                       ? G[sym ? pj * (size_t)ldg + ul : ul * ldg + pj]
                       : 0.f;
          }
#pragma unroll
          for (int h = 0; h < SEL_U; ++h) {
            const float dl = delta_l(al[h], e.y, wu[h], e.z, g[h]);
            if (dl == vs && pj < hp[h]) {
              hp[h] = pj;
              hv[h] = dl;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < SEL_U; ++h) {
          const unsigned hit = __ballot_sync(FULL, hp[h] < BIG);
          if (hit != 0 && !found) {
            const int f = __ffs(hit) - 1;
            bu = u0 + 32 * h + f;
            bp = __shfl_sync(FULL, hp[h], f);
            bv = __shfl_sync(FULL, hv[h], f);
            found = true;
          }
        }
        continue;
      }
      for (int h = 0; h < SEL_U && !found; ++h) {
        unsigned keep = __ballot_sync(FULL, al[h] < INFINITY);
        while (keep != 0 && !found) {
          const int f = __ffs(keep) - 1;
          keep &= keep - 1u;
          const int u = u0 + 32 * h + f;
          const float au = __shfl_sync(FULL, al[h], f);
          const float wu = w[rd + u];
          const float* gu = G + (size_t)u * ldg;
          for (int p0 = 0; p0 < d; p0 += 32) {
            const int p = p0 + lane;
            const float dl = p < d ? delta_l(au, b[rd + p], wu, w[rd + p],
                                             gu[p])
                                   : INFINITY;
            const unsigned hit = __ballot_sync(FULL, dl == vs);
            if (hit != 0) {
              const int hl = __ffs(hit) - 1;
              bu = u;
              bp = p0 + hl;
              bv = __shfl_sync(FULL, dl, hl);
              found = true;
              break;
            }
          }
        }
      }
    }
  }
  if (lane == 0) {
    best[row] = bv;
    u_out[row] = bu;
    p_out[row] = bp;
  }
}

constexpr int PT = 32;                    // preparation tile edge
constexpr int PREP_ROWS = 8;              // ...rows of it at a time
constexpr int PREP_THREADS = 32 * PREP_ROWS;
constexpr int PREP_BLOCKS = 8 * 132;      // grid-stride: 8 an H100 SM

// (I, J), I <= J, of tile pair b of the upper triangle, column by column
__device__ __forceinline__ void pair_of(int b, int& I, int& J) {
  J = static_cast<int>((sqrt(8.0 * b + 1.0) - 1.0) / 2.0);
  while (J * (J + 1) / 2 > b) --J;
  while ((J + 1) * (J + 2) / 2 <= b) ++J;
  I = b - J * (J + 1) / 2;
}

// One PT x PT tile of G at (r0, c0) into st, and 2 G (and G, where graw
// is not null) into the (d, ld) copies; true if some |g| is too large to
// double. PREP_THREADS threads, PT / PREP_ROWS rows each: every load is
// issued before the stores.
__device__ __forceinline__ bool prep_tile(const float* __restrict__ G,
                                          float* __restrict__ g2,
                                          float* __restrict__ graw, int d,
                                          int ld, int r0, int c0,
                                          float (&st)[PT][PT + 1]) {
  const int tx = threadIdx.x & 31;
  const int c = c0 + tx;
  float g[PT / PREP_ROWS];
#pragma unroll
  for (int i = 0; i < PT / PREP_ROWS; ++i) {
    const int r = r0 + (threadIdx.x >> 5) + PREP_ROWS * i;
    g[i] = r < d && c < d ? G[(size_t)r * d + c] : 0.f;
  }
  bool bad = false;
#pragma unroll
  for (int i = 0; i < PT / PREP_ROWS; ++i) {
    const int ty = (threadIdx.x >> 5) + PREP_ROWS * i;
    const int r = r0 + ty;
    bad |= !(fabsf(g[i]) < G_SAFE);
    st[ty][tx] = g[i];
    if (r < d && c < ld) {
      g2[(size_t)r * ld + c] = __fmul_rn(2.0f, g[i]);
      if (graw != nullptr) graw[(size_t)r * ld + c] = g[i];
    }
  }
  return bad;
}

// The Gram as the other kernels read it: 2 G into g2 (d rows of ld) and G
// itself into graw when that is not null (rows padded to ld). flags gets
// UNSAFE where doubling could change a product (some |g| >= 2^127 or
// |w| >= 2^63, or not a number) and ASYM where some G[i][j] and G[j][i]
// differ in their bits; it is zero on entry. Blocks take pairs of
// mirrored tiles, so each element is read once.
__global__ void __launch_bounds__(PREP_THREADS)
swap_topk_prep_kernel(const float* __restrict__ G,
                      const float* __restrict__ w, float* __restrict__ g2,
                      float* __restrict__ graw, int* __restrict__ flags,
                      int R, int d, int ld) {
  __shared__ float t1[PT][PT + 1];
  __shared__ float t2[PT][PT + 1];
  const int nt = (d + PT - 1) / PT;
  const int n_pairs = nt * (nt + 1) / 2;
  bool bad = false;
  bool asym = false;
  for (int bpair = blockIdx.x; bpair < n_pairs; bpair += gridDim.x) {
    int I, J;
    pair_of(bpair, I, J);
    bad |= prep_tile(G, g2, graw, d, ld, I * PT, J * PT, t1);
    if (I != J) bad |= prep_tile(G, g2, graw, d, ld, J * PT, I * PT, t2);
    __syncthreads();
    const float (&mirror)[PT][PT + 1] = I != J ? t2 : t1;
    for (int e = threadIdx.x; e < PT * PT; e += PREP_THREADS) {
      const int i = e / PT;
      const int j = e % PT;
      asym |= __float_as_int(t1[i][j]) != __float_as_int(mirror[j][i]);
    }
    __syncthreads();
  }
  const size_t nw = (size_t)R * d;
  for (size_t i = blockIdx.x * (size_t)PREP_THREADS + threadIdx.x; i < nw;
       i += (size_t)gridDim.x * PREP_THREADS)
    bad |= !(fabsf(w[i]) < W_SAFE);
  if (bad) atomicOr(flags, UNSAFE);
  if (asym) atomicOr(flags, ASYM);
}

size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

// scratch: part_v, part_p, the flags, 2 G, and G padded where its
// rows are not 16-byte aligned (each piece 256-byte aligned)
struct Scratch {
  size_t part, flag, g2, graw, total;
};

Scratch layout(int R, int d, int k, const void* G) {
  const size_t npt = (d + TP - 1) / TP;
  const size_t part = round_up((size_t)R * npt * k * 4, 256);
  const size_t gbytes = round_up((size_t)d * round_up(d, 4) * 4, 256);
  const bool pad = d % 4 != 0 || reinterpret_cast<uintptr_t>(G) % 16 != 0;
  Scratch s;
  s.part = part;
  s.flag = 2 * part;
  s.g2 = s.flag + 256;
  s.graw = pad ? s.g2 + gbytes : 0;
  s.total = s.g2 + gbytes + (pad ? gbytes : 0);
  return s;
}

int fail_code() {
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : static_cast<int>(cudaErrorInvalidValue);
}

// Where a call's pieces of scratch lie, and the Gram the last kernel reads
struct Parts {
  float* part_v;
  int* part_p;
  int* flags;
  const float* g;  // G, or its padded copy
  int ldg;
  int npt;
};

// The preparation and the partial search with lists of k, shared by both
// searches; returns cudaGetLastError().
int prep_and_partial(const void* a, const void* b, const void* w,
                     const void* G, void* scratch, int R, int d, int k,
                     cudaStream_t st, Parts* out) {
  static bool ready = false;
  if (!ready) {
    if (cudaFuncSetAttribute(swap_topk_partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM) != cudaSuccess)
      return fail_code();
    ready = true;
  }
  const int npt = (d + TP - 1) / TP;
  const int ld = static_cast<int>(round_up(d, 4));
  const Scratch lay = layout(R, d, k, G);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  float* g2 = reinterpret_cast<float*>(sc + lay.g2);
  float* graw = lay.graw ? reinterpret_cast<float*>(sc + lay.graw) : nullptr;
  Parts q;
  q.part_v = reinterpret_cast<float*>(sc);
  q.part_p = reinterpret_cast<int*>(sc + lay.part);
  q.flags = reinterpret_cast<int*>(sc + lay.flag);
  q.g = graw ? graw : static_cast<const float*>(G);
  q.ldg = graw ? ld : d;
  q.npt = npt;
  *out = q;
  if (cudaMemsetAsync(q.flags, 0, sizeof(int), st) != cudaSuccess)
    return fail_code();
  swap_topk_prep_kernel<<<PREP_BLOCKS, PREP_THREADS, 0, st>>>(
      static_cast<const float*>(G), static_cast<const float*>(w), g2, graw,
      q.flags, R, d, ld);
  CUtensorMap tm_fold, tm_raw;
  if (!tensor_map(&tm_fold, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, g2, d, d,
                  4ull * ld, UC, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&tm_raw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, q.g, d, d,
                  4ull * q.ldg, UC, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + RB - 1) / RB, npt);
  swap_topk_partial_kernel<<<grid, THREADS, SMEM, st>>>(
      tm_fold, tm_raw, q.flags, static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(w), q.part_v,
      q.part_p, R, d, k, npt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of device scratch swap_topk_search needs for these arguments: the
// partial lists (values and columns), a flag, the doubled Gram, and a
// padded copy of G when its rows are not 16-byte aligned.
size_t swap_topk_scratch_bytes(int R, int d, int k, const void* G) {
  if (k < 1 || k > 32 || R < 1 || d < 1) return 0;
  return layout(R, d, k, G).total;
}

// a, b, w: (R, d) fp32 row-major, +inf at infeasible a/b entries;
// G: (d, d) fp32 row-major. vals: (R, k) fp32; u, p: (R, k) int32;
// scratch: swap_topk_scratch_bytes(R, d, k, G) bytes, 256-byte aligned.
// 1 <= k <= 32. Launches the Gram's preparation, the partial search and
// the merge on the stream; returns cudaGetLastError().
int swap_topk_search(const void* a, const void* b, const void* w,
                     const void* G, void* vals, void* u, void* p,
                     void* scratch, int R, int d, int k, void* stream) {
  if (k < 1 || k > 32 || R < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Parts q;
  const int err = prep_and_partial(a, b, w, G, scratch, R, d, k, st, &q);
  if (err != 0) return err;
  swap_topk_merge_kernel<<<(R + MERGE_WARPS - 1) / MERGE_WARPS,
                           MERGE_WARPS * 32, 0, st>>>(
      q.part_v, q.part_p, static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(w), q.g, q.ldg,
      q.flags, static_cast<float*>(vals), static_cast<int*>(u),
      static_cast<int*>(p), R, d, k, q.npt);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of device scratch swap_argmin_search needs: as swap_topk's with
// lists of ARGMIN_K.
size_t swap_argmin_scratch_bytes(int R, int d, const void* G) {
  if (R < 1 || d < 1) return 0;
  return layout(R, d, ARGMIN_K, G).total;
}

// a, b, w, G as swap_topk_search. best: (R,) fp32; u, p: (R,) int32;
// scratch: swap_argmin_scratch_bytes(R, d, G) bytes, 256-byte aligned.
// Launches the preparation, the partial search and the selection on the
// stream; returns cudaGetLastError().
int swap_argmin_search(const void* a, const void* b, const void* w,
                       const void* G, void* best, void* u, void* p,
                       void* scratch, int R, int d, void* stream) {
  if (R < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Parts q;
  const int err = prep_and_partial(a, b, w, G, scratch, R, d, ARGMIN_K, st,
                                   &q);
  if (err != 0) return err;
  swap_argmin_select_kernel<<<(R + MERGE_WARPS - 1) / MERGE_WARPS,
                              MERGE_WARPS * 32, 0, st>>>(
      q.part_v, q.part_p, static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(w), q.g, q.ldg,
      q.flags, static_cast<float*>(best), static_cast<int*>(u),
      static_cast<int*>(p), R, d, q.npt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
