// y = act(x @ (mask ⊙ W)ᵀ + b) from packed sparse weights, for serving.
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmm.py::_spmm_kernel
// (_spmm_padded). There every (slot tile, d tile) grid step expands its
// packed slots into a dense (TO, TD) sub-tile in VMEM and feeds the MXU.
// Both formats are one scheme: slot s of row o has the absolute column
// (s / n) * m + idx[o, s] (nm24, uint8 within-block idx) or idx[o, s]
// (gathered, int32). Products and sums are fp32; bias and activation run
// on the fp32 sum; one cast to x's dtype at the store.
//
// bf16 nm24 (2:4, d_in % 16 == 0), the serving path: spmm_nm24_kernel.
// A block owns 128 output rows and BN tokens (8 for decode, T <= 8; 128
// for prefill) and walks its share of d_in in tiles of 128 columns
// through a ring of S = 4 shared-memory stages (decode 26 KB each,
// prefill 56 KB; one block per SM). A producer warp fills the ring with
// the TMA: per tile one 2-D box of packed values (128 rows x 64 slots,
// 16 KB), one of uint8 positions (8 KB; where k % 16 != 0 the producer
// copies them 8 bytes at a time with cp.async instead) and two of x
// (BN tokens x 64 columns each), all completing on the stage's "full"
// mbarrier; the boxes' parts past d_out, n_tok or d_in arrive as zeros.
// It refills a stage once all multiplying warps have arrived on its
// "empty" mbarrier, so up to S tiles (decode ~100 KB, prefill ~220 KB
// per SM) are in flight or waiting, and no barrier ties the warps
// together within the loop. The boxes are swizzled (128-byte mode for
// values and x, 64-byte for positions) so each fragment read hits
// distinct banks. Nothing is scattered into a dense tile: each of the 8
// multiplying warps builds its mma.sync m16n8k16 A fragments in
// registers from the staged pairs. Lane (g, tq) needs rows g and g+8 at
// dense columns 2tq, 2tq+1, 2tq+8, 2tq+9 of a 16-column step; each
// column pair lies in one 4-column block at offset o = 2(tq & 1), and
// that block's two kept slots (v0 at p0, v1 at p1) give the pair's
// 32-bit word as shl(v0, 16(p0 - o)) | shl(v1, 16(p1 - o)), PTX's shl
// clamping shifts of 32 or more (and the wrapped negative ones) to 0.
// The same read checks the format's contract (p0 < p1 < 4) and flags the
// row. B fragments come from the staged x (ldmatrix at prefill). Each
// warp owns 16 rows: decode 16 x 8 tokens, prefill 16 x 128 tokens (each
// A fragment built once per block).
//
// bf16 gathered (d_in % 8 == 0), PerRow masks: spmm_gather_kernel. A
// block owns 128 output rows and BN tokens (8 / 128) and walks its split's
// 128-column tiles, as nm24 does. A row's slots are contiguous but fall
// into the tiles in varying counts, so no fixed box fetches a tile's
// slots. Each row has two rings in shared memory (its values, its
// columns; decode 184 slots, prefill 112), streamed along the row by bulk
// copies of whole aligned 16-byte chunks: a row's copies never go past
// its split's slots or come back to them, so each slot is read from
// device memory once, and rows need no 16-byte alignment (an odd K gives
// 2-byte aligned value rows), since the chunks are aligned in memory, not
// in the row. 8 scatter warps own 16 rows each, two lanes a row: per tile
// each row walks its slots in rounds of 16 (8 a lane, read without
// wrapping, since each ring is followed by a copy of its start), takes
// them in order while they have landed and stay below the tile's end,
// checks each column against the one before, and writes each value into
// its column of the row of a dense A tile (rows of 256 B with 16-byte
// chunks swizzled by row, so ldmatrix reads hit distinct banks; zeroed
// first). 8 multiplying warps run the same chain of mma.sync m16n8k16
// over 16-column steps as nm24 (A by ldmatrix from the dense tile, B from
// x, which a producer warp streams by TMA through a ring of stages; decode
// 4, prefill 2) on each tile once every scatter warp has filled it (full
// and empty mbarriers over 2 A tiles). Each multiplying warp also copies
// for one scatter warp, which hands over its rows' cursors after each
// tile (the copier refills their rings to capacity, 3 refills in flight;
// a tile reads what the older ones brought): the multiplying warps wait
// most of the time, and a bulk copy is issued one lane at a time. A row
// that owes slots it does not have waits for the later refills, or hands
// over again for an urgent one (a fully kept row has 128 slots a tile),
// so no mask can deadlock it. A split's slot range is [first slot >= its
// first column, first slot >= its end), found from 128 slots read around
// the expected slot (and a 32-ary search where that misses), so every
// slot belongs to exactly one split and is checked there.
// launch/profile_spmm.py times the kernel beside copies of it without the
// scatter's stores, without the MMAs, with nothing but the copies, and
// with nothing but the MMAs; PERF.md has the numbers and the designs
// tried before this one.
//
// Stacked weights (MoE experts): spmm_run_stacked takes x (E, T, d_in),
// values and idx (E, d_out, K) and y (E, T, d_out), and replaces
// src/repro/kernels/spmm.py::spmm_stacked, a vmap of the kernel over
// experts. Every kernel takes the expert from blockIdx.z (the fp32 one:
// z = e; the tensor-core ones: z = e * splits + split), offsets its
// pointers by it and reads its TMA boxes from 3-D tensor maps whose third
// coordinate is the expert, so a box never crosses into the next expert's
// tokens or rows. Every expert runs the split plan of an unstacked call
// of its shapes, hence the same MMA chains and reduction: each expert's y
// is bitwise the unstacked call's on its slice, and nm24 == gathered
// holds per expert. One stacked call is one launch of each kernel (and
// of the split reduction, over all experts).
//
// Split d_in: when the row blocks are too few for one block per SM,
// d_in is split over blockIdx.z and a second kernel (counted with the
// first as one launch of spmm) adds the fp32 partials in split order,
// then applies the epilogue. The plan (plan_for) is one function of the
// shapes for both formats: splits of whole 128-column tiles, as many as
// fit one block per SM over the 128-row blocks, and no more than keep
// the scratch's write and read (splits x T x d_out x 8 bytes) within the
// nm24 weight bytes (at T = 128: none at w_gate, 4 splits and 17 MB
// against 88 MB at w_down). nm24 and gathered packings of one 2:4 mask
// give bitwise equal y: both run, for every output element and split,
// the same chain of m16n8k16 MMAs over the same dense A and B fragments
// in ascending 16-column steps (steps at or past d_in skipped), starting
// from 0, and the same reduction; the sum order depends only on the
// shapes, never on timing (no atomics). The tile widths and warp layouts
// differ between the kernels, which does not change any chain.
//
// fp32, or shapes the tensor-core kernels do not take: the CUDA-core
// kernel spmm_fma_kernel. A block of 8 warps owns 8 * RPW rows and TT
// tokens, stages x[tokens, d tile] transposed in shared memory as fp32,
// and lane l owns the slots l, l+32, ... of each of its rows, walking
// them with a cursor and a register ring of prefetched (column, value)
// pairs. Each lane sums its slots in slot order; the lanes meet in a
// fixed shuffle tree.
//
// The format's one contract, for every kernel: each row's columns
// ascend strictly within [0, d_in) (nm24: positions below m, ascending
// within each block), as packing emits them. A row that breaks it is
// flagged as its slots are read and comes out NaN, whatever the
// epilogue; nothing reads x out of order.
//
// What bounds it on an H100: the packed weight is read once per launch,
// against 2·T·d_out·K FLOP, so every serving shape is bytes-bound on
// paper: nm24 1.5 bytes per dense element at 2:4 (88 MB at w_gate, 0.026
// ms at 3.35 TB/s); gathered 6 bytes a kept slot (a bf16 value and an
// int32 column), 141 MB at PerRow(0.6), 1.2x dense bf16 (0.042 ms), and
// 176 MB on a 2:4 mask. nm24's TMA ring streams its boxes at 64-67% of
// the bound. gathered is held back by work the bound does not count: the
// scatter warps' walk (a tile's slots found and placed row by row, a
// column check each; 65-71% of a scatter warp's clocks on an H100 by
// clock counters) and the refills' per-lane bulk copies, which its
// streaming alone needs 0.08 ms for at w_gate T = 4 (PERF.md has the
// numbers, from launch/profile_spmm.py). At prefill both kernels also re-read x (1 MB
// at w_gate) from L2 in every block, nm24's A fragments take ~30 integer
// instructions to build, gathered's A tiles are written and read through
// shared memory, and mma.sync multiplies the dense fragment, zeros
// included (2x the useful FLOP at 2:4, 2.5x at PerRow(0.6)).
// 2:4 sparse MMA (mma.sp, the positions as metadata) would halve the
// multiply and drop the build, but it groups its products otherwise than
// two dense k16 steps, so nm24 would no longer equal gathered bit for
// bit; it is not used yet. Nor is wgmma (its sums are not shown to equal
// mma.sync's either).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (contraction
// allowed: the CUDA-core products use fmaf; repro_torch.kernels.build).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <limits.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;               // CUDA-core kernel: threads per block
constexpr int NW = NT / 32;

enum Act { ACT_NONE = 0, ACT_SILU, ACT_GELU, ACT_RELU, ACT_RELU2,
           ACT_SIGMOID };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int col_of(const uint8_t* irow, int s, int n,
                                      int m) {
  return (s / n) * m + static_cast<int>(irow[s]);
}
__device__ __forceinline__ int col_of(const int32_t* irow, int s, int, int) {
  return irow[s];
}

// slot s of a row holds column c: does it keep the row's columns
// strictly ascending within [0, d_in)?
__device__ __forceinline__ bool slot_ok(const uint8_t* irow, int s, int,
                                        int n, int m, int) {
  return irow[s] < m && (s % n == 0 || irow[s - 1] < irow[s]);
}
__device__ __forceinline__ bool slot_ok(const int32_t* irow, int s, int c,
                                        int, int, int d_in) {
  return c >= 0 && c < d_in && (s == 0 || irow[s - 1] < c);
}

// relu keeps a NaN (a flagged row) NaN, as torch.relu does; fmaxf would not
__device__ __forceinline__ float epilogue(float v, int act) {
  switch (act) {
    case ACT_SILU:
      return v / (1.0f + expf(-v));
    case ACT_GELU: {  // tanh form (jax.nn.gelu's default)
      const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.0f + tanhf(k0 * (v + 0.044715f * v * v * v)));
    }
    case ACT_RELU:
      return v < 0.0f ? 0.0f : v;
    case ACT_RELU2: {
      const float r = v < 0.0f ? 0.0f : v;
      return r * r;
    }
    case ACT_SIGMOID:
      return 1.0f / (1.0f + expf(-v));
    default:
      return v;
  }
}

// TT tokens per block, RPW rows per warp, PF slots prefetched per row,
// TD columns of d_in per shared-memory tile.
template <int TT, int RPW, int PF, int TD, typename TX, typename TI>
__global__ void __launch_bounds__(NT)
spmm_fma_kernel(const TX* __restrict__ x, const TX* __restrict__ vals,
            const TI* __restrict__ idx, const float* __restrict__ bias,
            TX* __restrict__ y, int n_tok, int d_in, int d_out, int K,
            int n, int m, int act) {
  constexpr int XS = TT >= 8 ? TT + 4 : TT;  // padded column stride
  constexpr int RB = NW * RPW;
  __shared__ __align__(16) float xs[TD][XS];
  __shared__ float ys[TT][RB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * TT;
  const int r0 = blockIdx.y * RB;
  const int rw = r0 + warp * RPW;           // this warp's first row
  x += (size_t)blockIdx.z * n_tok * d_in;   // the expert (0 unstacked)
  vals += (size_t)blockIdx.z * d_out * K;
  idx += (size_t)blockIdx.z * d_out * K;
  y += (size_t)blockIdx.z * n_tok * d_out;

  float acc[RPW][TT];
  int cur[RPW];                              // slot of ring entry 0
  int rc[RPW][PF];                           // ring: columns (INT_MAX = end)
  float rv[RPW][PF];                         // ring: values
  bool bad[RPW];                             // a slot broke the contract
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    cur[i] = lane;
    bad[i] = false;
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[i][t] = 0.0f;
    const int row = rw + i;
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int s = lane + 32 * j;
      if (row < d_out && s < K) {
        const TI* irow = idx + (size_t)row * K;
        rc[i][j] = col_of(irow, s, n, m);
        rv[i][j] = to_f32(vals[(size_t)row * K + s]);
        bad[i] |= !slot_ok(irow, s, rc[i][j], n, m, d_in);
      } else {
        rc[i][j] = INT_MAX;
        rv[i][j] = 0.0f;
      }
    }
  }

  for (int d0 = 0; d0 < d_in; d0 += TD) {
    const int d1 = min(d0 + TD, d_in);
    __syncthreads();                          // last tile's reads are done
    for (int e = threadIdx.x; e < TT * TD; e += NT) {
      const int t = e / TD;
      const int c = e - t * TD;
      const int tok = t0 + t;
      const int col = d0 + c;
      xs[c][t] = (tok < n_tok && col < d_in)
                     ? to_f32(x[(size_t)tok * d_in + col]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = rw + i;
      if (row >= d_out) continue;             // uniform across the warp
      const TI* irow = idx + (size_t)row * K;
      const TX* vrow = vals + (size_t)row * K;
      while (rc[i][0] < d1) {
        const int c = rc[i][0];
        const float v = rv[i][0];
        if (c >= d0) {                        // else a flagged slot
          const float* xr = &xs[c - d0][0];
#pragma unroll
          for (int t = 0; t < TT; t += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + t);
            acc[i][t] = fmaf(v, xv.x, acc[i][t]);
            acc[i][t + 1] = fmaf(v, xv.y, acc[i][t + 1]);
            acc[i][t + 2] = fmaf(v, xv.z, acc[i][t + 2]);
            acc[i][t + 3] = fmaf(v, xv.w, acc[i][t + 3]);
          }
        }
#pragma unroll
        for (int j = 0; j + 1 < PF; ++j) {
          rc[i][j] = rc[i][j + 1];
          rv[i][j] = rv[i][j + 1];
        }
        cur[i] += 32;
        const int s = cur[i] + 32 * (PF - 1);
        if (s < K) {
          rc[i][PF - 1] = col_of(irow, s, n, m);
          rv[i][PF - 1] = to_f32(vrow[s]);
          bad[i] |= !slot_ok(irow, s, rc[i][PF - 1], n, m, d_in);
        } else {
          rc[i][PF - 1] = INT_MAX;
          rv[i][PF - 1] = 0.0f;
        }
      }
    }
  }

  // the 32 lane sums of each (row, token) in a fixed tree
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const bool flagged = __any_sync(0xffffffffu, bad[i]);
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      float v = acc[i][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0)
        ys[t][warp * RPW + i] = flagged ? __int_as_float(0x7fc00000) : v;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TT * RB; e += NT) {
    const int t = e / RB;
    const int r = e - t * RB;
    const int tok = t0 + t;
    const int row = r0 + r;
    if (tok >= n_tok || row >= d_out) continue;
    float v = ys[t][r];
    if (bias != nullptr) v += bias[row];
    store(&y[(size_t)tok * d_out + row], epilogue(v, act));
  }
}

template <int TT, int RPW, int PF, int TD, typename TX, typename TI>
int launch_tt(const void* x, const void* vals, const void* idx,
              const void* bias, void* y, int n_exp, int n_tok, int d_in,
              int d_out, int K, int n, int m, int act, cudaStream_t stream) {
  constexpr int RB = NW * RPW;
  dim3 grid((n_tok + TT - 1) / TT, (d_out + RB - 1) / RB, n_exp);
  spmm_fma_kernel<TT, RPW, PF, TD, TX, TI><<<grid, NT, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(vals),
      static_cast<const TI*>(idx), static_cast<const float*>(bias),
      static_cast<TX*>(y), n_tok, d_in, d_out, K, n, m, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TI>
int launch_fma(const void* x, const void* vals, const void* idx,
               const void* bias, void* y, int n_exp, int n_tok, int d_in,
               int d_out, int K, int n, int m, int act, cudaStream_t s) {
  if (n_tok <= 4)        // decode: 4 tokens, more blocks, deep prefetch
    return launch_tt<4, 2, 8, 2048, TX, TI>(x, vals, idx, bias, y, n_exp,
                                            n_tok, d_in, d_out, K, n, m, act,
                                            s);
  return launch_tt<16, 4, 2, 512, TX, TI>(x, vals, idx, bias, y, n_exp,
                                          n_tok, d_in, d_out, K, n, m, act,
                                          s);
}

// ---------------------------------------------------------------------------
// tensor-core kernels (bf16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---- nm24: a ring of packed tiles filled by TMA, A fragments built in
// registers

constexpr int NM_BM = 128;               // rows of a block
constexpr int NM_BK = 128;               // columns of a staged tile

// A stage, as the TMA writes it (boxes of 64 slots or columns, rows of
// 128 B swizzled in 128-byte mode, rows of positions (64 B) in 64-byte
// mode, so the 8 rows a fragment read touches hit distinct banks).
template <int BN>
struct NmStage {
  static constexpr int V = 0;                       // values, 128 x 128 B
  static constexpr int I = NM_BM * 128;             // positions, 128 x 64 B
  static constexpr int X = I + NM_BM * 64;          // x: 2 halves of
  static constexpr int XH = BN * 128;               // BN x 64 columns
  static constexpr int BYTES = X + 2 * XH;          // a multiple of 1 KB
};

// byte offset of 16-byte chunk c of row r in 64-byte swizzle mode (in
// 128-byte mode: r * 128 + ((c ^ (r & 7)) << 4))
__device__ __forceinline__ int sw64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// 8 bytes by cp.async (zero fill when n = 0): positions whose rows are
// not 16-byte aligned (k % 16 != 0), which the TMA cannot read
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

// Start the copies of one tile (columns [k0, k0 + NM_BK)) of expert e
// into a stage, by the producer warp (idx: the expert's positions):
// lane 0 sends the TMA boxes of values, positions (idx_tma) and the two
// halves of x, all completing on the stage's mbarrier; without idx_tma
// the lanes first copy the positions 8 bytes at a time (zero fill past
// the edges, as the TMA does), the mbarrier tracking their completion
// too.
template <int BN>
__device__ __forceinline__ void nm_stage(uint8_t* st, uint32_t bar,
                                         const CUtensorMap* tm_v,
                                         const CUtensorMap* tm_i,
                                         const CUtensorMap* tm_x,
                                         const uint8_t* idx, int r0, int t0,
                                         int k0, int e, int d_out, int K,
                                         int lane, bool idx_tma) {
  using St = NmStage<BN>;
  const uint32_t sv = smem_addr(st);
  const int s0 = k0 / 2;                 // the tile's first slot
  if (!idx_tma) {
    for (int e = lane; e < NM_BM * 8; e += 32) {
      const int r = e >> 3, c8 = e & 7;  // row, 8-slot piece
      const int row = r0 + r, s = s0 + 8 * c8;
      const bool ok = row < d_out && s < K;
      cp_async8(sv + St::I + sw64(r, c8 >> 1) + 8 * (c8 & 1),
                ok ? static_cast<const void*>(idx + (size_t)row * K + s)
                   : static_cast<const void*>(idx), ok ? 8 : 0);
    }
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
    __syncwarp();
  }
  if (lane == 0) {
    mbar_expect(bar, St::I + (idx_tma ? NM_BM * 64 : 0) + 2 * St::XH);
    tma_load3(sv + St::V, tm_v, s0, r0, e, bar);
    if (idx_tma) tma_load3(sv + St::I, tm_i, s0, r0, e, bar);
    tma_load3(sv + St::X, tm_x, k0, t0, e, bar);
    tma_load3(sv + St::X + St::XH, tm_x, k0 + NM_BK / 2, t0, e, bar);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& d0,
                                        uint32_t& d1, uint32_t& d2,
                                        uint32_t& d3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3) : "r"(addr));
}

// v << s with shifts of 32 or more giving 0 (PTX clamps them; C++ would not)
__device__ __forceinline__ uint32_t shl_clamp(uint32_t v, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(s));
  return r;
}

// The dense bf16 pair at offsets (o, o + 1) of a 4-column block whose two
// kept values v (v0 low, v1 high) sit at positions p0 < p1; o16 = 16 o.
__device__ __forceinline__ uint32_t dense_pair(uint32_t v, uint32_t p0,
                                               uint32_t p1, uint32_t o16) {
  return shl_clamp(v & 0xffffu, 16 * p0 - o16) |
         shl_clamp(v >> 16, 16 * p1 - o16);
}

// The 16-column steps [0, n) of one staged tile: per step, each warp
// builds its A fragments from the staged pairs (flagging rows whose
// positions break the contract), reads its B fragments of x, and runs
// its MMAs. FULL: n = NM_BK / 16, unrolled without branches so the
// compiler can load step j + 1 while step j multiplies.
template <bool FULL, int BN, int MT, int NTL>
__device__ __forceinline__ void nm_steps(const uint8_t* st, int n,
                                         float (&acc)[MT][NTL][4],
                                         bool (&flag)[MT][2], int rl0,
                                         int tl0, int lane) {
  using St = NmStage<BN>;
  const int g = lane >> 2, tq = lane & 3;
  // lane (g, tq) reads blocks h and h + 2 of each step, at offset
  // o = 2 (tq & 1) in the block
  const int h = tq >> 1;
  const uint32_t o16 = 32u * (tq & 1);
  const uint32_t psel = h ? 0x7632u : 0x5410u;
  // The lane's rows are rl0 + g + 8 m (rl0 a multiple of 16), so every one
  // has the swizzle key g (128-byte mode) and g / 2 (64-byte mode); its
  // tokens likewise (ldmatrix: the lane's row lane % 8 of a matrix).
  const uint8_t* vb = st + St::V + (rl0 + g) * 128 + 4 * h;
  const uint8_t* ib = st + St::I + (rl0 + g) * 64;
  const int q = lane >> 3;
  const uint8_t* xb = NTL % 2 == 0
      ? st + St::X + (tl0 + (q >> 1) * 8 + (lane & 7)) * 128
      : st + St::X + (tl0 + g) * 128 + 4 * tq;
#pragma unroll
  for (int j = 0; j < (FULL ? NM_BK / 16 : n); ++j) {
    uint32_t a[MT][4], b[NTL][2];
    const int vo = (j ^ g) << 4;
    const int io = (((j >> 1) ^ (g >> 1)) << 4) + 8 * (j & 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {     // rows g and g + 8
        const int m8 = 2 * mt + hf;
        const uint8_t* vr = vb + m8 * 8 * 128 + vo;
        const uint2 iw =
            *reinterpret_cast<const uint2*>(ib + m8 * 8 * 64 + io);
        // positions [p0, p1] of block h, then [q0, q1] of block h + 2
        const uint32_t X = __byte_perm(iw.x, iw.y, psel);
        const uint32_t p0 = X & 0xffu, p1 = (X >> 8) & 0xffu;
        const uint32_t q0 = (X >> 16) & 0xffu, q1 = X >> 24;
        flag[mt][hf] |= !(p0 < p1 && p1 < 4u && q0 < q1 && q1 < 4u);
        a[mt][hf] = dense_pair(ld32(vr), p0, p1, o16);
        a[mt][hf + 2] = dense_pair(ld32(vr + 8), q0, q1, o16);
      }
    }
    // x: half j / 4 of the tile, chunks 2 (j % 4) and 2 (j % 4) + 1
    const uint8_t* xh = xb + (j >> 2) * St::XH;
    if constexpr (NTL % 2 == 0) {        // two token octets per ldmatrix
      const int xo = ((2 * (j & 3) + (q & 1)) ^ (lane & 7)) << 4;
#pragma unroll
      for (int n8 = 0; n8 < NTL; n8 += 2)
        ldsm_x4(smem_addr(xh + n8 * 8 * 128 + xo), b[n8][0], b[n8][1],
                b[n8 + 1][0], b[n8 + 1][1]);
    } else {
      const int xo0 = ((2 * (j & 3)) ^ g) << 4;
      const int xo1 = ((2 * (j & 3) + 1) ^ g) << 4;
#pragma unroll
      for (int n8 = 0; n8 < NTL; ++n8) {
        b[n8][0] = ld32(xh + n8 * 8 * 128 + xo0);
        b[n8][1] = ld32(xh + n8 * 8 * 128 + xo1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n8 = 0; n8 < NTL; ++n8) mma16816(acc[mt][n8], a[mt], b[n8]);
  }
}

// multiplying warps of an nm24 block with (WM, WN) warp tiles; one more
// warp produces
template <int BN, int WM, int WN>
__host__ __device__ constexpr int nm_warps() {
  return (NM_BM / WM) * (BN / WN);
}

template <int BN, int WM, int WN, int S>
__global__ void __launch_bounds__(32 * (nm_warps<BN, WM, WN>() + 1), 1)
spmm_nm24_kernel(const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_i,
                 const __grid_constant__ CUtensorMap tm_x,
                 const uint8_t* __restrict__ idx,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                 int n_tok, int d_in, int d_out, int K, int act,
                 int tiles_per_split, int idx_tma, int splits) {
  constexpr int MT = WM / 16;
  constexpr int NTL = WN / 8;
  constexpr int CW = nm_warps<BN, WM, WN>();   // multiplying warps
  static_assert(S >= 3, "a ring of at least three stages");
  static_assert(BN * (NM_BM + 4) * 4 <= S * NmStage<BN>::BYTES,
                "the epilogue's (token, row) sums fit in the ring");
  using St = NmStage<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzled boxes want 1 KB aligned stages
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __shared__ int bad[NM_BM];
  __shared__ __align__(8) uint64_t full[S];    // a stage's tile has landed
  __shared__ __align__(8) uint64_t empty[S];   // ...and has been multiplied

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * NM_BM;
  const int t0 = blockIdx.y * BN;
  const int n_kt = (d_in + NM_BK - 1) / NM_BK;
  const int e = blockIdx.z / splits;         // the expert (0 unstacked)
  const int kt0 = (blockIdx.z - e * splits) * tiles_per_split;
  const int nt = min(tiles_per_split, n_kt - kt0);
  idx += (size_t)e * d_out * K;
  y += (size_t)e * n_tok * d_out;

  for (int i = tid; i < NM_BM; i += 32 * (CW + 1)) bad[i] = 0;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CW) {
    // the producer: refill a stage once every multiplying warp is done
    // with it, S - 1 tiles ahead of the slowest
    for (int i = 0; i < nt; ++i) {
      const int s = i % S;
      if (i >= S) mbar_wait(smem_addr(&empty[s]), (i / S - 1) & 1);
      nm_stage<BN>(ring + s * St::BYTES, smem_addr(&full[s]), &tm_v, &tm_i,
                   &tm_x, idx, r0, t0, (kt0 + i) * NM_BK, e, d_out, K, lane,
                   idx_tma);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int g = lane >> 2;
  const int warp_m = warp % (NM_BM / WM);
  const int warp_n = warp / (NM_BM / WM);
  float acc[MT][NTL][4];
  bool flag[MT][2];
#pragma unroll
  for (int a = 0; a < MT; ++a) {
    flag[a][0] = flag[a][1] = false;
#pragma unroll
    for (int b = 0; b < NTL; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;
  }

  for (int i = 0; i < nt; ++i) {
    const int s = i % S;
    mbar_wait(smem_addr(&full[s]), (i / S) & 1);      // tile i has landed
    const uint8_t* st = ring + s * St::BYTES;
    const int jn = min(NM_BK, d_in - (kt0 + i) * NM_BK) / 16;
    if (jn == NM_BK / 16)
      nm_steps<true, BN>(st, jn, acc, flag, warp_m * WM, warp_n * WN, lane);
    else                                 // the ragged last tile
      nm_steps<false, BN>(st, jn, acc, flag, warp_m * WM, warp_n * WN, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (flag[mt][hf]) bad[warp_m * WM + mt * 16 + g + 8 * hf] = 1;
  // The epilogue, through shared memory (the ring is free now): the
  // sums land transposed, (token, row), then one compact loop applies
  // bias and activation and writes rows of y (or the split's scratch)
  // contiguously. Named barrier 1: the multiplying warps only.
  constexpr int YS = NM_BM + 4;          // padded: the fragment writes hit
  float* ys = reinterpret_cast<float*>(ring);   // 32 banks
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CW) : "memory");
  const int tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n8 = 0; n8 < NTL; ++n8)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ys[(warp_n * WN + n8 * 8 + 2 * tq + (c & 1)) * YS + warp_m * WM +
           mt * 16 + g + 8 * (c >> 1)] = acc[mt][n8][c];
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CW) : "memory");
  const int rows = min(NM_BM, d_out - r0);
  const int toks = min(BN, n_tok - t0);
#pragma unroll 1
  for (int e = tid; e < toks * NM_BM; e += 32 * CW) {
    const int tl = e / NM_BM, rl = e % NM_BM;
    if (rl >= rows) continue;
    float v = bad[rl] ? __int_as_float(0x7fc00000) : ys[tl * YS + rl];
    const size_t o = (size_t)(t0 + tl) * d_out + r0 + rl;
    if (ws != nullptr) {
      ws[(size_t)blockIdx.z * n_tok * d_out + o] = v;
    } else {
      if (bias != nullptr) v += bias[r0 + rl];
      y[o] = __float2bfloat16_rn(epilogue(v, act));
    }
  }
}

// ---- gathered: two lanes per row walk its slots through rings in
// shared memory into dense A tiles, which other warps multiply

constexpr int G_SW = 8;                  // warps that scatter, 16 rows each
constexpr int G_MW = 8;                  // warps that multiply
constexpr int G_RUN = 8;                 // slots a lane reads at once
constexpr int G_NA = 2;                  // dense A tiles in a ring
constexpr int G_D = 3;                   // refills in flight a scatter warp
constexpr int G_THREADS = 32 * (G_SW + G_MW + 1);   // + the x producer

// bytes rounded up to an odd number of 16-byte chunks
constexpr int odd_chunks(int b) {
  return (b + 15) / 16 % 2 ? (b + 15) / 16 * 16 : (b + 15) / 16 * 16 + 16;
}

// The shared memory of a gathered block: S stages of x (two TMA boxes of
// BN tokens x 64 columns, 128-byte swizzle, as nm24 stages them), G_NA
// dense A tiles (128 rows x 128 bf16 columns; rows of 256 B whose 16-byte
// chunks are XOR-swizzled by row % 8), then each row's two slot rings:
// RS values (2 B) and RS columns (4 B), each followed by a copy of its
// first G_RUN slots (so a lane reads a run of them without wrapping), rows
// of rings an odd number of 16-byte chunks apart (so equal positions of 8
// rows hit distinct banks).
template <int BN, int S, int RS>
struct GSmem {
  static constexpr int XH = BN * 128;
  static constexpr int XS = 2 * XH;                 // one x stage
  static constexpr int A = S * XS;                  // the A tiles
  static constexpr int AB = NM_BM * 256;            // one A tile (32 KB)
  static constexpr int VR = 2 * RS, IR = 4 * RS;    // ring bytes of a row
  static constexpr int VM = 2 * G_RUN, IM = 4 * G_RUN;   // the copies
  static constexpr int VS = odd_chunks(VR + VM);           // row strides
  static constexpr int IS = odd_chunks(IR + IM);
  static constexpr int V = A + G_NA * AB;
  static constexpr int I = V + NM_BM * VS;
  static constexpr int BYTES = I + NM_BM * IS;
  static_assert(RS % 8 == 0 && RS >= 4 * G_RUN && G_RUN % 8 == 0,
                "rings and their copied starts of whole 16-byte chunks, "
                "each ring longer than a round");
};

// The first slot with column >= key of row rw + lane % 16 (key: kstart
// for lanes 0-15, kend for 16-31), for every lane with `active` (others
// answer 0). First each search reads the 128 slots around the key's
// expected slot (K key / d_in; eight searches a round, four rounds),
// which settles a sorted row whose kept columns spread evenly,
// and those slots are read again from L2 as the split starts; what is
// left (crowded or skewed rows) narrows by a 32-ary search, one probe a
// lane a round. The answer lies in [a, b] and is b if no slot of [a, b)
// reaches key.
__device__ __forceinline__ int g_bound(const int32_t* __restrict__ idx,
                                       int rw, int K, int d_in, int kstart,
                                       int kend, bool active, int lane) {
  int a = 0, b = active ? K : 0;
#pragma unroll 1
  for (int q0 = 0; q0 < 32; q0 += 8) {
    int w0[8], col[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int q = q0 + t;
      const int B = __shfl_sync(0xffffffffu, b, q);
      const int kq = q < 16 ? kstart : kend;
      w0[t] = max(0, min(static_cast<int>((long long)B * kq / d_in) - 64,
                         B - 128));
      const int32_t* ir = idx + (size_t)(rw + q % 16) * K;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int p = w0[t] + 32 * m + lane;
        col[t][m] = p < B ? ir[p] : INT_MAX;
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int q = q0 + t;
      const int B = __shfl_sync(0xffffffffu, b, q);
      const int kq = q < 16 ? kstart : kend;
      int below = 0;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        below += __popc(__ballot_sync(0xffffffffu, col[t][m] < kq));
      const int n = min(128, B - w0[t]);
      if (lane == q && a < b) {
        if (below == 0) b = w0[t];                 // at or before it
        else if (below >= n) a = w0[t] + n;        // past it
        else a = b = w0[t] + below;                // inside it
      }
    }
  }
  for (;;) {
    if (!__any_sync(0xffffffffu, a < b)) break;
    int col[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int A = __shfl_sync(0xffffffffu, a, q);
      const int B = __shfl_sync(0xffffffffu, b, q);
      const int step = (B - A + 31) >> 5;
      const int p = A + (lane + 1) * step - 1;
      col[q] = INT_MIN;
      if (A < B && p < B) col[q] = idx[(size_t)(rw + q % 16) * K + p];
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int A = __shfl_sync(0xffffffffu, a, q);
      const int B = __shfl_sync(0xffffffffu, b, q);
      const unsigned m = __ballot_sync(0xffffffffu,
                                       col[q] >= (q < 16 ? kstart : kend));
      const int step = (B - A + 31) >> 5;
      if (lane == q && A < B) {
        if (m) {                            // answer in (p_{f-1}, p_f]
          a = A + (__ffs(m) - 1) * step;
          b = a + step - 1;
        } else {                            // answer in (p_last, B]
          a = A + (B - A) / step * step;
        }
      }
    }
  }
  return a;
}

// x mod R for x in [0, 2R)
template <int R>
__device__ __forceinline__ int ring_wrap(int x) {
  return x >= R ? x - R : x;
}

// One stream of a row (its values or its columns) and its ring.
struct GStream {
  const uint8_t* base;   // slot 0 of the row in this stream (null: none)
  uintptr_t src;         // next byte to copy (16-byte aligned)
  uintptr_t lim;         // end of the split's slots, rounded up to 16
  uint32_t ring;         // shared address of the ring
  int fpos;              // ring position of src
};

// Bytes that refill a stream's ring of RB bytes up to RB past the 16-byte
// chunk that holds the cursor, or to the end of the split's slots.
template <int RB, int LG>
__device__ __forceinline__ uint32_t g_len(const GStream& s, int cur) {
  if (s.base == nullptr) return 0;
  const uintptr_t keep =
      (reinterpret_cast<uintptr_t>(s.base) + ((uintptr_t)cur << LG)) &
      ~uintptr_t(15);
  const uintptr_t to = keep + RB < s.lim ? keep + RB : s.lim;
  return to > s.src ? static_cast<uint32_t>(to - s.src) : 0;
}

// Bytes of a refill of len that land in the first MB bytes of the ring,
// which go to its copy past the end as well.
template <int RB, int MB>
__device__ __forceinline__ uint32_t g_mirror(const GStream& s,
                                             uint32_t len) {
  const uint32_t p1 = min(len, static_cast<uint32_t>(RB - s.fpos));
  uint32_t m = 0;
  if (s.fpos < MB) m += min(static_cast<uint32_t>(MB - s.fpos), p1);
  if (len > p1) m += min(static_cast<uint32_t>(MB), len - p1);
  return m;
}

template <int RB, int MB>
__device__ __forceinline__ void g_copy(GStream& s, uint32_t len,
                                       uint32_t bar) {
  if (!len) return;
  const uint32_t p1 = min(len, static_cast<uint32_t>(RB - s.fpos));
  const void* a = reinterpret_cast<const void*>(s.src);
  bulk_load(s.ring + s.fpos, a, p1, bar);
  if (s.fpos < MB)
    bulk_load(s.ring + RB + s.fpos, a,
              min(static_cast<uint32_t>(MB - s.fpos), p1), bar);
  if (len > p1) {
    const void* b = reinterpret_cast<const void*>(s.src + p1);
    bulk_load(s.ring, b, len - p1, bar);
    bulk_load(s.ring + RB, b, min(static_cast<uint32_t>(MB), len - p1), bar);
  }
  s.src += len;
  s.fpos = ring_wrap<RB>(s.fpos + static_cast<int>(len));
}

// Refill one row stream's ring (lane (i, h) of a copying warp: row i of
// its scatter warp, h = 0 values, 1 columns) from the row's cursor cur up
// to RB bytes past the 16-byte chunk that holds it, or to the end of the
// split's slots, by bulk copies of whole aligned 16-byte chunks (an
// allocation starts and ends on such a boundary, so none reads outside
// it), completing on mbarrier bar, whose one arrival (lane 0) announces
// their bytes; first lim_row[i] gets the row's slots landed by then (hi,
// its split's end, if it has none).
template <int RS>
__device__ __forceinline__ void g_refill(GStream& s, int cur, uint32_t bar,
                                         int lane, int* lim_row, int hi) {
  constexpr int VM = 2 * G_RUN, IM = 4 * G_RUN;
  const bool h = lane >= 16;
  const uint32_t len = h ? g_len<4 * RS, 2>(s, cur) : g_len<2 * RS, 1>(s, cur);
  const uint32_t m =
      h ? g_mirror<4 * RS, IM>(s, len) : g_mirror<2 * RS, VM>(s, len);
  const int n = s.base == nullptr ? hi : static_cast<int>(
      static_cast<long long>(s.src + len -
                             reinterpret_cast<uintptr_t>(s.base)) >>
      (h ? 2 : 1));
  const int land = min(hi, min(n, __shfl_xor_sync(0xffffffffu, n, 16)));
  if (!h) lim_row[lane] = land;
  const uint32_t total = __reduce_add_sync(0xffffffffu, len + m);
  fence_proxy_async();
  __syncwarp();                          // lim_row before the arrival
  if (lane == 0) mbar_expect(bar, total);
  __syncwarp();
  if (h) g_copy<4 * RS, IM>(s, len, bar);
  else g_copy<2 * RS, VM>(s, len, bar);
}

// A scatter warp hands its rows' cursors (c) to its copying warp, once
// the copier has taken the previous handoff; kind says what the copier
// does after the refill (0: multiply the next tile, 1: wait for another
// handoff, 2: nothing, no refill).
__device__ __forceinline__ void g_handoff(int kind, int c, int& nref,
                                          uint32_t req, uint32_t ack,
                                          int* cur_row, int* kind_w, int hf,
                                          int lane) {
  if (nref > 0) mbar_wait(ack, (nref - 1) & 1);
  if (!hf) *cur_row = c;
  if (lane == 0) *kind_w = kind;
  __syncwarp();
  if (lane == 0) mbar_arrive(req);
  ++nref;
}

// bf16 gathered, d_in % 8 == 0. A block owns 128 rows and BN tokens and
// walks its split's 128-column tiles. G_SW warps scatter: lanes l and
// l + 16 of warp w serve row 16w + l, each walking half of each round of
// 2 G_RUN slots, each slot into its tile's row of a dense A tile (G_NA of
// them in a ring), checking each column against the one before. G_MW
// warps multiply (WM x WN warp tiles) each A tile once all scatter warps
// have filled it, and free it for tile j + G_NA; multiplying warp w also
// copies for scatter warp w: at each handoff (after each tile, and when a
// row owes slots it does not have) it refills the rows' rings from their
// cursors, G_D refills in flight (refill n completes on rbar[w][n % G_D]
// in phase n / G_D; a tile reads what the refills older than the G_D - 1
// latest brought, and waits for the later ones only when a row owes
// slots). A producer warp streams x by TMA through S stages.
template <int BN, int WM, int WN, int S, int RS>
__global__ void __launch_bounds__(G_THREADS, 1)
spmm_gather_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __nv_bfloat16* __restrict__ vals,
                   const int32_t* __restrict__ idx,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                   int n_tok, int d_in, int d_out, int K, int act,
                   int tiles_per_split, int splits) {
  constexpr int MT = WM / 16;
  constexpr int NTL = WN / 8;
  constexpr int URGENT = 1, DONE = 2;    // handoff kinds (else: tile end)
  static_assert((NM_BM / WM) * (BN / WN) == G_MW, "one warp tile a warp");
  static_assert(G_SW * 16 == NM_BM && G_SW == G_MW,
                "two scattering lanes a row; a copying warp a scatter warp");
  using Sm = GSmem<BN, S, RS>;
  static_assert(BN * (NM_BM + 4) * 4 <= Sm::V,
                "the epilogue's (token, row) sums fit before the rings");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __shared__ int bad[NM_BM];
  __shared__ int gcur[NM_BM];            // a row's cursor at a handoff,
  __shared__ int ghi[NM_BM];             // its split's end slot,
  __shared__ int glim[G_D][NM_BM];       // its landed slots after refill n
  __shared__ int gkind[G_SW];            // a handoff's kind
  __shared__ __align__(8) uint64_t full[S];    // x stage has landed
  __shared__ __align__(8) uint64_t empty[S];   // ...and has been multiplied
  __shared__ __align__(8) uint64_t afull[G_NA];   // A tile has been scattered
  __shared__ __align__(8) uint64_t aempty[G_NA]; // ...and has been multiplied
  __shared__ __align__(8) uint64_t rbar[G_SW][G_D];  // refill n has landed
  __shared__ __align__(8) uint64_t req[G_SW];  // a scatter warp hands off
  __shared__ __align__(8) uint64_t ack[G_SW];  // ...its copier took it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * NM_BM;
  const int t0 = blockIdx.y * BN;
  const int n_kt = (d_in + NM_BK - 1) / NM_BK;
  const int e = blockIdx.z / splits;         // the expert (0 unstacked)
  const int kt0 = (blockIdx.z - e * splits) * tiles_per_split;
  const int nt = min(tiles_per_split, n_kt - kt0);
  vals += (size_t)e * d_out * K;
  idx += (size_t)e * d_out * K;
  y += (size_t)e * n_tok * d_out;
  const int kstart = kt0 * NM_BK;
  const int kend = (kt0 + nt) * NM_BK;   // the split's end column
  // lane (i, h) of scatter warp w and of copying warp w serve row 16w + i:
  // h picks the stream it copies (0 values, 1 columns) and the half of
  // each round of slots it walks
  const int li = lane & 15, hf = lane >> 4;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), G_MW);
    }
#pragma unroll
    for (int b = 0; b < G_NA; ++b) {
      mbar_init(smem_addr(&afull[b]), G_SW);
      mbar_init(smem_addr(&aempty[b]), G_MW);
    }
    for (int w = 0; w < G_SW; ++w) {
      for (int b = 0; b < G_D; ++b) mbar_init(smem_addr(&rbar[w][b]), 1);
      mbar_init(smem_addr(&req[w]), 1);
      mbar_init(smem_addr(&ack[w]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == G_SW + G_MW) {
    // the producer: x tiles, S - 1 ahead of the slowest multiplying warp
    if (lane == 0) {
      for (int i = 0; i < nt; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(smem_addr(&empty[s]), (i / S - 1) & 1);
        const uint32_t st = smem_addr(sm + s * Sm::XS);
        const uint32_t bar = smem_addr(&full[s]);
        const int k0 = (kt0 + i) * NM_BK;
        mbar_expect(bar, Sm::XS);
        tma_load3(st, &tm_x, k0, t0, e, bar);
        tma_load3(st + Sm::XH, &tm_x, k0 + NM_BK / 2, t0, e, bar);
      }
    }
    return;
  }

  const int g = lane >> 2, tq = lane & 3;
  float acc[MT][NTL][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NTL; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;
  const int mw = warp - G_SW;            // multiplying warp index
  const int warp_m = mw % (NM_BM / WM);
  const int warp_n = mw / (NM_BM / WM);

  if (warp < G_SW) {
    // ---- scatter: the row's split slot range, then per tile its slots
    const int rl = warp * 16 + li;       // block-local row
    const int row = r0 + rl;
    const bool valid = row < d_out;
    const int lohi = g_bound(idx, r0 + warp * 16, K, d_in, kstart, kend,
                             valid && (hf ? kt0 + nt < n_kt : kt0 > 0),
                             lane);
    int lo = kt0 > 0 ? __shfl_sync(0xffffffffu, lohi, li) : 0;
    int hi = kt0 + nt < n_kt ? __shfl_sync(0xffffffffu, lohi, li + 16) : K;
    if (!valid) lo = hi = 0;
    // ring positions of slot lo, as the copier lays the rings out
    const int pv0 = static_cast<int>(
        reinterpret_cast<uintptr_t>(vals + (size_t)row * K + lo) & 15);
    const int pi0 = static_cast<int>(
        reinterpret_cast<uintptr_t>(idx + (size_t)row * K + lo) & 15);
    int pv = lo < hi ? pv0 : 0, pi = lo < hi ? pi0 : 0;
    // a handoff to the copier: the rows' cursors, then req; the copier
    // acknowledges on ack once it has issued the refill
    const uint32_t qb = smem_addr(&req[warp]), kb = smem_addr(&ack[warp]);
    const uint32_t rbs = smem_addr(&rbar[warp][0]);   // rbar[warp][b]: + 8 b
    int nref = 0;                        // handoffs made (refill n: n-th)
    if (!hf) ghi[rl] = hi;
    g_handoff(0, lo, nref, qb, kb, &gcur[rl], &gkind[warp], hf, lane);
    int waited = -1;                     // refills waited for
    int cur = lo, last = kstart - 1, lim = lo;
    bool fault = false;
    const uint8_t* vr = sm + Sm::V + rl * Sm::VS;
    const uint8_t* ir = sm + Sm::I + rl * Sm::IS;
    const int rsw = (rl & 7) << 4;

    for (int j = 0; j < nt; ++j) {
      const int k0 = (kt0 + j) * NM_BK;
      const int kcut = min(k0 + NM_BK, d_in);   // the tile's columns end
      const int b = j % G_NA;
      // all but the G_D - 1 latest refills
      const int want = nref - G_D > 0 ? nref - G_D : 0;
      for (; waited < want;) {
        ++waited;
        mbar_wait(rbs + 8 * (waited % G_D), (waited / G_D) & 1);
      }
      lim = max(lim, glim[want % G_D][rl]);
      // the tile's buffer, once tile j - G_NA's MMAs are done with it
      if (j >= G_NA) mbar_wait(smem_addr(&aempty[b]), (j / G_NA - 1) & 1);
      uint8_t* arow = sm + Sm::A + b * Sm::AB + rl * 256;
      {                                  // zero the row, half a lane:
        const uint4 z = make_uint4(0, 0, 0, 0);   // chunk q ^ (row % 8),
#pragma unroll                                     // no bank conflict
        for (int q = 8 * hf; q < 8 * hf + 8; ++q)
          *reinterpret_cast<uint4*>(arow + ((q ^ (rl & 7)) << 4)) = z;
      }
      // the row's slots below kcut, 2 G_RUN a round: lane h loads slots
      // G_RUN h .. G_RUN h + G_RUN - 1 of it (unconditionally: the ring is
      // followed by a copy of its start) and takes them in order while
      // they have landed and stay below kcut, the second half only after
      // a full first half
#pragma unroll 1
      for (;;) {
        const uint8_t* ic = ir + ring_wrap<Sm::IR>(pi + 4 * G_RUN * hf);
        const uint8_t* vc = vr + ring_wrap<Sm::VR>(pv + 2 * G_RUN * hf);
        int c[G_RUN];
        uint16_t v[G_RUN];
#pragma unroll
        for (int u = 0; u < G_RUN; ++u) {
          c[u] = reinterpret_cast<const int*>(ic)[u];
          v[u] = reinterpret_cast<const uint16_t*>(vc)[u];
        }
        const int av = lim - cur - G_RUN * hf;   // mine that have landed
        int n = 0, ml = INT_MIN;         // my slots taken, the last one
#pragma unroll
        for (int u = 0; u < G_RUN; ++u) {
          const bool t = n == u && u < av && c[u] < kcut;
          n = t ? u + 1 : n;
          ml = t ? c[u] : ml;
        }
        const int n0 = __shfl_sync(0xffffffffu, n, li);
        const int n1 = __shfl_sync(0xffffffffu, n, li + 16);
        const int cz = __shfl_sync(0xffffffffu, c[G_RUN - 1], li);
        const int m0 = __shfl_sync(0xffffffffu, ml, li);
        const int m1 = __shfl_sync(0xffffffffu, ml, li + 16);
        const int nr = n0 + (n0 == G_RUN ? n1 : 0);  // the row's slots taken
        const int nm = hf && n0 < G_RUN ? 0 : n;     // mine among them
        const int p0 = hf ? cz : last;
#pragma unroll
        for (int u = 0; u < G_RUN; ++u)
          if (u < nm) {
            fault |= c[u] <= (u ? c[u - 1] : p0);
            // the tile starts at a multiple of 128: (c << 1) & 255 is c's
            // byte in the tile's row
            *reinterpret_cast<uint16_t*>(
                arow + (((c[u] << 1) & 255) ^ rsw)) = v[u];
          }
        last = nr > G_RUN ? m1 : nr > 0 ? m0 : last;
        cur += nr;
        pi = ring_wrap<Sm::IR>(pi + 4 * nr);
        pv = ring_wrap<Sm::VR>(pv + 2 * nr);
        if (__any_sync(0xffffffffu, nr == 2 * G_RUN)) continue;
        // done, unless a row still owes slots to this tile and has none
        // landed: then the later refills, else an urgent one
        const bool owe = cur >= lim && cur < hi && last < kcut - 1;
        if (!__any_sync(0xffffffffu, owe)) break;
        if (waited + 1 >= nref)
          g_handoff(URGENT, cur, nref, qb, kb, &gcur[rl], &gkind[warp], hf,
                    lane);
        for (; waited + 1 < nref;) {
          ++waited;
          mbar_wait(rbs + 8 * (waited % G_D), (waited / G_D) & 1);
        }
        lim = max(lim, glim[waited % G_D][rl]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&afull[b]));
      // refill for the next tiles (none after the last)
      g_handoff(j + 1 < nt ? 0 : DONE, cur, nref, qb, kb, &gcur[rl],
                &gkind[warp], hf, lane);
    }
    // refills still in flight must land before the epilogue reuses memory
    for (; waited + 2 < nref;) {         // (the last handoff refills none)
      ++waited;
      mbar_wait(rbs + 8 * (waited % G_D), (waited / G_D) & 1);
    }
    // a row whose split's slots were not all taken held a column out of
    // order or past d_in
    fault |= __shfl_xor_sync(0xffffffffu, fault, 16);
    if (!hf) bad[rl] = fault || cur != hi;
  } else {
    // ---- copy for scatter warp mw, and multiply: before tile j's MMAs,
    // every refill its scatter warp asks for up to the end of tile j
    const int rl = mw * 16 + li;
    const int row = r0 + rl;
    const uint32_t qb = smem_addr(&req[mw]), kb = smem_addr(&ack[mw]);
    const uint32_t rbs = smem_addr(&rbar[mw][0]);
    GStream gs;
    gs.base = nullptr;
    gs.src = gs.lim = 0;
    gs.fpos = 0;
    gs.ring = smem_addr(sm + (hf ? Sm::I + rl * Sm::IS : Sm::V + rl * Sm::VS));
    int hi = 0, served = 0;
    // j = -1: the first fill; then before tile j's MMAs every handoff up
    // to its scatter warp's end of tile j
    for (int j = -1; j < nt; ++j) {
      for (;;) {
        mbar_wait(qb, served & 1);
        const int kind = gkind[mw];
        const int c = gcur[rl];
        if (served == 0) {               // the first: lay out the streams
          hi = ghi[rl];
          if (c < hi) {
            gs.base = hf
                ? reinterpret_cast<const uint8_t*>(idx + (size_t)row * K)
                : reinterpret_cast<const uint8_t*>(vals + (size_t)row * K);
            gs.src = (reinterpret_cast<uintptr_t>(gs.base) +
                      ((uintptr_t)c << (1 + hf))) & ~uintptr_t(15);
            gs.lim = (reinterpret_cast<uintptr_t>(gs.base) +
                      ((uintptr_t)hi << (1 + hf)) + 15) & ~uintptr_t(15);
          }
        }
        if (kind != DONE)                // refill n = served
          g_refill<RS>(gs, c, rbs + 8 * (served % G_D), lane,
                       glim[served % G_D] + mw * 16, hi);
        __syncwarp();
        if (lane == 0) mbar_arrive(kb);
        ++served;
        if (j < 0 || kind != URGENT) break;
      }
      if (j < 0) continue;
      const int k0 = (kt0 + j) * NM_BK;
      const int b = j % G_NA, s = j % S;
      mbar_wait(smem_addr(&afull[b]), (j / G_NA) & 1);
      mbar_wait(smem_addr(&full[s]), (j / S) & 1);
      const uint8_t* at = sm + Sm::A + b * Sm::AB;
      const uint8_t* xs = sm + s * Sm::XS;
      const int jn = (min(k0 + NM_BK, d_in) - k0 + 15) / 16;
      const int q = lane >> 3;
      const uint8_t* xb = NTL % 2 == 0
          ? xs + (warp_n * WN + (q >> 1) * 8 + (lane & 7)) * 128
          : xs + (warp_n * WN + g) * 128 + 4 * tq;
#pragma unroll 2
      for (int kk = 0; kk < jn; ++kk) {
        uint32_t a[MT][4], bfr[NTL][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int ar = warp_m * WM + mt * 16 + (q & 1) * 8 + (lane & 7);
          ldsm_x4(smem_addr(at + ar * 256 +
                            (((2 * kk + (q >> 1)) ^ (ar & 7)) << 4)),
                  a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
        }
        const uint8_t* xh = xb + (kk >> 2) * Sm::XH;
        if constexpr (NTL % 2 == 0) {
          const int xo = ((2 * (kk & 3) + (q & 1)) ^ (lane & 7)) << 4;
#pragma unroll
          for (int n8 = 0; n8 < NTL; n8 += 2)
            ldsm_x4(smem_addr(xh + n8 * 8 * 128 + xo), bfr[n8][0],
                    bfr[n8][1], bfr[n8 + 1][0], bfr[n8 + 1][1]);
        } else {
          const int xo0 = ((2 * (kk & 3)) ^ g) << 4;
          const int xo1 = ((2 * (kk & 3) + 1) ^ g) << 4;
#pragma unroll
          for (int n8 = 0; n8 < NTL; ++n8) {
            bfr[n8][0] = ld32(xh + n8 * 8 * 128 + xo0);
            bfr[n8][1] = ld32(xh + n8 * 8 * 128 + xo1);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n8 = 0; n8 < NTL; ++n8)
            mma16816(acc[mt][n8], a[mt], bfr[n8]);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(smem_addr(&aempty[b]));
        mbar_arrive(smem_addr(&empty[s]));
      }
    }
  }
  // the epilogue, through shared memory as nm24's: sums land (token, row),
  // then rows of y (or the split's scratch) are written contiguously
  constexpr int NTH = 32 * (G_SW + G_MW);
  asm volatile("bar.sync 15, %0;\n" :: "n"(NTH) : "memory");
  constexpr int YS = NM_BM + 4;
  float* ys = reinterpret_cast<float*>(sm);
  if (warp >= G_SW)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n8 = 0; n8 < NTL; ++n8)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ys[(warp_n * WN + n8 * 8 + 2 * tq + (c & 1)) * YS + warp_m * WM +
             mt * 16 + g + 8 * (c >> 1)] = acc[mt][n8][c];
  asm volatile("bar.sync 15, %0;\n" :: "n"(NTH) : "memory");
  const int rows = min(NM_BM, d_out - r0);
  const int toks = min(BN, n_tok - t0);
#pragma unroll 1
  for (int e = tid; e < toks * NM_BM; e += NTH) {
    const int tl = e / NM_BM, r = e % NM_BM;
    if (r >= rows) continue;
    float v = bad[r] ? __int_as_float(0x7fc00000) : ys[tl * YS + r];
    const size_t o = (size_t)(t0 + tl) * d_out + r0 + r;
    if (ws != nullptr) {
      ws[(size_t)blockIdx.z * n_tok * d_out + o] = v;
    } else {
      if (bias != nullptr) v += bias[r0 + r];
      y[o] = __float2bfloat16_rn(epilogue(v, act));
    }
  }
}

// y = epilogue(sum of the splits' fp32 partials, in split order), for
// each of n_exp experts (expert e's split s at ws + (e * splits + s) *
// n_tok * d_out, its y at y + e * n_tok * d_out).
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ bias,
                                     __nv_bfloat16* __restrict__ y,
                                     int splits, int n_tok, int d_out,
                                     int act, int n_exp) {
  const size_t total = (size_t)n_tok * d_out;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total * n_exp) return;
  const size_t e = i / total, j = i - e * total;
  const float* w = ws + e * splits * total + j;
  float v = w[0];
  for (int s = 1; s < splits; ++s) v += w[(size_t)s * total];
  if (bias != nullptr) v += bias[j % d_out];
  y[i] = __float2bfloat16_rn(epilogue(v, act));
}

struct Plan {
  bool mma;
  bool decode;         // BN = 8 (else 128)
  int splits;
  int tiles_per_split;  // of NM_BK columns
};

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 132;
  }
  return cached[dev];
}

// One plan for both formats, from the shapes alone: the tiling, and the
// splits of d_in in whole NM_BK-column tiles — as many as fit one
// 128-row block per SM, and no more than keep the scratch's write and
// read (splits x T x d_out fp32, twice) within the nm24 weight bytes
// (1.5 x d_out x d_in).
Plan plan_for(int n_tok, int d_in, int d_out, int n, int m, int kind,
              int bf16) {
  Plan p{false, false, 1, 0};
  // nm24: 2:4 with whole 16-byte groups of 8 slots per row (K % 8 == 0)
  p.mma = bf16 && d_in % 8 == 0 &&
          (kind == 1 || (n == 2 && m == 4 && d_in % 16 == 0));
  if (!p.mma) return p;
  p.decode = n_tok <= 8;
  const int bn = p.decode ? 8 : 128;
  const int n_kt = (d_in + NM_BK - 1) / NM_BK;
  const long blocks = (long)((d_out + NM_BM - 1) / NM_BM) *
                      ((n_tok + bn - 1) / bn);
  long splits = sm_count() / blocks;
  const long cap = 3L * d_in / (16L * n_tok);    // 8 s T <= 1.5 d_in
  splits = splits < cap ? splits : cap;
  splits = splits < 1 ? 1 : (splits > n_kt ? n_kt : splits);
  p.tiles_per_split = (int)((n_kt + splits - 1) / splits);
  p.splits = (n_kt + p.tiles_per_split - 1) / p.tiles_per_split;
  return p;
}

// Raise a kernel's dynamic shared memory limit, once per device.
template <typename F>
bool allow_smem(F* kern, int bytes, bool (&done)[64]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return false;
  if (!done[dev])
    done[dev] = cudaFuncSetAttribute(
                    kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                    bytes) == cudaSuccess;
  return done[dev];
}

int launch_reduce(const Plan& p, const float* wsf, const float* bias,
                  __nv_bfloat16* y, int n_exp, int n_tok, int d_out, int act,
                  cudaStream_t s) {
  const size_t total = (size_t)n_exp * n_tok * d_out;
  splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      wsf, bias, y, p.splits, n_tok, d_out, act, n_exp);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int WM, int WN, int S>
int launch_nm24(const Plan& p, const void* x, const void* vals,
                const void* idx, const void* bias, void* y, void* ws,
                int n_exp, int n_tok, int d_in, int d_out, int K, int act,
                cudaStream_t s) {
  constexpr int SMEM = S * NmStage<BN>::BYTES + 1024;   // + alignment
  static bool done[64] = {false};
  auto* kern = spmm_nm24_kernel<BN, WM, WN, S>;
  if (!allow_smem(kern, SMEM, done)) {
    const int err = static_cast<int>(cudaGetLastError());
    return err != 0 ? err : static_cast<int>(cudaErrorInvalidValue);
  }
  // the TMA reads positions only from 16-byte aligned rows
  const bool idx_tma =
      K % 16 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  CUtensorMap tm_v, tm_i, tm_x;
  memset(&tm_i, 0, sizeof(tm_i));
  if (!tensor_map3(&tm_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, vals, K, d_out,
                   n_exp, 2ull * K, NM_BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map3(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, d_in, n_tok,
                   n_exp, 2ull * d_in, BN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (idx_tma && !tensor_map3(&tm_i, CU_TENSOR_MAP_DATA_TYPE_UINT8, idx, K,
                               d_out, n_exp, K, NM_BM,
                               CU_TENSOR_MAP_SWIZZLE_64B)))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((d_out + NM_BM - 1) / NM_BM, (n_tok + BN - 1) / BN,
            n_exp * p.splits);
  float* wsf = p.splits > 1 ? static_cast<float*>(ws) : nullptr;
  kern<<<grid, 32 * (nm_warps<BN, WM, WN>() + 1), SMEM, s>>>(
      tm_v, tm_i, tm_x, static_cast<const uint8_t*>(idx),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), wsf,
      n_tok, d_in, d_out, K, act, p.tiles_per_split, idx_tma, p.splits);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || p.splits == 1) return err;
  return launch_reduce(p, wsf, static_cast<const float*>(bias),
                       static_cast<__nv_bfloat16*>(y), n_exp, n_tok, d_out,
                       act, s);
}

template <int BN, int WM, int WN, int S, int RS>
int launch_gather(const Plan& p, const void* x, const void* vals,
                  const void* idx, const void* bias, void* y, void* ws,
                  int n_exp, int n_tok, int d_in, int d_out, int K, int act,
                  cudaStream_t s) {
  constexpr int SMEM = GSmem<BN, S, RS>::BYTES + 1024;   // + alignment
  static bool done[64] = {false};
  auto* kern = spmm_gather_kernel<BN, WM, WN, S, RS>;
  if (!allow_smem(kern, SMEM, done)) {
    const int err = static_cast<int>(cudaGetLastError());
    return err != 0 ? err : static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm_x;
  if (!tensor_map3(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, d_in, n_tok,
                   n_exp, 2ull * d_in, BN, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((d_out + NM_BM - 1) / NM_BM, (n_tok + BN - 1) / BN,
            n_exp * p.splits);
  float* wsf = p.splits > 1 ? static_cast<float*>(ws) : nullptr;
  kern<<<grid, G_THREADS, SMEM, s>>>(
      tm_x, static_cast<const __nv_bfloat16*>(vals),
      static_cast<const int32_t*>(idx), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), wsf, n_tok, d_in, d_out, K, act,
      p.tiles_per_split, p.splits);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || p.splits == 1) return err;
  return launch_reduce(p, wsf, static_cast<const float*>(bias),
                       static_cast<__nv_bfloat16*>(y), n_exp, n_tok, d_out,
                       act, s);
}

// The launches of spmm_run_stacked below.
int run(const void* x, const void* vals, const void* idx, const void* bias,
        void* y, void* ws, int n_exp, int n_tok, int d_in, int d_out, int K,
        int n, int m, int act, int kind, int bf16, cudaStream_t s) {
  const Plan p = plan_for(n_tok, d_in, d_out, n, m, kind, bf16);
  if (p.mma) {
    if (kind == 0) {
      if (p.decode)
        return launch_nm24<8, 16, 8, 4>(p, x, vals, idx, bias, y, ws, n_exp,
                                        n_tok, d_in, d_out, K, act, s);
      return launch_nm24<128, 16, 128, 4>(p, x, vals, idx, bias, y, ws, n_exp,
                                          n_tok, d_in, d_out, K, act, s);
    }
    if (p.decode)
      return launch_gather<8, 16, 8, 4, 184>(p, x, vals, idx, bias, y, ws,
                                             n_exp, n_tok, d_in, d_out, K,
                                             act, s);
    return launch_gather<128, 32, 64, 2, 112>(p, x, vals, idx, bias, y, ws,
                                              n_exp, n_tok, d_in, d_out, K,
                                              act, s);
  }
  if (bf16) {
    if (kind == 0)
      return launch_fma<__nv_bfloat16, uint8_t>(x, vals, idx, bias, y, n_exp,
                                                n_tok, d_in, d_out, K, n, m,
                                                act, s);
    return launch_fma<__nv_bfloat16, int32_t>(x, vals, idx, bias, y, n_exp,
                                              n_tok, d_in, d_out, K, n, m,
                                              act, s);
  }
  if (kind == 0)
    return launch_fma<float, uint8_t>(x, vals, idx, bias, y, n_exp, n_tok,
                                      d_in, d_out, K, n, m, act, s);
  return launch_fma<float, int32_t>(x, vals, idx, bias, y, n_exp, n_tok, d_in,
                                    d_out, K, n, m, act, s);
}

}  // namespace

extern "C" {

// fp32 floats of scratch spmm_run_stacked needs for n_exp experts of
// these shapes (0: none): n_exp times an unstacked call's. kind: 0 nm24,
// 1 gathered; bf16: 1 when x and values are bf16.
long long spmm_workspace_stacked(int n_exp, int n_tok, int d_in, int d_out,
                                 int n, int m, int kind, int bf16) {
  const Plan p = plan_for(n_tok, d_in, d_out, n, m, kind, bf16);
  return p.mma && p.splits > 1
             ? (long long)n_exp * p.splits * n_tok * d_out : 0;
}

// x: (n_exp, n_tok, d_in) row-major, 16-byte aligned; vals: (n_exp,
// d_out, K) row-major in x's dtype (fp32 or bf16); idx: (n_exp, d_out, K)
// uint8 within-block positions (kind 0, nm24: K = d_in / m * n) or int32
// absolute columns (kind 1, gathered); bias: (d_out,) fp32 shared by the
// experts, or NULL; y: (n_exp, n_tok, d_out) in x's dtype, overwritten;
// ws: spmm_workspace_stacked() floats of scratch (or NULL when it is 0).
// act: 0 none, 1 silu, 2 gelu (tanh), 3 relu, 4 relu2, 5 sigmoid. One
// launch of each kernel for all experts (n_exp = 1: an unstacked
// product). Returns cudaGetLastError() after the launches.
int spmm_run_stacked(const void* x, const void* vals, const void* idx,
                     const void* bias, void* y, void* ws, int n_exp,
                     int n_tok, int d_in, int d_out, int K, int n, int m,
                     int act, int kind, int bf16, void* stream) {
  return run(x, vals, idx, bias, y, ws, n_exp, n_tok, d_in, d_out, K, n, m,
             act, kind, bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
