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
// bf16 gathered (d_in % 8 == 0): spmm_gather_kernel, 64 x 64-column
// tiles densified in shared memory: it zeroes a dense (64, 64) bf16
// tile, scatters the tile's slots into it from a per-row cursor that a
// warp advances 32 slots at a time with a ballot (64 slots prefetched in
// registers; needs the format's ascending columns, below), stages x, and
// runs the same m16n8k16 MMAs over the tile.
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
// What bounds it on an H100: the packed weight (1.5 bytes per dense
// element at 2:4) is read once per launch, against 2·T·d_out·K FLOP, so
// every serving shape is bytes-bound on paper. With one block per SM,
// per-thread cp.async could not keep enough of it in flight; the TMA
// ring can (PERF.md has the numbers, from launch/profile_spmm.py). At
// prefill the kernel is held back by work the bound does not count:
// every block re-reads x (1 MB at w_gate) from L2, each A fragment takes
// ~30 integer instructions to build, and mma.sync multiplies the dense
// fragment, zeros included (2x the useful FLOP).
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
constexpr int BK = 64;                // gathered tensor-core kernel: d_in
                                      // tile
constexpr int PADK = BK + 8;          // its shared row stride (bf16): the
                                      // fragment loads hit 32 banks

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
              const void* bias, void* y, int n_tok, int d_in, int d_out,
              int K, int n, int m, int act, cudaStream_t stream) {
  constexpr int RB = NW * RPW;
  dim3 grid((n_tok + TT - 1) / TT, (d_out + RB - 1) / RB);
  spmm_fma_kernel<TT, RPW, PF, TD, TX, TI><<<grid, NT, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(vals),
      static_cast<const TI*>(idx), static_cast<const float*>(bias),
      static_cast<TX*>(y), n_tok, d_in, d_out, K, n, m, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TI>
int launch_fma(const void* x, const void* vals, const void* idx,
               const void* bias, void* y, int n_tok, int d_in, int d_out,
               int K, int n, int m, int act, cudaStream_t s) {
  if (n_tok <= 4)        // decode: 4 tokens, more blocks, deep prefetch
    return launch_tt<4, 2, 8, 2048, TX, TI>(x, vals, idx, bias, y, n_tok,
                                            d_in, d_out, K, n, m, act, s);
  return launch_tt<16, 4, 2, 512, TX, TI>(x, vals, idx, bias, y, n_tok,
                                          d_in, d_out, K, n, m, act, s);
}

// ---------------------------------------------------------------------------
// tensor-core kernels (bf16)
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 8;             // warps of a tensor-core block
constexpr int MMA_NTH = MMA_WARPS * 32;

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

// fp32 sums of one (rows x tokens) warp tile to y (epilogue) or, when
// d_in is split, to this split's slice of the scratch; a flagged row
// comes out NaN.
template <int MT, int NTL>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][NTL][4],
                                           const int* bad, int rl0, int tl0,
                                           int r0, int t0, int lane,
                                           const float* bias,
                                           __nv_bfloat16* y, float* ws,
                                           int n_tok, int d_out, int act) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rl = rl0 + mt * 16 + g + 8 * (c >> 1);
        const int row = r0 + rl;
        const int tok = t0 + tl0 + nt * 8 + 2 * tq + (c & 1);
        if (row >= d_out || tok >= n_tok) continue;
        float v = bad[rl] ? __int_as_float(0x7fc00000) : acc[mt][nt][c];
        if (ws != nullptr) {
          ws[((size_t)blockIdx.z * n_tok + tok) * d_out + row] = v;
        } else {
          if (bias != nullptr) v += bias[row];
          y[(size_t)tok * d_out + row] = __float2bfloat16_rn(epilogue(v, act));
        }
      }
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

// Issue the copies of one tile (columns [k0, k0 + NM_BK)) into a stage,
// by the producer warp: lane 0 sends the TMA boxes of values, positions
// (idx_tma) and the two halves of x, all completing on the stage's
// mbarrier; without idx_tma the lanes first copy the positions 8 bytes
// at a time (zero fill past the edges, as the TMA does), the mbarrier
// tracking their completion too.
template <int BN>
__device__ __forceinline__ void nm_stage(uint8_t* st, uint32_t bar,
                                         const CUtensorMap* tm_v,
                                         const CUtensorMap* tm_i,
                                         const CUtensorMap* tm_x,
                                         const uint8_t* idx, int r0, int t0,
                                         int k0, int d_out, int K, int lane,
                                         bool idx_tma) {
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
    tma_load(sv + St::V, tm_v, s0, r0, bar);
    if (idx_tma) tma_load(sv + St::I, tm_i, s0, r0, bar);
    tma_load(sv + St::X, tm_x, k0, t0, bar);
    tma_load(sv + St::X + St::XH, tm_x, k0 + NM_BK / 2, t0, bar);
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
                 int tiles_per_split, int idx_tma) {
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
  const int kt0 = blockIdx.z * tiles_per_split;
  const int nt = min(tiles_per_split, n_kt - kt0);

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
                   &tm_x, idx, r0, t0, (kt0 + i) * NM_BK, d_out, K, lane,
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

// ---- gathered: 64-column tiles densified in shared memory

constexpr int G_BM = 64;                 // rows of a block

// a row's next 64 slots from its cursor, two per lane (slots cur + lane
// and cur + 32 + lane), kept as loaded (INT_MAX past K): no arithmetic on
// them until the next tile places them, so the loads stay in flight
// while the current tile multiplies.
template <int RPW>
struct ChunkG {
  int col[RPW][2];
  uint16_t val[RPW][2];
};

template <int RPW>
__device__ __forceinline__ void load_gather(ChunkG<RPW>& ch,
                                            const uint16_t* vbits,
                                            const int32_t* idx,
                                            const int* cur, int rw, int lane,
                                            int d_out, int K) {
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = rw + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = cur[i] + 32 * h + lane;
      ch.col[i][h] = INT_MAX;
      if (row < d_out && s < K) {
        ch.col[i][h] = idx[(size_t)row * K + s];
        ch.val[i][h] = vbits[(size_t)row * K + s];
      }
    }
  }
}

// Scatter one 32-slot chunk of a row into its dense tile row and advance
// the row's cursor past the slots in [k0, k0 + BK). Returns true when all
// 32 fell in the tile (more may follow).
__device__ __forceinline__ bool place_gather(int c, uint16_t v,
                                             uint16_t* wrow, int* bad_row,
                                             int& cur, int& last, int lane,
                                             int k0, int d_in) {
  const bool in = c < k0 + BK;
  const unsigned msk = __ballot_sync(0xffffffffu, in);
  const int cnt = __popc(msk);
  int prev = __shfl_up_sync(0xffffffffu, c, 1);
  if (lane == 0) prev = last;
  if (in) {
    if (c >= k0 && c > prev && c < d_in) wrow[c - k0] = v;
    else *bad_row = 1;
  }
  if (msk != (cnt == 32 ? 0xffffffffu : (1u << cnt) - 1u) && lane == 0)
    *bad_row = 1;                         // columns out of ascending order
  const int lst = __shfl_sync(0xffffffffu, c, cnt > 0 ? cnt - 1 : 0);
  if (cnt > 0) last = lst;
  cur += cnt;
  return cnt == 32;
}

template <int BN, int WM, int WN>
__global__ void __launch_bounds__(MMA_NTH)
spmm_gather_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ vals,
                   const int32_t* __restrict__ idx32,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                   int n_tok, int d_in, int d_out, int K, int act,
                   int tiles_per_split) {
  constexpr int BM = G_BM;
  constexpr int MW = (BM / WM) * (BN / WN);   // warps that multiply
  static_assert(MW <= MMA_WARPS, "warp tile too small for the block");
  constexpr int RPW = BM / MMA_WARPS;    // rows each warp scatters
  constexpr int MT = WM / 16;
  constexpr int NTL = WN / 8;
  __shared__ __align__(16) __nv_bfloat16 Ws[BM][PADK];
  __shared__ __align__(16) __nv_bfloat16 Xs[BN][PADK];
  __shared__ int bad[BM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;               // mma group
  const int tq = lane & 3;               // thread in group
  const int warp_m = warp % (BM / WM);
  const int warp_n = warp / (BM / WM);
  const int r0 = blockIdx.x * BM;
  const int t0 = blockIdx.y * BN;
  const int n_kt = (d_in + BK - 1) / BK;
  constexpr int PER = NM_BK / BK;        // a split is whole 128-column tiles
  const int kt0 = blockIdx.z * tiles_per_split * PER;
  const int kt1 = min(kt0 + tiles_per_split * PER, n_kt);
  const int rw = r0 + warp * RPW;        // first row this warp scatters
  const uint16_t* vbits = reinterpret_cast<const uint16_t*>(vals);

  for (int i = tid; i < BM; i += MMA_NTH) bad[i] = 0;
  __syncthreads();

  int cur[RPW], last[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    // first slot with column >= this split's first column (the first
    // split starts at slot 0, so it meets a negative column and flags it)
    const int row = rw + i;
    int lo = 0, hi = row < d_out && kt0 > 0 ? K : 0;
    const int kstart = kt0 * BK;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (idx32[(size_t)row * K + mid] < kstart) lo = mid + 1;
      else hi = mid;
    }
    cur[i] = lo;
    last[i] = -1;
  }
  ChunkG<RPW> ch;
  load_gather(ch, vbits, idx32, cur, rw, lane, d_out, K);

  float acc[MT][NTL][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NTL; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                      // the last tile's MMAs are done
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int e = tid; e < BM * BK / 8; e += MMA_NTH) {
      const int r = e / (BK / 8);
      const int c8 = e - r * (BK / 8);
      *reinterpret_cast<uint4*>(&Ws[r][c8 * 8]) = zero;
    }
    for (int e = tid; e < BN * BK / 8; e += MMA_NTH) {
      const int t = e / (BK / 8);
      const int c8 = e - t * (BK / 8);
      const int tok = t0 + t;
      const int col = k0 + c8 * 8;
      uint4 v = zero;
      if (tok < n_tok && col < d_in)
        v = *reinterpret_cast<const uint4*>(x + (size_t)tok * d_in + col);
      *reinterpret_cast<uint4*>(&Xs[t][c8 * 8]) = v;
    }
    __syncthreads();
    // scatter this tile's slots into the dense tile, then fetch the next
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int wr = warp * RPW + i;
      uint16_t* wrow = reinterpret_cast<uint16_t*>(&Ws[wr][0]);
      if (rw + i < d_out) {               // uniform across the warp
        bool more = place_gather(ch.col[i][0], ch.val[i][0], wrow, &bad[wr],
                                 cur[i], last[i], lane, k0, d_in);
        if (more)
          more = place_gather(ch.col[i][1], ch.val[i][1], wrow, &bad[wr],
                              cur[i], last[i], lane, k0, d_in);
        while (more) {                    // > 64 slots in this tile
          const int s = cur[i] + lane;
          int c = INT_MAX;
          uint16_t v = 0;
          if (s < K) {
            c = idx32[(size_t)(rw + i) * K + s];
            v = vbits[(size_t)(rw + i) * K + s];
          }
          more = place_gather(c, v, wrow, &bad[wr], cur[i], last[i], lane,
                              k0, d_in);
        }
      }
    }
    if (kt + 1 < kt1)
      load_gather(ch, vbits, idx32, cur, rw, lane, d_out, K);
    __syncthreads();
    if (warp >= MW) continue;             // decode: 4 of the 8 warps multiply
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      if (k0 + kk >= d_in) break;         // the steps past d_in
      uint32_t a[MT][4], b[NTL][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int rr = warp_m * WM + mt * 16 + g;
        a[mt][0] = ld32(&Ws[rr][kk + 2 * tq]);
        a[mt][1] = ld32(&Ws[rr + 8][kk + 2 * tq]);
        a[mt][2] = ld32(&Ws[rr][kk + 2 * tq + 8]);
        a[mt][3] = ld32(&Ws[rr + 8][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const int tt = warp_n * WN + nt * 8 + g;
        b[nt][0] = ld32(&Xs[tt][kk + 2 * tq]);
        b[nt][1] = ld32(&Xs[tt][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) mma16816(acc[mt][nt], a[mt], b[nt]);
    }
  }
  // a slot left after the last column, or one the cursor stopped at
  // because its column is past d_in, is corrupt
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (rw + i >= d_out || cur[i] >= K || lane != 0) continue;
    const int c = idx32[(size_t)(rw + i) * K + cur[i]];
    if (kt1 == n_kt || c < 0 || c >= d_in) bad[warp * RPW + i] = 1;
  }
  __syncthreads();
  if (warp >= MW) return;
  store_tile<MT, NTL>(acc, bad, warp_m * WM, warp_n * WN, r0, t0, lane, bias,
                      y, ws, n_tok, d_out, act);
}

// y = epilogue(sum of the splits' fp32 partials, in split order).
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ bias,
                                     __nv_bfloat16* __restrict__ y,
                                     int splits, int n_tok, int d_out,
                                     int act) {
  const size_t total = (size_t)n_tok * d_out;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = ws[i];
  for (int s = 1; s < splits; ++s) v += ws[(size_t)s * total + i];
  if (bias != nullptr) v += bias[i % d_out];
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
                  __nv_bfloat16* y, int n_tok, int d_out, int act,
                  cudaStream_t s) {
  const size_t total = (size_t)n_tok * d_out;
  splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      wsf, bias, y, p.splits, n_tok, d_out, act);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int WM, int WN, int S>
int launch_nm24(const Plan& p, const void* x, const void* vals,
                const void* idx, const void* bias, void* y, void* ws,
                int n_tok, int d_in, int d_out, int K, int act,
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
  if (!tensor_map(&tm_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, vals, K, d_out,
                  2ull * K, NM_BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, d_in, n_tok,
                  2ull * d_in, BN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (idx_tma && !tensor_map(&tm_i, CU_TENSOR_MAP_DATA_TYPE_UINT8, idx, K,
                              d_out, K, NM_BM, CU_TENSOR_MAP_SWIZZLE_64B)))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((d_out + NM_BM - 1) / NM_BM, (n_tok + BN - 1) / BN, p.splits);
  float* wsf = p.splits > 1 ? static_cast<float*>(ws) : nullptr;
  kern<<<grid, 32 * (nm_warps<BN, WM, WN>() + 1), SMEM, s>>>(
      tm_v, tm_i, tm_x, static_cast<const uint8_t*>(idx),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), wsf,
      n_tok, d_in, d_out, K, act, p.tiles_per_split, idx_tma);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || p.splits == 1) return err;
  return launch_reduce(p, wsf, static_cast<const float*>(bias),
                       static_cast<__nv_bfloat16*>(y), n_tok, d_out, act, s);
}

template <int BN, int WM, int WN>
int launch_gather(const Plan& p, const void* x, const void* vals,
                  const void* idx, const void* bias, void* y, void* ws,
                  int n_tok, int d_in, int d_out, int K, int act,
                  cudaStream_t s) {
  dim3 grid((d_out + G_BM - 1) / G_BM, (n_tok + BN - 1) / BN, p.splits);
  float* wsf = p.splits > 1 ? static_cast<float*>(ws) : nullptr;
  spmm_gather_kernel<BN, WM, WN><<<grid, MMA_NTH, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(vals),
      static_cast<const int32_t*>(idx), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), wsf, n_tok, d_in, d_out, K, act,
      p.tiles_per_split);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || p.splits == 1) return err;
  return launch_reduce(p, wsf, static_cast<const float*>(bias),
                       static_cast<__nv_bfloat16*>(y), n_tok, d_out, act, s);
}

}  // namespace

extern "C" {

// fp32 floats of scratch spmm_run needs for these shapes (0: none).
// kind: 0 nm24, 1 gathered; bf16: 1 when x and values are bf16.
long long spmm_workspace(int n_tok, int d_in, int d_out, int n, int m,
                         int kind, int bf16) {
  const Plan p = plan_for(n_tok, d_in, d_out, n, m, kind, bf16);
  return p.mma && p.splits > 1 ? (long long)p.splits * n_tok * d_out : 0;
}

// x: (n_tok, d_in) row-major, 16-byte aligned; vals: (d_out, K)
// row-major in x's dtype (fp32 or bf16); idx: (d_out, K) uint8
// within-block positions (kind 0, nm24: K = d_in / m * n) or int32
// absolute columns (kind 1, gathered); bias: (d_out,) fp32 or NULL;
// y: (n_tok, d_out) in x's dtype, overwritten; ws: spmm_workspace()
// floats of scratch (or NULL when it is 0). act: 0 none, 1 silu, 2 gelu
// (tanh), 3 relu, 4 relu2, 5 sigmoid. Returns cudaGetLastError() after
// the launches.
int spmm_run(const void* x, const void* vals, const void* idx,
             const void* bias, void* y, void* ws, int n_tok, int d_in,
             int d_out, int K, int n, int m, int act, int kind, int bf16,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan_for(n_tok, d_in, d_out, n, m, kind, bf16);
  if (p.mma) {
    if (kind == 0) {
      if (p.decode)
        return launch_nm24<8, 16, 8, 4>(p, x, vals, idx, bias, y, ws, n_tok,
                                        d_in, d_out, K, act, s);
      return launch_nm24<128, 16, 128, 4>(p, x, vals, idx, bias, y, ws, n_tok,
                                         d_in, d_out, K, act, s);
    }
    if (p.decode)
      return launch_gather<8, 16, 8>(p, x, vals, idx, bias, y, ws, n_tok,
                                     d_in, d_out, K, act, s);
    return launch_gather<128, 32, 32>(p, x, vals, idx, bias, y, ws, n_tok,
                                      d_in, d_out, K, act, s);
  }
  if (bf16) {
    if (kind == 0)
      return launch_fma<__nv_bfloat16, uint8_t>(x, vals, idx, bias, y, n_tok,
                                                d_in, d_out, K, n, m, act, s);
    return launch_fma<__nv_bfloat16, int32_t>(x, vals, idx, bias, y, n_tok,
                                              d_in, d_out, K, n, m, act, s);
  }
  if (kind == 0)
    return launch_fma<float, uint8_t>(x, vals, idx, bias, y, n_tok, d_in,
                                      d_out, K, n, m, act, s);
  return launch_fma<float, int32_t>(x, vals, idx, bias, y, n_tok, d_in,
                                    d_out, K, n, m, act, s);
}

}  // extern "C"
