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
// bf16 (the serving path), d_in % 8 == 0 (nm24: 2:4 and d_in % 16 == 0):
// the tensor-core kernel spmm_mma_kernel. A block of 8 warps owns BM = 64
// output rows and BN tokens (8 for decode, 128 for prefill) and walks
// d_in in tiles of BK = 64 columns: it zeroes a dense (BM, BK) bf16 tile
// in shared memory, scatters the tile's packed slots into it (the Pallas
// kernel's expansion), stages x[tokens, tile], and runs mma.sync
// m16n8k16 (bf16 in, fp32 sums) over the two tiles. The next tile's
// packed slots are loaded into registers while the current tile
// multiplies. A 2:4 row's slots of a tile are a static range, loaded 8
// slots (16 B of values, 8 B of positions) per lane; a gathered row keeps
// a cursor that a warp advances 32 slots at a time with a ballot (64
// slots prefetched), which needs the format's ascending columns (below).
// When the row blocks are too few to fill the card (decode, narrow
// layers), d_in is split over blockIdx.z and a second kernel (counted
// with the first as one launch of spmm) adds the fp32 partials in
// split order, then applies the epilogue. The dense tiles of the nm24
// and gathered packings of one 2:4 mask are identical, and the sum order
// depends only on the shapes (tiles, splits, the MMA), never on timing
// (no atomics): the two packings give bitwise equal y.
//
// fp32, or shapes the tensor-core kernel does not take: the CUDA-core
// kernel spmm_fma_kernel. A block of 8 warps owns 8 * RPW rows and TT
// tokens, stages x[tokens, d tile] transposed in shared memory as fp32,
// and lane l owns the slots l, l+32, ... of each of its rows, walking
// them with a cursor and a register ring of prefetched (column, value)
// pairs. Each lane sums its slots in slot order; the lanes meet in a
// fixed shuffle tree.
//
// The format's one contract, for both kernels: each row's columns
// ascend strictly within [0, d_in) (nm24: positions below m, ascending
// within each block), as packing emits them. A row that breaks it is
// flagged as its slots are read and comes out NaN, whatever the
// epilogue; nothing reads x out of order.
//
// What bounds it on an H100: at every shape of the serving path the work
// is bytes-bound — the packed weight is read once per launch, against
// 2·T·d_out·K FLOP that the tensor cores do in a fraction of that time.
// The tensor-core kernel multiplies the dense tile, zeros included (2×
// the useful FLOP at 2:4), which stays far below the bf16 peak; its
// tiles are synchronised phases without TMA or a deeper pipeline, and
// 2:4 sparse MMA (mma.sp) would halve the multiply: both later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (contraction
// allowed: the CUDA-core products use fmaf; repro_torch.kernels.build).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include <type_traits>

namespace {

constexpr int NT = 256;               // CUDA-core kernel: threads per block
constexpr int NW = NT / 32;
constexpr int BK = 64;                // tensor-core kernel: d_in tile
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
// tensor-core kernel (bf16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 2:4: a lane holds 8 consecutive slots of one row (16 B of values, 8 B
// of positions); 4 lanes cover a row's 32 slots of a 64-column tile, a
// warp 8 rows per load. RG row groups per warp.
template <int RG>
struct Chunk24 {
  uint4 v[RG];
  uint2 i[RG];
};

template <int RG>
__device__ __forceinline__ void load_24(Chunk24<RG>& ch,
                                        const __nv_bfloat16* vals,
                                        const uint8_t* idx, int rw, int lane,
                                        int kt, int d_out, int K) {
  const int q = kt * (BK / 2) + (lane & 3) * 8;
#pragma unroll
  for (int gr = 0; gr < RG; ++gr) {
    const int row = rw + gr * 8 + (lane >> 2);
    if (row < d_out && q < K) {
      ch.v[gr] = *reinterpret_cast<const uint4*>(vals + (size_t)row * K + q);
      ch.i[gr] = *reinterpret_cast<const uint2*>(idx + (size_t)row * K + q);
    }
  }
}

// Scatter a lane's 8 slots (4 blocks of 4 columns) into its dense tile
// row; a block whose two positions do not ascend within [0, 4) flags
// the row.
template <int RG>
__device__ __forceinline__ void place_24(const Chunk24<RG>& ch,
                                         __nv_bfloat16 (*Ws)[PADK], int* bad,
                                         int r0, int wr0, int lane, int kt,
                                         int d_out, int K) {
  const int q = kt * (BK / 2) + (lane & 3) * 8;
  const int cb = (lane & 3) * 16;         // 8 slots = 4 blocks = 16 columns
#pragma unroll
  for (int gr = 0; gr < RG; ++gr) {
    const int rl = wr0 + gr * 8 + (lane >> 2);
    if (r0 + rl >= d_out || q >= K) continue;
    uint16_t* wrow = reinterpret_cast<uint16_t*>(&Ws[rl][0]);
    const uint32_t vw[4] = {ch.v[gr].x, ch.v[gr].y, ch.v[gr].z, ch.v[gr].w};
    const uint32_t iw[2] = {ch.i[gr].x, ch.i[gr].y};
    bool ok = true;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i0 = (iw[b >> 1] >> (16 * (b & 1))) & 0xff;
      const int i1 = (iw[b >> 1] >> (16 * (b & 1) + 8)) & 0xff;
      ok = ok && i0 < i1 && i1 < 4;
      wrow[cb + 4 * b + (i0 & 3)] = static_cast<uint16_t>(vw[b] & 0xffffu);
      wrow[cb + 4 * b + (i1 & 3)] = static_cast<uint16_t>(vw[b] >> 16);
    }
    if (!ok) bad[rl] = 1;
  }
}

// gathered: a row's next 64 slots from its cursor, two per lane (slots
// cur + lane and cur + 32 + lane), kept as loaded (INT_MAX past K): no
// arithmetic on them until the next tile places them, so the loads stay
// in flight while the current tile multiplies.
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

constexpr int MMA_WARPS = 8;             // warps of a tensor-core block

template <int BM, int BN, int WM, int WN, bool NM>
__global__ void __launch_bounds__(MMA_WARPS * 32)
spmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ vals,
                const void* __restrict__ idx_, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                int n_tok, int d_in, int d_out, int K, int act,
                int tiles_per_split) {
  constexpr int MW = (BM / WM) * (BN / WN);   // warps that multiply
  static_assert(MW <= MMA_WARPS, "warp tile too small for the block");
  constexpr int NTH = MMA_WARPS * 32;
  constexpr int RPW = BM / MMA_WARPS;    // rows each warp scatters
  constexpr int MT = WM / 16;
  constexpr int NTL = WN / 8;
  static_assert(RPW % 8 == 0, "2:4 loads cover 8 rows per warp");
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
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, n_kt);
  const int rw = r0 + warp * RPW;        // first row this warp scatters
  const uint16_t* vbits = reinterpret_cast<const uint16_t*>(vals);
  const uint8_t* idx8 = static_cast<const uint8_t*>(idx_);
  const int32_t* idx32 = static_cast<const int32_t*>(idx_);

  for (int i = tid; i < BM; i += NTH) bad[i] = 0;
  __syncthreads();

  int cur[RPW], last[RPW];
  if constexpr (!NM) {
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
  }
  using ChunkT = typename std::conditional<NM, Chunk24<RPW / 8>,
                                            ChunkG<RPW>>::type;
  ChunkT ch;
  if constexpr (NM)
    load_24(ch, vals, idx8, rw, lane, kt0, d_out, K);
  else
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
    for (int e = tid; e < BM * BK / 8; e += NTH) {
      const int r = e / (BK / 8);
      const int c8 = e - r * (BK / 8);
      *reinterpret_cast<uint4*>(&Ws[r][c8 * 8]) = zero;
    }
    for (int e = tid; e < BN * BK / 8; e += NTH) {
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
    if constexpr (NM) {
      place_24(ch, Ws, bad, r0, warp * RPW, lane, kt, d_out, K);
    } else {
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int wr = warp * RPW + i;
        uint16_t* wrow = reinterpret_cast<uint16_t*>(&Ws[wr][0]);
        if (rw + i < d_out) {               // uniform across the warp
          bool more = place_gather(ch.col[i][0], ch.val[i][0], wrow,
                                   &bad[wr], cur[i], last[i], lane, k0, d_in);
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
    }
    if (kt + 1 < kt1) {
      if constexpr (NM)
        load_24(ch, vals, idx8, rw, lane, kt + 1, d_out, K);
      else
        load_gather(ch, vbits, idx32, cur, rw, lane, d_out, K);
    }
    __syncthreads();
    if (warp >= MW) continue;             // decode: 4 of the 8 warps multiply
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
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
  if constexpr (!NM) {
    // a slot left after the last column, or one the cursor stopped at
    // because its column is past d_in, is corrupt
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (rw + i >= d_out || cur[i] >= K || lane != 0) continue;
      const int c = idx32[(size_t)(rw + i) * K + cur[i]];
      if (kt1 == n_kt || c < 0 || c >= d_in) bad[warp * RPW + i] = 1;
    }
  }
  __syncthreads();
  if (warp >= MW) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rl = warp_m * WM + mt * 16 + g + 8 * (c >> 1);
        const int row = r0 + rl;
        const int tok = t0 + warp_n * WN + nt * 8 + 2 * tq + (c & 1);
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
  int tiles_per_split;
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

Plan plan_for(int n_tok, int d_in, int d_out, int n, int m, int kind,
              int bf16) {
  Plan p{false, false, 1, 0};
  // nm24: 2:4 with whole 16-byte groups of 8 slots per row (K % 8 == 0)
  p.mma = bf16 && d_in % 8 == 0 &&
          (kind == 1 || (n == 2 && m == 4 && d_in % 16 == 0));
  if (!p.mma) return p;
  p.decode = n_tok <= 8;
  const int bn = p.decode ? 8 : 128;
  const int n_kt = (d_in + BK - 1) / BK;
  const long blocks = (long)((d_out + 63) / 64) * ((n_tok + bn - 1) / bn);
  const long want = (2L * sm_count() + blocks - 1) / blocks;  // 2 waves
  int splits = (int)(want < 1 ? 1 : (want > n_kt ? n_kt : want));
  p.tiles_per_split = (n_kt + splits - 1) / splits;
  p.splits = (n_kt + p.tiles_per_split - 1) / p.tiles_per_split;
  return p;
}

template <int BN, int WM, int WN>
int launch_mma(const Plan& p, const void* x, const void* vals,
               const void* idx, const void* bias, void* y, void* ws,
               int n_tok, int d_in, int d_out, int K, int act, int kind,
               cudaStream_t s) {
  constexpr int BM = 64;
  constexpr int NTH = MMA_WARPS * 32;
  dim3 grid((d_out + BM - 1) / BM, (n_tok + BN - 1) / BN, p.splits);
  float* wsf = p.splits > 1 ? static_cast<float*>(ws) : nullptr;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* vb = static_cast<const __nv_bfloat16*>(vals);
  const auto* bf = static_cast<const float*>(bias);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (kind == 0)
    spmm_mma_kernel<BM, BN, WM, WN, true><<<grid, NTH, 0, s>>>(
        xb, vb, idx, bf, yb, wsf, n_tok, d_in, d_out, K, act,
        p.tiles_per_split);
  else
    spmm_mma_kernel<BM, BN, WM, WN, false><<<grid, NTH, 0, s>>>(
        xb, vb, idx, bf, yb, wsf, n_tok, d_in, d_out, K, act,
        p.tiles_per_split);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || p.splits == 1) return err;
  const size_t total = (size_t)n_tok * d_out;
  splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      wsf, bf, yb, p.splits, n_tok, d_out, act);
  return static_cast<int>(cudaGetLastError());
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
    if (p.decode)
      return launch_mma<8, 16, 8>(p, x, vals, idx, bias, y, ws, n_tok, d_in,
                                  d_out, K, act, kind, s);
    return launch_mma<128, 32, 32>(p, x, vals, idx, bias, y, ws, n_tok,
                                   d_in, d_out, K, act, kind, s);
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
