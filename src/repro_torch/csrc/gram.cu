// G = Xᵀ X with fp32 sums, for calibration activations x (T, d), and the
// stacked form G_e = X_eᵀ X_e for x (E, T, d) -> (E, d, d) (MoE experts,
// each over its capacity buffer).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram.py::_kernel
// (gram_xtx_padded): there a (TI, TJ) output tile stays in VMEM while the
// sequential grid streams token strips through it. The stacked form
// replaces src/repro/kernels/ops.py::gram_xtx_stacked, a vmap of that
// kernel over experts: here the expert is the grid's y axis (blockIdx.y),
// so a stacked call is one launch, and each expert's blocks run exactly
// the unstacked call's code on its slice (bitwise the unstacked result).
// On Hopper the blocks run in parallel and in no order, so each block owns
// one 128 x 128 output tile and loops over all T tokens itself. G is
// symmetric: the grid holds only the nt (nt + 1) / 2 tiles on and above
// the diagonal (1-D, so no block exits empty), and each block writes its
// tile and the tile's mirror image. The tile passes through shared memory
// on its way out (store_tile): rows of the tile, then rows of its
// transpose, each warp store 128 contiguous bytes; a diagonal tile writes
// its upper half and mirrors it. G == Gᵀ therefore holds exactly,
// whatever order the sums took.
//
// bf16 activations (the calibration path on the card): gram_bf16_kernel,
// on the tensor cores. Products of bf16 values are exact in fp32, so the
// tensor cores sum the same terms as an fp32 upcast would, in another
// order. A producer warp streams 64-token strips X[t0:t0+64, i0:i0+128]
// and X[t0:t0+64, j0:j0+128] by TMA (four 64 x 64 boxes, 128-byte swizzle,
// zeros past T and d; two boxes on a diagonal tile, where the strips are
// the same) through a ring of STAGES 32 KB stages with full / empty
// mbarriers. The tensor map is 3-D, (ld, T, E): a strip that runs past an
// expert's T (MoE capacity buffers make T any size, 160 at mixtral's
// calibration) reads the TMA's zero fill, never the next expert's rows.
// Two consumer warpgroups each own 64 rows of the tile and run wgmma
// m64n128k16 with both operands from shared memory: the strips lie
// token-major, so A = X_iᵀ and B = X_j are both MN-major (the transpose
// bits wgmma allows for 16-bit types). Two blocks fit on an SM (97 KB of
// shared memory each), so one block's stores overlap the other's loads.
//
// fp32 activations: gram_f32_kernel, on the CUDA cores with plain fp32
// FFMA (no TF32: this path is the fp32 semantics). 256 threads each keep
// an 8 x 8 register tile (rows and columns in two 4-wide halves, so the
// operands load as float4 without bank conflicts), and 16-token strips are
// double-buffered in shared memory by cp.async, so a strip loads while the
// previous one is multiplied.
//
// What bounds it on an H100, at T = 512: with bf16 input the d²·4 bytes
// written (d = 14336: 822 MB, 0.245 ms at 3.35 TB/s; the T·d·(d+1)
// operations take 0.106 ms at the bf16 tensor-core peak); with fp32 input
// the operations (1.571 ms at 67 TFLOP/s). Each tile re-reads its two
// strips from L2 (x is 4-15 MB in bf16); the output goes out with streaming
// stores so it does not push x out of L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false ...
// (the shared flags of repro_torch.kernels.build). The fp32 sums use
// __fmaf_rn explicitly, so -fmad=false does not slow this kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TILE = 128;                    // output tile edge
constexpr int SP = TILE + 1;                 // staged tile's row stride
constexpr int STAGE_TILE_BYTES = TILE * SP * 4;

// (bi, bj), bi <= bj, of tile b of the upper triangle, row by row
__device__ __forceinline__ void tile_of(int b, int nt, int& bi, int& bj) {
  int i = 0;
  while (b >= nt - i) {
    b -= nt - i;
    ++i;
  }
  bi = i;
  bj = i + b;
}

// Write the staged tile st (TILE x TILE, row stride SP) of rows i0.. and
// columns j0.. to out (d x d), and its transpose to rows j0.., columns i0..;
// a diagonal tile (i0 == j0) writes its upper half and mirrors it. Each
// warp store covers 32 consecutive columns of one row; reads of st hit 32
// distinct banks. Called by nthr threads with index tid.
__device__ __forceinline__ void store_tile(const float* st, float* out, int d,
                                           int i0, int j0, int tid,
                                           int nthr) {
  const int lane = tid & 31;
  const int nw = nthr >> 5;
  const bool diag = i0 == j0;
  for (int r = tid >> 5; r < TILE && i0 + r < d; r += nw) {
    float* row = out + (size_t)(i0 + r) * d + j0;
#pragma unroll
    for (int e = 0; e < TILE / 32; ++e) {
      const int c = lane + 32 * e;
      if (j0 + c < d)
        __stcs(row + c, (diag && c < r) ? st[c * SP + r] : st[r * SP + c]);
    }
  }
  if (diag) return;
  for (int c = tid >> 5; c < TILE && j0 + c < d; c += nw) {
    float* row = out + (size_t)(j0 + c) * d + i0;
#pragma unroll
    for (int e = 0; e < TILE / 32; ++e) {
      const int r = lane + 32 * e;
      if (i0 + r < d) __stcs(row + r, st[r * SP + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BKT = 64;                      // tokens per stage
constexpr int STAGES = 3;
constexpr int BOX = 64 * BKT * 2;            // one 64-feature box: 8 KB
constexpr int STAGE_BYTES = 4 * BOX;         // A and B strips: 32 KB
constexpr int TC_CONSUMERS = 256;            // two warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // and a producer warp
constexpr int TC_SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment
static_assert(STAGE_TILE_BYTES <= STAGES * STAGE_BYTES,
              "the staged output tile fits in the ring");

__global__ void __launch_bounds__(TC_THREADS, 2)
gram_bf16_kernel(const __grid_constant__ CUtensorMap tm,
                 float* __restrict__ out, int n_tok, int d, int nt) {
  const int e = blockIdx.y;                  // the expert (0 unstacked)
  out += (size_t)e * d * d;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzled boxes want 1 KB aligned stages
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __shared__ __align__(8) uint64_t full[STAGES];    // a stage has landed
  __shared__ __align__(8) uint64_t empty[STAGES];   // ...and been multiplied

  int bi, bj;
  tile_of(blockIdx.x, nt, bi, bj);
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;
  const bool diag = bi == bj;
  const int n_st = (n_tok + BKT - 1) / BKT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), TC_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == TC_CONSUMERS / 32) {
    // the producer: refill a stage once every consumer warp is done with
    // it, STAGES - 1 strips ahead of the slowest
    if (lane == 0) {
      const uint32_t bytes = (diag ? 2 : 4) * BOX;
      for (int i = 0; i < n_st; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(smem_addr(&empty[s]), (i / STAGES - 1) & 1);
        const uint32_t dst = smem_addr(ring + s * STAGE_BYTES);
        const uint32_t bar = smem_addr(&full[s]);
        const int t0 = i * BKT;
        mbar_expect(bar, bytes);
        tma_load3(dst, &tm, i0, t0, e, bar);
        tma_load3(dst + BOX, &tm, i0 + 64, t0, e, bar);
        if (!diag) {
          tma_load3(dst + 2 * BOX, &tm, j0, t0, e, bar);
          tma_load3(dst + 3 * BOX, &tm, j0 + 64, t0, e, bar);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of the tile. In a
  // stage, box b holds features [64 b, 64 b + 64) of the strip as 64 token
  // rows of 128 bytes (8-token swizzle atoms of 1 KB); an operand's two
  // 64-feature halves lie one box apart (the leading byte offset), its
  // 8-token groups 1 KB apart (the stride byte offset), and each k16 step
  // moves 16 tokens = 2 KB.
  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int v = 0; v < 64; ++v) acc[v] = 0.0f;
  for (int i = 0; i < n_st; ++i) {
    const int s = i % STAGES;
    mbar_wait(smem_addr(&full[s]), (i / STAGES) & 1);
    const uint32_t base = smem_addr(ring + s * STAGE_BYTES);
    const uint32_t a = base + wg * BOX;
    const uint32_t b = base + (diag ? 0 : 2 * BOX);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BKT / 16; ++k)
      wgmma_m64n128k16_bf16_tt(acc, wgmma_desc_sw128(a + k * 2048, BOX, 1024),
                               wgmma_desc_sw128(b + k * 2048, BOX, 1024));
    wgmma_commit();
    // the previous stage's products are done: hand it back
    wgmma_wait<1>();
    if (i > 0 && lane == 0) mbar_arrive(smem_addr(&empty[(i - 1) % STAGES]));
  }
  wgmma_wait<0>();

  // stage the tile in the ring (free once both warpgroups are done), then
  // write it out. Named barrier 1: the consumer warps only.
  float* st = reinterpret_cast<float*>(ring);
  asm volatile("bar.sync 1, %0;\n" :: "n"(TC_CONSUMERS) : "memory");
  {
    // wgmma's fp32 D layout: warp w of the warpgroup owns rows 16 w ..
    // 16 w + 15; register 4 j + h of lane (g, q) holds row g + 8 (h / 2),
    // column 8 j + 2 q + (h % 2)
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        st[(r0 + 8 * (h >> 1)) * SP + 8 * j + c0 + (h & 1)] = acc[4 * j + h];
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(TC_CONSUMERS) : "memory");
  store_tile(st, out, d, i0, j0, tid, TC_CONSUMERS);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int FK = 16;                       // tokens per strip
constexpr int F_THREADS = 256;
constexpr int F_STRIP = FK * TILE;           // floats per operand strip
constexpr int F_SMEM = STAGE_TILE_BYTES;     // >= 2 buffers x 2 operands
static_assert(2 * 2 * F_STRIP * 4 <= F_SMEM, "strips fit in the stage");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// one 16-token strip of features [f0, f0 + 128) into dst (FK rows of 128
// floats), 16 bytes a copy, zeros past T and past the row length ld
__device__ __forceinline__ void load_strip(float* dst, const float* x,
                                           int n_tok, int ld, int t0, int f0,
                                           int tid) {
#pragma unroll
  for (int h = 0; h < F_STRIP / 4 / F_THREADS; ++h) {
    const int e = tid + h * F_THREADS;
    const int kk = e / (TILE / 4);
    const int c = 4 * (e % (TILE / 4));
    const int t = t0 + kk;
    const bool valid = t < n_tok && f0 + c < ld;
    const float* src = valid ? x + (size_t)t * ld + f0 + c : x;
    cp_async16(smem_addr(dst + kk * TILE + c), src, valid);
  }
}

// strip i of both operands into buffer i & 1: the A strip (features i0..)
// at fsm + 2 (i & 1) F_STRIP, the B strip (j0..) right after it; a
// diagonal tile (i0 == j0) multiplies the A strip by itself
__device__ __forceinline__ void fetch_strips(float* fsm, const float* x,
                                             int n_tok, int ld, int i, int i0,
                                             int j0, int tid) {
  float* buf = fsm + (i & 1) * 2 * F_STRIP;
  load_strip(buf, x, n_tok, ld, i * FK, i0, tid);
  if (i0 != j0) load_strip(buf + F_STRIP, x, n_tok, ld, i * FK, j0, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(F_THREADS, 2)
gram_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                int n_tok, int d, int ld, int nt) {
  extern __shared__ __align__(16) float fsm[];
  x += (size_t)blockIdx.y * n_tok * ld;      // the expert (0 unstacked)
  out += (size_t)blockIdx.y * d * d;
  int bi, bj;
  tile_of(blockIdx.x, nt, bi, bj);
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;
  const bool diag = bi == bj;
  const int tid = threadIdx.x;
  const int tx = tid & 15;                   // columns tx*4.., 64 + tx*4..
  const int ty = tid >> 4;                   // rows ty*4.., 64 + ty*4..
  const int n_st = (n_tok + FK - 1) / FK;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  if (n_st > 0) fetch_strips(fsm, x, n_tok, ld, 0, i0, j0, tid);
  for (int i = 0; i < n_st; ++i) {
    if (i + 1 < n_st) {
      fetch_strips(fsm, x, n_tok, ld, i + 1, i0, j0, tid);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* as = fsm + (i & 1) * 2 * F_STRIP;
    const float* bs = diag ? as : as + F_STRIP;
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * TILE + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * TILE + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * TILE + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * TILE + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
    }
    __syncthreads();                         // the buffer is refilled next
  }

  float* st = fsm;                           // the strips are done with
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      st[((r >> 2) * 64 + ty * 4 + (r & 3)) * SP + (c >> 2) * 64 + tx * 4 +
         (c & 3)] = acc[r][c];
  __syncthreads();
  store_tile(st, out, d, i0, j0, tid, F_THREADS);
}

// The kernels' shared memory beyond 48 KB, allowed once per process
template <typename K>
bool allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes) == cudaSuccess;
}

int fail_code() {
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : static_cast<int>(cudaErrorInvalidValue);
}

// x: (n_exp, n_tok, ld) row-major fp32 with d <= ld, ld % 4 == 0 and x
// 16-byte aligned; out: (n_exp, d, d) row-major fp32, each overwritten
// with its expert's XᵀX of the first d columns, in one launch.
int launch_f32(const void* x, void* out, int n_exp, int n_tok, int d, int ld,
               cudaStream_t stream) {
  static bool ready = false;
  if (!ready && !(ready = allow_smem(gram_f32_kernel, F_SMEM)))
    return fail_code();
  const int nt = (d + TILE - 1) / TILE;
  gram_f32_kernel<<<dim3(nt * (nt + 1) / 2, n_exp), F_THREADS, F_SMEM,
                    stream>>>(static_cast<const float*>(x),
                              static_cast<float*>(out), n_tok, d, ld, nt);
  return static_cast<int>(cudaGetLastError());
}

// The same with bf16 activations: ld % 8 == 0 (the TMA reads rows whose
// stride is a multiple of 16 bytes).
int launch_bf16(const void* x, void* out, int n_exp, int n_tok, int d,
                int ld, cudaStream_t stream) {
  static bool ready = false;
  if (!ready && !(ready = allow_smem(gram_bf16_kernel, TC_SMEM)))
    return fail_code();
  CUtensorMap tm;
  if (!tensor_map3(&tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, ld, n_tok, n_exp,
                   2ull * ld, BKT, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (d + TILE - 1) / TILE;
  gram_bf16_kernel<<<dim3(nt * (nt + 1) / 2, n_exp), TC_THREADS, TC_SMEM,
                     stream>>>(tm, static_cast<float*>(out), n_tok, d, nt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (n_exp, n_tok, ld) row-major fp32 with d <= ld, ld % 4 == 0 and x
// 16-byte aligned; out: (n_exp, d, d) row-major fp32, out[e] overwritten
// with X_eᵀX_e of the first d columns; one launch, blockIdx.y the expert
// (n_exp = 1: an unstacked Gram). Returns cudaGetLastError() after the
// launch.
int gram_xtx_stacked_f32(const void* x, void* out, int n_exp, int n_tok,
                         int d, int ld, void* stream) {
  return launch_f32(x, out, n_exp, n_tok, d, ld,
                    static_cast<cudaStream_t>(stream));
}

// The same with bf16 activations: x (n_exp, n_tok, ld) bf16, ld % 8 == 0
// (the TMA reads rows whose stride is a multiple of 16 bytes), x 16-byte
// aligned.
int gram_xtx_stacked_bf16(const void* x, void* out, int n_exp, int n_tok,
                          int d, int ld, void* stream) {
  return launch_bf16(x, out, n_exp, n_tok, d, ld,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
