// G = Xᵀ X with fp32 accumulation, for calibration activations x (T, d).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram.py::_kernel
// (gram_xtx_padded): there a (TI, TJ) output tile stays in VMEM while the
// sequential grid streams token strips through it. On Hopper the blocks
// run in parallel and in no order, so each block owns one 64x64 output
// tile and loops over all T tokens itself, staging 16-token strips of the
// two column ranges it needs in shared memory. Each of the 256 threads
// keeps a 4x4 register tile of fp32 sums (plain FFMA, no TF32).
//
// G is symmetric: blocks below the diagonal exit at once and each block
// above it also writes its mirror image, so half the products are done.
// A diagonal block computes both halves of its tile with the same
// summation order, so the result is exactly symmetric.
//
// What bounds it on an H100: T·d·(d+1) fp32 operations against d²·4 bytes
// written and T·d read. At T = 512 it is operation-bound (67 TFLOP/s fp32
// against 3.35 TB/s). This simple version reaches a fraction of that peak;
// TMA staging and a warp-specialised pipeline are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false ...
// (the shared flags of repro_torch.kernels.build). The sums use
// __fmaf_rn explicitly, so -fmad=false does not slow this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;                       // output tile edge
constexpr int BK = 16;                       // tokens per strip
constexpr int TM = 4;                        // per-thread tile edge
constexpr int TPR = BM / TM;                 // threads per tile row (16)
constexpr int NT = TPR * TPR;                // threads per block (256)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
gram_kernel(const T* __restrict__ x, float* __restrict__ out, int n_tok,
            int d) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bi > bj) return;  // mirrored by block (bj, bi)
  const int i0 = bi * BM;
  const int j0 = bj * BM;

  __shared__ __align__(16) float xs_i[BK][BM];
  __shared__ __align__(16) float xs_j[BK][BM];

  const int tid = threadIdx.x;
  const int tx = tid % TPR;
  const int ty = tid / TPR;
  float acc[TM][TM];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[r][c] = 0.f;

  for (int t0 = 0; t0 < n_tok; t0 += BK) {
    // coalesced strip loads: consecutive threads read consecutive features
#pragma unroll
    for (int e = tid; e < BK * BM; e += NT) {
      const int kk = e / BM;
      const int cc = e % BM;
      const int t = t0 + kk;
      const int ci = i0 + cc;
      const int cj = j0 + cc;
      const size_t row = (size_t)t * d;
      xs_i[kk][cc] = (t < n_tok && ci < d) ? to_f32(x[row + ci]) : 0.f;
      xs_j[kk][cc] = (t < n_tok && cj < d) ? to_f32(x[row + cj]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&xs_i[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&xs_j[kk][tx * TM]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      const float b[TM] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TM; ++c) acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gi = i0 + ty * TM + r;
    if (gi >= d) continue;
#pragma unroll
    for (int c = 0; c < TM; ++c) {
      const int gj = j0 + tx * TM + c;
      if (gj >= d) continue;
      out[(size_t)gi * d + gj] = acc[r][c];
      if (bi != bj) out[(size_t)gj * d + gi] = acc[r][c];
    }
  }
}

template <typename T>
int launch(const void* x, float* out, int n_tok, int d, void* stream) {
  const int nt = (d + BM - 1) / BM;
  dim3 grid(nt, nt);
  gram_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), out, n_tok, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (n_tok, d) row-major fp32; out: (d, d) row-major fp32, overwritten
// with XᵀX. Returns cudaGetLastError() after the launch.
int gram_xtx_f32(const void* x, void* out, int n_tok, int d, void* stream) {
  return launch<float>(x, static_cast<float*>(out), n_tok, d, stream);
}

// Same with bf16 activations (converted to fp32 on load).
int gram_xtx_bf16(const void* x, void* out, int n_tok, int d, void* stream) {
  return launch<__nv_bfloat16>(x, static_cast<float*>(out), n_tok, d, stream);
}

}  // extern "C"
