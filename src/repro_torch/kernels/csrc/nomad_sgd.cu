// NOMAD block-SGD wave kernel for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of the JAX package's
// src/repro/kernels/nomad_sgd.py, which are one computation:
//   * nomad_sgd_waves_grid  (_wave_grid_kernel) - one schedule step, p cells;
//   * nomad_sgd_waves_block (_wave_kernel)      - the same for one cell;
//   * nomad_sgd_block       (_kernel)           - one cell, every rating its
//                                                 own wave.
// Per rating (eqs. 9-10), from the old values of both rows:
//   err = a - <w, h>;  w' = w - lr(-err h + lam w);  h' = h - lr(-err w + lam h)
//
// Layout: a CSR of conflict-free waves.  rows/cols (int32, local indices
// into the cell's W shard and H block) and vals (f32) are one flat list in
// wave-major order; woff[w] .. woff[w+1] are the ratings of wave w, and
// cell_woff[c] .. cell_woff[c+1] are the waves of cell c.  Within a wave no
// row and no column repeats, so its ratings may be applied in any order.
//
// Mapping: one CTA per cell (blockIdx.x).  The CTA walks its waves in
// order; each warp takes ratings of the current wave; lane l holds the k
// indices l, l+32, ... in fp32 registers.  The dot is reduced by a fixed
// __shfl_xor_sync butterfly, so every lane gets the same bits and the
// result does not depend on which warp took the rating (no atomics).  Both
// rows are written once, rounded once to the storage type.  A
// __syncthreads() between waves orders them: it makes one wave's global
// writes visible to the next wave's reads in the same CTA.
//
// Bound: the wave chain, not bandwidth.  Each wave costs at least one
// block-wide barrier plus one dependent global-memory round trip (the next
// wave reads rows the previous one may have written), and a hot item puts
// its whole conflict chain into every cell.  The bandwidth bound - both
// rows read and written per update, 4*k*s + 12 bytes - is far below the
// chain's latency at the shapes the engine runs (PERF.md has both numbers).
// What this design does about it today: nothing beyond batching all p
// cells of a schedule step into one launch (p CTAs on 132 SMs).
//
// The storage type T is float, __nv_bfloat16 or __half; arithmetic is fp32
// and conversions use the intrinsics only.  KPL = k values per lane.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const __half* p) {
  return __half2float(*p);
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_f32(__half* p, float x) {
  *p = __float2half_rn(x);
}

template <typename T, int KPL>
__global__ void __launch_bounds__(kThreads)
nomad_sgd_waves_kernel(T* W, T* H,
                       const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ cols,
                       const float* __restrict__ vals,
                       const int32_t* __restrict__ woff,
                       const int32_t* __restrict__ cell_woff,
                       long long w_cell_stride, long long h_cell_stride,
                       int k, float lr, float lam) {
  const int cell = blockIdx.x;
  T* Wc = W + cell * w_cell_stride;
  T* Hc = H + cell * h_cell_stride;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int w_begin = cell_woff[cell];
  const int w_end = cell_woff[cell + 1];

  for (int w = w_begin; w < w_end; ++w) {
    const int r_end = woff[w + 1];
    for (int t = woff[w] + warp; t < r_end; t += n_warps) {
      T* wp = Wc + static_cast<long long>(rows[t]) * k;
      T* hp = Hc + static_cast<long long>(cols[t]) * k;
      const float a = vals[t];
      float wv[KPL];
      float hv[KPL];
      float part = 0.0f;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const int d = lane + u * kWarp;
        wv[u] = d < k ? load_f32(wp + d) : 0.0f;
        hv[u] = d < k ? load_f32(hp + d) : 0.0f;
        part += wv[u] * hv[u];
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      const float err = a - part;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const int d = lane + u * kWarp;
        if (d < k) {
          store_f32(wp + d, wv[u] - lr * (-err * hv[u] + lam * wv[u]));
          store_f32(hp + d, hv[u] - lr * (-err * wv[u] + lam * hv[u]));
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int KPL>
cudaError_t launch(void* W, void* H, const void* rows, const void* cols,
                   const void* vals, const void* woff, const void* cell_woff,
                   int n_cells, long long w_cell_stride,
                   long long h_cell_stride, int k, float lr, float lam,
                   cudaStream_t stream) {
  nomad_sgd_waves_kernel<T, KPL><<<n_cells, kThreads, 0, stream>>>(
      static_cast<T*>(W), static_cast<T*>(H),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const float*>(vals), static_cast<const int32_t*>(woff),
      static_cast<const int32_t*>(cell_woff), w_cell_stride, h_cell_stride,
      k, lr, lam);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k(void* W, void* H, const void* rows, const void* cols,
                       const void* vals, const void* woff,
                       const void* cell_woff, int n_cells,
                       long long w_cell_stride, long long h_cell_stride,
                       int k, float lr, float lam, cudaStream_t stream) {
#define NOMAD_LAUNCH(KPL)                                                   \
  return launch<T, KPL>(W, H, rows, cols, vals, woff, cell_woff, n_cells,  \
                        w_cell_stride, h_cell_stride, k, lr, lam, stream)
  if (k <= 1 * kWarp) NOMAD_LAUNCH(1);
  if (k <= 2 * kWarp) NOMAD_LAUNCH(2);
  if (k <= 4 * kWarp) NOMAD_LAUNCH(4);
  if (k <= 8 * kWarp) NOMAD_LAUNCH(8);
  if (k <= 16 * kWarp) NOMAD_LAUNCH(16);
  NOMAD_LAUNCH(32);
#undef NOMAD_LAUNCH
}

}  // namespace

// Largest k the kernel takes (32 values per lane).
extern "C" int nomad_sgd_max_k() { return 32 * kWarp; }

// Applies the waves of n_cells cells in place on W (n_cells, m_tile, k)
// and H (n_cells, n_tile, k); w_cell_stride = m_tile * k and
// h_cell_stride = n_tile * k elements.  dtype: 0 float, 1 bfloat16,
// 2 float16.  Launches on `stream` and does not synchronise.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int nomad_sgd_waves(void* W, void* H, const void* rows,
                               const void* cols, const void* vals,
                               const void* woff, const void* cell_woff,
                               int n_cells, long long w_cell_stride,
                               long long h_cell_stride, int k, float lr,
                               float lam, int dtype, void* stream) {
  if (n_cells < 1 || k < 1 || k > 32 * kWarp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch_k<float>(
          W, H, rows, cols, vals, woff, cell_woff, n_cells, w_cell_stride,
          h_cell_stride, k, lr, lam, s));
    case 1:
      return static_cast<int>(dispatch_k<__nv_bfloat16>(
          W, H, rows, cols, vals, woff, cell_woff, n_cells, w_cell_stride,
          h_cell_stride, k, lr, lam, s));
    case 2:
      return static_cast<int>(dispatch_k<__half>(
          W, H, rows, cols, vals, woff, cell_woff, n_cells, w_cell_stride,
          h_cell_stride, k, lr, lam, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
