// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's
// src/repro/kernels/flash_attn.py, flash_attention (_flash_kernel): for q
// (B, Hq, S, D) and k, v (B, Hkv, S, D) with Hq % Hkv == 0, query head h
// attends to KV head h / (Hq / Hkv):
//
//   o = softmax(q k^T / sqrt(D) [causal: masked to -1e30 above the diagonal])
//       v
//
// by the online softmax: a running max m, denominator l and accumulator
// acc in fp32 over key blocks, finalised as acc / max(l, 1e-30) and cast to
// the input type.  Masked scores are -1e30 (not -inf), as in the reference;
// keys past the end of the sequence (a ragged last tile) are -inf, so they
// weigh exactly 0.
//
// The TPU kernel's grid is (B * Hq, S / bq, S / bk) with the k axis
// sequential, carrying m, l and acc in VMEM scratch from one grid step to
// the next.  CTAs run in no order and carry nothing to each other, so here
// one CTA owns one (b * Hq + h, 64-row query block) and loops over the key
// blocks itself; under the causal mask the loop stops at the diagonal, so
// blocks above it cost nothing (the reference's pl.when skip).  Query
// blocks are issued heaviest first (the last rows see the most keys).
//
// Layout of work: 256 threads as 16 x 16.  Thread (ty, tx) owns query rows
// 4 ty .. 4 ty + 3 of the block: it computes the scores of those rows at
// key columns tx + 16 j (j < 4) and the output of those rows at feature
// columns tx + 16 j (j < 8, so D <= 128).  Its rows' m and l live in its
// registers (the 16 threads of a row group reduce the block's max and sum
// with warp shuffles), and so do its 32 accumulators, so the rescaling by
// exp(m_old - m_new) needs no shared memory.  The Q tile stays in shared
// memory as fp32 for the whole loop; each K/V tile is staged there as fp32
// (K rows padded to D + 1 floats, so the 16 different key rows a warp
// reads sit in 16 banks), and P = exp(s - m) goes through shared memory
// into the second product.  115 KB of shared memory at D = 128: two CTAs
// per SM.
//
// Bound: at the served shape (B = 4, Hq = 40, Hkv = 8, S = 1024, D = 128,
// bf16) the causal products are 43 GFLOP against 101 MB of q, k, v and o,
// so the tensor cores' rate bounds it (0.043 ms at 989 TFLOP/s), and in
// fp32 the 67 TFLOP/s of the FMA units (0.64 ms).  What this design does:
// it skips the blocks above the diagonal and reads each K/V tile once per
// 64 query rows; every product is an fp32 FMA out of shared memory, so it
// runs at the FMA units' rate at best, limited by the shared-memory loads
// (8 loads per 16 FMAs in q k^T, 12 per 32 in p v).  It does not use the
// tensor cores (mma.sync / wgmma), TMA or a pipeline of tiles; PERF.md has
// its measured gap to the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // key rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxD = 128;      // 16 threads x 8 feature columns
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// max / sum over the 16 lanes of a row group (lanes 16 g .. 16 g + 15)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Strides {  // elements; the feature axis is contiguous
  long long b, h, s;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq,
                 int group, int S, int D, int causal, float scale,
                 Strides qs, Strides ks, Strides vs, Strides os) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // kBQ x D
  float* Ks = Qs + kBQ * D;          // kBK x (D + 1)
  float* Vs = Ks + kBK * (D + 1);    // kBK x D
  float* Ps = Vs + kBK * D;          // kBQ x kBK

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* op = o + b * os.b + h * os.h;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D, row = q0 + r;
    Qs[idx] = row < S ? to_f(qp[row * qs.s + c]) : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q is staged / the last tile's P V is done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D, row = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (row < S) {
        kx = to_f(kp[row * ks.s + c]);
        vx = to_f(vp[row * vs.s + c]);
      }
      Ks[r * (D + 1) + c] = kx;
      Vs[idx] = vx;
    }
    __syncthreads();

    // s = q k^T for rows 4 ty + i, key columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float* qrow = Qs + (ty * 4) * D;
    const float* krow = Ks + tx * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qrow[i * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = krow[j * 16 * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over this tile, one row at a time
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= S) x = -INFINITY;
        else if (causal && col > row) x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * kBK + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = corr * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P V for rows 4 ty + i, feature columns tx + 16 j
    const float* prow = Ps + (ty * 4) * kBK;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = prow[i * kBK + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < D ? Vs[kk * D + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store(op + row * os.s + c, acc[i][j] / den);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D +
          (size_t)kBQ * kBK);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int S, int D, int causal,
                   float scale, Strides qs, Strides ks, Strides vs,
                   Strides os, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + kBQ - 1) / kBQ));
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hq / Hkv, S, D,
      causal, scale, qs, ks, vs, os);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_max_d() { return kMaxD; }

// dtype codes: 0 float, 1 bfloat16, 2 float16 (q, k, v and o alike).
// Strides are in elements, for the (b, h, s) axes of each tensor; the
// feature axis is contiguous.  Returns a cudaError_t, or -1 for an
// unsupported dtype.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int S, int D, int causal, float scale, int dtype,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss,
    void* stream_ptr) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || D < 1 ||
      D > kMaxD || (long long)B * Hq > 0x7FFFFFFFLL ||
      (S + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, B, Hq, Hkv, S, D, causal, scale, qs,
                           ks, vs, os, stream);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, D, causal,
                                   scale, qs, ks, vs, os, stream);
    case 2:
      return launch<__half>(q, k, v, o, B, Hq, Hkv, S, D, causal, scale, qs,
                            ks, vs, os, stream);
    default:
      return -1;
  }
}
