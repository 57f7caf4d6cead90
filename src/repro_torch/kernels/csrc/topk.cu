// Serving top-k kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's src/repro/serve/topk.py,
// _topk_pallas (_topk_kernel): for a batch of U user rows W_u (U, k) and the
// item catalog H (n, k), the k_top items of largest score <W_u[u], H[i]>,
// ordered by (score descending, item id ascending) - exactly, ties included.
// With int8 H a per-item scale multiplies the fp32 dot *after* the sum.
//
// The TPU kernel keeps a running (U, k_top) list resident across a
// sequential grid over item tiles.  CTAs carry nothing to each other, so
// here the selection is a tournament of sorted lists:
//
//   pass 1 (topk_chunk_kernel), grid (item chunks x user blocks): a CTA
//     holds UB user rows in shared memory (fp32), scores its CHUNK items
//     (one thread per item, fp32 FMAs over k in a fixed order 0..k-1),
//     rounds each score once to the score type, packs (score, id) into one
//     64-bit key, bitonic-sorts each user's CHUNK keys in shared memory and
//     writes the best kc = min(k_top, CHUNK);
//   pass 2 (topk_merge_kernel), one launch per round: each user's sorted
//     lists are merged pairwise (merge path: one thread per output element,
//     a binary search for its co-rank), truncated to k_top, until one list
//     is left;
//   decode (topk_decode_kernel): keys back to (score, id).
//
// The key orders exactly as the reference selects: the high word is the
// score's IEEE bits mapped to an unsigned order (-0.0 first canonicalised to
// +0.0, which the reference treats as equal), the low word 0xFFFFFFFF - id,
// so a larger key is a larger score or, on equal scores, a smaller id.
// Keys are unique per user (ids are), so every round is an exact total
// order: no atomics, a fixed reduction order, bitwise-equal results from
// call to call.  A score of -inf reports the sentinel id n, as the
// reference's scan does.
//
// Bound: bytes.  H is read once from device memory for each user block
// (2 U n k flops against n k elem bytes: at U = 64, k = 100 the fp32
// flops take about as long as one read of H).  What this design does about
// it: UB up to 32 users share each H row a thread loads; the W_u rows are
// broadcast from shared memory.  It does not yet use tensor cores, TMA or
// coalesced loads of H (each thread walks its own row), and the bitonic
// sort of every chunk costs more than the selection needs at small k_top;
// PERF.md has the measured gap to the bound.
//
// Types: W_u (and the scores) float, __nv_bfloat16 or __half with H of the
// same type, or float W_u with int8 H (dequantised user rows against the
// quantised catalog).  Arithmetic is fp32; conversions use the intrinsics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;          // items per pass-1 CTA == its threads
constexpr int kMergeThreads = 256;
constexpr int kMaxSmem = 232448;     // Hopper: 227 KB per block
constexpr uint32_t kNegInf = 0xFF800000u;

typedef unsigned long long u64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// round an fp32 score once to the score type (and back, exactly)
__device__ __forceinline__ float round_to(float s, const float*) { return s; }
__device__ __forceinline__ float round_to(float s, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(s));
}
__device__ __forceinline__ float round_to(float s, const __half*) {
  return __half2float(__float2half_rn(s));
}

__device__ __forceinline__ void store_score(float* p, float s) { *p = s; }
__device__ __forceinline__ void store_score(__nv_bfloat16* p, float s) {
  *p = __float2bfloat16_rn(s);      // exact: s came from this type
}
__device__ __forceinline__ void store_score(__half* p, float s) {
  *p = __float2half_rn(s);
}

__device__ __forceinline__ u64 make_key(float s, uint32_t id) {
  uint32_t b = __float_as_uint(s);
  if ((b & 0x7FFFFFFFu) == 0) b = 0;                 // -0.0 -> +0.0
  const uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)ord << 32) | (u64)(0xFFFFFFFFu - id);
}

__device__ __forceinline__ float key_score(u64 key) {
  const uint32_t ord = (uint32_t)(key >> 32);
  const uint32_t b = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
  return __uint_as_float(b);
}

__device__ __forceinline__ uint32_t key_id(u64 key) {
  return 0xFFFFFFFFu - (uint32_t)key;
}

template <typename TW, typename TH, int UB>
__global__ void __launch_bounds__(kChunk) topk_chunk_kernel(
    const TW* __restrict__ Wu, const TH* __restrict__ H,
    const float* __restrict__ hs, int U, long long n, int k, int kc,
    long long n_chunks, u64* __restrict__ out) {
  extern __shared__ u64 smem[];
  u64* keys = smem;                                        // UB x kChunk
  float* w = reinterpret_cast<float*>(smem + UB * kChunk);  // UB x k
  const long long chunk = blockIdx.x;
  const int u0 = blockIdx.y * UB;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < UB * k; idx += kChunk) {
    const int u = idx / k;
    w[idx] = (u0 + u < U)
        ? to_f(Wu[(long long)(u0 + u) * k + (idx - u * k)]) : 0.0f;
  }
  __syncthreads();

  const long long item = chunk * kChunk + tid;
  if (item < n) {
    float acc[UB];
#pragma unroll
    for (int u = 0; u < UB; ++u) acc[u] = 0.0f;
    const TH* h = H + item * k;
    for (int kk = 0; kk < k; ++kk) {
      const float hv = to_f(h[kk]);
#pragma unroll
      for (int u = 0; u < UB; ++u) acc[u] = fmaf(w[u * k + kk], hv, acc[u]);
    }
    const float scale = hs != nullptr ? hs[item] : 1.0f;
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const float s = hs != nullptr ? acc[u] * scale : acc[u];
      keys[u * kChunk + tid] = make_key(round_to(s, Wu), (uint32_t)item);
    }
  } else {
#pragma unroll
    for (int u = 0; u < UB; ++u) keys[u * kChunk + tid] = 0ull;  // below all
  }
  __syncthreads();

  // bitonic sort of each user's kChunk keys, descending
  for (int size = 2; size <= kChunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int idx = tid; idx < UB * (kChunk / 2); idx += kChunk) {
        const int row = idx / (kChunk / 2);
        const int j = idx - row * (kChunk / 2);
        const int i = 2 * stride * (j / stride) + (j % stride);
        u64* r = keys + row * kChunk;
        const u64 a = r[i], b = r[i + stride];
        const bool desc = (i & size) == 0;
        if ((a < b) == desc) {
          r[i] = b;
          r[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < UB * kc; idx += kChunk) {
    const int row = idx / kc;
    const int j = idx - row * kc;
    if (u0 + row < U)
      out[((long long)(u0 + row) * n_chunks + chunk) * kc + j] =
          keys[row * kChunk + j];
  }
}

// Merge lists 2j and 2j+1 of each user (nl lists of length L, sorted
// descending, padded with key 0) into list j of length Lo = min(k_top, 2L);
// an odd last list is copied through.  One thread per output element.
__global__ void __launch_bounds__(kMergeThreads) topk_merge_kernel(
    const u64* __restrict__ in, int nl, int L, u64* __restrict__ out,
    int nlo, int Lo, long long total) {
  const long long t = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (t >= total) return;
  const int i = (int)(t % Lo);
  const long long r = t / Lo;
  const int j = (int)(r % nlo);
  const long long u = r / nlo;
  const u64* A = in + (u * nl + 2LL * j) * L;
  u64 v;
  if (2 * j + 1 >= nl) {
    v = i < L ? A[i] : 0ull;
  } else {
    const u64* B = A + L;
    // a = how many of the first i outputs come from A (A wins ties)
    int lo = i - L > 0 ? i - L : 0;
    int hi = i < L ? i : L;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (A[mid] >= B[i - mid - 1]) lo = mid + 1; else hi = mid;
    }
    const int a = lo, b = i - lo;
    v = (a < L && (b >= L || A[a] >= B[b])) ? A[a] : B[b];
  }
  out[t] = v;
}

template <typename TW>
__global__ void __launch_bounds__(kMergeThreads) topk_decode_kernel(
    const u64* __restrict__ in, int L, int k_top, long long total,
    uint32_t n, TW* __restrict__ out_s, int* __restrict__ out_i) {
  const long long t = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (t >= total) return;
  const long long u = t / k_top;
  const u64 key = in[u * L + (t - u * k_top)];
  float s = key_score(key);
  uint32_t id = key_id(key);
  if (key == 0ull || __float_as_uint(s) == kNegInf) {
    s = __uint_as_float(kNegInf);
    id = n;
  }
  store_score(out_s + t, s);
  out_i[t] = (int)id;
}

long long min_ll(long long a, long long b) { return a < b ? a : b; }
long long max_ll(long long a, long long b) { return a > b ? a : b; }

template <typename TW, typename TH, int UB>
cudaError_t launch_chunks(const void* Wu, const void* H, const float* hs,
                          int U, long long n, int k, int kc,
                          long long n_chunks, u64* out, cudaStream_t stream) {
  const size_t smem = (size_t)UB * kChunk * sizeof(u64)
      + (size_t)UB * k * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kern = topk_chunk_kernel<TW, TH, UB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)n_chunks, (unsigned)((U + UB - 1) / UB));
  kern<<<grid, kChunk, smem, stream>>>(
      static_cast<const TW*>(Wu), static_cast<const TH*>(H), hs, U, n, k, kc,
      n_chunks, out);
  return cudaGetLastError();
}

template <typename TW, typename TH>
cudaError_t launch_chunks_ub(const void* Wu, const void* H, const float* hs,
                             int U, long long n, int k, int kc,
                             long long n_chunks, u64* out,
                             cudaStream_t stream) {
  if (U == 1)
    return launch_chunks<TW, TH, 1>(Wu, H, hs, U, n, k, kc, n_chunks, out,
                                    stream);
  if (U <= 8)
    return launch_chunks<TW, TH, 8>(Wu, H, hs, U, n, k, kc, n_chunks, out,
                                    stream);
  return launch_chunks<TW, TH, 32>(Wu, H, hs, U, n, k, kc, n_chunks, out,
                                   stream);
}

template <typename TW>
cudaError_t launch_decode(const u64* in, int L, int U, int k_top, long long n,
                          void* out_s, int* out_i, cudaStream_t stream) {
  const long long total = (long long)U * k_top;
  const unsigned blocks =
      (unsigned)((total + kMergeThreads - 1) / kMergeThreads);
  topk_decode_kernel<TW><<<blocks, kMergeThreads, 0, stream>>>(
      in, L, k_top, total, (uint32_t)n, static_cast<TW*>(out_s), out_i);
  return cudaGetLastError();
}

}  // namespace

// Scratch (in 64-bit keys) one buffer of topk_scores needs: the largest
// round of the tournament.
extern "C" long long topk_scratch_elems(int U, long long n, int k_top) {
  long long nl = (n + kChunk - 1) / kChunk;
  long long L = min_ll(k_top, kChunk);
  long long most = (long long)U * nl * L;
  while (nl > 1) {
    nl = (nl + 1) / 2;
    L = min_ll(k_top, 2 * L);
    most = max_ll(most, (long long)U * nl * L);
  }
  return most;
}

// dtype codes: 0 float, 1 bfloat16, 2 float16, 3 int8 (H only, float W_u).
// buf0/buf1 hold topk_scratch_elems(U, n, k_top) keys each.  Returns a
// cudaError_t, or -1 for an unsupported type pair, -2 for short scratch.
extern "C" int topk_scores(const void* Wu, const void* H, const void* hs,
                           int U, long long n, int k, int w_dtype,
                           int h_dtype, int k_top, void* buf0, void* buf1,
                           long long buf_elems, void* out_s, void* out_i,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (U < 1 || n < 1 || k < 1 || k_top < 1 || k_top > n || n >= 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  if (topk_scratch_elems(U, n, k_top) > buf_elems) return -2;
  const float* scale = static_cast<const float*>(hs);
  u64* cur = static_cast<u64*>(buf0);
  u64* nxt = static_cast<u64*>(buf1);
  long long nl = (n + kChunk - 1) / kChunk;
  int L = (int)min_ll(k_top, kChunk);

  cudaError_t err;
  if (w_dtype == 0 && h_dtype == 0)
    err = launch_chunks_ub<float, float>(Wu, H, scale, U, n, k, L, nl, cur,
                                         stream);
  else if (w_dtype == 1 && h_dtype == 1)
    err = launch_chunks_ub<__nv_bfloat16, __nv_bfloat16>(
        Wu, H, scale, U, n, k, L, nl, cur, stream);
  else if (w_dtype == 2 && h_dtype == 2)
    err = launch_chunks_ub<__half, __half>(Wu, H, scale, U, n, k, L, nl, cur,
                                           stream);
  else if (w_dtype == 0 && h_dtype == 3)
    err = launch_chunks_ub<float, int8_t>(Wu, H, scale, U, n, k, L, nl, cur,
                                          stream);
  else
    return -1;
  if (err != cudaSuccess) return err;

  while (nl > 1) {
    const long long nlo = (nl + 1) / 2;
    const int Lo = (int)min_ll(k_top, 2LL * L);
    const long long total = (long long)U * nlo * Lo;
    const unsigned blocks =
        (unsigned)((total + kMergeThreads - 1) / kMergeThreads);
    topk_merge_kernel<<<blocks, kMergeThreads, 0, stream>>>(
        cur, (int)nl, L, nxt, (int)nlo, Lo, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    u64* t = cur;
    cur = nxt;
    nxt = t;
    nl = nlo;
    L = Lo;
  }

  int* ids = static_cast<int*>(out_i);
  if (w_dtype == 0)
    err = launch_decode<float>(cur, L, U, k_top, n, out_s, ids, stream);
  else if (w_dtype == 1)
    err = launch_decode<__nv_bfloat16>(cur, L, U, k_top, n, out_s, ids,
                                       stream);
  else
    err = launch_decode<__half>(cur, L, U, k_top, n, out_s, ids, stream);
  return err;
}
