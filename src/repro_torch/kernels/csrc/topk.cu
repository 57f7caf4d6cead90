// Serving top-k kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's src/repro/serve/topk.py,
// _topk_pallas (_topk_kernel): for a batch of U user rows W_u (U, k) and the
// item catalog H (n, k), the k_top items of largest score <W_u[u], H[i]>,
// ordered by (score descending, item id ascending) - exactly, ties included.
// With int8 H a per-item scale multiplies the fp32 dot *after* the sum.
//
// The TPU kernel keeps one running (U, k_top) list resident across a
// sequential grid over item tiles.  Here a CTA does the same over one
// stripe of the catalog, and the stripes' lists meet in a tournament:
//
//   pass 1 (topk_stripe_kernel), grid (user blocks x stripes), the user
//     block fastest so the CTAs that read the same items run together and
//     share them through L2: a CTA holds UB user rows in shared memory
//     (fp32, rows padded to a multiple of 4 and read 16 bytes at a time)
//     and walks its stripe's chunks of 256 items, one thread per item.
//     Each score is an fp32 FMA chain over k in the fixed order 0..k-1,
//     rounded once to the score type and packed with its id into one
//     64-bit key.  Each user keeps a sorted running list of its best L =
//     min(k_top, stripe items) keys; its threshold tau is the list's last
//     key (key 0, below every item, until the list is full).  A key enters
//     the user's candidate buffer only if it exceeds tau; after each chunk
//     a warp per user with candidates flushes just those into the list,
//     truncated to L: for L <= 32 in registers, 32 candidates at a time by
//     bitonic networks of shuffles (flush_short); for longer lists by a
//     bitonic sort of the candidates, padded to a power of two, and an
//     insertion by rank that moves the list's keys in place, from the back
//     (flush_user).  A flush costs what passed, not the chunk.
//   pass 2 (topk_merge_kernel), one launch per round: each user's S sorted
//     lists are merged pairwise (merge path: one thread per output element,
//     a binary search for its co-rank), truncated to k_top, until one list
//     is left;
//   decode (topk_decode_kernel): keys back to (score, id).
//
// The filter is exact because keys are unique per user: a key at or below
// the L-th best key seen so far can never be among the stripe's best L.
//
// The key orders exactly as the reference selects: the high word is the
// score's IEEE bits mapped to an unsigned order (-0.0 first canonicalised to
// +0.0, which the reference treats as equal), the low word 0xFFFFFFFF - id,
// so a larger key is a larger score or, on equal scores, a smaller id.
// Every round is an exact total order: the candidates' order in a buffer
// (set by shared-memory atomics) is erased by the sort, so the results are
// bitwise equal from call to call.  A score of -inf reports the sentinel id
// n, as the reference's scan does.
//
// Bound: bytes or flops, by type.  H is read once from device memory (and
// once from L2 per user block); 2 U n k fp32 FMAs score it (at U = 64,
// k = 100 in fp32 these take about as long as one read of H).  The user
// block, its shared-memory lists and the stripes are planned by the Python
// wrapper (kernels/topk.py, plan): the largest UB whose CTA fits twice per
// SM, and as many stripes as make one wave of two CTAs per SM.  What the
// design does not do yet: the scores use no tensor cores, every FMA takes
// its w from shared memory (a broadcast 16-byte load per 4 FMAs), and H
// is read row per thread, not in coalesced tiles; a long list's flush
// waits on shared-memory round trips.  PERF.md has the measured split.
//
// Types: W_u (and the scores) float, __nv_bfloat16 or __half with H of the
// same type, or float W_u with int8 H (dequantised user rows against the
// quantised catalog).  Arithmetic is fp32; conversions use the intrinsics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;          // items per chunk == threads per CTA
constexpr int kWarps = kChunk / 32;
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

// four consecutive elements of H as one load of 4 x sizeof(T) bytes
template <typename T> struct Pack4;
template <> struct Pack4<float> { typedef float4 type; };
template <> struct Pack4<__nv_bfloat16> { typedef uint2 type; };
template <> struct Pack4<__half> { typedef uint2 type; };
template <> struct Pack4<int8_t> { typedef int type; };

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&f)[4]) {
  const typename Pack4<T>::type r =
      *reinterpret_cast<const typename Pack4<T>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = to_f(e[j]);
}

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

// acc[u] = sum over kk = 0..k-1 of w[u][kk] * h[kk], one fmaf at a time in
// that order (so vector loads do not change a bit of it).  w's rows are kp
// floats apart, kp a multiple of 4; vec: h is 4-element aligned, k % 4 == 0.
template <typename TH, int UB>
__device__ __forceinline__ void score_row(const float* w, int kp,
                                          const TH* h, int k, bool vec,
                                          float (&acc)[UB]) {
#pragma unroll
  for (int u = 0; u < UB; ++u) acc[u] = 0.0f;
  const int k4 = k & ~3;
  for (int kk = 0; kk < k4; kk += 4) {
    float hv[4];
    if (vec) {
      load4(h + kk, hv);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = to_f(h[kk + j]);
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const float4 wv = *reinterpret_cast<const float4*>(w + u * kp + kk);
      acc[u] = fmaf(wv.x, hv[0], acc[u]);
      acc[u] = fmaf(wv.y, hv[1], acc[u]);
      acc[u] = fmaf(wv.z, hv[2], acc[u]);
      acc[u] = fmaf(wv.w, hv[3], acc[u]);
    }
  }
  for (int kk = k4; kk < k; ++kk) {
    const float hv = to_f(h[kk]);
#pragma unroll
    for (int u = 0; u < UB; ++u) acc[u] = fmaf(w[u * kp + kk], hv, acc[u]);
  }
}

// One warp merges a user's c candidates (cb, unsorted, 1 <= c <= kChunk)
// into its sorted list lb of L keys, truncated to L; rk holds c ranks.
__device__ void flush_user(u64* lb, int L, u64* cb, unsigned short* rk,
                           int c, int lane) {
  int P = 1;
  while (P < c) P <<= 1;
  for (int i = c + lane; i < P; i += 32) cb[i] = 0ull;
  __syncwarp();
  // bitonic sort of cb[0..P), descending; a lane's (up to 4) pairs of a
  // stage are disjoint, so it loads them all before it stores any
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      u64 a[kChunk / 64], b[kChunk / 64];
      int at[kChunk / 64];
#pragma unroll
      for (int t = 0; t < kChunk / 64; ++t) {
        const int j = lane + 32 * t;
        at[t] = ((j & ~(stride - 1)) << 1) | (j & (stride - 1));
        if (j < P / 2) {
          a[t] = cb[at[t]];
          b[t] = cb[at[t] + stride];
        }
      }
#pragma unroll
      for (int t = 0; t < kChunk / 64; ++t) {
        const int i = at[t];
        if (lane + 32 * t < P / 2 && (a[t] < b[t]) == ((i & size) == 0)) {
          cb[i] = b[t];
          cb[i + stride] = a[t];
        }
      }
      __syncwarp();
    }
  }
  // only the best cn candidates can stay; candidate j lands at j + rk[j],
  // rk[j] = how many list keys beat it
  const int cn = c < L ? c : L;
  for (int j = lane; j < cn; j += 32) {
    int lo = 0, hi = L;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lb[mid] > cb[j]) lo = mid + 1; else hi = mid;
    }
    rk[j] = (unsigned short)lo;
  }
  __syncwarp();
  // list key p >= rk[0] moves down by g(p) = #{j < cn : rk[j] <= p} (a
  // count over the ascending rk, by a fixed number of halvings), dropped
  // past L.  From the back, 4 x 32 keys at a time: every key moves to
  // a place at or after its own, so reading a group before writing it
  // and going backwards overwrites no key before it is read.
  const int r0 = rk[0];
  int top_step = 1;
  while (top_step * 2 <= cn) top_step <<= 1;
  for (int top = L; top > r0; top -= 128) {
    u64 v[4];
    int q[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int p = top - 128 + 32 * w + lane;
      q[w] = L;
      if (p >= r0) {
        v[w] = lb[p];
        q[w] = p;
      }
    }
    for (int step = top_step; step > 0; step >>= 1) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int p = top - 128 + 32 * w + lane;
        const int g = q[w] - p;
        if (p >= r0 && g + step <= cn && rk[g + step - 1] <= p)
          q[w] += step;
      }
    }
    __syncwarp();
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (q[w] < L) lb[q[w]] = v[w];
    __syncwarp();
  }
  for (int j = lane; j < cn; j += 32)
    if (j + rk[j] < L) lb[j + rk[j]] = cb[j];
  __syncwarp();
}

__device__ __forceinline__ u64 max_u64(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 min_u64(u64 a, u64 b) { return a < b ? a : b; }

// One compare-exchange stage of a bitonic network across the warp: lane
// and lane ^ stride keep the larger key in the lane whose stride bit is
// clear when desc, else the smaller.
__device__ __forceinline__ u64 warp_exchange(u64 x, int lane, int stride,
                                             bool desc) {
  const u64 o = __shfl_xor_sync(~0u, x, stride);
  return (((lane & stride) == 0) == desc) ? max_u64(x, o) : min_u64(x, o);
}

// A list of L <= 32 keys: one warp merges the c candidates into it with
// the list in registers, one key per lane, 32 candidates at a time.  Up to
// kInsert of them are inserted one by one (a ballot finds the rank, a
// shuffle moves the keys below it down a lane); more are sorted across the
// warp (bitonic), the larger of list[i] and candidate[31 - i] kept (the
// best 32 of both, a bitonic sequence) and that sorted.  Lanes at and past
// L carry keys beyond the list; only L are stored.
constexpr int kInsert = 4;
__device__ void flush_short(u64* lb, int L, const u64* cb, int c, int lane) {
  u64 x = lane < L ? lb[lane] : 0ull;
  for (int base = 0; base < c; base += 32) {
    if (c - base <= kInsert) {
      for (int j = base; j < c; ++j) {
        const u64 y = cb[j];
        const int r = __popc(__ballot_sync(~0u, x > y));
        const u64 up = __shfl_up_sync(~0u, x, 1);
        x = lane < r ? x : (lane == r ? y : up);
      }
      break;
    }
    u64 y = base + lane < c ? cb[base + lane] : 0ull;
    for (int size = 2; size <= 32; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        y = warp_exchange(y, lane, stride, (lane & size) == 0);
    x = max_u64(x, __shfl_sync(~0u, y, 31 - lane));
    for (int stride = 16; stride > 0; stride >>= 1)
      x = warp_exchange(x, lane, stride, true);
  }
  if (lane < L) lb[lane] = x;
}

// Pass 1: CTA (user block blockIdx.x, stripe blockIdx.y) writes each of its
// users' best L keys of the stripe, sorted; launched two per SM (so at most
// 128 registers a thread).  With kSelect false it only scores, and writes
// the XOR of its keys (for timing the scoring apart).
template <typename TW, typename TH, int UB, bool kSelect>
__global__ void __launch_bounds__(kChunk, 2) topk_stripe_kernel(
    const TW* __restrict__ Wu, const TH* __restrict__ H,
    const float* __restrict__ hs, int U, long long n, int k, int kp, int L,
    long long n_chunks, long long cps, bool vec, u64* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);                // UB x kp
  u64* list = reinterpret_cast<u64*>(w + UB * kp);          // UB x L
  u64* cand = list + UB * L;                                 // UB x kChunk
  u64* checksum = cand + UB * kChunk;
  int* ccnt = reinterpret_cast<int*>(checksum + 1);          // UB
  unsigned short* ranks =                                // kWarps x kChunk
      reinterpret_cast<unsigned short*>(ccnt + UB);
  const int u0 = blockIdx.x * UB;
  const long long stripe = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int users = U - u0 < UB ? U - u0 : UB;

  for (int idx = tid; idx < UB * kp; idx += kChunk) {
    const int u = idx / kp, kk = idx - u * kp;
    w[idx] = (u < users && kk < k)
        ? to_f(Wu[(long long)(u0 + u) * k + kk]) : 0.0f;
  }
  if (kSelect) {
    for (int idx = tid; idx < UB * L; idx += kChunk) list[idx] = 0ull;
    if (tid < UB) ccnt[tid] = 0;
  } else if (tid == 0) {
    *checksum = 0ull;
  }
  __syncthreads();

  u64 sum = 0;
  const long long c0 = stripe * cps;
  const long long c1 = c0 + cps < n_chunks ? c0 + cps : n_chunks;
  for (long long chunk = c0; chunk < c1; ++chunk) {
    const long long item = chunk * kChunk + tid;
    const bool live = item < n;
    float acc[UB];
    if (live) {
      score_row<TH, UB>(w, kp, H + item * k, k, vec, acc);
    } else {
#pragma unroll
      for (int u = 0; u < UB; ++u) acc[u] = 0.0f;
    }
    const float scale = hs != nullptr && live ? hs[item] : 1.0f;
    // the users' thresholds, 8 at a time, loaded before they are compared
#pragma unroll
    for (int u8 = 0; u8 < UB; u8 += 8) {
      constexpr int G = UB < 8 ? UB : 8;
      u64 tau[G];
#pragma unroll
      for (int j = 0; j < G; ++j)
        tau[j] = kSelect ? list[(u8 + j) * L + L - 1] : 0ull;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int u = u8 + j;
        const float s = hs != nullptr ? acc[u] * scale : acc[u];
        const u64 key = make_key(round_to(s, Wu), (uint32_t)item);
        if (!kSelect) {
          if (live) sum ^= key;
          continue;
        }
        // append the keys above tau, one shared atomic per warp and user
        const bool pass = live && u < users && key > tau[j];
        const unsigned m = __ballot_sync(~0u, pass);
        if (m == 0u) continue;
        int base = 0;
        if (lane == __ffs(m) - 1) base = atomicAdd(&ccnt[u], __popc(m));
        base = __shfl_sync(~0u, base, __ffs(m) - 1);
        if (pass)
          cand[u * kChunk + base + __popc(m & ((1u << lane) - 1u))] = key;
      }
    }
    if (kSelect) {
      __syncthreads();
      for (int u = warp; u < users; u += kWarps) {
        const int c = ccnt[u];
        if (c == 0) continue;
        if (L <= 32)
          flush_short(list + u * L, L, cand + u * kChunk, c, lane);
        else
          flush_user(list + u * L, L, cand + u * kChunk,
                     ranks + warp * kChunk, c, lane);
        if (lane == 0) ccnt[u] = 0;
      }
      __syncthreads();
    }
  }

  if (!kSelect) {
    for (int o = 16; o > 0; o >>= 1) sum ^= __shfl_xor_sync(~0u, sum, o);
    if (lane == 0) atomicXor(checksum, sum);
    __syncthreads();
    if (tid == 0) out[stripe * gridDim.x + blockIdx.x] = *checksum;
    return;
  }
  const long long S = gridDim.y;
  for (int idx = tid; idx < users * L; idx += kChunk) {
    const int u = idx / L;
    out[((long long)(u0 + u) * S + stripe) * L + (idx - u * L)] = list[idx];
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

// Pass 1's plan comes from the Python wrapper (kernels/topk.py, plan): ub
// users per CTA, S stripes of cps chunks, lists of L keys, smem bytes of
// dynamic shared memory.  These check it: it must cover the catalog, keep
// L = min(k_top, stripe items) and size the shared memory exactly as
// topk_stripe_kernel lays it out, so a plan that drifts from the kernel
// fails instead of launching at another occupancy.
size_t stripe_smem(int ub, int L, int k) {
  return (size_t)ub * ((k + 3) & ~3) * sizeof(float)
      + (size_t)ub * (L + kChunk) * sizeof(u64) + sizeof(u64)
      + (size_t)ub * sizeof(int)
      + (size_t)kWarps * kChunk * sizeof(unsigned short);
}

bool valid(int U, long long n, int k, int k_top, int ub, long long S,
           long long cps, int L, long long smem) {
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  return U >= 1 && n >= 1 && k >= 1 && k_top >= 1 && k_top <= n
      && n < 0x7FFFFFFFLL && ub >= 1 && S >= 1 && S <= 65535 && cps >= 1
      && cps * S >= n_chunks && L == min_ll(k_top, cps * kChunk)
      && smem == (long long)stripe_smem(ub, L, k) && smem <= kMaxSmem;
}

struct Launch {
  const void* Wu;
  const void* H;
  const float* hs;
  int U;
  long long n;
  int k, k_top, ub;
  long long S, cps;
  int L;
  size_t smem;
  u64* out;
  cudaStream_t stream;
  int* attrs;        // non-null: report the kernel's attributes, no launch
};

template <typename TW, typename TH, int UB, bool kSelect>
int launch_stripes(const Launch& a) {
  auto kern = topk_stripe_kernel<TW, TH, UB, kSelect>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  if (a.attrs != nullptr) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, kChunk,
                                                        a.smem);
    if (err != cudaSuccess) return err;
    a.attrs[0] = fa.numRegs;
    a.attrs[1] = (int)fa.sharedSizeBytes;
    a.attrs[2] = (int)a.smem;
    a.attrs[3] = (int)fa.localSizeBytes;
    a.attrs[4] = ctas;
    return cudaSuccess;
  }
  const bool vec = a.k % 4 == 0
      && reinterpret_cast<uintptr_t>(a.H) % (4 * sizeof(TH)) == 0;
  dim3 grid((unsigned)((a.U + UB - 1) / UB), (unsigned)a.S);
  kern<<<grid, kChunk, a.smem, a.stream>>>(
      static_cast<const TW*>(a.Wu), static_cast<const TH*>(a.H), a.hs, a.U,
      a.n, a.k, (a.k + 3) & ~3, a.L, (a.n + kChunk - 1) / kChunk, a.cps, vec,
      a.out);
  return cudaGetLastError();
}

template <typename TW, typename TH, bool kSelect>
int stripes_ub(const Launch& a) {
  switch (a.ub) {
    case 1: return launch_stripes<TW, TH, 1, kSelect>(a);
    case 2: return launch_stripes<TW, TH, 2, kSelect>(a);
    case 4: return launch_stripes<TW, TH, 4, kSelect>(a);
    case 8: return launch_stripes<TW, TH, 8, kSelect>(a);
    case 16: return launch_stripes<TW, TH, 16, kSelect>(a);
    case 32: return launch_stripes<TW, TH, 32, kSelect>(a);
    default: return cudaErrorInvalidValue;
  }
}

// dtype codes: 0 float, 1 bfloat16, 2 float16, 3 int8 (H only, float W_u).
template <bool kSelect>
int stripes(int w_dtype, int h_dtype, const Launch& a) {
  if (w_dtype == 0 && h_dtype == 0)
    return stripes_ub<float, float, kSelect>(a);
  if (w_dtype == 1 && h_dtype == 1)
    return stripes_ub<__nv_bfloat16, __nv_bfloat16, kSelect>(a);
  if (w_dtype == 2 && h_dtype == 2)
    return stripes_ub<__half, __half, kSelect>(a);
  if (w_dtype == 0 && h_dtype == 3)
    return stripes_ub<float, int8_t, kSelect>(a);
  return -1;
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

// Scratch (in 64-bit keys) one buffer of topk_scores needs with S stripes
// of lists of L keys: the largest round of the tournament.
extern "C" long long topk_scratch_elems(int U, long long S, int L,
                                        int k_top) {
  long long nl = S, l = L;
  long long most = (long long)U * nl * l;
  while (nl > 1) {
    nl = (nl + 1) / 2;
    l = min_ll(k_top, 2 * l);
    most = max_ll(most, (long long)U * nl * l);
  }
  return most;
}

// The top-k of W_u against H on the wrapper's plan (ub users per CTA, S
// stripes of cps chunks, lists of L keys, smem bytes; see valid).
// buf0/buf1 hold topk_scratch_elems(U, S, L, k_top) keys each.  Returns a
// cudaError_t, or -1 for an unsupported type pair, -2 for short scratch.
extern "C" int topk_scores(const void* Wu, const void* H, const void* hs,
                           int U, long long n, int k, int w_dtype,
                           int h_dtype, int k_top, int ub, long long S,
                           long long cps, int L, long long smem, void* buf0,
                           void* buf1, long long buf_elems, void* out_s,
                           void* out_i, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!valid(U, n, k, k_top, ub, S, cps, L, smem))
    return cudaErrorInvalidValue;
  if (topk_scratch_elems(U, S, L, k_top) > buf_elems) return -2;
  u64* cur = static_cast<u64*>(buf0);
  u64* nxt = static_cast<u64*>(buf1);
  const Launch a{Wu, H, static_cast<const float*>(hs), U, n, k, k_top, ub,
                 S, cps, L, (size_t)smem, cur, stream, nullptr};
  int err = stripes<true>(w_dtype, h_dtype, a);
  if (err != cudaSuccess) return err;

  long long nl = S;
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
    return launch_decode<float>(cur, L, U, k_top, n, out_s, ids, stream);
  if (w_dtype == 1)
    return launch_decode<__nv_bfloat16>(cur, L, U, k_top, n, out_s, ids,
                                        stream);
  return launch_decode<__half>(cur, L, U, k_top, n, out_s, ids, stream);
}

// Pass 1 with its selection compiled out, on the same plan: each CTA scores
// its stripe and writes one checksum (the XOR of its keys), so the scoring
// is not dead code.  For timing the scoring apart; out holds one key per
// CTA (ceil(U / ub) * S).
extern "C" int topk_score_only(const void* Wu, const void* H, const void* hs,
                               int U, long long n, int k, int w_dtype,
                               int h_dtype, int k_top, int ub, long long S,
                               long long cps, int L, long long smem,
                               void* out, long long out_elems,
                               void* stream_ptr) {
  if (!valid(U, n, k, k_top, ub, S, cps, L, smem))
    return cudaErrorInvalidValue;
  if ((long long)((U + ub - 1) / ub) * S > out_elems) return -2;
  const Launch a{Wu, H, static_cast<const float*>(hs), U, n, k, k_top, ub,
                 S, cps, L, (size_t)smem, static_cast<u64*>(out),
                 static_cast<cudaStream_t>(stream_ptr), nullptr};
  return stripes<false>(w_dtype, h_dtype, a);
}

// Pass 1's kernel for this plan: out[0..5) = registers per thread, static
// shared memory, dynamic shared memory, local (spill) bytes per thread,
// CTAs per SM (cudaFuncGetAttributes, cudaOccupancy...).
extern "C" int topk_kernel_attrs(int U, long long n, int k, int w_dtype,
                                 int h_dtype, int k_top, int ub, long long S,
                                 long long cps, int L, long long smem,
                                 int* out) {
  if (!valid(U, n, k, k_top, ub, S, cps, L, smem))
    return cudaErrorInvalidValue;
  const Launch a{nullptr, nullptr, nullptr, U, n, k, k_top, ub, S, cps, L,
                 (size_t)smem, nullptr, nullptr, out};
  return stripes<true>(w_dtype, h_dtype, a);
}
