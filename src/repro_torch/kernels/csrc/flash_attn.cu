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
// the input type.  Given an lse pointer, each row's log-normaliser
// L = m + ln(max(l, 1e-30)) (natural units) is written as fp32 (B, Hq, S):
// the training forward saves it, with o, for the torch-ops backward of
// repro_torch/models/flash_xla.py (the recurrence of the JAX package's
// models/flash_xla.py::_bwd, which recomputes p = exp(s - L)).  Masked
// scores are -1e30 (not -inf), as in the reference; keys past the end of
// the sequence (a ragged last tile) are -inf, so they weigh exactly 0.
//
// The TPU kernel's grid is (B * Hq, S / bq, S / bk) with the k axis
// sequential, carrying m, l and acc in VMEM scratch from one grid step to
// the next.  CTAs run in no order and carry nothing to each other, so here
// one CTA owns one (b * Hq + h, 64-row query block) and loops over the key
// blocks itself; under the causal mask the loop stops at the diagonal, so
// blocks above it cost nothing (the reference's pl.when skip).  Query
// blocks are issued heaviest first (the last rows see the most keys).
//
// Two kernels, chosen by the input type (no fallback between them):
//
// * bf16 and fp16: flash_fwd_mma_kernel, on the tensor cores.  4 warps,
//   each owning 16 query rows of the 64-row block.  Q is loaded once into
//   mma.sync.m16n8k16 A fragments (ldmatrix) and stays in registers.  Per
//   64-key tile, S = Q K^T and O += P V are mma.sync products with fp32
//   sums; K fragments come by ldmatrix, V's by ldmatrix.trans.  The online
//   softmax runs on the C fragments in registers: a row lives on the four
//   lanes of a quad, so its max is two shuffles (l is summed per lane and
//   reduced once at the end), the scale is folded into exp2, and P is
//   rounded once to the input type as the A fragment of the second product
//   without leaving registers.  K/V tiles are stored as the input type in
//   shared memory, 16-byte chunks XOR-swizzled by the row's low three bits
//   so ldmatrix reads are free of bank conflicts, and double-buffered: tile
//   j + 1 is copied by cp.async.cg while tile j is computed, one
//   __syncthreads per tile.  Rows at or past S and columns at or past D are
//   zero-filled (the copy's src-size operand); D is padded to 64 or 128
//   (kDp).  Rows that are not 16-byte aligned (D % 8 != 0, or a stride or
//   base that is not a multiple of 16 bytes) take the element-wise loading
//   variant of the same kernel (kVec = false).  The output is staged in the
//   warp's own rows of the Q tile and stored with 16-byte stores.  40 KB
//   (kDp = 64) or 80 KB (kDp = 128) of shared memory per CTA.
//
// * fp32: flash_fwd_kernel, on the FMA units.  256 threads as 16 x 16:
//   thread (ty, tx) owns query rows 4 ty .. 4 ty + 3 of the block; it
//   computes the scores of those rows at key columns tx + 16 j (j < 4) and
//   the output at feature columns tx + 16 j (j < 8, so D <= 128).  Its
//   rows' m, l and 32 accumulators live in registers; the 16 threads of a
//   row group reduce the block's max and sum with warp shuffles.  The Q
//   tile stays in shared memory for the whole loop; each K/V tile is staged
//   there (K rows padded to D + 1 floats, so the 16 key rows a warp reads
//   sit in 16 banks), and P = exp(s - m) goes through shared memory into
//   the second product.  115 KB of shared memory at D = 128: two CTAs/SM.
//
// Bound: at the served shape (B = 4, Hq = 40, Hkv = 8, S = 1024, D = 128,
// bf16) the causal products are 43 GFLOP against 101 MB of q, k, v and o,
// so the tensor cores' rate bounds it (0.043 ms at 989 TFLOP/s), and in
// fp32 the 67 TFLOP/s of the FMA units (0.64 ms).  The bf16/fp16 kernel
// reaches the tensor cores through mma.sync, which is not their full rate
// on Hopper (that takes wgmma), and copies with cp.async rather than TMA;
// PERF.md has the measured gap to the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // key rows per tile
constexpr int kMaxD = 128;
constexpr float kMasked = -1e30f;

struct Strides {  // elements; the feature axis is contiguous
  long long b, h, s;
};

// ------------------------------------------------------------------------
// fp32: the FMA kernel
// ------------------------------------------------------------------------

constexpr int kThreads = 256;   // 16 x 16; 16 threads x 8 feature columns

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Hq,
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
    Qs[idx] = row < S ? qp[row * qs.s + c] : 0.f;
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
        kx = kp[row * ks.s + c];
        vx = vp[row * vs.s + c];
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
      if (c < D) op[row * os.s + c] = acc[i][j] / den;
    }
    if (lse != nullptr && tx == 0) lse[(long long)bh * S + row] =
        m[i] + logf(den);
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D +
          (size_t)kBQ * kBK);
}

// ------------------------------------------------------------------------
// bf16 / fp16: the tensor-core kernel
// ------------------------------------------------------------------------

constexpr int kWarps = 4;             // 16 query rows each
constexpr int kMmaThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the element (r, c) of a tile with kDp columns: 16-byte chunk c / 8 of
// row r sits at chunk (c / 8) ^ (r % 8)
template <int kDp>
__device__ __forceinline__ int swz(int r, int chunk) {
  return r * kDp + ((chunk ^ (r & 7)) << 3);
}

// 2^x by the SFU's ex2.approx.ftz (about 2 ulps; results below fp32's
// normal range flush to 0, a weight under 2^-126 per key), without the
// instructions exp2f adds for subnormal results
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// pack(lo, hi): two fp32 values rounded once to T, lo in the low half;
// mma(c, a, b0, b1): c += a b on m16n8k16 fragments, fp32 sums
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Rows r0 .. r0 + 63 of one head's (S, D) slice (row stride ld elements,
// 16-bit values) into a swizzled tile of kDp columns; rows at or past S
// and columns at or past D are 0.  kVec: 16-byte cp.async copies (the
// caller commits and waits); else element-wise loads and shared stores.
template <bool kVec, int kDp>
__device__ __forceinline__ void load_tile(uint16_t* tile,
                                          const uint16_t* src, long long ld,
                                          int r0, int S, int D, int tid) {
  constexpr int kCh = kDp / 8;               // chunks per row
  constexpr int kRowStep = kMmaThreads / kCh;
  const int c = tid % kCh;
#pragma unroll
  for (int i = 0; i < kBK / kRowStep; ++i) {
    const int r = tid / kCh + i * kRowStep, row = r0 + r;
    uint16_t* dst = tile + swz<kDp>(r, c);
    if constexpr (kVec) {
      const bool ok = row < S && c * 8 < D;
      cp_async16(dst, ok ? src + row * ld + c * 8 : src, ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c * 8 + 2 * i;
        const uint32_t lo =
            row < S && col < D ? src[row * ld + col] : 0u;
        const uint32_t hi =
            row < S && col + 1 < D ? src[row * ld + col + 1] : 0u;
        w[i] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int kDp>
constexpr size_t mma_smem_bytes() {  // Q, two K and two V tiles
  return sizeof(uint16_t) * 5 * kBK * kDp;
}

template <typename T, bool kVec, int kDp>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Hq,
                     int group, int S, int D, int causal, float scale,
                     Strides qs, Strides ks, Strides vs, Strides os) {
  static_assert(kBQ == 16 * kWarps && kDp % 16 == 0 && kDp <= kMaxD, "");
  constexpr int kTile = kBK * kDp;
  constexpr int kD16 = kDp / 16;             // k-steps of Q K^T
  extern __shared__ __align__(128) unsigned char mma_smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(mma_smem);
  uint16_t* Ks = Qs + kTile;                 // two buffers
  uint16_t* Vs = Ks + 2 * kTile;             // two buffers

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wrow = (tid >> 5) * 16;          // the warp's first row
  const int g = lane >> 2, tig = lane & 3;   // quad, lane in quad

  const uint16_t* qp = reinterpret_cast<const uint16_t*>(q) + b * qs.b +
                       h * qs.h;
  const uint16_t* kp = reinterpret_cast<const uint16_t*>(k) + b * ks.b +
                       hk * ks.h;
  const uint16_t* vp = reinterpret_cast<const uint16_t*>(v) + b * vs.b +
                       hk * vs.h;
  uint16_t* op = reinterpret_cast<uint16_t*>(o) + b * os.b + h * os.h;

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int nk = (k_end + kBK - 1) / kBK;

  load_tile<kVec, kDp>(Qs, qp, qs.s, q0, S, D, tid);
  load_tile<kVec, kDp>(Ks, kp, ks.s, 0, S, D, tid);
  load_tile<kVec, kDp>(Vs, vp, vs.s, 0, S, D, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // Q's A fragments: matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15)
  uint32_t qf[kD16][4];
#pragma unroll
  for (int kt = 0; kt < kD16; ++kt) {
    const int r = wrow + (lane & 15);
    ldsm_x4(qf[kt], Qs + swz<kDp>(r, 2 * kt + (lane >> 4)));
  }

  float acc[kDp / 8][4];
#pragma unroll
  for (int dt = 0; dt < kDp / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  // rows g and g + 8 of the warp: running max (in log2 units) and this
  // lane's part of the denominator
  float m[2] = {kMasked * kLog2e, kMasked * kLog2e}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    const uint16_t* Kt = Ks + (j & 1) * kTile;
    const uint16_t* Vt = Vs + (j & 1) * kTile;
    if (j + 1 < nk) {  // the other buffer was released by the last sync
      load_tile<kVec, kDp>(Ks + ((j + 1) & 1) * kTile, kp, ks.s, k0 + kBK,
                           S, D, tid);
      load_tile<kVec, kDp>(Vs + ((j + 1) & 1) * kTile, vp, vs.s, k0 + kBK,
                           S, D, tid);
    }
    cp_async_commit();

    // S = Q K^T: n-tiles of 8 keys, two per ldmatrix.x4 of K
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int np = 0; np < kBK / 16; ++np) {
#pragma unroll
      for (int kt = 0; kt < kD16; ++kt) {
        const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t kf[4];
        ldsm_x4(kf, Kt + swz<kDp>(r, 2 * kt + ((lane >> 3) & 1)));
        Mma<T>::mma(s[2 * np], qf[kt], kf[0], kf[1]);
        Mma<T>::mma(s[2 * np + 1], qf[kt], kf[2], kf[3]);
      }
    }

    // to log2 units; mask only the diagonal tile and a ragged last one
    const bool edge = (causal && j == nk - 1) || k0 + kBK > S;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * sl2;
        if (edge) {
          const int col = k0 + nt * 8 + 2 * tig + (e & 1);
          const int row = q0 + wrow + g + 8 * (e >> 1);
          if (col >= S) x = -INFINITY;
          else if (causal && col > row) x = kMasked * kLog2e;
        }
        s[nt][e] = x;
      }

    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[i] = exp2_approx(m[i] - mx);
      m[i] = mx;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int dt = 0; dt < kDp / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // P = exp2(s - m): l sums the fp32 values, the A fragments of P V
    // (16 keys each) take them rounded once to T
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = exp2_approx(s[nt][e] - m[e >> 1]);
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pf[nt >> 1][2 * (nt & 1)] = Mma<T>::pack(p[0], p[1]);
      pf[nt >> 1][2 * (nt & 1) + 1] = Mma<T>::pack(p[2], p[3]);
    }

    // O += P V: d-tiles of 8 columns, two per ldmatrix.x4.trans of V
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kD16; ++dp) {
        const int r = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vt + swz<kDp>(r, 2 * dp + (lane >> 4)));
        Mma<T>::mma(acc[2 * dp], pf[kk], vf[0], vf[1]);
        Mma<T>::mma(acc[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    }

    cp_async_wait_all();  // tile j + 1 has landed
    __syncthreads();      // ... for every warp, and tile j is released
  }

  // epilogue: acc / max(l, 1e-30) rounded once to T, staged in the warp's
  // own rows of the Q tile (its Q is in registers), then stored by rows
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x = l[i];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    den[i] = fmaxf(x, 1e-30f);
  }
  // L = m + ln(l) in natural units (m is kept in log2 units), one lane of
  // the quad writing each row
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wrow + g + 8 * i;
      if (row < S)
        lse[(long long)bh * S + row] = m[i] * kLn2 + logf(den[i]);
    }
  }
#pragma unroll
  for (int dt = 0; dt < kDp / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wrow + g + 8 * i;
      *reinterpret_cast<uint32_t*>(Qs + swz<kDp>(r, dt) + 2 * tig) =
          Mma<T>::pack(acc[dt][2 * i] / den[i], acc[dt][2 * i + 1] / den[i]);
    }
  __syncwarp();
  if constexpr (kVec) {
    constexpr int kCh = kDp / 8, kRowStep = 32 / kCh;
    const int c = lane % kCh;
#pragma unroll
    for (int i = 0; i < 16 / kRowStep; ++i) {
      const int r = wrow + lane / kCh + i * kRowStep, row = q0 + r;
      if (row < S && c * 8 < D)
        *reinterpret_cast<uint4*>(op + row * os.s + c * 8) =
            *reinterpret_cast<const uint4*>(Qs + swz<kDp>(r, c));
    }
  } else {
    for (int idx = lane; idx < 16 * D; idx += 32) {
      const int rr = idx / D, col = idx - rr * D;
      const int r = wrow + rr, row = q0 + r;
      if (row < S)
        op[row * os.s + col] = Qs[swz<kDp>(r, col >> 3) + (col & 7)];
    }
  }
}

// ------------------------------------------------------------------------
// launches
// ------------------------------------------------------------------------

// lets a kernel take smem bytes of dynamic shared memory, and prefers the
// largest shared-memory carveout for it
template <typename F>
cudaError_t set_smem(F* kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int S, int D,
                       int causal, float scale, Strides qs, Strides ks,
                       Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  const cudaError_t err = set_smem(flash_fwd_kernel<float>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + kBQ - 1) / kBQ));
  flash_fwd_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq,
      Hq / Hkv, S, D, causal, scale, qs, ks, vs, os);
  return cudaGetLastError();
}

template <typename T, bool kVec, int kDp>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int S, int D,
                       int causal, float scale, Strides qs, Strides ks,
                       Strides vs, Strides os, cudaStream_t stream) {
  auto* kernel = flash_fwd_mma_kernel<T, kVec, kDp>;
  const size_t smem = mma_smem_bytes<kDp>();
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + kBQ - 1) / kBQ));
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hq / Hkv, S,
      D, causal, scale, qs, ks, vs, os);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// out: registers per thread, static shared bytes, dynamic shared bytes of
// a launch, local (spill) bytes per thread, CTAs per SM
template <typename F>
cudaError_t kernel_attrs(F* kernel, int threads, size_t smem, int* out) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = (int)a.localSizeBytes;
  out[4] = ctas;
  return cudaSuccess;
}

template <typename T, bool kVec, int kDp>
cudaError_t mma_attrs(int* out) {
  return kernel_attrs(flash_fwd_mma_kernel<T, kVec, kDp>, kMmaThreads,
                      mma_smem_bytes<kDp>(), out);
}
cudaError_t fma_attrs(int* out) {
  return kernel_attrs(flash_fwd_kernel<float>, kThreads, smem_bytes(kMaxD),
                      out);
}

// The kernels, numbered as the wrapper's KERNELS: the fp32 FMA kernel, then
// the tensor-core kernel for bf16 and fp16, each with 16-byte and with
// element-wise loads, each with D padded to 128 and to 64.
struct Kernel {
  cudaError_t (*launch)(const void*, const void*, const void*, void*,
                        float*, int, int, int, int, int, int, float, Strides,
                        Strides, Strides, Strides, cudaStream_t);
  cudaError_t (*attrs)(int*);
  int max_d;
  bool vec;
};
#define REPRO_MMA(T, V, DP) \
  { launch_mma<T, V, DP>, mma_attrs<T, V, DP>, DP, V }
const Kernel kKernels[] = {
    {launch_fma, fma_attrs, kMaxD, false},
    REPRO_MMA(__nv_bfloat16, true, 128), REPRO_MMA(__nv_bfloat16, true, 64),
    REPRO_MMA(__nv_bfloat16, false, 128), REPRO_MMA(__nv_bfloat16, false, 64),
    REPRO_MMA(__half, true, 128), REPRO_MMA(__half, true, 64),
    REPRO_MMA(__half, false, 128), REPRO_MMA(__half, false, 64),
};
#undef REPRO_MMA
constexpr int kNumKernels = sizeof(kKernels) / sizeof(kKernels[0]);

}  // namespace

extern "C" int flash_attention_max_d() { return kMaxD; }

// kernel: the index into kKernels; q, k, v and o of its dtype; lse null,
// or (B, Hq, S) fp32, contiguous, which receives each row's log-normaliser
// L = m + ln(max(l, 1e-30)) (the training forward saves it for the
// backward; prefill passes null and writes nothing more).  Strides are in
// elements, for the (b, h, s) axes of each tensor; the feature axis
// is contiguous.  A kernel with 16-byte loads needs D % 8 == 0 and every
// base and stride 16-byte aligned, else cudaErrorMisalignedAddress.
// Returns a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Hq, int Hkv, int S, int D, int causal, float scale, int kernel,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss,
    void* stream_ptr) {
  if (kernel < 0 || kernel >= kNumKernels || B < 1 || Hq < 1 || Hkv < 1 ||
      Hq % Hkv != 0 || S < 1 || D < 1 || D > kKernels[kernel].max_d ||
      (long long)B * Hq > 0x7FFFFFFFLL || (S + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  if (kKernels[kernel].vec) {
    bool ok = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
              aligned16(o);
    for (long long st : {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb,
                         osh, oss})
      ok = ok && st % 8 == 0;
    if (!ok) return cudaErrorMisalignedAddress;
  }
  return kKernels[kernel].launch(
      q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, S, D, causal, scale,
      {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
      static_cast<cudaStream_t>(stream_ptr));
}

// Attributes of kKernels[kernel] into out[5]: registers, static shared
// bytes, dynamic shared bytes of a launch (the fp32 kernel's at D = 128),
// local (spill) bytes, CTAs per SM.  Returns a cudaError_t.
extern "C" int flash_attention_kernel_attrs(int kernel, int* out) {
  if (kernel < 0 || kernel >= kNumKernels) return cudaErrorInvalidValue;
  return kKernels[kernel].attrs(out);
}
