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
// prev[t] is the position of the last rating before t of the same cell
// with the same W row, or -1.
//
// Mapping: one CTA per cell (blockIdx.x).  The CTA walks its waves in
// order; warps 0-6 take the ratings of the current wave; lane l holds the
// k indices l, l+32, ... in fp32 registers.  The dot is reduced by a fixed
// __shfl_xor_sync butterfly, so every lane gets the same bits and the
// result does not depend on which warp took the rating (no atomics).  Both
// rows are rounded once to the storage type.  A barrier between waves
// orders them.
//
// Bound: the wave chain, not bandwidth.  Each wave costs at least one
// barrier, and a hot item puts its whole conflict chain into every cell.
// The bandwidth bound - both rows read and written per update, 4*k*s + 12
// bytes - is far below the chain's latency (PERF.md has both numbers).  So
// the design keeps the global-memory round trips off the chain:
//   * H resident.  The cell's n_tile x k H block is copied into shared
//     memory at the start; every wave reads and writes its H rows there;
//     one writeback at the end.  (Where it does not fit, the plan says so
//     and H stays in global memory: the RESIDENT template flag.)
//   * W rows, indices and wave offsets staged ahead.  Warp 7, the stager,
//     fills a ring of R W-row slots, a ring of 2R index entries (row, col,
//     val, prev) and a ring of wave offsets with cp.async.  The waves go
//     in blocks of kBlock: warps 0-6 order the waves of a block by a named
//     barrier and meet the stager at the end of each block.  While they
//     run block b, the stager stages the ratings of block b + 2 on into
//     the slots of the ratings before block b, then waits for the copies
//     it issued in block b - 1 and meets them: a copy has a whole block
//     to land, and none is in flight when its slot is read.  Each slot
//     records the rating it holds; a rating whose slot does not hold it
//     (a wave wider than the ring, a ring that fell behind) reads its
//     indices and W row from global memory.
//   * Exact forwarding of repeated W rows.  prev[t] links each rating to
//     the last earlier rating of its cell with the same W row.  When the
//     stager stages u in block b, that writer p either ran before block b
//     (its row reached global memory before the barrier that began the
//     block, which orders it before the stager's cp.async, an ordinary
//     read: COPY), or may be running in block b (u reads global memory
//     when it runs, after the barrier that ends block b: PULL), or runs
//     later: if p is staged itself, p's slot is marked to push its updated
//     row into u's slot (PUSH), else u reads global memory (PULL).  A
//     slot's state is reset when it is staged again, after its rating ran.
//   * Updated W rows go to global memory at once (and to a pushed slot).
// The plan (kernels/nomad_sgd.py::plan) picks R, the copy width and H
// residence; nomad_sgd_waves checks it against the layout below.
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
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxK = 32 * kWarp;
constexpr int kMaxSmem = 232448;
constexpr int kMaxRing = 256;
// waves per block: the stager meets the updating warps once a block
constexpr int kBlock = 8;
// wave offsets staged ahead (a power of two)
constexpr int kWaveRing = 256;
enum : int { kCopy = 0, kPush = 1, kPull = 2 };

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One asynchronous copy of `bytes` (16, 8 or 4) from global to shared
// memory; 2 bytes (a 16-bit row of odd length) is copied synchronously.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Dynamic shared memory of one CTA, in bytes from its start: the H block
// (if resident), R W-row slots of row_bytes (k elements rounded up to 16
// bytes), each slot's push target, mode and rating (int32), the index
// ring of 2R
// entries as four int32/f32 arrays (row, col, val, prev), and a ring of
// kWaveRing wave offsets.
struct Layout {
  long long row_bytes, w_off, fwd_off, mode_off, hold_off, idx_off, woff_off,
      total;
};

// Index entries beside a ring of R W-row slots.
__host__ __device__ inline int index_ring(int R) { return 2 * R; }

__host__ __device__ inline Layout layout(int n_tile, int k, int elem,
                                         bool resident, int R) {
  Layout L;
  L.row_bytes = (static_cast<long long>(k) * elem + 15) / 16 * 16;
  L.w_off = resident
                ? (static_cast<long long>(n_tile) * k * elem + 15) / 16 * 16
                : 0;
  L.fwd_off = L.w_off + R * L.row_bytes;
  L.mode_off = L.fwd_off + 4LL * R;
  L.hold_off = L.mode_off + 4LL * R;
  L.idx_off = L.hold_off + 4LL * R;
  L.woff_off = L.idx_off + 4LL * 4 * index_ring(R);
  L.total = L.woff_off + 4LL * kWaveRing;
  return L;
}

// A loop-invariant value kept in a register: after this the compiler
// cannot recompute it from the kernel's parameters or the thread index
// inside the wave loop, which would lengthen each wave's dependent chain.
__device__ __forceinline__ int pinned(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

template <typename T>
struct Args {
  T* W;
  T* H;
  const int32_t* rows;
  const int32_t* cols;
  const float* vals;
  const int32_t* prev;
  const int32_t* woff;
  const int32_t* cell_woff;
  long long w_cell_stride, h_cell_stride;
  int n_tile, k;
  float lr, lam;
  int R, copy_bytes;
  long long* prof;
};

// Where a wave's time goes, sampled with clock64() by lane 0 of warp 0 of
// the CTA a profiling launch runs (one cell): the sums over its waves of
//   [0] the index fetch (from the last barrier's end), [1] the factor-row
//   fetch (W and H) and the lane's partial dot, [11] the butterfly, [2]
//   the update and its stores, [5] from the last update to the barrier's
//   end; and by lane 0 of the stager warp, per block: [3] staging (the
//   copies issued and committed), [4] the wait for its copies, [10] from
//   there to the barrier's end; [6] the waves, [7] the trips, [8] the
//   clock64() cycles from the first wave's start to the last barrier's
//   end; [9] a checksum of the sampled values, which keeps their uses in
//   the code.  A barrier's wait falls on the warp's next load after it,
//   so each barrier segment ends with a load that is waited for.
// Each clock is read after an add that uses the values of its segment,
// so it is taken after those values have arrived.
constexpr int kProfileSlots = 12;

__device__ __forceinline__ void wait_for(int& sink, int x) {
  asm volatile("add.s32 %0, %0, %1;" : "+r"(sink) : "r"(x));
}
__device__ __forceinline__ void wait_for(int& sink, float x) {
  wait_for(sink, __float_as_int(x));
}

template <typename T, int KPL, bool RESIDENT, bool PROFILE>
__global__ void __launch_bounds__(kThreads)
nomad_sgd_waves_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cell = blockIdx.x;
  const int k = pinned(a.k);
  T* Wc = a.W + cell * a.w_cell_stride;
  T* Hc = a.H + cell * a.h_cell_stride;
  const int lane = pinned(threadIdx.x & (kWarp - 1));
  const int warp = pinned(threadIdx.x / kWarp);
  const bool stager = warp == kWarps - 1;
  const int w_begin = pinned(a.cell_woff[cell]);
  const int w_end = pinned(a.cell_woff[cell + 1]);
  if (w_begin >= w_end) return;
  const int base = pinned(a.woff[w_begin]);
  const int end = pinned(a.woff[w_end]);
  const int R = pinned(a.R);
  const int RI = index_ring(R);
  const Layout L = layout(a.n_tile, k, sizeof(T), RESIDENT, R);
  const int row_bytes = pinned(static_cast<int>(L.row_bytes));
  T* Hs = reinterpret_cast<T*>(smem);
  T* Hb = RESIDENT ? Hs : Hc;
  auto at = [&](long long off) { return smem + pinned(static_cast<int>(off)); };
  unsigned char* wslot = at(L.w_off);
  int* sfwd = reinterpret_cast<int*>(at(L.fwd_off));
  int* smode = reinterpret_cast<int*>(at(L.mode_off));
  int* shold = reinterpret_cast<int*>(at(L.hold_off));
  int* irow = reinterpret_cast<int*>(at(L.idx_off));
  int* icol = irow + RI;
  float* ival = reinterpret_cast<float*>(icol + RI);
  int* iprev = reinterpret_cast<int*>(ival + RI);
  int* soff = reinterpret_cast<int*>(at(L.woff_off));
  const int cw = a.copy_bytes;
  const int chunks = k * static_cast<int>(sizeof(T)) / cw;

  // lane 0 of warp 0 samples the updates, lane 0 of the stager the
  // staging
  const bool sample = PROFILE && threadIdx.x == 0;
  const bool sample_stage = PROFILE && stager && lane == 0;
  long long acc[kProfileSlots] = {};
  long long t_first = 0, c0 = 0, c1 = 0;
  int sink = 0;

  // Index entries [lo, hi) into the index ring, one thread an entry.
  auto stage_index = [&](int lo, int hi, int tid, int n_threads) {
    for (int u = lo + tid; u < hi; u += n_threads) {
      const int i = (u - base) & (RI - 1);
      copy_async(irow + i, a.rows + u, 4);
      copy_async(icol + i, a.cols + u, 4);
      copy_async(ival + i, a.vals + u, 4);
      copy_async(iprev + i, a.prev + u, 4);
    }
  };
  // W rows of ratings [lo, hi) into their slots, by one warp, while the
  // ratings before `done` have been applied and those of [done, next)
  // may be running.  Each lane classifies one rating: a writer not yet
  // run pushes its row into the slot only if it is staged itself
  // (earlier, or in this batch); one run from global memory is read back
  // from there.  All reads of the slot states come before any write, and
  // a slot's reset before any push into it.  Then the lanes copy each
  // COPY rating's row, one chunk a lane.
  auto stage_rows = [&](int lo, int hi, int done, int next) {
    for (int u0 = lo; u0 < hi; u0 += kWarp) {
      const int u = u0 + lane;
      const bool has = u < hi;
      const int s = (u - base) & (R - 1);
      const int i = (u - base) & (RI - 1);
      int p = -1, mode = kCopy, row = 0;
      if (has) {
        p = iprev[i];
        row = irow[i];
        const bool p_staged =
            (p >= lo && p < u) || (p >= 0 && shold[(p - base) & (R - 1)] == p);
        mode = p < done ? kCopy : p >= next && p_staged ? kPush : kPull;
      }
      __syncwarp();
      if (has) {
        smode[s] = mode;
        shold[s] = u;
        sfwd[s] = -1;
      }
      __syncwarp();
      if (has && mode == kPush) sfwd[(p - base) & (R - 1)] = s;
      const int n = min(hi - u0, kWarp);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int mj = __shfl_sync(0xffffffffu, mode, j);
        const int rj = __shfl_sync(0xffffffffu, row, j);
        const int sj = __shfl_sync(0xffffffffu, s, j);
        if (mj == kCopy) {
          const unsigned char* src = reinterpret_cast<const unsigned char*>(
              Wc + static_cast<long long>(rj) * k);
          unsigned char* dst = wslot + sj * row_bytes;
          for (int c = lane; c < chunks; c += kWarp) {
            copy_async(dst + c * cw, src + c * cw, cw);
          }
        }
      }
    }
  };
  // Wave offsets [lo, hi) (indices into woff) into their ring.
  auto stage_woff = [&](int lo, int hi, int tid, int n_threads) {
    for (int v = lo + tid; v < hi; v += n_threads) {
      copy_async(soff + ((v - w_begin) & (kWaveRing - 1)), a.woff + v, 4);
    }
  };
  auto wave_off = [&](int v) {
    return soff[(min(v, w_end) - w_begin) & (kWaveRing - 1)];
  };

  if (RESIDENT) {
    const int n = a.n_tile * k;
    for (int i = threadIdx.x; i < n; i += kThreads) Hs[i] = Hc[i];
  }
  for (int i = threadIdx.x; i < R; i += kThreads) shold[i] = -1;
  int ie = min(base + RI, end);                  // index entries issued
  stage_index(base, ie, threadIdx.x, kThreads);
  int ve = min(w_begin + kWaveRing, w_end + 1);  // wave offsets issued
  stage_woff(w_begin, ve, threadIdx.x, kThreads);
  commit_group();
  wait_group<0>();
  __syncthreads();
  int se = min(base + R, ie);                    // ratings considered
  if (stager) {
    stage_rows(base, se, base, base);
    commit_group();
    wait_group<0>();
  }
  __syncthreads();

  if (sample || sample_stage) {
    t_first = clock64();
    c0 = t_first;
  }
  if (stager) {
    // Block by block: while the other warps run the waves of block b,
    // stage for the ratings of block b + 2 on into the slots of the
    // ratings before block b, wait for the copies issued in block b - 1,
    // and meet the other warps at the barrier that ends block b.
    int ie_landed = ie;
    for (int b0 = w_begin; b0 < w_end; b0 += kBlock) {
      const int b1 = min(b0 + kBlock, w_end);
      const int done = wave_off(b0);
      const int next = wave_off(b1);
      const int lo = max(se, wave_off(b1 + kBlock));
      const int lim = min(done + R, min(ie_landed, end));
      if (lim > lo) stage_rows(lo, lim, done, next);
      se = max(lo, lim);
      const int ilo = max(ie, next);
      const int ilim = min(done + RI, end);
      if (ilim > ilo) stage_index(ilo, ilim, lane, kWarp);
      ie_landed = ie;  // issued before this block: landed at its end
      ie = max(ilo, ilim);
      // the other warps read wave offsets from b0 on
      const int vlim = min(b0 + kWaveRing, w_end + 1);
      if (vlim > ve) stage_woff(ve, vlim, lane, kWarp);
      ve = max(ve, vlim);
      commit_group();
      if (sample_stage) {
        c1 = clock64();
        acc[3] += c1 - c0;
        c0 = c1;
      }
      wait_group<1>();
      if (sample_stage) {
        c1 = clock64();
        acc[4] += c1 - c0;
        c0 = c1;
      }
      __syncthreads();
      if (sample_stage) {
        wait_for(sink, soff[0]);
        c1 = clock64();
        acc[10] += c1 - c0;
        c0 = c1;
      }
    }
  } else {
    int wa = base;
    int wb = wave_off(w_begin + 1);
    for (int w = w_begin; w < w_end; ++w) {
      const int wc = wave_off(w + 2);
      for (int t = wa + warp; t < wb; t += kWarps - 1) {
        const int s = (t - base) & (R - 1);
        const int i = (t - base) & (RI - 1);
        const T* ws = reinterpret_cast<const T*>(wslot + s * row_bytes);
        // the slot's state, index entry and row, read at once whether or
        // not the slot holds this rating
        const int hold = shold[s];
        int row = irow[i], col = icol[i], mode = smode[s], fwd = sfwd[s];
        float val = ival[i];
        float wv[KPL];
#pragma unroll
        for (int u = 0; u < KPL; ++u) {
          const int d = lane + u * kWarp;
          wv[u] = d < k ? load_f32(ws + d) : 0.0f;
        }
        const bool staged = hold == t;
        if (!staged) {
          row = a.rows[t];
          col = a.cols[t];
          val = a.vals[t];
          mode = kPull;
          fwd = -1;
        }
        if (sample) {
          wait_for(sink, row);
          wait_for(sink, col);
          wait_for(sink, val);
          wait_for(sink, mode + fwd);
          c1 = clock64();
          acc[0] += c1 - c0;
          c0 = c1;
        }
        T* wg = Wc + static_cast<long long>(row) * k;
        T* hp = Hb + static_cast<long long>(col) * k;
        if (mode == kPull) {
#pragma unroll
          for (int u = 0; u < KPL; ++u) {
            const int d = lane + u * kWarp;
            wv[u] = d < k ? load_f32(wg + d) : 0.0f;
          }
        }
        float hv[KPL];
        float part = 0.0f;
#pragma unroll
        for (int u = 0; u < KPL; ++u) {
          const int d = lane + u * kWarp;
          hv[u] = d < k ? load_f32(hp + d) : 0.0f;
          part += wv[u] * hv[u];
        }
        if (sample) {
          wait_for(sink, part);
          c1 = clock64();
          acc[1] += c1 - c0;
          c0 = c1;
        }
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, off);
        }
        if (sample) {
          wait_for(sink, part);
          c1 = clock64();
          acc[11] += c1 - c0;
          c0 = c1;
        }
        const float err = val - part;
        T* wf = reinterpret_cast<T*>(wslot + fwd * row_bytes);
#pragma unroll
        for (int u = 0; u < KPL; ++u) {
          const int d = lane + u * kWarp;
          if (d < k) {
            const float wn = wv[u] - a.lr * (-err * hv[u] + a.lam * wv[u]);
            store_f32(wg + d, wn);
            store_f32(hp + d, hv[u] - a.lr * (-err * wv[u] + a.lam * hv[u]));
            if (fwd >= 0) store_f32(wf + d, wn);
          }
        }
        if (sample) {
          c1 = clock64();
          acc[2] += c1 - c0;
          acc[7] += 1;
          c0 = c1;
        }
      }
      // the waves of a block are ordered by a barrier of the updating
      // warps; the last wave of a block by one with the stager too
      if (w + 1 == w_end || (w + 1 - w_begin) % kBlock == 0) {
        __syncthreads();
      } else {
        asm volatile("bar.sync 1, %0;" ::"n"(kThreads - kWarp) : "memory");
      }
      if (sample) {
        wait_for(sink, soff[0]);  // a barrier's wait falls on the next load
        c1 = clock64();
        acc[5] += c1 - c0;
        acc[6] += 1;
        c0 = c1;
      }
      wa = wb;
      wb = wc;
    }
  }
  wait_group<0>();
  if (RESIDENT) {
    __syncthreads();
    const int n = a.n_tile * k;
    for (int i = threadIdx.x; i < n; i += kThreads) Hc[i] = Hs[i];
  }
  if (sample) {
    acc[8] = clock64() - t_first;
    acc[9] = sink;
#pragma unroll
    for (int i = 0; i < kProfileSlots; ++i) {
      if (i != 3 && i != 4 && i != 10) a.prof[i] = acc[i];
    }
  }
  if (sample_stage) {
    a.prof[3] = acc[3];
    a.prof[4] = acc[4];
    a.prof[10] = acc[10];
  }
}

template <typename T, int KPL, bool RESIDENT, bool PROFILE>
cudaError_t launch(const Args<T>& args, int n_cells, long long smem,
                   cudaStream_t stream) {
  auto kernel = nomad_sgd_waves_kernel<T, KPL, RESIDENT, PROFILE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_cells, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <typename T, bool RESIDENT, bool PROFILE>
cudaError_t dispatch_k(const Args<T>& args, int n_cells, long long smem,
                       cudaStream_t stream) {
  const int k = args.k;
#define NOMAD_LAUNCH(KPL) \
  return launch<T, KPL, RESIDENT, PROFILE>(args, n_cells, smem, stream)
  if (k <= 1 * kWarp) NOMAD_LAUNCH(1);
  if (k <= 2 * kWarp) NOMAD_LAUNCH(2);
  if (k <= 4 * kWarp) NOMAD_LAUNCH(4);
  if (k <= 8 * kWarp) NOMAD_LAUNCH(8);
  if (k <= 16 * kWarp) NOMAD_LAUNCH(16);
  NOMAD_LAUNCH(32);
#undef NOMAD_LAUNCH
}

template <typename T, bool PROFILE>
int dispatch(void* W, void* H, const void* rows, const void* cols,
             const void* vals, const void* prev, const void* woff,
             const void* cell_woff, int n_cells, long long w_cell_stride,
             long long h_cell_stride, int n_tile, int k, float lr, float lam,
             int resident, int R, int copy_bytes, long long smem,
             long long* prof, cudaStream_t stream) {
  const int elem = static_cast<int>(sizeof(T));
  const long long row = static_cast<long long>(k) * elem;
  const bool copy_ok =
      (copy_bytes == 16 || copy_bytes == 8 || copy_bytes == 4 ||
       copy_bytes == 2) &&
      row % copy_bytes == 0 &&
      reinterpret_cast<uintptr_t>(W) % copy_bytes == 0 &&
      (w_cell_stride * elem) % copy_bytes == 0;
  const bool ring_ok = R >= 1 && R <= kMaxRing && (R & (R - 1)) == 0;
  if (!copy_ok || !ring_ok || n_tile < 1 ||
      smem != layout(n_tile, k, elem, resident != 0, R).total ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<T> args{static_cast<T*>(W),
               static_cast<T*>(H),
               static_cast<const int32_t*>(rows),
               static_cast<const int32_t*>(cols),
               static_cast<const float*>(vals),
               static_cast<const int32_t*>(prev),
               static_cast<const int32_t*>(woff),
               static_cast<const int32_t*>(cell_woff),
               w_cell_stride,
               h_cell_stride,
               n_tile,
               k,
               lr,
               lam,
               R,
               copy_bytes,
               prof};
  return static_cast<int>(
      resident ? dispatch_k<T, true, PROFILE>(args, n_cells, smem, stream)
               : dispatch_k<T, false, PROFILE>(args, n_cells, smem, stream));
}

}  // namespace

// Largest k the kernel takes (32 values per lane).
extern "C" int nomad_sgd_max_k() { return kMaxK; }

// Dynamic shared memory of a plan (Layout::total), for the wrapper's
// plan to check itself against.
extern "C" long long nomad_sgd_smem(int n_tile, int k, int elem,
                                    int resident, int R) {
  return layout(n_tile, k, elem, resident != 0, R).total;
}

// Applies the waves of n_cells cells in place on W (n_cells, m_tile, k)
// and H (n_cells, n_tile, k); w_cell_stride = m_tile * k and
// h_cell_stride = n_tile * k elements.  dtype: 0 float, 1 bfloat16,
// 2 float16.  The plan: H resident in shared memory or not, the ring of R
// slots (a power of two, at most 256), the bytes of one W-row copy, and
// the dynamic shared memory, which must equal the layout's.  Launches on
// `stream` and does not synchronise.  Returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue for arguments or a plan it
// refuses).
extern "C" int nomad_sgd_waves(void* W, void* H, const void* rows,
                               const void* cols, const void* vals,
                               const void* prev, const void* woff,
                               const void* cell_woff, int n_cells,
                               long long w_cell_stride,
                               long long h_cell_stride, int n_tile, int k,
                               float lr, float lam, int dtype, int resident,
                               int R, int copy_bytes, long long smem,
                               void* stream) {
  if (n_cells < 1 || k < 1 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NOMAD_DISPATCH(T)                                                  \
  dispatch<T, false>(W, H, rows, cols, vals, prev, woff, cell_woff,        \
                     n_cells, w_cell_stride, h_cell_stride, n_tile, k, lr, \
                     lam, resident, R, copy_bytes, smem, nullptr, s)
  switch (dtype) {
    case 0:
      return NOMAD_DISPATCH(float);
    case 1:
      return NOMAD_DISPATCH(__nv_bfloat16);
    case 2:
      return NOMAD_DISPATCH(__half);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NOMAD_DISPATCH
}

// The same launch in fp32, compiled with the clock64() sampling of one
// warp (see kProfileSlots): a timing entry point
// that no wrapper of the engine calls.  prof: kProfileSlots int64 on the
// card, written by block 0.
extern "C" int nomad_sgd_waves_profile(
    void* W, void* H, const void* rows, const void* cols, const void* vals,
    const void* prev, const void* woff, const void* cell_woff, int n_cells,
    long long w_cell_stride, long long h_cell_stride, int n_tile, int k,
    float lr, float lam, int resident, int R, int copy_bytes,
    long long smem, void* prof, void* stream) {
  if (n_cells < 1 || k < 1 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<float, true>(W, H, rows, cols, vals, prev, woff, cell_woff,
                               n_cells, w_cell_stride, h_cell_stride, n_tile,
                               k, lr, lam, resident, R, copy_bytes, smem,
                               static_cast<long long*>(prof),
                               static_cast<cudaStream_t>(stream));
}
