// The flat filter's scan: squared-L2 distance tiles, and the fused scan +
// running top-k' over the whole database.
//
// Replaces: src/repro/kernels/l2_topk/l2_topk.py :: pairwise_sq_dists
// (Pallas tile kernel _l2_tile_kernel, line 77), which computes
//     out[i, j] = ||q_i||^2 - 2 q_i . x_j + ||x_j||^2
// for Q (nq, d) and X (n, d) in float32, together with its streaming
// wrapper src/repro/kernels/l2_topk/ops.py :: knn, which folds each
// (nq, chunk) block into a running ascending top-k', ties to the lowest id.
// Two entries share one tile main loop:
//   repro_l2_sq_dists — the tile with a "store the tile" epilogue: the
//       (nq, n) distance matrix;
//   repro_l2_knn — the fused scan: the same tiles offered to a per-query
//       running top-k' in shared memory (topk_select.cuh), so no distance
//       reaches device memory; then a per-query merge of the blocks'
//       partial top-k'.  One call replaces the reference's chunk loop.
//
// What bounds it on the H100: at the flat path's shape (nq = 32 queries,
// n = 1M rows, d = 128, k' = 80) the scan must read X once, 512 MB, 0.153
// ms at 3.35 TB/s; its 2 nq n d = 8.4 GFLOP of true fp32 FMA take 0.126 ms
// at 67 TFLOP/s, so bytes and operations are close and both pipes must be
// kept busy at once.
//
// What the design does about it:
//   * one block holds all 32 queries of a batch (QB = 32 for k' <= 256),
//     so X is read from device memory once; the blocks split the rows into
//     one chunk each, about one block per SM;
//   * X and Q are staged in 16-deep slices by cp.async in a 3-stage ring
//     (2 where k' > 128 needs the shared memory), so two slices are in
//     flight while one is multiplied; rows keep an 80-byte padded stride,
//     so the 16-byte shared loads are conflict-free;
//   * each of 256 threads keeps an 8-query x 8-row register tile of true
//     fp32 FMA products, in ascending depth order (no TF32, no tensor
//     cores: the ids near the k' boundary depend on fp32 sums); a warp's
//     lanes are 4 query groups x 8 row groups, so a 16-byte shared load
//     serves the warp with 4 or 8 distinct addresses, one pass each;
//     ||x||^2 and ||q||^2 are summed from the same staged slices (two rows
//     a thread; ||q||^2 during the first tile), in ascending depth order;
//   * the selection costs little after the first tiles: a key goes to the
//     buffer only below its query's k'-th best so far; a thread keeps a key
//     that finds the buffer full and offers it again after the flush, which
//     sorts each query's keys in one warp's registers (k' <= 256);
//   * the merge reads each block's sorted partial top-k' in runs of 8,
//     flushes after each run and stops at the first run in which no key
//     beats the running k'-th best.
// What still holds it back: the FMA loop reads one shared-memory byte per
// FMA, which holds it well below the fp32 peak, and the selection (every
// key of a chunk's first tile is offered) is a large share of the scan.
// k' > 256 takes 8 queries a block (2 per thread), so the selection state
// fits in shared memory up to k' = 1024.  A larger k' runs in passes of at
// most 1024 (the wrapper's): each pass scans again and offers only the
// keys after its query's floor key, the last key of the pass before, so
// the passes' lists joined are the first k' keys; one comparison an offer,
// in a kernel variant of its own.  Ragged nq, n and d are masked in the
// loads (zero fill) and in the offers; nothing is padded or copied.
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "topk_select.cuh"

namespace {

using topk::EMPTY;
using topk::FLOAT_INF_BITS;
using topk::order_float;
using topk::pack_key;
using topk::u64;
using topk::unorder;

constexpr int THREADS = 256;
constexpr int ROWS = 512;          // rows of X per block tile
constexpr int RT = 8;              // rows per thread, RSTEP apart
constexpr int QSTEP = 4;           // a thread's queries are QSTEP apart
constexpr int RSTEP = 8;           // and its rows RSTEP apart
constexpr int NR = ROWS / THREADS; // rows whose ||x||^2 a thread sums
constexpr int BK = 16;             // depth per staged slice
constexpr int BKP = BK + 4;        // padded slice row stride: 80 B
constexpr int DEEP = 3;            // stages of the ring while k' <= 128
constexpr int SHALLOW = 2;         // stages where the selection needs room
constexpr int MAX_KP = 1024;
constexpr int MIN_BUFFER = 128;    // buffer keys per query, at least

typedef topk::Select<THREADS> Select;

__host__ __device__ inline int queries_per_block(int kp) {
  return kp <= 256 ? 32 : 8;
}

__host__ __device__ inline int scan_stages(int kp) {
  return kp <= 128 ? DEEP : SHALLOW;
}

__host__ __device__ inline int scan_sort_len(int kp) {
  return topk::pow2_at_least(topk::state_len(kp) + MIN_BUFFER);
}

// Staged slices, ||q||^2 and ||x||^2 of a block of qb queries.
__host__ __device__ inline size_t tile_smem(int qb, int stages) {
  return (size_t)stages * (ROWS + qb) * BKP * 4 + (size_t)qb * 4 +
         (size_t)ROWS * 4;
}

__host__ __device__ inline size_t knn_smem(int kp) {
  const int qb = queries_per_block(kp);
  return Select::bytes(qb, scan_sort_len(kp)) +
         tile_smem(qb, scan_stages(kp));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The tile main loop of both entries: a block of QB = 4 TQ queries walks
// rows [r_begin, r_end) in tiles of ROWS rows and hands each tile's
// distances (TQ x RT per thread, in registers) to `epilogue`.
//   warp w, lane l: queries l % 4 + 4 i, rows 64 w + l / 4 + 8 j.
template <int TQ, int STAGES>
struct Tiles {
  static constexpr int QB = 4 * TQ;
  float* Xs;     // [STAGES][ROWS][BKP]
  float* Qs;     // [STAGES][QB][BKP]
  float* qn;     // [QB]
  float* xns;    // [ROWS]
  const float* Q;
  const float* X;
  int nq, n, d, q0, nk;
  bool vec;      // 16-byte copies: d % 4 == 0 and 16-byte aligned Q, X

  __device__ Tiles(unsigned char* smem, const float* Q_, const float* X_,
                   int nq_, int n_, int d_, int q0_)
      : Q(Q_), X(X_), nq(nq_), n(n_), d(d_), q0(q0_) {
    Xs = reinterpret_cast<float*>(smem);
    Qs = Xs + STAGES * ROWS * BKP;
    qn = Qs + STAGES * QB * BKP;
    xns = qn + QB;
    nk = (d + BK - 1) / BK;
    vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(Q) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(X) % 16 == 0;
  }

  // Issue the copies of depth slice ks of the tile at row r0 into stage st
  // (rows past n and depth past d are zero-filled).
  __device__ void load(int r0, int ks, int st, int tid) const {
    float* xs = Xs + st * ROWS * BKP;
    float* qs = Qs + st * QB * BKP;
    const int k0 = ks * BK;
    if (vec) {
#pragma unroll
      for (int it = 0; it < ROWS * (BK / 4) / THREADS; ++it) {
        const int c = tid + it * THREADS;
        const int row = c / (BK / 4), k = k0 + (c % (BK / 4)) * 4;
        const bool in = r0 + row < n && k < d;
        cp_async16(xs + row * BKP + (k - k0),
                   in ? X + (size_t)(r0 + row) * d + k : X, in);
      }
      if (tid < QB * (BK / 4)) {
        const int q = tid / (BK / 4), k = k0 + (tid % (BK / 4)) * 4;
        const bool in = q0 + q < nq && k < d;
        cp_async16(qs + q * BKP + (k - k0),
                   in ? Q + (size_t)(q0 + q) * d + k : Q, in);
      }
    } else {
#pragma unroll
      for (int it = 0; it < ROWS * BK / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int row = e / BK, k = k0 + e % BK;
        const bool in = r0 + row < n && k < d;
        cp_async4(xs + row * BKP + (k - k0),
                  in ? X + (size_t)(r0 + row) * d + k : X, in);
      }
      for (int e = tid; e < QB * BK; e += THREADS) {
        const int q = e / BK, k = k0 + e % BK;
        const bool in = q0 + q < nq && k < d;
        cp_async4(qs + q * BKP + (k - k0),
                  in ? Q + (size_t)(q0 + q) * d + k : Q, in);
      }
    }
  }

  template <class Epilogue>
  __device__ void run(int r_begin, int r_end, int tid, Epilogue&& epilogue) {
    const int warp = tid >> 5, lane = tid & 31;
    const int qloc = lane % QSTEP;                 // queries qloc + 4 i
    const int rloc = warp * (RSTEP * RT) + lane / QSTEP;  // rows rloc + 8 j
    const int ntiles = (r_end - r_begin + ROWS - 1) / ROWS;
    const int total = ntiles * nk;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < total) load(r_begin + (s / nk) * ROWS, s % nk, s, tid);
      cp_async_commit();
    }

    float acc[TQ][RT], xn[NR], q2 = 0.f;
#pragma unroll
    for (int j = 0; j < RT; ++j)
#pragma unroll
      for (int i = 0; i < TQ; ++i) acc[i][j] = 0.f;
#pragma unroll
    for (int r = 0; r < NR; ++r) xn[r] = 0.f;

    for (int it = 0; it < total; ++it) {
      cp_async_wait<STAGES - 2>();
      // slice `it` has landed for every thread, and every thread is done
      // with slice it - 1, whose stage the next copies overwrite
      __syncthreads();
      const int nxt = it + STAGES - 1;
      if (nxt < total)
        load(r_begin + (nxt / nk) * ROWS, nxt % nk, nxt % STAGES, tid);
      cp_async_commit();

      const float* xs = Xs + (it % STAGES) * ROWS * BKP;
      const float* qs = Qs + (it % STAGES) * QB * BKP;
      if (it < nk && tid < QB) {               // ||q||^2, during tile 0
#pragma unroll
        for (int kk = 0; kk < BK; kk += 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              qs + tid * BKP + kk);
          q2 = fmaf(v.x, v.x, q2);
          q2 = fmaf(v.y, v.y, q2);
          q2 = fmaf(v.z, v.z, q2);
          q2 = fmaf(v.w, v.w, q2);
        }
        if (it == nk - 1) qn[tid] = q2;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r)             // ||x||^2 of rows tid + 256 r
#pragma unroll
        for (int kk = 0; kk < BK; kk += 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              xs + (tid + THREADS * r) * BKP + kk);
          xn[r] = fmaf(v.x, v.x, xn[r]);
          xn[r] = fmaf(v.y, v.y, xn[r]);
          xn[r] = fmaf(v.z, v.z, xn[r]);
          xn[r] = fmaf(v.w, v.w, xn[r]);
        }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        // a warp reads 8 rows and 4 queries per 16-byte load: one pass
        // of shared memory each
        float xv[4][RT], qv[4][TQ];      // [depth][row or query]
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              xs + (rloc + RSTEP * j) * BKP + kk);
          xv[0][j] = v.x, xv[1][j] = v.y, xv[2][j] = v.z, xv[3][j] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              qs + (qloc + QSTEP * i) * BKP + kk);
          qv[0][i] = v.x, qv[1][i] = v.y, qv[2][i] = v.z, qv[3][i] = v.w;
        }
        // one depth at a time over the whole register tile: consecutive
        // FMAs are independent, each sum still runs in ascending depth
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < RT; ++j)
              acc[i][j] = fmaf(qv[c][i], xv[c][j], acc[i][j]);
      }

      if (it % nk == nk - 1) {           // the tile's last slice
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          xns[tid + THREADS * r] = xn[r];
          xn[r] = 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const float x2 = xns[rloc + RSTEP * j];
#pragma unroll
          for (int i = 0; i < TQ; ++i)   // -2 acc is exact: one rounding
            acc[i][j] = fmaf(-2.f, acc[i][j], qn[qloc + QSTEP * i]) + x2;
        }
        epilogue(r_begin + (it / nk) * ROWS, qloc, rloc, acc);
#pragma unroll
        for (int j = 0; j < RT; ++j)
#pragma unroll
          for (int i = 0; i < TQ; ++i) acc[i][j] = 0.f;
      }
    }
    cp_async_wait<0>();
  }
};

// repro_l2_sq_dists: grid (query groups, row tiles); one tile a block.
__global__ void __launch_bounds__(THREADS, 1)
l2_tile_kernel(const float* __restrict__ Q, const float* __restrict__ X,
               float* __restrict__ out, int nq, int n, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  Tiles<8, DEEP> t(smem, Q, X, nq, n, d, blockIdx.x * 32);
  const int r0 = blockIdx.y * ROWS;
  t.run(r0, min(n, r0 + ROWS), tid,
        [&](int tile0, int qloc, int rloc, float (&dist)[8][RT]) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int q = t.q0 + qloc + QSTEP * i;
            if (q >= nq) continue;
#pragma unroll
            for (int j = 0; j < RT; ++j) {
              const int r = tile0 + rloc + RSTEP * j;
              if (r < n) out[(size_t)q * n + r] = dist[i][j];
            }
          }
        });
}

// Stage 1 of repro_l2_knn: grid (query groups, row chunks).  E > 0: the
// segments hold 32 E keys and are sorted a warp each in registers.
// FLOOR: a later pass of a call above MAX_KP, which offers only the keys
// after its query's floor key (the last key of the pass before).
template <int TQ, int STAGES, int E, bool FLOOR>
__global__ void __launch_bounds__(THREADS, 1)
l2_scan_kernel(const float* __restrict__ Q, const float* __restrict__ X,
               u64* __restrict__ part, const u64* __restrict__ floor, int nq,
               int n, int d, int kp, int chunk_rows, int G) {
  constexpr int QB = 4 * TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int S = scan_sort_len(kp);
  const int g = blockIdx.y;
  Tiles<TQ, STAGES> t(smem + (size_t)QB * S * 8, Q, X, nq, n, d,
                      blockIdx.x * QB);
  u64 lo[TQ];                                    // the floor keys
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int q = t.q0 + (tid & 31) % QSTEP + QSTEP * i;
    lo[i] = FLOOR && q < nq ? floor[q] : 0;
  }
  Select sel = Select::at(smem, QB, kp, S, tile_smem(QB, STAGES));
  auto flush = [&]() {
    if constexpr (E > 0) sel.template flush_warps<E>(tid);
    else sel.flush(tid);
  };
  sel.init(tid);
  const int r_begin = g * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  t.run(r_begin, r_end, tid,
        [&](int tile0, int qloc, int rloc, float (&dist)[TQ][RT]) {
          static_assert(TQ * RT <= 64, "one pending bit per distance");
          u64 pend = 0;
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < RT; ++j)
              if (t.q0 + qloc + QSTEP * i < nq &&
                  tile0 + rloc + RSTEP * j < r_end &&
                  (!FLOOR || pack_key(order_float(dist[i][j]),
                                      tile0 + rloc + RSTEP * j) > lo[i]))
                pend |= 1ull << (i * RT + j);
          // Offer; a key that finds its buffer full stays pending until
          // the block has flushed.  Every thread reaches each barrier.
          while (true) {
#pragma unroll
            for (int i = 0; i < TQ; ++i) {
              const int q = qloc + QSTEP * i;
              const u64 thr = sel.thr[q];
#pragma unroll
              for (int j = 0; j < RT; ++j) {
                const u64 bit = 1ull << (i * RT + j);
                if (pend & bit) {
                  const u64 key = pack_key(order_float(dist[i][j]),
                                           tile0 + rloc + RSTEP * j);
                  if (key >= thr || sel.try_put(q, key)) pend &= ~bit;
                }
              }
            }
            if (!__syncthreads_or(pend != 0)) break;
            flush();
          }
        });
  flush();
  for (int i = tid; i < QB * kp; i += THREADS) {
    const int q = i / kp, j = i - q * kp;
    if (t.q0 + q < nq)
      part[((size_t)(t.q0 + q) * G + g) * kp + j] = sel.keys[(size_t)q * S + j];
  }
}

// Stage 2 of repro_l2_knn: one block per query merges the G sorted
// partial top-kp lists (Select::merge_runs: runs of MERGE_RUN keys of
// every list a round, stopping after a round that brings nothing below
// the running kp-th best); with floor_out, it leaves there the query's
// last key (EMPTY if the rows ran out), the next pass's floor.
__global__ void __launch_bounds__(THREADS)
l2_merge_kernel(const u64* __restrict__ part, float* __restrict__ out_d,
                long long* __restrict__ out_i, u64* __restrict__ floor_out,
                int G, int kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int q = blockIdx.x;
  Select sel = Select::at(smem, 1, kp, Select::merge_len(kp, G), 0);
  sel.init(tid);
  sel.merge_runs(part + (size_t)q * G * kp, G, tid);
  if (floor_out && tid == 0) floor_out[q] = sel.keys[kp - 1];
  for (int j = tid; j < kp; j += THREADS) {
    const u64 top = sel.keys[j];
    const size_t o = (size_t)q * kp + j;
    if (top == EMPTY) {
      out_d[o] = __uint_as_float(FLOAT_INF_BITS);
      out_i[o] = -1;
    } else {
      out_d[o] = __uint_as_float(unorder((unsigned)(top >> 32), true));
      out_i[o] = (long long)(unsigned)(top & 0xffffffffu);
    }
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Q (nq, d), X (n, d), out (nq, n): float32, row-major, contiguous, all on
// `device`.  Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_l2_sq_dists(const float* Q, const float* X, float* out,
                                 int nq, int n, int d, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq == 0 || n == 0) return cudaSuccess;
  if (d < 1 || (n + ROWS - 1) / ROWS > 65535) return cudaErrorInvalidValue;
  const size_t smem = tile_smem(32, DEEP);
  err = set_smem(reinterpret_cast<const void*>(l2_tile_kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + 31) / 32, (n + ROWS - 1) / ROWS);
  l2_tile_kernel<<<grid, THREADS, smem, stream>>>(Q, X, out, nq, n, d);
  return cudaGetLastError();
}

// Queries a block of the fused scan takes at this kp (the wrapper cuts the
// batch into groups of that many), and the shared memory (bytes) its stage
// 1 needs; the wrapper refuses a call whose need exceeds the device's
// per-block limit.
extern "C" int repro_l2_knn_queries_per_block(int kp) {
  return queries_per_block(kp);
}

extern "C" long long repro_l2_knn_smem(int kp) {
  return (long long)knn_smem(kp);
}

// Q (nq, d), X (n, d) float32; part (nq, G, kp) uint64 scratch; out_d
// (nq, kp) float32, out_i (nq, kp) int64; all contiguous on `device`.
// Rows are split into G chunks of chunk_rows (a multiple of 512), one
// block per (query group, chunk).  A call above MAX_KP runs in passes:
// floor_in (nq,) (nullptr on the first pass; kp > 256 on the others)
// holds each query's last key of the pass before, and only keys after
// it are offered; floor_out (or nullptr) gets this pass's last keys (it
// may be floor_in: the scan has read it before the merge writes).
// Launches both stages on `stream` and returns cudaGetLastError().
extern "C" int repro_l2_knn(const float* Q, const float* X, u64* part,
                            float* out_d, long long* out_i,
                            const u64* floor_in, u64* floor_out, int nq,
                            int n, int d, int kp, int chunk_rows, int G,
                            int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq == 0) return cudaSuccess;
  if (kp < 1 || kp > MAX_KP || kp > n || d < 1 || chunk_rows < ROWS ||
      chunk_rows % ROWS || (long long)chunk_rows * G < n ||
      (long long)chunk_rows * (G - 1) >= n || G > 65535 ||
      (long long)G * kp > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  const int qb = queries_per_block(kp);
  if (floor_in && qb != 8) return cudaErrorInvalidValue;
  const size_t smem = knn_smem(kp);
  const dim3 grid((nq + qb - 1) / qb, G);
#define REPRO_L2_SCAN(TQ, STAGES, E, FLOOR)                                \
  do {                                                                      \
    err = set_smem(reinterpret_cast<const void*>(                          \
                       l2_scan_kernel<TQ, STAGES, E, FLOOR>), smem);        \
    if (err != cudaSuccess) return err;                                     \
    l2_scan_kernel<TQ, STAGES, E, FLOOR><<<grid, THREADS, smem, stream>>>(  \
        Q, X, part, floor_in, nq, n, d, kp, chunk_rows, G);                 \
  } while (0)
  if (kp <= 128) REPRO_L2_SCAN(8, DEEP, 8, false);
  else if (qb == 32) REPRO_L2_SCAN(8, SHALLOW, 16, false);
  else if (floor_in) REPRO_L2_SCAN(2, SHALLOW, 0, true);
  else REPRO_L2_SCAN(2, SHALLOW, 0, false);
#undef REPRO_L2_SCAN
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t msmem = Select::bytes(1, Select::merge_len(kp, G));
  err = set_smem(reinterpret_cast<const void*>(l2_merge_kernel), msmem);
  if (err != cudaSuccess) return err;
  l2_merge_kernel<<<nq, THREADS, msmem, stream>>>(part, out_d, out_i,
                                                  floor_out, G, kp);
  return cudaGetLastError();
}
