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
//     chunks of whole tiles by the wrapper's block plan
//     (`common.block_plan`): over slots = SMs x the blocks of the launched
//     variant that one SM holds (repro_l2_knn_blocks_per_sm: 1 on the
//     H100 at k' 80, 128 and 800, where shared memory takes one), G chunks
//     cost ceil(groups G / slots) waves of ceil(tiles / G) + c tile-times,
//     and the least cost wins, ties to the smaller G.  c, a chunk's fixed
//     cost (its first tile's offers, the ring's fill, one more list to
//     merge), is 10 tile-times: the least-squares fit of the 42 plans
//     timed at nq 1024 over 1M rows (k' 80) and 2^24 rows (k' 128), one
//     variant (21.9 us a tile of 512 rows x 32 queries; each shape alone
//     fits 5.5 and 14.0; scripts/scan_plans.py times the plans and fits
//     c).  At 2^24 rows the plan is 8 whole waves of 32 x 33 blocks
//     (178.7 ms; 32 x 4 in one wave 181.2).  At 1M rows the plan is one
//     wave of 32 x 4 blocks (11.28 ms; 32 x 33 12.35; 32 x 5, two waves
//     whose second holds 28 blocks on 132 SMs, 17.99); the 32 blocks of a
//     chunk read its rows at about the same time, so X comes from L2 and
//     not 32 times from device memory;
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
//
// 16-bit rows.  The reference casts X to float32 before its kernel
// computes; here X may be float32, bfloat16 or float16 and is read in
// place (Q is float32: the wrapper converts it, as it is small).  A 16-bit
// slice lands in shared memory as it is: 16-byte cp.async copies carry 8
// values (d % 8 == 0 and a 16-byte aligned X; else plain loads, as
// cp.async has no 2-byte size), rows keep a 48-byte stride (the 8-byte
// reads of a warp's 8 rows meet no bank twice), and the FMA loop and the
// ||x||^2 sums convert each value to float32 as they read it.  bf16 and
// f16 values are exact in float32, so every product and sum is the one
// the float32 kernel computes on a float32 copy of the rows, in the same
// order: distances and ids are bit-equal to it.  The slices take 24 KB a
// stage instead of 40 KB; the bytes bound halves, the operations bound
// does not (the FMAs are fp32 on the CUDA cores).
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "row_elements.cuh"
#include "topk_select.cuh"

namespace {

using elem::load4;
using elem::zero;
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
constexpr int BKP = BK + 4;        // padded float32 slice row stride: 80 B
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

// A row's padded stride (elements) in a staged X slice, by element size:
// 80 B for float32 (conflict-free 16-byte reads), 48 B for 16-bit values
// (conflict-free 8-byte reads, 16-byte aligned cp.async destinations).
__host__ __device__ constexpr int x_stride(int esize) {
  return esize == 4 ? BKP : BK + 8;
}

// Staged X and Q slices, ||q||^2 and ||x||^2 of a block of qb queries,
// for rows of `esize` bytes an element.
__host__ __device__ inline size_t tile_smem(int qb, int stages, int esize) {
  return (size_t)stages * ROWS * x_stride(esize) * esize +
         (size_t)stages * qb * BKP * 4 + (size_t)qb * 4 + (size_t)ROWS * 4;
}

__host__ __device__ inline size_t knn_smem(int kp, int esize) {
  const int qb = queries_per_block(kp);
  return Select::bytes(qb, scan_sort_len(kp)) +
         tile_smem(qb, scan_stages(kp), esize);
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
// rows [r_begin, r_end) of X (elements of type T) in tiles of ROWS rows
// and hands each tile's distances (TQ x RT per thread, in registers) to
// `epilogue`.
//   warp w, lane l: queries l % 4 + 4 i, rows 64 w + l / 4 + 8 j.
template <typename T, int TQ, int STAGES>
struct Tiles {
  static constexpr int QB = 4 * TQ;
  static constexpr int XS = x_stride(sizeof(T));  // X slice row stride
  static constexpr int VEC = 16 / sizeof(T);      // elements a 16-byte copy
  T* Xs;         // [STAGES][ROWS][XS]
  float* Qs;     // [STAGES][QB][BKP]
  float* qn;     // [QB]
  float* xns;    // [ROWS]
  const float* Q;
  const T* X;
  int nq, n, d, q0, nk;
  bool vec;      // 16-byte copies: d % VEC == 0 and 16-byte aligned Q, X

  __device__ Tiles(unsigned char* smem, const float* Q_, const T* X_,
                   int nq_, int n_, int d_, int q0_)
      : Q(Q_), X(X_), nq(nq_), n(n_), d(d_), q0(q0_) {
    Xs = reinterpret_cast<T*>(smem);
    Qs = reinterpret_cast<float*>(Xs + STAGES * ROWS * XS);
    qn = Qs + STAGES * QB * BKP;
    xns = qn + QB;
    nk = (d + BK - 1) / BK;
    vec = d % VEC == 0 && reinterpret_cast<uintptr_t>(Q) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(X) % 16 == 0;
  }

  // Issue the copies of depth slice ks of the tile at row r0 into stage st
  // (rows past n and depth past d are zero-filled).  Without 16-byte
  // copies, float32 rows take 4-byte cp.async and 16-bit rows plain loads
  // (the stage is free: every thread has passed the barrier after its
  // last reads).
  __device__ void load(int r0, int ks, int st, int tid) const {
    T* xs = Xs + st * ROWS * XS;
    float* qs = Qs + st * QB * BKP;
    const int k0 = ks * BK;
    if (vec) {
#pragma unroll
      for (int it = 0; it < ROWS * (BK / VEC) / THREADS; ++it) {
        const int c = tid + it * THREADS;
        const int row = c / (BK / VEC), k = k0 + (c % (BK / VEC)) * VEC;
        const bool in = r0 + row < n && k < d;
        cp_async16(xs + row * XS + (k - k0),
                   in ? X + (size_t)(r0 + row) * d + k : X, in);
      }
    } else {
#pragma unroll
      for (int it = 0; it < ROWS * BK / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int row = e / BK, k = k0 + e % BK;
        const bool in = r0 + row < n && k < d;
        if constexpr (sizeof(T) == 4)
          cp_async4(xs + row * XS + (k - k0),
                    in ? X + (size_t)(r0 + row) * d + k : X, in);
        else
          xs[row * XS + (k - k0)] =
              in ? X[(size_t)(r0 + row) * d + k] : zero<T>();
      }
    }
    if (vec) {
      if (tid < QB * (BK / 4)) {
        const int q = tid / (BK / 4), k = k0 + (tid % (BK / 4)) * 4;
        const bool in = q0 + q < nq && k < d;
        cp_async16(qs + q * BKP + (k - k0),
                   in ? Q + (size_t)(q0 + q) * d + k : Q, in);
      }
    } else {
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

      const T* xs = Xs + (it % STAGES) * ROWS * XS;
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
          const float4 v = load4(xs + (tid + THREADS * r) * XS + kk);
          xn[r] = fmaf(v.x, v.x, xn[r]);
          xn[r] = fmaf(v.y, v.y, xn[r]);
          xn[r] = fmaf(v.z, v.z, xn[r]);
          xn[r] = fmaf(v.w, v.w, xn[r]);
        }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        // a warp reads 8 rows and 4 queries per 16-byte (X: 8-byte if
        // 16-bit) load: one pass of shared memory each
        float xv[4][RT], qv[4][TQ];      // [depth][row or query]
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const float4 v = load4(xs + (rloc + RSTEP * j) * XS + kk);
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
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
l2_tile_kernel(const float* __restrict__ Q, const T* __restrict__ X,
               float* __restrict__ out, int nq, int n, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  Tiles<T, 8, DEEP> t(smem, Q, X, nq, n, d, blockIdx.x * 32);
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
template <typename T, int TQ, int STAGES, int E, bool FLOOR>
__global__ void __launch_bounds__(THREADS, 1)
l2_scan_kernel(const float* __restrict__ Q, const T* __restrict__ X,
               u64* __restrict__ part, const u64* __restrict__ floor, int nq,
               int n, int d, int kp, int chunk_rows, int G) {
  constexpr int QB = 4 * TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int S = scan_sort_len(kp);
  const int g = blockIdx.y;
  Tiles<T, TQ, STAGES> t(smem + (size_t)QB * S * 8, Q, X, nq, n, d,
                         blockIdx.x * QB);
  u64 lo[TQ];                                    // the floor keys
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int q = t.q0 + (tid & 31) % QSTEP + QSTEP * i;
    lo[i] = FLOOR && q < nq ? floor[q] : 0;
  }
  Select sel = Select::at(smem, QB, kp, S,
                          tile_smem(QB, STAGES, sizeof(T)));
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

template <typename T>
cudaError_t sq_dists(const float* Q, const void* X, float* out, int nq,
                     int n, int d, cudaStream_t stream) {
  const size_t smem = tile_smem(32, DEEP, sizeof(T));
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(l2_tile_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + 31) / 32, (n + ROWS - 1) / ROWS);
  l2_tile_kernel<T><<<grid, THREADS, smem, stream>>>(
      Q, static_cast<const T*>(X), out, nq, n, d);
  return cudaGetLastError();
}

// The stage-1 variant that scan() launches at this kp (FLOOR only where
// kp > 256 takes 8 queries a block), as a pointer: every variant takes the
// same arguments.
template <typename T>
using ScanKernel = void (*)(const float*, const T*, u64*, const u64*, int,
                            int, int, int, int, int);

template <typename T>
ScanKernel<T> scan_kernel(int kp, bool floor) {
  if (kp <= 128) return l2_scan_kernel<T, 8, DEEP, 8, false>;
  if (queries_per_block(kp) == 32)
    return l2_scan_kernel<T, 8, SHALLOW, 16, false>;
  if (floor) return l2_scan_kernel<T, 2, SHALLOW, 0, true>;
  return l2_scan_kernel<T, 2, SHALLOW, 0, false>;
}

template <typename T>
cudaError_t scan(const float* Q, const void* X, u64* part,
                 const u64* floor_in, int nq, int n, int d, int kp,
                 int chunk_rows, int G, cudaStream_t stream) {
  const int qb = queries_per_block(kp);
  const size_t smem = knn_smem(kp, sizeof(T));
  const dim3 grid((nq + qb - 1) / qb, G);
  const ScanKernel<T> kernel = scan_kernel<T>(kp, floor_in != nullptr);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(Q, static_cast<const T*>(X), part,
                                          floor_in, nq, n, d, kp, chunk_rows,
                                          G);
  return cudaGetLastError();
}

// Blocks of scan_kernel<T>(kp, floor) that one SM holds at once, at the
// shared memory it launches with; a negative cudaError_t on failure.
template <typename T>
int blocks_per_sm(int kp, bool floor) {
  const ScanKernel<T> kernel = scan_kernel<T>(kp, floor);
  const size_t smem = knn_smem(kp, sizeof(T));
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

int element_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// Q (nq, d) float32, X (n, d) of element type `dtype` (0 float32, 1
// bfloat16, 2 float16), out (nq, n) float32: row-major, contiguous, all
// on `device`.  Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_l2_sq_dists(const float* Q, const void* X, float* out,
                                 int nq, int n, int d, int dtype, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq == 0 || n == 0) return cudaSuccess;
  if (d < 1 || (n + ROWS - 1) / ROWS > 65535 || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return sq_dists<__nv_bfloat16>(Q, X, out, nq, n, d, stream);
  if (dtype == 2) return sq_dists<__half>(Q, X, out, nq, n, d, stream);
  return sq_dists<float>(Q, X, out, nq, n, d, stream);
}

// Queries a block of the fused scan takes at this kp (the wrapper cuts the
// batch into groups of that many), and the shared memory (bytes) its stage
// 1 needs for rows of element type `dtype`; the wrapper refuses a call
// whose need exceeds the device's per-block limit.
extern "C" int repro_l2_knn_queries_per_block(int kp) {
  return queries_per_block(kp);
}

extern "C" long long repro_l2_knn_smem(int kp, int dtype) {
  return (long long)knn_smem(kp, element_size(dtype));
}

// Stage-1 blocks of the fused scan that one SM of `device` holds at once,
// for the variant a pass at this kp launches (floor: a later pass of a
// call above MAX_KP) on rows of element type `dtype`; the wrapper's block
// plan counts the card's slots with it.  A negative cudaError_t on
// failure.
extern "C" int repro_l2_knn_blocks_per_sm(int kp, int dtype, int floor,
                                          int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  if (kp < 1 || kp > MAX_KP || dtype < 0 || dtype > 2)
    return -(int)cudaErrorInvalidValue;
  if (dtype == 1) return blocks_per_sm<__nv_bfloat16>(kp, floor != 0);
  if (dtype == 2) return blocks_per_sm<__half>(kp, floor != 0);
  return blocks_per_sm<float>(kp, floor != 0);
}

// Q (nq, d) float32, X (n, d) of element type `dtype` (0 float32, 1
// bfloat16, 2 float16); part (nq, G, kp) uint64 scratch; out_d
// (nq, kp) float32, out_i (nq, kp) int64; all contiguous on `device`.
// Rows are split into G chunks of chunk_rows (a multiple of 512), one
// block per (query group, chunk).  A call above MAX_KP runs in passes:
// floor_in (nq,) (nullptr on the first pass; kp > 256 on the others)
// holds each query's last key of the pass before, and only keys after
// it are offered; floor_out (or nullptr) gets this pass's last keys (it
// may be floor_in: the scan has read it before the merge writes).
// Launches both stages on `stream` and returns cudaGetLastError().
extern "C" int repro_l2_knn(const float* Q, const void* X, u64* part,
                            float* out_d, long long* out_i,
                            const u64* floor_in, u64* floor_out, int nq,
                            int n, int d, int kp, int chunk_rows, int G,
                            int dtype, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq == 0) return cudaSuccess;
  if (kp < 1 || kp > MAX_KP || kp > n || d < 1 || chunk_rows < ROWS ||
      chunk_rows % ROWS || (long long)chunk_rows * G < n ||
      (long long)chunk_rows * (G - 1) >= n || G > 65535 ||
      (long long)G * kp > (1LL << 31) - 1 || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  if (floor_in && queries_per_block(kp) != 8) return cudaErrorInvalidValue;
  if (dtype == 1)
    err = scan<__nv_bfloat16>(Q, X, part, floor_in, nq, n, d, kp,
                              chunk_rows, G, stream);
  else if (dtype == 2)
    err = scan<__half>(Q, X, part, floor_in, nq, n, d, kp, chunk_rows, G,
                       stream);
  else
    err = scan<float>(Q, X, part, floor_in, nq, n, d, kp, chunk_rows, G,
                      stream);
  if (err != cudaSuccess) return err;
  const size_t msmem = Select::bytes(1, Select::merge_len(kp, G));
  err = set_smem(reinterpret_cast<const void*>(l2_merge_kernel), msmem);
  if (err != cudaSuccess) return err;
  l2_merge_kernel<<<nq, THREADS, msmem, stream>>>(part, out_d, out_i,
                                                  floor_out, G, kp);
  return cudaGetLastError();
}
