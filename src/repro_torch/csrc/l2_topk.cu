// Squared-L2 distance tiles of the flat filter.
//
// Replaces: src/repro/kernels/l2_topk/l2_topk.py :: pairwise_sq_dists
// (Pallas tile kernel _l2_tile_kernel), which computes
//     out[i, j] = ||q_i||^2 - 2 q_i . x_j + ||x_j||^2
// for Q (nq, d) and X (n, d) in float32.  The caller (ops.knn) folds each
// (nq, chunk) block into a running top-k'.
//
// What bounds it on the H100: at the main-path shape (nq = 32 queries
// against a chunk of 4096 rows, d = 128) the work is 2*nq*chunk*d = 33.6
// MFLOP against ~2.6 MB moved (the chunk of X read once, the distance
// block written once), about 13 FLOP per byte: memory-bound, ~0.8 us at
// 3.35 TB/s.  At that size the launch itself (a few us) and the torch
// top-k merge that follows each block cost more than the bytes.
//
// What the design does about it: it is the simple, right version.  Each
// block stages a 32-query x 32-deep slice of Q and a 64-row x 32-deep
// slice of X in shared memory (coalesced along d, stored transposed; the
// next slice is loaded into registers while the current one is used, so
// a stage costs one round trip to memory, not one per load), and each of
// 128 threads keeps a 4 x 4 register tile of dot products in true fp32
// FMA (no TF32, no tensor cores: the filter's ids near the k'
// boundary depend on fp32 sums).  The norms are accumulated from the same
// shared-memory tiles, so X is read from device memory once.  Ragged nq,
// n and d are masked in the loads and stores; no padding is needed.
// Fusing the running top-k' into the kernel, so the (nq, chunk) block
// never reaches device memory and one launch covers the whole scan, is
// later work.
#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int BM = 32;                          // queries per block
constexpr int BN = 64;                          // database rows per block
constexpr int BK = 32;                          // depth per stage
constexpr int TM = 4;                           // queries per thread
constexpr int TN = 4;                           // rows per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128

__global__ void __launch_bounds__(THREADS)
l2_tile_kernel(const float* __restrict__ Q, const float* __restrict__ X,
               float* __restrict__ out, int nq, int n, int d) {
  __shared__ float Qs[BK][BM + 1];
  __shared__ float Xs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int q0 = blockIdx.y * BM;
  const int x0 = blockIdx.x * BN;

  float acc[TM][TN];
  float qn[TM];
  float xn[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    qn[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) xn[j] = 0.f;

  // Register prefetch: the next stage's loads are in flight while the
  // current stage is multiplied out of shared memory.
  constexpr int QLOADS = BM * BK / THREADS;     // 8 per thread
  constexpr int XLOADS = BN * BK / THREADS;     // 16 per thread
  const int c = tid % BK;                       // this thread's depth column
  const int r0 = tid / BK;                      // and its first row
  float qv[QLOADS], xv[XLOADS];
  auto load = [&](int k0) {
    const int gk = k0 + c;
#pragma unroll
    for (int it = 0; it < QLOADS; ++it) {
      const int gq = q0 + r0 + it * (THREADS / BK);
      qv[it] = (gq < nq && gk < d) ? Q[(size_t)gq * d + gk] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < XLOADS; ++it) {
      const int gx = x0 + r0 + it * (THREADS / BK);
      xv[it] = (gx < n && gk < d) ? X[(size_t)gx * d + gk] : 0.f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int it = 0; it < QLOADS; ++it) Qs[c][r0 + it * (THREADS / BK)] = qv[it];
#pragma unroll
    for (int it = 0; it < XLOADS; ++it) Xs[c][r0 + it * (THREADS / BK)] = xv[it];
    __syncthreads();
    if (k0 + BK < d) load(k0 + BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Qs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Xs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        qn[i] = fmaf(a[i], a[i], qn[i]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) xn[j] = fmaf(b[j], b[j], xn[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gq = q0 + ty * TM + i;
    if (gq >= nq) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gx = x0 + tx * TN + j;
      if (gx < n) out[(size_t)gq * n + gx] = qn[i] - 2.f * acc[i][j] + xn[j];
    }
  }
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
  const dim3 grid((n + BN - 1) / BN, (nq + BM - 1) / BM);
  l2_tile_kernel<<<grid, THREADS, 0, stream>>>(Q, X, out, nq, n, d);
  return cudaGetLastError();
}
