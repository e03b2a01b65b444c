// Batched DCE DistanceComp (pairwise Z) tiles of the refine.
//
// Replaces: src/repro/kernels/dce_comp/dce_comp.py :: batched_z_matrix
// (Pallas tile kernel _z_tile_kernel_batched) and :: z_matrix
// (_z_tile_kernel), the same math for one candidate set (B = 1 here).
// For each query b and candidates i, j of its set:
//     Z[b,i,j] = (C[b,i,0] o T_b) . C[b,j,2]  -  (C[b,i,1] o T_b) . C[b,j,3]
// over D = 2*d_pad + 16, in float32.  Z[b,i,j] < 0 iff candidate i is
// closer to the query than j; the caller turns Z into win counts.
//
// What bounds it on the H100: at the main-path shape (B = 32 queries,
// n = k' = 80 candidates, D = 272) the kernel reads 32*80*4*272*4 B =
// 11.1 MB of ciphertexts and writes 0.8 MB of Z for 2*2*B*n^2*D = 0.22
// GFLOP, about 19 FLOP per byte: memory-bound, ~3.6 us at 3.35 TB/s
// (~24 us at D = 1936).
//
// What the design does about it: it is the simple, right version.  One
// block per (query b, 32-row i-tile, 32-column j-tile) stages, per 32-deep
// slice of D, the trapdoor-scaled left operands C[b,i,0] o T_b and
// C[b,i,1] o T_b (the scaling is fused into the load, as in the TPU
// kernel) and the right operands C[b,j,2] and C[b,j,3] in shared memory;
// the next slice is loaded into registers while the current one is used,
// so a stage costs one round trip to memory, not one per load.
// Each of 256 threads keeps 2 x 2 tiles of both products in fp32
// registers with true fp32 FMA: DCE's exactness in f32 rests on true
// fp32 sums, so no TF32 and no tensor cores.  The two products are kept
// apart and subtracted once at the end, as the reference does.  Ragged n
// and D are masked; nothing is padded.  Fusing the win count (so Z never
// reaches device memory) and the candidate gather is later work.
#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int TI = 32;                          // rows i per block
constexpr int TJ = 32;                          // columns j per block
constexpr int DK = 32;                          // depth per stage
constexpr int RI = 2;                           // rows per thread
constexpr int RJ = 2;                           // columns per thread
constexpr int THREADS = (TI / RI) * (TJ / RJ);  // 256

__global__ void __launch_bounds__(THREADS)
z_tile_kernel(const float* __restrict__ C, const float* __restrict__ T,
              float* __restrict__ Z, int n, int D) {
  __shared__ float L1[DK][TI + 1];
  __shared__ float L2[DK][TI + 1];
  __shared__ float R3[DK][TJ + 1];
  __shared__ float R4[DK][TJ + 1];

  const int tid = threadIdx.x;
  const int tx = tid % (TJ / RJ);
  const int ty = tid / (TJ / RJ);
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TI;
  const int j0 = blockIdx.x * TJ;
  const float* Cb = C + (size_t)b * n * 4 * D;
  const float* Tb = T + (size_t)b * D;

  float acc1[RI][RJ], acc2[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc1[i][j] = acc2[i][j] = 0.f;

  // Register prefetch: the next stage's loads are in flight while the
  // current stage is multiplied out of shared memory.
  constexpr int LOADS = TI * DK / THREADS;      // 4 rows per thread
  const int c = tid % DK;                       // this thread's depth column
  const int r0 = tid / DK;                      // and its first row
  float v1[LOADS], v2[LOADS], v3[LOADS], v4[LOADS];
  auto load = [&](int k0) {
    const int gk = k0 + c;
    const bool kin = gk < D;
    const float t = kin ? Tb[gk] : 0.f;
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int r = r0 + it * (THREADS / DK);
      const bool iok = kin && i0 + r < n;
      const bool jok = kin && j0 + r < n;
      const float* rowi = Cb + (size_t)(i0 + r) * 4 * D + gk;
      const float* rowj = Cb + (size_t)(j0 + r) * 4 * D + gk;
      v1[it] = iok ? rowi[0] * t : 0.f;           // fused trapdoor scaling
      v2[it] = iok ? rowi[D] * t : 0.f;
      v3[it] = jok ? rowj[2 * (size_t)D] : 0.f;
      v4[it] = jok ? rowj[3 * (size_t)D] : 0.f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < D; k0 += DK) {
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int r = r0 + it * (THREADS / DK);
      L1[c][r] = v1[it];
      L2[c][r] = v2[it];
      R3[c][r] = v3[it];
      R4[c][r] = v4[it];
    }
    __syncthreads();
    if (k0 + DK < D) load(k0 + DK);
#pragma unroll 8
    for (int kk = 0; kk < DK; ++kk) {
      float a1[RI], a2[RI], b3[RJ], b4[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        a1[i] = L1[kk][ty * RI + i];
        a2[i] = L2[kk][ty * RI + i];
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        b3[j] = R3[kk][tx * RJ + j];
        b4[j] = R4[kk][tx * RJ + j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          acc1[i][j] = fmaf(a1[i], b3[j], acc1[i][j]);
          acc2[i][j] = fmaf(a2[i], b4[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int gi = i0 + ty * RI + i;
    if (gi >= n) continue;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int gj = j0 + tx * RJ + j;
      if (gj < n) Z[((size_t)b * n + gi) * n + gj] = acc1[i][j] - acc2[i][j];
    }
  }
}

}  // namespace

// C (B, n, 4, D), T (B, D), Z (B, n, n): float32, contiguous, all on
// `device`.  B <= 65535 (one grid z-slice per query).  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int repro_dce_batched_z(const float* C, const float* T, float* Z,
                                   int B, int n, int D, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || n == 0) return cudaSuccess;
  const dim3 grid((n + TJ - 1) / TJ, (n + TI - 1) / TI, B);
  z_tile_kernel<<<grid, THREADS, 0, stream>>>(C, T, Z, n, D);
  return cudaGetLastError();
}
