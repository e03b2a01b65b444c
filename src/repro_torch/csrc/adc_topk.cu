// Fused quantized-ADC filter scan + top-kp: the int8 (K4) and PQ (K5)
// kernels of the ADC filter.
//
// Replaces: src/repro/kernels/adc_topk/adc_topk.py :: sq_adc_topk (Pallas
// kernel _sq_adc_kernel) and :: pq_adc_topk (_pq_adc_kernel), both with
// the running top-k merge _merge_topk.  For each query and each row i
// with ok[i] != 0:
//     int8: d_i = cn_i - 2 * (q8 . c8_i)                 in int32, exact;
//     pq8:  d_i = sum_j lut[q, j, codes_t[j, i]]         in float32, one add
//                                                        at a time, j ascending;
// and the kp smallest (d_i, i) pairs, ascending, ties to the lowest id.
// Rows with ok = 0 never enter the selection; when fewer than kp rows are
// valid the remaining slots are (INT_BIG = 2^30, -1) or (+inf, -1), never
// a duplicated id.
//
// Selection by 64-bit keys, (orderable distance bits << 32) | row id,
// through the shared `topk_select.cuh`: their order is the stable sort's,
// so the tie rule needs no extra code anywhere.
//
// Two launches per call.  Stage 1: a block takes QB queries and a chunk of
// rows, walks the chunk in tiles of 256 rows (one row a thread) and keeps,
// per query, a running top-kp in shared memory: a sorted state of SC >=
// kp keys, a buffer, and a threshold (the kp-th best key so far).  A key
// below the threshold is appended to the buffer (shared atomic counter);
// when a buffer could overflow in the next tile, all QB segments
// [state | buffer] are sorted by one bitonic network and the buffer is
// emptied.  After the first tiles the threshold admits few keys, so the
// sorts are rare and the scan dominates.  The chunk's top-kp keys go to a
// partial buffer (nq, G, kp).  Stage 2: one block per query runs the same
// selection over its G * kp partial keys and writes (dists, ids).
//
// What bounds them on the H100:
//   K4 at the main-path shape (32 queries, 1M rows, d = 128, kp = 160):
//   128 MB of codes + 5 MB of norms and flags, ~40 us at 3.35 TB/s; the
//   8.4 G int8 operations would take ~4 us on the tensor cores.  This
//   version computes on the CUDA cores with __dp4a (4 int8 products into
//   int32 per instruction, 1 G instructions), so the integer issue rate
//   and the shared-memory reads feeding it bound it before the bytes do.
//   Each block stages a 256-row x 128-byte slice of codes in shared memory
//   (coalesced global loads; 16-byte shared loads, a padded stride so they
//   are conflict-free) and each thread keeps 8 query accumulators, so a
//   staged word feeds 8 dp4a.  The codes are read once per group of 8
//   queries (4 times at 32 queries, mostly from L2, as the 4 query groups
//   of a chunk are neighbouring blocks).
//   K5 at the main-path shape (32 queries, 1M rows, m = 16, kp = 320):
//   16 MB of codes, ~5 us at 3.35 TB/s, and 512 M float adds, ~8 us at
//   67 TFLOP/s; but each add needs a look-up in the query's table, a
//   random shared-memory read with bank conflicts, so the shared-memory
//   read rate bounds it.  A block holds the tables of 4 queries (16 KB
//   each at m = 16) in shared memory; the codes stream coalesced along n.
// Both: d not a multiple of 4 (or codes not 4-byte aligned) is read with
// masked byte loads; nothing is padded or copied.  Tensor-core (wgmma)
// int8 products for K4, and a cheaper selection (per-warp queues instead
// of block-wide sorts), are later work.
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "topk_select.cuh"

namespace {

using topk::EMPTY;
using topk::FLOAT_INF_BITS;
using topk::order_float;
using topk::order_int;
using topk::pack_key;
using topk::state_len;
using topk::u64;
using topk::unorder;

constexpr int THREADS = 256;
constexpr int TILE = 256;          // rows (or partial keys) offered per step
constexpr int KC = 32;             // int8 path: words (4 codes) per staged slice
constexpr int KCS = KC + 4;        // slice row stride in words: 9 x 16 B (odd)
constexpr int SQ_QB = 8;           // queries per block, int8
constexpr int PQ_QB = 4;           // queries per block, PQ
constexpr int PQ_K = 256;          // centroids per subspace
constexpr int MAX_KP = 1024;
constexpr int MAX_D = 2048;
constexpr int INT_BIG = 1 << 30;

typedef topk::Select<THREADS> Select;

// Sorted segment per query: the state (state_len) and a buffer that
// holds at least two tiles of offers.
__host__ __device__ inline int sort_len(int kp) {
  return topk::pow2_at_least(state_len(kp) + 2 * TILE);
}

__host__ __device__ inline int words_padded(int d) {
  return ((d + 3) / 4 + KC - 1) / KC * KC;
}

size_t sq_smem(int kp, int d) {
  return Select::bytes(SQ_QB, sort_len(kp)) + (size_t)TILE * KCS * 4 +
         (size_t)SQ_QB * words_padded(d) * 4;
}

size_t pq_smem(int kp, int m) {
  return Select::bytes(PQ_QB, sort_len(kp)) + (size_t)PQ_QB * m * PQ_K * 4;
}

size_t merge_smem(int kp) { return Select::bytes(1, sort_len(kp)); }

__device__ __forceinline__ Select make_select(unsigned char* smem, int nseg,
                                              int kp, size_t tail_bytes) {
  return Select::at(smem, nseg, kp, sort_len(kp), tail_bytes);
}

// Word w (codes 4w .. 4w+3, little-endian) of a row of d int8 codes,
// zero past d.
__device__ __forceinline__ int pack4(const int8_t* row, int w, int d) {
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int k = 4 * w + b;
    if (k < d) v |= (unsigned)(unsigned char)row[k] << (8 * b);
  }
  return (int)v;
}

// Stage 1 of K4: grid (query groups, row chunks).
__global__ void __launch_bounds__(THREADS)
sq_scan_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ c8,
               const int* __restrict__ cn, const unsigned char* __restrict__ ok,
               u64* __restrict__ part, int nq, int n, int d, int kp,
               int chunk_rows, int G, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * SQ_QB;
  const int g = blockIdx.y;
  const int DW = (d + 3) / 4;
  const int DWP = words_padded(d);
  const int S = sort_len(kp);
  int* cs = reinterpret_cast<int*>(smem + (size_t)SQ_QB * S * 8);
  int* qs = cs + TILE * KCS;
  Select sel = make_select(smem, SQ_QB, kp,
                           (size_t)TILE * KCS * 4 + (size_t)SQ_QB * DWP * 4);
  sel.init(tid);
  for (int i = tid; i < SQ_QB * DWP; i += THREADS) {
    const int q = i / DWP, w = i - q * DWP;
    qs[i] = (q0 + q < nq && w < DW) ? pack4(q8 + (size_t)(q0 + q) * d, w, d)
                                    : 0;
  }
  __syncthreads();

  const int r_begin = g * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  for (int t0 = r_begin; t0 < r_end; t0 += TILE) {
    int acc[SQ_QB];
#pragma unroll
    for (int q = 0; q < SQ_QB; ++q) acc[q] = 0;
    for (int k0 = 0; k0 < DW; k0 += KC) {
      for (int i = tid; i < TILE * KC; i += THREADS) {
        const int rr = i / KC, w = i - rr * KC;
        const int r = t0 + rr, gw = k0 + w;
        int v = 0;
        if (r < r_end && gw < DW)
          v = aligned ? reinterpret_cast<const int*>(c8)[(size_t)r * DW + gw]
                      : pack4(c8 + (size_t)r * d, gw, d);
        cs[rr * KCS + w] = v;
      }
      __syncthreads();
      const int* crow = cs + tid * KCS;
#pragma unroll
      for (int w = 0; w < KC; w += 4) {
        const int4 c = *reinterpret_cast<const int4*>(crow + w);
#pragma unroll
        for (int q = 0; q < SQ_QB; ++q) {
          const int4 e = *reinterpret_cast<const int4*>(qs + q * DWP + k0 + w);
          acc[q] = __dp4a(c.x, e.x, acc[q]);
          acc[q] = __dp4a(c.y, e.y, acc[q]);
          acc[q] = __dp4a(c.z, e.z, acc[q]);
          acc[q] = __dp4a(c.w, e.w, acc[q]);
        }
      }
      __syncthreads();
    }
    const int r = t0 + tid;
    if (r < r_end && ok[r]) {
      const int norm = cn[r];
#pragma unroll
      for (int q = 0; q < SQ_QB; ++q) {
        const int dist = norm - 2 * acc[q];
        if (q0 + q < nq && dist < INT_BIG)
          sel.offer(q, pack_key(order_int(dist), r));
      }
    }
    sel.end_step(tid, TILE);
  }
  sel.flush(tid);
  for (int i = tid; i < SQ_QB * kp; i += THREADS) {
    const int q = i / kp, j = i - q * kp;
    if (q0 + q < nq)
      part[((size_t)(q0 + q) * G + g) * kp + j] = sel.keys[(size_t)q * S + j];
  }
}

// Stage 1 of K5: grid (query groups, row chunks).
__global__ void __launch_bounds__(THREADS)
pq_scan_kernel(const float* __restrict__ lut,
               const uint8_t* __restrict__ codes_t,
               const unsigned char* __restrict__ ok, u64* __restrict__ part,
               int nq, int n, int m, int kp, int chunk_rows, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * PQ_QB;
  const int g = blockIdx.y;
  const int S = sort_len(kp);
  const int T = m * PQ_K;                         // one query's table
  float* luts = reinterpret_cast<float*>(smem + (size_t)PQ_QB * S * 8);
  Select sel = make_select(smem, PQ_QB, kp, (size_t)PQ_QB * T * 4);
  sel.init(tid);
  for (int i = tid; i < PQ_QB * T; i += THREADS) {
    const int q = i / T;
    luts[i] = q0 + q < nq ? lut[(size_t)q0 * T + i] : 0.f;
  }
  __syncthreads();

  const int r_begin = g * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  for (int t0 = r_begin; t0 < r_end; t0 += TILE) {
    const int r = t0 + tid;
    if (r < r_end && ok[r]) {
      float acc[PQ_QB];
#pragma unroll
      for (int q = 0; q < PQ_QB; ++q) acc[q] = 0.f;
      for (int j = 0; j < m; ++j) {
        const int code = codes_t[(size_t)j * n + r];
#pragma unroll
        for (int q = 0; q < PQ_QB; ++q)
          acc[q] = __fadd_rn(acc[q], luts[q * T + j * PQ_K + code]);
      }
#pragma unroll
      for (int q = 0; q < PQ_QB; ++q)
        if (q0 + q < nq && acc[q] < __int_as_float(FLOAT_INF_BITS))
          sel.offer(q, pack_key(order_float(acc[q]), r));
    }
    sel.end_step(tid, TILE);
  }
  sel.flush(tid);
  for (int i = tid; i < PQ_QB * kp; i += THREADS) {
    const int q = i / kp, j = i - q * kp;
    if (q0 + q < nq)
      part[((size_t)(q0 + q) * G + g) * kp + j] = sel.keys[(size_t)q * S + j];
  }
}

// Stage 2 of both: one block per query selects the top kp of its G * kp
// partial keys and decodes them.
__global__ void __launch_bounds__(THREADS)
merge_kernel(const u64* __restrict__ part, unsigned* __restrict__ out_d,
             long long* __restrict__ out_i, int G, int kp, int is_float) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int q = blockIdx.x;
  Select sel = make_select(smem, 1, kp, 0);
  sel.init(tid);
  __syncthreads();
  const int total = G * kp;
  const u64* src = part + (size_t)q * total;
  for (int t0 = 0; t0 < total; t0 += TILE) {
    const int i = t0 + tid;
    if (i < total) sel.offer(0, src[i]);      // EMPTY is never below thr
    sel.end_step(tid, TILE);
  }
  sel.flush(tid);
  for (int j = tid; j < kp; j += THREADS) {
    const u64 top = sel.keys[j];
    const size_t o = (size_t)q * kp + j;
    if (top == EMPTY) {
      out_d[o] = is_float ? FLOAT_INF_BITS : (unsigned)INT_BIG;
      out_i[o] = -1;
    } else {
      out_d[o] = unorder((unsigned)(top >> 32), is_float);
      out_i[o] = (long long)(unsigned)(top & 0xffffffffu);
    }
  }
}

cudaError_t launch_merge(const u64* part, unsigned* out_d, long long* out_i,
                         int nq, int G, int kp, int is_float,
                         cudaStream_t stream) {
  merge_kernel<<<nq, THREADS, merge_smem(kp), stream>>>(part, out_d, out_i,
                                                        G, kp, is_float);
  return cudaGetLastError();
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool bad_plan(int nq, int n, int kp, int chunk_rows, int G) {
  return kp < 1 || kp > MAX_KP || kp > n || chunk_rows < TILE ||
         chunk_rows % TILE || (long long)chunk_rows * G < n ||
         (long long)chunk_rows * (G - 1) >= n || G > 65535 ||
         (long long)G * kp > (1LL << 31) - 1;
}

}  // namespace

// Shared memory (bytes) that stage 1 of K4 (pq = 0, width = d) or K5
// (pq = 1, width = m) needs at this kp; the wrapper refuses a call whose
// need exceeds the device's per-block limit.
extern "C" long long repro_adc_smem_bytes(int pq, int kp, int width) {
  return (long long)(pq ? pq_smem(kp, width) : sq_smem(kp, width));
}

// q8 (nq, d) int8, c8 (n, d) int8, cn (n,) int32, ok (n,) uint8 (0 = row
// masked), part (nq, G, kp) uint64 scratch, out_d (nq, kp) int32, out_i
// (nq, kp) int64; all contiguous on `device`.  Rows are split into G
// chunks of chunk_rows (a multiple of 256).  Launches both stages on
// `stream` and returns cudaGetLastError().
extern "C" int repro_sq_adc_topk(const int8_t* q8, const int8_t* c8,
                                 const int* cn, const unsigned char* ok,
                                 u64* part, unsigned* out_d, long long* out_i,
                                 int nq, int n, int d, int kp, int chunk_rows,
                                 int G, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq == 0) return cudaSuccess;
  if (bad_plan(nq, n, kp, chunk_rows, G) || d < 1 || d > MAX_D)
    return cudaErrorInvalidValue;
  const size_t smem = sq_smem(kp, d);
  err = set_smem(reinterpret_cast<const void*>(sq_scan_kernel), smem);
  if (err != cudaSuccess) return err;
  const int aligned = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(c8) % 4 == 0);
  const dim3 grid((nq + SQ_QB - 1) / SQ_QB, G);
  sq_scan_kernel<<<grid, THREADS, smem, stream>>>(q8, c8, cn, ok, part, nq, n,
                                                  d, kp, chunk_rows, G,
                                                  aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part, out_d, out_i, nq, G, kp, 0, stream);
}

// lut (nq, m, 256) float32, codes_t (m, n) uint8, ok (n,) uint8, part,
// out_d (nq, kp) float32, out_i (nq, kp) int64: as above.
extern "C" int repro_pq_adc_topk(const float* lut, const uint8_t* codes_t,
                                 const unsigned char* ok, u64* part,
                                 unsigned* out_d, long long* out_i, int nq,
                                 int n, int m, int kp, int chunk_rows, int G,
                                 int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq == 0) return cudaSuccess;
  if (bad_plan(nq, n, kp, chunk_rows, G) || m < 1)
    return cudaErrorInvalidValue;
  const size_t smem = pq_smem(kp, m);
  err = set_smem(reinterpret_cast<const void*>(pq_scan_kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + PQ_QB - 1) / PQ_QB, G);
  pq_scan_kernel<<<grid, THREADS, smem, stream>>>(lut, codes_t, ok, part, nq,
                                                  n, m, kp, chunk_rows, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part, out_d, out_i, nq, G, kp, 1, stream);
}
