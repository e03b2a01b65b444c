// The DCE tournament refine: batched DistanceComp (pairwise Z) tiles, and
// the fused refine (candidate gather + Z + win count + top-k by wins).
//
// Replaces: src/repro/kernels/dce_comp/dce_comp.py :: batched_z_matrix
// (Pallas tile kernel _z_tile_kernel_batched, line 131) and :: z_matrix
// (_z_tile_kernel, line 67), the same math for one candidate set, with
// their consumers src/repro/kernels/dce_comp/ops.py ::
// batched_top_k_by_wins and src/repro/serving/search_engine.py ::
// refine_candidates.  For each query b and candidates i, j of its set:
//     Z[b,i,j] = (C[b,i,0] o T_b) . C[b,j,2]  -  (C[b,i,1] o T_b) . C[b,j,3]
// over D = 2*d_pad + 16, in float32; Z[b,i,j] < 0 iff candidate i is
// closer to the query than j.  Two entries share one main loop:
//   repro_dce_batched_z — the "store Z" epilogue: Z (B, n, n) for
//       C (B, n, 4, D); z_matrix is its B = 1 case;
//   repro_dce_refine_topk — the fused refine: the rows of C_dce (N, 4, D)
//       are read through cand (B, n), and a win of i over j (Z < 0, j != i,
//       j valid) is counted in registers, so neither the gathered
//       candidates nor Z reach device memory; a second launch ranks each
//       query's slots by wins (descending, ties to the lowest slot, invalid
//       slots last with -1 wins) and writes cand[b, i], or -1 for an invalid
//       slot, at ranks below k.
//
// What bounds it on the H100: at the pq8 path's shape (B = 32 queries,
// n = 320 candidates, D = 272) the 2 * 2 * B * n^2 * D = 3.6 GFLOP of true
// fp32 FMA take 0.053 ms at 67 TFLOP/s, against 44.6 MB of rows, 0.013 ms:
// operations.  At n = 160 it is 0.013 ms (operations), at n = 80 the
// 11.1 MB of rows, 0.0036 ms (bytes).
//
// What the design does about it:
//   * a block owns one query b and TI = 16 RI rows i (RI = 1..5, chosen per
//     call so that B * ceil(n / TI) blocks fill the SMs once: RI = 5 at
//     n = 320, 3 at 160, 2 at 80) and walks every 80-column j-tile (the
//     paths' n = 80, 160, 320 are whole tiles), 16 deep a stage; the
//     stages stream through a 4-deep cp.async ring (16-byte copies, three
//     stages in flight: the rows come through cand from anywhere in
//     C_dce), and components 0 and 1 are scaled by T_b in shared memory
//     once landed (80-byte padded rows: conflict-free 16-byte reads);
//   * each of 256 threads keeps an RI x 5 tile of both products in fp32
//     registers, true fp32 FMA in ascending depth order, the two products
//     kept apart and subtracted once at the end: the arithmetic of the
//     reference's two products, so the Z entry and the win counts see the
//     same Z, bit for bit (DCE's exactness in f32 rests on true fp32 sums:
//     no TF32, no tensor cores, no concatenated 2D-deep product).  The two
//     products of a stage run one after the other, so only one product's
//     operands are in registers at a time.  What holds the loop back is
//     the shared-memory reads that feed it: 2 (RI + 5) floats a thread per
//     depth for 10 RI FMAs;
//   * a row's wins are summed over its 16 column threads by warp shuffles:
//     no atomics, deterministic; the ranking is one small block a query;
//   * the Z entry, where B x ceil(n / TI) blocks leave SMs idle (z_matrix
//     at n 512: 32 blocks on 132 SMs), also splits the j-tiles over a
//     third grid dimension (the wrapper's plan, `dce_comp.z_plan`: at
//     n 512, RI 2 and one j-tile a block, 112 blocks).  Every Z element
//     is still summed whole in one thread, so Z stays bit-equal to the
//     unsplit run; the refine epilogue counts a row's wins over all
//     columns and is never split.
// Ragged n and D, and candidate ids outside [0, N) (the slots a filter
// marks invalid), are read as zeros; nothing is padded or copied.
//
// 16-bit rows.  The reference casts C to float32 before its kernel
// computes; here C (or C_dce) may be float32, bfloat16 or float16 and is
// read in place (T is float32: the wrapper converts it, as it is small).
// 16-bit stages land by 8-byte cp.async (D % 4 == 0 and an 8-byte
// aligned C; else plain loads, as cp.async has no 2-byte size) in a
// staging ring of STAGES laid out as the float32 stages; once a stage has
// landed, each thread converts the chunks it copied itself to float32 and
// writes them, components 0 and 1 scaled by T_b, into one of two float32
// stages the FMA loop reads.  The fp32 stage of item `it` was last read
// at item it - 2, before the barrier of item it - 1, so the conversion
// needs no barrier of its own.  bf16 and f16 values are exact in float32,
// so C o T_b, Z and the win counts are bit-equal to the float32 kernel's
// on a float32 copy of the rows.  Shared memory: 2 float32 stages + 4
// 16-bit ones, the float32 kernel's 4 float32 stages.
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "row_elements.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUPS = 16;                      // row and column thread groups
constexpr int RJ = 5;                           // columns per thread, 16 apart
constexpr int TJ = GROUPS * RJ;                 // 80 columns per j-tile
constexpr int DK = 16;                          // depth per stage
constexpr int DKP = DK + 4;                     // padded row stride: 80 B
constexpr int STAGES = 4;                       // ring of stages in flight
constexpr int MAX_RI = 5;
constexpr int RANK_TILE = 1024;                 // wins staged per rank step

// The rows a (query, slot) pair reads: slot i of query b is row cand[b, i]
// of C_dce (refine) or row b * n + i of C (Z entry); rows outside
// [0, N) and slots past n read as zeros.  T: the rows' element type.
template <typename T>
struct Rows {
  const T* C;
  const long long* cand;     // nullptr: the Z entry's rows
  long long N;
  int n, D;
  bool vec;                  // whole-chunk copies: D % 4 == 0 and C
                             // aligned to a chunk (16 B; 8 B if 16-bit)

  __device__ const T* row(int b, int i) const {
    if (i >= n) return nullptr;
    const long long r = cand ? cand[(size_t)b * n + i] : (long long)b * n + i;
    if (r < 0 || r >= N) return nullptr;
    return C + (size_t)r * 4 * D;
  }

  // Component `comp` of a row from `row` (nullptr stays nullptr).
  __device__ const T* comp(const T* row, int c) const {
    return row ? row + (size_t)c * D : nullptr;
  }
};

__device__ __forceinline__ float4 scale4(float4 v, float4 t) {
  return make_float4(__fmul_rn(v.x, t.x), __fmul_rn(v.y, t.y),
                     __fmul_rn(v.z, t.z), __fmul_rn(v.w, t.w));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 8 : 0));
}

// Elements k .. k+3 of the D-vector at p into shared memory at dst, zero
// past D or if p is null.
__device__ __forceinline__ void copy4(float* dst, const float* p, int k,
                                      int D, bool vec, const float* any) {
  if (vec) {
    cp_async16(dst, p && k < D ? p + k : any, p && k < D);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cp_async4(dst + e, p && k + e < D ? p + k + e : any, p && k + e < D);
  }
}

// The same for 16-bit elements: one 8-byte cp.async, or plain loads (the
// staging slot is free: its last reader was this thread).
template <typename T>
__device__ __forceinline__ void copy4(T* dst, const T* p, int k, int D,
                                      bool vec, const T* any) {
  if (vec) {
    cp_async8(dst, p && k < D ? p + k : any, p && k < D);
  } else {
    unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
    const unsigned short* p16 = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) d16[e] = p && k + e < D ? p16[k + e] : 0;
  }
}

__host__ __device__ constexpr int stage_floats(int ri) {
  return (2 * GROUPS * ri + 2 * TJ) * DKP;
}

// The main loop of both entries.  Grid (ceil(n / TI), B, splits): block z
// walks the j-tiles [z per, (z + 1) per), per = ceil(j-tiles / splits)
// (splits = 1 for the refine).  Thread t: row group ig = t / 16 (rows
// ig * RI + r), column group jg = t % 16 (columns jg + 16 c of each
// j-tile).  Stages of DK depth (rows i of components 0
// and 1, rows j of components 2 and 3) stream through a ring of STAGES
// in shared memory by cp.async; a thread scales the component-0/1 chunks
// it copied itself by T_b once they have landed (16-bit rows: converts
// its chunks into a float32 stage, scaling those).  REFINE counts wins
// into `wins` (B, n); otherwise Z (B, n, n) is stored.
template <typename E, int RI, bool REFINE>
__global__ void __launch_bounds__(THREADS)
z_kernel(Rows<E> rows, const float* __restrict__ T,
         const unsigned char* __restrict__ valid, float* __restrict__ Z,
         int* __restrict__ wins) {
  constexpr bool WIDE = sizeof(E) == 4;           // float32 rows
  constexpr int CBUF = WIDE ? STAGES : 2;         // float32 stages
  constexpr int TI = GROUPS * RI;
  constexpr int P = DK / 4;                         // float4s of a row
  constexpr int LCHUNKS = TI * P * 2;               // float4s of L1, L2
  constexpr int RCHUNKS = TJ * P * 2;               // float4s of R3, R4
  constexpr int LPT = (LCHUNKS + THREADS - 1) / THREADS;
  constexpr int RPT = (RCHUNKS + THREADS - 1) / THREADS;
  // [CBUF][stage] float32, T_b, then (16-bit rows) [STAGES][stage] of E
  extern __shared__ __align__(16) float ring[];

  const int tid = threadIdx.x;
  const int ig = tid / GROUPS, jg = tid % GROUPS;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * TI;
  const int n = rows.n, D = rows.D;
  const float* Tb = T + (size_t)b * D;
  const int nk = (D + DK - 1) / DK;
  const int njt = (n + TJ - 1) / TJ;
  // the refine walks every j-tile (its grid has no third dimension)
  const int per = REFINE ? njt : (njt + gridDim.z - 1) / gridDim.z;
  const int jt0 = REFINE ? 0 : blockIdx.z * per;
  const int total = REFINE ? njt * nk : max(0, min(per, njt - jt0)) * nk;
  float* Ts = ring + CBUF * stage_floats(RI);      // T_b, zero past D
  E* stg = reinterpret_cast<E*>(Ts + nk * DK);      // 16-bit staging ring
  for (int k = tid; k < nk * DK; k += THREADS) Ts[k] = k < D ? Tb[k] : 0.f;
  __syncthreads();

  // L1 [TI][DKP], L2 [TI][DKP], R3 [TJ][DKP], R4 [TJ][DKP] of a stage;
  // a chunk is 4 elements of one row: c -> (component, row, k-part).
  // Offsets within a stage, the same in the float32 and staging stages:
  auto Lo = [&](int comp) { return comp * TI * DKP; };
  auto Ro = [&](int comp) { return 2 * TI * DKP + comp * TJ * DKP; };
  // the copies' destination (stage st of the ring they land in) and the
  // float32 stage the FMA loop reads for item `it`
  auto dst = [&](int st, int off) {
    if constexpr (WIDE) return ring + st * stage_floats(RI) + off;
    else return stg + st * stage_floats(RI) + off;
  };
  auto L = [&](int it, int comp) {
    return ring + (it % CBUF) * stage_floats(RI) + Lo(comp);
  };
  auto R = [&](int it, int comp) {
    return ring + (it % CBUF) * stage_floats(RI) + Ro(comp);
  };
  const E* lrow[LPT];                      // this thread's L rows (fixed)
#pragma unroll
  for (int u = 0; u < LPT; ++u) {
    const int c = tid + u * THREADS;
    lrow[u] = c < LCHUNKS ? rows.row(b, i0 + (c % (TI * P)) / P) : nullptr;
  }
  auto issue = [&](int item) {
    const int st = item % STAGES;
    const int j0 = (jt0 + item / nk) * TJ, k0 = (item % nk) * DK;
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int c = tid + u * THREADS;
      if (c < LCHUNKS) {
        const int comp = c / (TI * P), r = (c % (TI * P)) / P, part = c % P;
        copy4(dst(st, Lo(comp) + r * DKP + part * 4),
              rows.comp(lrow[u], comp), k0 + part * 4, D, rows.vec, rows.C);
      }
    }
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int c = tid + u * THREADS;
      if (c >= RCHUNKS) break;
      const int comp = c / (TJ * P), r = (c % (TJ * P)) / P, part = c % P;
      copy4(dst(st, Ro(comp) + r * DKP + part * 4),
            rows.comp(rows.row(b, j0 + r), 2 + comp), k0 + part * 4, D,
            rows.vec, rows.C);
    }
  };
  // After landing: the fused o T_b of this thread's L chunks; 16-bit rows
  // also convert this thread's chunks into the float32 stage.
  auto land = [&](int item) {
    const int st = item % STAGES, k0 = (item % nk) * DK;
    float* fs = ring + (item % CBUF) * stage_floats(RI);
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int c = tid + u * THREADS;
      if (c < LCHUNKS) {
        const int comp = c / (TI * P), r = (c % (TI * P)) / P, part = c % P;
        const int off = Lo(comp) + r * DKP + part * 4;
        float4* p = reinterpret_cast<float4*>(fs + off);
        float4 v;
        if constexpr (WIDE) {
          if (!lrow[u]) continue;
          v = *p;
        } else {
          v = elem::load4(stg + st * stage_floats(RI) + off);
        }
        if (lrow[u])
          v = scale4(v, *reinterpret_cast<const float4*>(Ts + k0 + part * 4));
        *p = v;
      }
    }
    if constexpr (!WIDE) {
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const int c = tid + u * THREADS;
        if (c >= RCHUNKS) break;
        const int comp = c / (TJ * P), r = (c % (TJ * P)) / P, part = c % P;
        const int off = Ro(comp) + r * DKP + part * 4;
        *reinterpret_cast<float4*>(fs + off) =
            elem::load4(stg + st * stage_floats(RI) + off);
      }
    }
  };

  float acc1[RI][RJ], acc2[RI][RJ];
  int won[RI];
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    won[r] = 0;
#pragma unroll
    for (int c = 0; c < RJ; ++c) acc1[r][c] = acc2[r][c] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    land(it);
    // stage `it` has landed and is scaled (and converted), and every
    // thread is done with stage it - 1, which the next copies overwrite
    __syncthreads();
    if (it + STAGES - 1 < total) issue(it + STAGES - 1);
    cp_async_commit();
    const float* L1 = L(it, 0);
    const float* L2 = L(it, 1);
    const float* R3 = R(it, 0);
    const float* R4 = R(it, 1);
    // the two products one after the other: half the operand registers
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float* Lp = p ? L2 : L1;
      const float* Rp = p ? R4 : R3;
#pragma unroll
      for (int kk = 0; kk < DK; kk += 4) {
        float a[4][RI], bb[4][RJ];                 // [depth][row]
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
          const float4 u = *reinterpret_cast<const float4*>(
              Rp + (jg + GROUPS * c) * DKP + kk);
          bb[0][c] = u.x, bb[1][c] = u.y, bb[2][c] = u.z, bb[3][c] = u.w;
        }
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          const float4 u = *reinterpret_cast<const float4*>(
              Lp + (ig * RI + r) * DKP + kk);
          a[0][r] = u.x, a[1][r] = u.y, a[2][r] = u.z, a[3][r] = u.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < RI; ++r)
#pragma unroll
            for (int c = 0; c < RJ; ++c) {
              if (p) acc2[r][c] = fmaf(a[e][r], bb[e][c], acc2[r][c]);
              else acc1[r][c] = fmaf(a[e][r], bb[e][c], acc1[r][c]);
            }
      }
    }
    if (it % nk == nk - 1) {                 // the j-tile's last stage
      const int j0 = (jt0 + it / nk) * TJ;
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int i = i0 + ig * RI + r;
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
          const int j = j0 + jg + GROUPS * c;
          const float z = acc1[r][c] - acc2[r][c];
          if constexpr (REFINE) {
            won[r] += z < 0.f && j < n && j != i &&
                      (!valid || valid[(size_t)b * n + j]);
          } else if (i < n && j < n) {
            Z[((size_t)b * n + i) * n + j] = z;
          }
          acc1[r][c] = acc2[r][c] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (REFINE) {
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      int w = won[r];
#pragma unroll
      for (int off = GROUPS / 2; off > 0; off >>= 1)   // the 16 column threads
        w += __shfl_xor_sync(0xffffffffu, w, off);
      const int i = i0 + ig * RI + r;
      if (jg == 0 && i < n)
        wins[(size_t)b * n + i] =
            (!valid || valid[(size_t)b * n + i]) ? w : -1;
    }
  }
}

// Stage 2 of the refine: one block per query.  Slot i's rank is
// #{j : w_j > w_i} + #{j < i : w_j == w_i}, the position a stable sort by
// descending wins gives it; ranks below k are written.
__global__ void __launch_bounds__(THREADS)
rank_kernel(const int* __restrict__ wins, const long long* __restrict__ cand,
            long long* __restrict__ out, int n, int k) {
  __shared__ int ws[RANK_TILE];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int* w = wins + (size_t)b * n;
  for (int i0 = 0; i0 < n; i0 += THREADS) {
    const int i = i0 + tid;
    const int wi = i < n ? w[i] : 0;
    int rank = 0;
    for (int j0 = 0; j0 < n; j0 += RANK_TILE) {
      const int m = min(RANK_TILE, n - j0);
      __syncthreads();
      for (int jj = tid; jj < m; jj += THREADS) ws[jj] = w[j0 + jj];
      __syncthreads();
      if (i < n)
        for (int jj = 0; jj < m; ++jj) {
          const int wj = ws[jj];
          rank += wj > wi || (wj == wi && j0 + jj < i);
        }
    }
    if (i < n && rank < k)
      out[(size_t)b * k + rank] = wi < 0 ? -1 : cand[(size_t)b * n + i];
  }
}

// RI for this batch: the smallest tile whose blocks fit the SMs once, the
// largest beyond that.
int rows_per_thread(int B, int n, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  for (int ri = 1; ri < MAX_RI; ++ri)
    if ((long long)B * ((n + GROUPS * ri - 1) / (GROUPS * ri)) <= sms)
      return ri;
  return MAX_RI;
}

// Shared memory of a block: the float32 stages, T_b, and for 16-bit rows
// the staging ring.
template <typename E>
size_t z_smem(int ri, int D) {
  const size_t stage = stage_floats(ri);
  const size_t tb = (size_t)(D + DK - 1) / DK * DK * 4;
  if (sizeof(E) == 4) return STAGES * stage * 4 + tb;
  return 2 * stage * 4 + tb + STAGES * stage * sizeof(E);
}

template <typename E, int RI, bool REFINE>
cudaError_t launch_ri(dim3 grid, const Rows<E>& rows, const float* T,
                      const unsigned char* valid, float* Z, int* wins,
                      cudaStream_t stream) {
  const size_t smem = z_smem<E>(RI, rows.D);
  const cudaError_t err = cudaFuncSetAttribute(
      z_kernel<E, RI, REFINE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  z_kernel<E, RI, REFINE><<<grid, THREADS, smem, stream>>>(rows, T, valid,
                                                            Z, wins);
  return cudaGetLastError();
}

template <typename E, bool REFINE>
cudaError_t launch_z(const Rows<E>& rows, const float* T,
                     const unsigned char* valid, float* Z, int* wins, int B,
                     int ri, int splits, cudaStream_t stream) {
  const int njt = (rows.n + TJ - 1) / TJ;
  const int per = (njt + splits - 1) / splits;
  const dim3 grid((rows.n + GROUPS * ri - 1) / (GROUPS * ri), B,
                  (njt + per - 1) / per);
  switch (ri) {
    case 1:
      return launch_ri<E, 1, REFINE>(grid, rows, T, valid, Z, wins, stream);
    case 2:
      return launch_ri<E, 2, REFINE>(grid, rows, T, valid, Z, wins, stream);
    case 3:
      return launch_ri<E, 3, REFINE>(grid, rows, T, valid, Z, wins, stream);
    case 4:
      return launch_ri<E, 4, REFINE>(grid, rows, T, valid, Z, wins, stream);
    default:
      return launch_ri<E, 5, REFINE>(grid, rows, T, valid, Z, wins, stream);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The rows at C (`N` of them; cand or nullptr) as element type E, with
// whole-chunk copies where D and C's alignment allow.
template <typename E>
Rows<E> make_rows(const void* C, const long long* cand, long long N, int n,
                  int D, const float* T) {
  const bool vec = D % 4 == 0 &&
                   (sizeof(E) == 4 ? aligned(C, 16) && aligned(T, 16)
                                   : aligned(C, 8));
  return Rows<E>{static_cast<const E*>(C), cand, N, n, D, vec};
}

template <typename E>
cudaError_t batched_z(const void* C, const float* T, float* Z, int B, int n,
                      int D, int ri, int splits, cudaStream_t stream) {
  return launch_z<E, false>(make_rows<E>(C, nullptr, (long long)B * n, n,
                                         D, T),
                            T, nullptr, Z, nullptr, B, ri, splits, stream);
}

template <typename E>
cudaError_t refine_wins(const void* C, long long N, const long long* cand,
                        const float* T, const unsigned char* valid,
                        int* wins, int B, int n, int D, int ri,
                        cudaStream_t stream) {
  return launch_z<E, true>(make_rows<E>(C, cand, N, n, D, T), T, valid,
                           nullptr, wins, B, ri, 1, stream);
}

}  // namespace

// C (B, n, 4, D) of element type `dtype` (0 float32, 1 bfloat16, 2
// float16), T (B, D) float32, Z (B, n, n) float32: contiguous, all on
// `device`.  B <= 65535 (one grid y-slice per query).  ri (1..5) rows a
// thread and the j-tiles cut into `splits` ranges: the wrapper's plan
// (`dce_comp.z_plan`).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int repro_dce_batched_z(const void* C, const float* T, float* Z,
                                   int B, int n, int D, int ri, int splits,
                                   int dtype, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || n == 0) return cudaSuccess;
  if (B > 65535 || D < 1 || ri < 1 || ri > MAX_RI || splits < 1 ||
      splits > (n + TJ - 1) / TJ || splits > 65535 || dtype < 0 ||
      dtype > 2)
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return batched_z<__nv_bfloat16>(C, T, Z, B, n, D, ri, splits, stream);
  if (dtype == 2)
    return batched_z<__half>(C, T, Z, B, n, D, ri, splits, stream);
  return batched_z<float>(C, T, Z, B, n, D, ri, splits, stream);
}

// C_dce (N, 4, D) of element type `dtype` (0 float32, 1 bfloat16, 2
// float16), cand (B, n) int64 row ids, T (B, D) float32,
// valid (B, n) uint8 or nullptr (all valid), wins (B, n) int32 scratch
// (the win counts, -1 for invalid slots, are left there), out (B, k)
// int64; all contiguous on `device`.  1 <= k <= n, B <= 65535.  Launches
// both stages on `stream` and returns cudaGetLastError().
extern "C" int repro_dce_refine_topk(const void* C_dce, long long N,
                                     const long long* cand, const float* T,
                                     const unsigned char* valid, int* wins,
                                     long long* out, int B, int n, int D,
                                     int k, int dtype, int device,
                                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (B > 65535 || D < 1 || k < 1 || k > n || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  const int ri = rows_per_thread(B, n, device);
  if (dtype == 1)
    err = refine_wins<__nv_bfloat16>(C_dce, N, cand, T, valid, wins, B, n,
                                     D, ri, stream);
  else if (dtype == 2)
    err = refine_wins<__half>(C_dce, N, cand, T, valid, wins, B, n, D, ri,
                              stream);
  else
    err = refine_wins<float>(C_dce, N, cand, T, valid, wins, B, n, D, ri,
                             stream);
  if (err != cudaSuccess) return err;
  rank_kernel<<<B, THREADS, 0, stream>>>(wins, cand, out, n, k);
  return cudaGetLastError();
}
