// Layer-0 beam search of the batched HNSW graph filter.
//
// Replaces: src/repro/kernels/graph_expand/graph_expand.py :: expand_layer0
// (Pallas kernel _expand_kernel with _beam_insert).  For each query, the
// best-first beam search over layer 0 of the CSR graph, starting at the
// query's upper-layer descent endpoint.  One hop:
//   1. select the closest unexpanded beam entry (ties to the lowest slot);
//      stop if it is +inf or worse than the ef-th entry, or after
//      max_hops hops;
//   2. load its neighbour row neigh0[sel] (M0 ids, -1 padded);
//   3. score the M0 rows: sum((x - q)^2) in fp32;
//   4. a neighbour is fresh if its id is >= 0, its row is ok and its
//      visited bit is clear: all M0 bits are read before any is set, as
//      the XLA walk does (repro/graph/traverse.py beam_layer0), so a row
//      holding one id twice inserts it twice there and here;
//   5. merge the fresh neighbours into the beam in the order of a stable
//      ascending sort of [beam | neighbours], keep ef_cap entries and
//      invalidate the slots >= ef.
// hops and edges count the hops taken and the fresh neighbours scored,
// as beam_layer0 does for a non-oblivious walk.
//
// What bounds it on the H100: latency, not bandwidth.  A hop is a chain
// of dependent steps (beam argmin in shared memory, then the neighbour
// row from device memory, then the M0 row gathers and visited words,
// then the merge), a few microseconds each hop whatever the bytes.  At
// the main-path shape (32 queries, M0 = 16, d = 128) a hop gathers
// 16 * 516 B = 8.3 KB per query, so the bytes bound of a batch is a few
// microseconds against a hop chain of some hundred hops.
//
// What the design does about it: it is the simple, right version.  One
// block of 128 threads per query; queries are independent, so blocks run
// in any order and a finished query's block exits, where the XLA walk
// runs until the whole batch is done.  The loop over hops runs inside
// the block.  Shared memory holds the query, the beam (ids, distances,
// expanded flags; double-buffered for the merge), the neighbour row and
// its scores and fresh flags: a few KB.  The visited bitmap (R/32 words
// per query, 128 KB at R = 2^20) does not fit there; it lives in the
// global output, zeroed by the entry point, and each block owns its row
// (reads with ld.global.cg, sets with atomicOr, so no stale L1 line is
// ever read).  Each warp scores whole rows with 16-byte loads per lane
// and a shuffle sum; -1 padding and rows with ok = 0 are masked after
// the load, never by branching around it.  The merge is a rank merge:
// beam entry i moves to i + #{fresh m : d_m < bd_i}, fresh neighbour m
// to #{i : bd_i <= d_m} + #{m' : d_m' < d_m or (d_m' == d_m and m' < m)}.
// At 32 queries only 32 of the 132 SMs are busy; several queries per SM
// in flight, or a warp per query, is later work.
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool before(float v, int j, float bv, int bj) {
  return v < bv || (v == bv && j < bj);
}

__global__ void __launch_bounds__(THREADS)
expand_kernel(const int* __restrict__ neigh0,
              const unsigned char* __restrict__ ok,
              const float* __restrict__ C, const float* __restrict__ Q,
              const int* __restrict__ ep, const float* __restrict__ ep_d,
              int* __restrict__ beam_i, float* __restrict__ beam_d,
              unsigned* vis, int* __restrict__ hops_out,
              int* __restrict__ edges_out, int RW, int M0, int d, int ef,
              int ef_cap, int max_hops, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dpad = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem);
  float* bd = qs + dpad;                  // beam, two buffers each
  float* nbd = bd + ef_cap;
  int* bi = reinterpret_cast<int*>(nbd + ef_cap);
  int* nbi = bi + ef_cap;
  int* bx = nbi + ef_cap;                 // 1 = expanded or inert
  int* nbx = bx + ef_cap;
  int* nb = nbx + ef_cap;                 // neighbour row
  float* nd = reinterpret_cast<float*>(nb + M0);   // its scores
  int* fr = reinterpret_cast<int*>(nd + M0);       // its fresh flags
  float* red_v = reinterpret_cast<float*>(fr + M0);
  int* red_i = reinterpret_cast<int*>(red_v + WARPS);

  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float INF = __int_as_float(0x7f800000);
  unsigned* vrow = vis + (size_t)qi * RW;

  for (int k = tid; k < dpad; k += THREADS)
    qs[k] = k < d ? Q[(size_t)qi * d + k] : 0.f;
  const int e = ep[qi];
  const bool ep_ok = e >= 0;
  for (int s = tid; s < ef_cap; s += THREADS) {
    const bool first = s == 0 && ep_ok;
    bd[s] = first ? ep_d[qi] : INF;
    bi[s] = first ? e : -1;
    bx[s] = first ? 0 : 1;
  }
  if (tid == 0 && ep_ok) atomicOr(&vrow[e >> 5], 1u << (e & 31));
  __syncthreads();

  int hops = 0, edges = 0;                // kept by thread 0
  for (int t = 0; t < max_hops && ep_ok; ++t) {
    // 1. closest unexpanded entry, first slot among equals
    float bv = INF;
    int bj = 0x7fffffff;
    for (int s = tid; s < ef_cap; s += THREADS) {
      const float v = bx[s] ? INF : bd[s];
      if (before(v, s, bv, bj)) { bv = v; bj = s; }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oj = __shfl_xor_sync(FULL, bj, off);
      if (before(ov, oj, bv, bj)) { bv = ov; bj = oj; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bj; }
    __syncthreads();
    bv = red_v[0];
    bj = red_i[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      if (before(red_v[w], red_i[w], bv, bj)) { bv = red_v[w]; bj = red_i[w]; }
    if (isinf(bv) || bv > bd[ef - 1]) break;          // uniform in the block

    // 2. the neighbour row
    const int sel = bi[bj];
    const int src = sel >= 0 ? sel : 0;
    for (int m = tid; m < M0; m += THREADS)
      nb[m] = neigh0[(size_t)src * M0 + m];
    __syncthreads();

    // 3-4. fresh flags (visited words read before any bit is set) and the
    // scores of all M0 rows; both only depend on the ids, so their loads
    // are in flight together
    for (int m = tid; m < M0; m += THREADS) {
      const int id = nb[m];
      const int safe = id >= 0 ? id : 0;
      const unsigned word = __ldcg(&vrow[safe >> 5]);
      fr[m] = id >= 0 && ok[safe] && !((word >> (safe & 31)) & 1u);
    }
#pragma unroll 4
    for (int m = warp; m < M0; m += WARPS) {
      const int id = nb[m];
      const float* row = C + (size_t)(id >= 0 ? id : 0) * d;
      float acc = 0.f;
      if (vec4) {
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const float4* q4 = reinterpret_cast<const float4*>(qs);
        for (int k = lane; k < (d >> 2); k += 32) {
          const float4 x = __ldg(r4 + k);
          const float4 y = q4[k];
          const float a = x.x - y.x, b = x.y - y.y;
          const float c = x.z - y.z, g = x.w - y.w;
          acc = fmaf(a, a, acc);
          acc = fmaf(b, b, acc);
          acc = fmaf(c, c, acc);
          acc = fmaf(g, g, acc);
        }
      } else {
        for (int k = lane; k < d; k += 32) {
          const float a = __ldg(row + k) - qs[k];
          acc = fmaf(a, a, acc);
        }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc += __shfl_xor_sync(FULL, acc, off);
      if (lane == 0) nd[m] = acc;
    }
    __syncthreads();

    // 5. rank merge into the other buffer; every slot < ef_cap is written
    // exactly once, the slots >= ef as inert entries
    for (int s = tid; s < ef_cap; s += THREADS) {
      const float v = bd[s];
      int p = s;
      for (int m = 0; m < M0; ++m) p += fr[m] && nd[m] < v;
      if (p < ef) {
        nbd[p] = v;
        nbi[p] = bi[s];
        nbx[p] = bx[s] | (s == bj);
      } else if (p < ef_cap) {
        nbd[p] = INF;
        nbi[p] = -1;
        nbx[p] = 1;
      }
    }
    for (int m = tid; m < M0; m += THREADS) {
      if (!fr[m]) continue;
      const int id = nb[m];
      atomicOr(&vrow[id >> 5], 1u << (id & 31));
      const float v = nd[m];
      int p = 0;
      for (int s = 0; s < ef_cap; ++s) p += bd[s] <= v;
      for (int m2 = 0; m2 < M0; ++m2)
        p += fr[m2] && (nd[m2] < v || (nd[m2] == v && m2 < m));
      if (p < ef) {
        nbd[p] = v;
        nbi[p] = id;
        nbx[p] = 0;
      } else if (p < ef_cap) {
        nbd[p] = INF;
        nbi[p] = -1;
        nbx[p] = 1;
      }
    }
    if (tid == 0) {
      int n_fresh = 0;
      for (int m = 0; m < M0; ++m) n_fresh += fr[m];
      ++hops;
      edges += n_fresh;
    }
    __syncthreads();
    float* tf = bd; bd = nbd; nbd = tf;
    int* ti = bi; bi = nbi; nbi = ti;
    ti = bx; bx = nbx; nbx = ti;
  }

  for (int s = tid; s < ef_cap; s += THREADS) {
    beam_i[(size_t)qi * ef_cap + s] = bi[s];
    beam_d[(size_t)qi * ef_cap + s] = bd[s];
  }
  if (tid == 0) {
    hops_out[qi] = hops;
    edges_out[qi] = edges;
  }
}

size_t smem_bytes(int M0, int d, int ef_cap) {
  const size_t dpad = (d + 3) & ~3;
  return 4 * (dpad + 6 * (size_t)ef_cap + 3 * (size_t)M0 + 2 * WARPS);
}

}  // namespace

// neigh0 (R, M0) int32; ok (R,) bytes 0/1; C (R, d) float32; Q (nq, d)
// float32; ep (nq,) int32 (-1: empty graph); ep_d (nq,) float32.
// Outputs: beam_i (nq, ef_cap) int32, beam_d (nq, ef_cap) float32,
// vis (nq, ceil(R/32)) uint32 words (zeroed here), hops, edges (nq,)
// int32.  All contiguous on `device`; values finite; 1 <= ef <= ef_cap.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_graph_expand_layer0(
    const int* neigh0, const unsigned char* ok, const float* C,
    const float* Q, const int* ep, const float* ep_d, int* beam_i,
    float* beam_d, unsigned* vis, int* hops, int* edges, int nq, int R,
    int M0, int d, int ef, int ef_cap, int max_hops, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq == 0) return cudaSuccess;
  const int RW = (R + 31) / 32;
  err = cudaMemsetAsync(vis, 0, (size_t)nq * RW * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(M0, d, ef_cap);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(expand_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  expand_kernel<<<nq, THREADS, smem, stream>>>(
      neigh0, ok, C, Q, ep, ep_d, beam_i, beam_d, vis, hops, edges, RW, M0,
      d, ef, ef_cap, max_hops, vec4);
  return cudaGetLastError();
}
