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
// rows, walks the chunk in tiles and keeps, per
// query, a running top-kp in shared memory: a sorted state, a buffer of
// 256 keys and a threshold (the kp-th best key so far).  Each thread
// compares its keys with their queries' thresholds in registers and puts
// only the keys below them into the buffers; a key that finds its buffer
// full stays with its thread until a warp has merged that buffer into its
// state (Select::merge_buffers: the buffer sorted in registers, one
// bitonic merge), then it is offered again.  The chunk's top-kp keys go to
// a partial buffer (nq, G, kp).  Stage 2: one block per query merges its
// G sorted partial lists in runs of 8 keys a list, stopping after a round
// that brings nothing below its kp-th best (Select::merge_runs).
//
// The chunks are the wrapper's block plan (`common.block_plan`): over
// slots = SMs x the blocks of the launched variant that one SM holds
// (repro_adc_blocks_per_sm: 1 on the H100 for K4 at kp 160 and K5 at m
// 16, kp 320, where shared memory takes one; K4's TMA route likewise),
// G chunks cost ceil(groups G / slots) waves of
// ceil(tiles / G) + c tile-times, the least cost wins, ties to the
// smaller G.  c, a chunk's fixed cost (its first tiles, whose keys are
// nearly all offered, the ring's fill, one more list to merge), measured
// on the H100 at nq 1024, n 1M: K4 (kp 160, 256-row tiles, TMA route) 74
// tile-times, the least-squares fit of 20 plans (1.39 us a tile; 30 at
// 3.18 us on the staging route); K5 (m 16, kp 320, 1024-row tiles) 11,
// the time each further wave adds at 128 query groups (0.075 ms) over the
// tile time of one chunk a group (6.9 us); scripts/scan_plans.py times
// the plans and fits c.  K4 at nq 1024 takes one wave of 32 x 4 blocks
// (2.34 ms on the TMA route; 3.72 on the staging route, 5.96 there in
// two waves of 32 x 5).
//
// What bounds them on the H100, and what the design does about it:
//   K4 at the main-path shape (32 queries, 1M rows, d = 128, kp = 160):
//   128 MB of codes + 5 MB of norms and flags, ~40 us at 3.35 TB/s; its
//   8.4 G int8 operations take ~4 us at the 1979 TOPS of the tensor cores.
//   So it is bound by bytes once each code byte is read once:
//     * one block takes 32 queries (16 where kp > 256 needs the shared
//       memory), the whole default batch, so the codes leave device
//       memory once per call;
//     * int8 x int8 -> int32 is exact in any order, so the products run
//       on the tensor cores: mma.sync m16n8k32 s8, queries as A and rows
//       as B (ldmatrix x4 both), int32 accumulators in registers; 16
//       warps a block, a warp owns 16 rows x all the block's queries of
//       a 256-row tile, so the 4 lanes that share a query put its keys
//       with one atomic;
//     * rows and queries are staged in 64-byte depth slices by a 4-stage
//       cp.async ring (3 where kp > 512 needs the shared memory; 16-byte
//       copies, zero-filled past d, past the chunk
//       and past nq, and zero codes add exactly 0), rows 80 bytes apart so
//       the ldmatrix row reads are conflict-free; a d that is not a
//       multiple of 16, or misaligned codes, take masked byte loads;
//     * the epilogue forms cn - 2 cross from the accumulator fragments;
//       the norms and flags of a tile's rows are loaded a tile ahead.
//   K5 at the main-path shape (32 queries, 1M rows, m = 16, kp = 320):
//   16 MB of codes (~5 us) and 512 M float adds (~8 us at 67 TFLOP/s),
//   but every add needs a table entry from shared memory: 2 GB of reads a
//   call, 69 us at the SMs' 128 bytes a cycle, more where random codes
//   meet in a bank.  So the shared-memory read rate bounds it:
//     * a block holds the tables of QB queries (8 at m = 16: 128 KB; 4,
//       2 or 1 where a wider m needs the room), interleaved across the
//       queries as [j][code][QB], so one 16-byte load brings 4 queries'
//       entries for a code; at QB = 8 two lanes share a row and read the
//       two halves of its 32-byte entry, so the 8 lanes of a load phase
//       meet 4 random entries (about 2 passes of shared memory a phase,
//       against 2.5 for 8 random 16-byte entries);
//     * a lane takes 4 (8 at QB = 8) consecutive rows and reads each
//       subspace's codes as 32-bit loads from codes_t (m, n), prefetched
//       a group of 4 subspaces ahead, across tiles; each query's sum runs
//       over j in ascending order, one __fadd_rn at a time, as the plain
//       version's.
// Both select as above.  After the first tiles the thresholds admit few
// keys; a full buffer costs one warp a sort of 256 keys and a merge of the
// state.  The lanes that share a query put their keys with one shared
// atomic (offsets from ballots).  A flush merges the full buffers and, on
// the warps that would idle, the fullest others, and a buffer that a
// pass leaves exactly full is merged at once, so the queries' flushes
// fall together.  What still holds them back: the warp merges (a bitonic
// network of dependent shuffles) and the passes around them take longer
// than the scan itself, and K5's look-ups meet in shared-memory banks.
// A kp above MAX_KP runs in passes of at most MAX_KP (the wrapper's): each
// pass scans again and offers only the keys after its query's floor key,
// the last key of the pass before (left by the pass's merge), so the
// passes' lists joined are the first kp keys, bit for bit; one comparison
// an offer, in kernel variants of their own.
//
// K4's TMA route (sq_tma_scan_kernel), taken wherever the rows span more
// than one tile, the codes allow a tensor map (d % 16 == 0, 16-byte
// aligned codes) and its ring fits beside the selection; the byte-staging
// kernel above (sq_scan_kernel) keeps the other shapes.  At the int8
// cell's shape (1024 queries, 1M rows, d 128, kp 160) the staging kernel
// ran its tensor cores under 5% of the time: a tile took 12 ldmatrix a
// warp (8 of them reloading the same queries), three block barriers and a
// copy of the queries with every slice, and each code byte left L2 32
// times, once a query group.  So:
//   * the block's query A fragments are loaded once, at its start, into
//     registers where MT x slices x 16 registers <= 32 (d <= 128 at 32
//     queries, d <= 256 at 16), else into shared memory, swizzled as the
//     ring; the ring carries code rows only;
//   * code tiles arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle:
//     conflict-free ldmatrix) in 128-byte depth slices of 256 rows into a
//     ring of 2-4 stages, each guarded by a full mbarrier (the copy's
//     bytes) and an empty one (every warp, once it has read the stage).
//     Lane 0 of warp 0 issues the copies: the selection's block barriers
//     (topk_select.cuh) count every thread, so no warp may run a loop of
//     its own.  The selection's barrier is the only block-wide one a tile;
//   * the epilogue tests a lane's least distance of each query against
//     the query's threshold distance (held in a register, refreshed after
//     each merge); only a warp with a row below it finds its keys, and it
//     puts each group of queries that has one.  A distance equal to the
//     threshold's needs no key: until the tile's first merge the state
//     holds earlier (lower) rows only, so such a key is never below its
//     threshold; after a merge it gets the 64-bit test.  The keys offered
//     are the staging kernel's.
// On the H100 at that shape the scan with every row masked fell from 2.85
// to 1.26 ms and the call from 3.80 to 2.34 ms.  Each code byte still
// leaves L2 once a query group (4.1 GB a call), which does not bound the
// scan: clusters of 2 blocks that shared each tile by TMA multicast, half
// the L2 reads, ran 1.4-3.4% slower, clusters of 4 2x slower, each block
// held to its partners' pace.  What holds it now: the instructions around
// the mma.sync products (a tile's 256 mma are a quarter of its issue
// slots) and the offers, whose puts and the block barrier after them take
// as long as the scan.
#include <cuda.h>               // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <cstring>

#include "topk_select.cuh"

namespace {

using topk::EMPTY;
using topk::FLOAT_INF_BITS;
using topk::order_float;
using topk::order_int;
using topk::pack_key;
using topk::u64;
using topk::unorder;

constexpr int THREADS = 256;            // K5 and the merge
constexpr int SQ_THREADS = 512;         // K4: 16 warps
constexpr int MAX_KP = 1024;
constexpr int MAX_D = 2048;
constexpr int INT_BIG = 1 << 30;
constexpr int BUF_E = 8;                // buffer: 32 * BUF_E keys a query
constexpr int BUFFER = 32 * BUF_E;

// K4: rows of a tile (16 a warp: two n8 tiles), depth bytes a staged
// slice (two k32 steps), slice row stride, ring stages.
constexpr int SQ_WARPS = SQ_THREADS / 32;
constexpr int SQ_ROWS = 16 * SQ_WARPS;
constexpr int SQ_KS = 64;
constexpr int SQ_STRIDE = SQ_KS + 16;
constexpr int SQ_DEEP = 4;              // ring stages while kp <= 512
constexpr int SQ_SHALLOW = 3;           // where kp > 512 needs the room

// K4's TMA route: depth bytes a stage (one 128-byte swizzle row), a
// stage's bytes (a tile's rows), the swizzle's alignment, query A
// fragments a lane holds in registers at most.
constexpr int SQ_SLICE = 128;
constexpr int SQ_STAGE = SQ_ROWS * SQ_SLICE;
constexpr int SQ_ALIGN = 1024;
constexpr int SQ_QREGS = 32;
// A masked row's norm on the TMA route: |2 q . c| < 2^27 at d <= 2048, so
// its distance stays above every cap and below 2^31.
constexpr int SQ_MASKED_NORM = INT_BIG + (1 << 27);

// K5: centroids a subspace, rows of a tile (4 or 8 consecutive a lane).
constexpr int PQ_K = 256;
constexpr int PQ_ROWS = 4 * THREADS;

typedef topk::Select<THREADS> Select;
typedef topk::Select<SQ_THREADS> SqSelect;

// A query's state: at least the buffer's length (merge_segment needs it).
__host__ __device__ inline int scan_state_len(int kp) {
  const int sc = topk::state_len(kp);
  return sc > BUFFER ? sc : BUFFER;
}

__host__ __device__ inline int scan_seg_len(int kp) {
  return scan_state_len(kp) + BUFFER;
}

__host__ __device__ inline int sq_queries_per_block(int kp) {
  return kp <= 256 ? 32 : 16;
}

__host__ __device__ inline size_t sq_stage_bytes(int qb) {
  return (size_t)(SQ_ROWS + qb) * SQ_STRIDE;
}

__host__ __device__ inline int sq_stages(int kp) {
  return kp <= 512 ? SQ_DEEP : SQ_SHALLOW;
}

size_t sq_smem(int qb, int kp) {
  return SqSelect::bytes(qb, scan_seg_len(kp)) +
         sq_stages(kp) * sq_stage_bytes(qb);
}

__host__ __device__ inline int sq_slices(int d) {
  return (d + SQ_SLICE - 1) / SQ_SLICE;
}

// The TMA route's query A fragments in registers: 16 a lane per 16
// queries and 128-byte slice.
__host__ __device__ inline bool sq_queries_in_registers(int qb, int d) {
  return (qb / 16) * sq_slices(d) * 16 <= SQ_QREGS;
}

// The TMA route's shared memory after the selection's keys: the slack that
// aligns the ring to the swizzle's 1024 bytes, the ring, the queries (where
// they are not in registers), a full and an empty barrier a stage.
__host__ __device__ inline size_t sq_tma_tail(int qb, int d, int qreg,
                                              int stages) {
  return SQ_ALIGN + (size_t)stages * SQ_STAGE +
         (qreg ? 0 : (size_t)qb * sq_slices(d) * SQ_SLICE) + 16 * stages;
}

size_t sq_tma_smem(int qb, int kp, int d, int qreg, int stages) {
  return SqSelect::bytes(qb, scan_seg_len(kp)) +
         sq_tma_tail(qb, d, qreg, stages);
}

size_t pq_smem(int qb, int kp, int m) {
  return Select::bytes(qb, scan_seg_len(kp)) + (size_t)qb * m * PQ_K * 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16 x 32 int8, row-major) * b (32 x 8 int8, column-major), int32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b, as mma_s8 from zero sums.
__device__ __forceinline__ void mma_s8_first(int (&c)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// Bytes k .. k+3 of a row of d int8 codes (little-endian), zero past d.
__device__ __forceinline__ unsigned pack4(const int8_t* row, int k, int d) {
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (k + b < d) v |= (unsigned)(unsigned char)row[k + b] << (8 * b);
  return v;
}

// Copy `count` rows of depth slice [k0, k0 + SQ_KS) of a (.., d) int8
// matrix, rows `first` .. first + count - 1 (zero past `end` and past d),
// into shared rows SQ_STRIDE bytes apart.  vec: 16-byte cp.async, else
// synchronous masked byte loads, 4 bytes a store.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const int8_t* src, int first,
                                           int count, int end, int d, int k0,
                                           bool vec, int tid) {
  if (vec) {
    for (int c = tid; c < count * (SQ_KS / 16); c += SQ_THREADS) {
      const int row = c / (SQ_KS / 16), k = k0 + (c % (SQ_KS / 16)) * 16;
      const bool in = first + row < end && k < d;
      cp_async16(dst + row * SQ_STRIDE + (k - k0),
                 in ? src + (size_t)(first + row) * d + k : src, in);
    }
  } else {
    for (int c = tid; c < count * (SQ_KS / 4); c += SQ_THREADS) {
      const int row = c / (SQ_KS / 4), k = k0 + (c % (SQ_KS / 4)) * 4;
      const unsigned v = first + row < end
          ? pack4(src + (size_t)(first + row) * d, k, d) : 0u;
      *reinterpret_cast<unsigned*>(dst + row * SQ_STRIDE + (k - k0)) = v;
    }
  }
}

// Stage 1 of K4: grid (query groups, row chunks); QB = 16 MT queries, a
// ring of STAGES slices.  Queries are the mma's A operand and rows its B:
//   warp w, lane l (g = l / 4, t = l % 4): queries 16 mt + 8 h + g and rows
//   16 w + 8 nt + 2 t + u of every tile, in acc[mt][nt][2 h + u];
// so the 4 lanes of a group g share a query, and put one group of keys.
// FLOOR: a later pass, which offers only the keys after floor[q].
template <int MT, int STAGES, bool FLOOR>
__global__ void __launch_bounds__(SQ_THREADS, 1)
sq_scan_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ c8,
               const int* __restrict__ cn, const unsigned char* __restrict__ ok,
               u64* __restrict__ part, const u64* __restrict__ floor, int nq,
               int n, int d, int kp, int chunk_rows, int G, int vec) {
  constexpr int QB = 16 * MT;
  constexpr int RPW = SQ_ROWS / SQ_WARPS;      // rows a warp: 16
  constexpr int NT = RPW / 8;                  // row tiles of 8 a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * QB;
  const int SC = scan_state_len(kp), S = SC + BUFFER;
  unsigned char* ring = smem + (size_t)QB * S * 8;
  SqSelect sel = SqSelect::at(smem, QB, kp, S, STAGES * sq_stage_bytes(QB),
                              SC);
  sel.init(tid);
  u64 lo[2 * MT];                   // floor keys of queries 8 gq + g
#pragma unroll
  for (int gq = 0; gq < 2 * MT; ++gq)
    lo[gq] = FLOOR && q0 + 8 * gq + g < nq ? floor[q0 + 8 * gq + g] : 0;

  const int r_begin = blockIdx.y * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const int nk = (d + SQ_KS - 1) / SQ_KS;
  const int total = (r_end - r_begin + SQ_ROWS - 1) / SQ_ROWS * nk;
  auto load = [&](int s) {                 // slice s of the chunk's walk
    unsigned char* xs = ring + (s % STAGES) * sq_stage_bytes(QB);
    const int k0 = (s % nk) * SQ_KS;
    stage_rows(xs, c8, r_begin + (s / nk) * SQ_ROWS, SQ_ROWS, r_end, d, k0,
               vec, tid);
    stage_rows(xs + SQ_ROWS * SQ_STRIDE, q8, q0, QB, nq, d, k0, vec, tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;
  // cn and ok of the lane's rows 8 nt + 2 t + u ([2 nt + u]) of this tile,
  // and of the next, loaded a tile ahead (zero past the chunk)
  int norm[2 * NT], norm_next[2 * NT];
  unsigned char okr[2 * NT], ok_next[2 * NT];
  auto load_rows = [&](int tile0, int (&nrm)[2 * NT],
                       unsigned char (&okv)[2 * NT]) {
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      const int r = tile0 + warp * RPW + 2 * t + (i >> 1) * 8 + (i & 1);
      nrm[i] = r < r_end ? cn[r] : 0;
      okv[i] = r < r_end ? ok[r] : 0;
    }
  };
  load_rows(r_begin, norm, okr);

  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    // slice `it` has landed for every thread, and every thread is done
    // with slice it - 1, whose stage the next copies overwrite
    __syncthreads();
    if (it + STAGES - 1 < total) load(it + STAGES - 1);
    cp_async_commit();
    const int tile0 = r_begin + (it / nk) * SQ_ROWS;
    const int row0 = tile0 + warp * RPW + 2 * t;      // + 8 nt + u
    if (it % nk == 0) load_rows(tile0 + SQ_ROWS, norm_next, ok_next);
    const unsigned char* xs = ring + (it % STAGES) * sq_stage_bytes(QB);
    const unsigned char* qs = xs + SQ_ROWS * SQ_STRIDE;
#pragma unroll
    for (int kk = 0; kk < SQ_KS; kk += 32) {
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], qs + (mt * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * SQ_STRIDE +
                               kk + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, xs + (warp * RPW + np * 16 + (lane & 7) +
                             (lane >> 4) * 8) * SQ_STRIDE +
                           kk + ((lane >> 3) & 1) * 16);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    if (it % nk != nk - 1) continue;

    // the tile's last slice: distances, then offers until every key below
    // its threshold is placed.  Bit 8 (2 mt + h) + (2 nt + u) of `pend`:
    // query 16 mt + 8 h + g, row 8 nt + 2 t + u.  Every thread reaches
    // each barrier.
    static_assert(2 * MT * 2 * NT <= 32, "one pending bit per key");
    unsigned pend = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 2 * nt + (c & 1), gq = 2 * mt + (c >> 1);
          const int dist = norm[i] - 2 * acc[mt][nt][c];
          acc[mt][nt][c] = dist;
          if (okr[i] && q0 + 8 * gq + g < nq && dist < INT_BIG &&
              (!FLOOR || pack_key(order_int(dist), row0 + nt * 8 + (c & 1))
                             > lo[gq]))
            pend |= 1u << (8 * gq + i);
        }
    auto key_of = [&](int gq, int i) {
      return pack_key(order_int(acc[gq >> 1][i >> 1][2 * (gq & 1) + (i & 1)]),
                      row0 + (i >> 1) * 8 + (i & 1));
    };
    while (true) {
      // keys at or above their thresholds drop out; the puts run only
      // where a lane of the warp has a key left
#pragma unroll
      for (int gq = 0; gq < 2 * MT; ++gq) {
        const u64 thr = sel.thr[8 * gq + g];
#pragma unroll
        for (int i = 0; i < 2 * NT; ++i)
          if (key_of(gq, i) >= thr) pend &= ~(1u << (8 * gq + i));
      }
      if (__any_sync(0xffffffffu, pend != 0)) {
        int q[2 * MT];
        unsigned mask[2 * MT];
#pragma unroll
        for (int gq = 0; gq < 2 * MT; ++gq) {
          q[gq] = 8 * gq + g;
          mask[gq] = (pend >> (8 * gq)) & 0xffu;
        }
        sel.template put_groups<2 * MT, 2 * NT>(q, mask, lane,
                                                0xfu << (lane & ~3), key_of);
        pend = 0;
#pragma unroll
        for (int gq = 0; gq < 2 * MT; ++gq) pend |= mask[gq] << (8 * gq);
      }
      // also merge a buffer that a pass left exactly full, so the next
      // tile meets the lower threshold
      if (!__syncthreads_or(pend != 0 || sel.full(tid))) break;
      sel.template merge_buffers<BUF_E>(tid, false);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      norm[i] = norm_next[i];
      okr[i] = ok_next[i];
    }
  }
  cp_async_wait<0>();
  sel.template merge_buffers<BUF_E>(tid, true);
  for (int i = tid; i < QB * kp; i += SQ_THREADS) {
    const int q = i / kp, j = i - q * kp;
    if (q0 + q < nq)
      part[((size_t)(q0 + q) * G + blockIdx.y) * kp + j] =
          sel.keys[(size_t)q * S + j];
  }
}

// --- K4's TMA route -------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The box of `map` at (byte c0, row c1) into shared address dst, its bytes
// counted on the barrier at `bar`.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(bar)
      : "memory");
}

// Byte `byte` (a multiple of 16) of row `row` of a region of 128-byte rows
// laid out by the 128-byte swizzle: 16-byte chunk c of row r at chunk
// c ^ (r % 8).  The 8 rows of an ldmatrix phase meet 8 distinct chunks.
__device__ __forceinline__ int swz(int row, int byte) {
  return row * SQ_SLICE + ((((byte >> 4) ^ row) & 7) << 4);
}

// Stage 1 of K4 on the TMA route: grid (query groups, row chunks).  QB =
// 16 MT queries; their A fragments
// in registers over NKR slices (1 or 2), or in shared memory (NKR = 0).
// Warp w, lane l (g = l / 4, t = l % 4) as sq_scan_kernel: queries 16 mt
// + 8 h + g and rows 16 w + 8 nt + 2 t + u of every tile, in
// acc[mt][nt][2 h + u].  Slice s of the walk (tile s / nk, depth bytes
// 128 (s % nk) ..) goes to stage s % stages.
// FLOOR: a later pass, which offers only the keys after floor[q].
template <int MT, int NKR, bool FLOOR>
__global__ void __launch_bounds__(SQ_THREADS, 1)
sq_tma_scan_kernel(const __grid_constant__ CUtensorMap codes,
                   const int8_t* __restrict__ q8, const int* __restrict__ cn,
                   const unsigned char* __restrict__ ok,
                   u64* __restrict__ part, const u64* __restrict__ floor,
                   int nq, int n, int d, int kp, int chunk_rows, int G,
                   int stages) {
  constexpr int QB = 16 * MT;
  constexpr int RPW = SQ_ROWS / SQ_WARPS;      // rows a warp: 16
  constexpr int NT = RPW / 8;                  // row tiles of 8 a warp
  constexpr int KR = NKR > 0 ? NKR : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * QB;
  const int SC = scan_state_len(kp), S = SC + BUFFER;
  const int nk = sq_slices(d);
  SqSelect sel = SqSelect::at(smem, QB, kp, S,
                              sq_tma_tail(QB, d, NKR > 0, stages), SC);
  const unsigned base = smem_u32(smem);
  const unsigned ring_s =
      (base + (unsigned)QB * S * 8 + SQ_ALIGN - 1) & ~(unsigned)(SQ_ALIGN - 1);
  unsigned char* ring = smem + (ring_s - base);
  unsigned char* qs = ring + (size_t)stages * SQ_STAGE;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (stages + s)
  const unsigned bars =
      ring_s + stages * SQ_STAGE + (NKR > 0 ? 0 : QB * nk * SQ_SLICE);
  sel.init(tid);
  u64 lo[2 * MT];                   // floor keys of queries 8 gq + g
#pragma unroll
  for (int gq = 0; gq < 2 * MT; ++gq)
    lo[gq] = FLOOR && q0 + 8 * gq + g < nq ? floor[q0 + 8 * gq + g] : 0;

  // The queries, once: A fragment register r of (mt, slice j, k-step ks)
  // holds query 16 mt + g + 8 (r & 1), bytes 128 j + 32 ks + 16 (r >> 1) +
  // 4 t .. + 3 (zero past d and nq); or rows QB of 128-byte slices in
  // shared memory, swizzled as the ring.
  unsigned qa[MT][KR][4][4];
  // 4-byte words where q8 allows (d % 16 == 0 on this route)
  const bool words = (reinterpret_cast<uintptr_t>(q8) & 3) == 0;
  auto q4 = [&](const int8_t* row, int k) {
    return words ? (k < d ? *reinterpret_cast<const unsigned*>(row + k) : 0u)
                 : pack4(row, k, d);
  };
  if constexpr (NKR > 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < KR; ++j)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = q0 + 16 * mt + g + 8 * (r & 1);
            qa[mt][j][ks][r] =
                row < nq ? q4(q8 + (size_t)row * d,
                              SQ_SLICE * j + 32 * ks + 16 * (r >> 1) + 4 * t)
                         : 0u;
          }
  } else {
    for (int c = tid; c < nk * QB * 8; c += SQ_THREADS) {
      const int j = c / (QB * 8), r = (c / 8) % QB, b = 16 * (c % 8);
      const int k = SQ_SLICE * j + b;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < nq) {
        const int8_t* row = q8 + (size_t)(q0 + r) * d;
        v = make_uint4(q4(row, k), q4(row, k + 4), q4(row, k + 8),
                       q4(row, k + 12));
      }
      *reinterpret_cast<uint4*>(qs + j * QB * SQ_SLICE + swz(r, b)) = v;
    }
  }
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<unsigned long long>(&codes))
                 : "memory");
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (stages + s), SQ_WARPS);
    }
    // the barriers are set before the copies' completions reach them
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int r_begin = blockIdx.y * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const int total = (r_end - r_begin + SQ_ROWS - 1) / SQ_ROWS * nk;
  // the producer's next slice: its stage, depth byte and first row
  int p_st = 0, p_k = 0, p_row = r_begin;
  auto issue = [&]() {
    mbar_expect_tx(bars + 8 * p_st, SQ_STAGE);
    tma_load(ring_s + p_st * SQ_STAGE, &codes, p_k, p_row, bars + 8 * p_st);
    if (++p_st == stages) p_st = 0;
    p_k += SQ_SLICE;
    if (p_k >= d) {
      p_k = 0;
      p_row += SQ_ROWS;
    }
  };
  if (tid == 0)
    for (int s = 0; s < stages && s < total; ++s) issue();

  int acc[MT][NT][4];              // a tile's first product sets them
  // cn and ok of the lane's rows 8 nt + 2 t + u ([2 nt + u]) of a tile
  // (zero past the chunk), loaded once the tile before is offered: the
  // tile's copies and products cover their latency, and no second set of
  // registers holds them
  int norm[2 * NT];
  unsigned char okr[2 * NT];
  auto load_rows = [&](int tile0) {
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      const int r = tile0 + warp * RPW + 2 * t + (i >> 1) * 8 + (i & 1);
      norm[i] = r < r_end ? cn[r] : 0;
      okr[i] = r < r_end ? ok[r] : 0;
    }
  };
  load_rows(r_begin);
  // cap[gq]: the distance of query 8 gq + g's threshold key, or the
  // sentinel if less.  A key below the threshold has a distance below the
  // cap or, equal to it, a row below the threshold key's.  Until a tile's
  // first merge every key in the state is of an earlier tile's row, so
  // there a key at the cap is never below its threshold; after it, a key
  // at the cap is tested.
  int cap[2 * MT];
  auto load_caps = [&]() {
#pragma unroll
    for (int gq = 0; gq < 2 * MT; ++gq)
      cap[gq] = min((int)((unsigned)(sel.thr[8 * gq + g] >> 32) ^ 0x80000000u),
                    INT_BIG);
  };
  load_caps();
  unsigned live_q = 0;              // pending bits of the valid queries
#pragma unroll
  for (int gq = 0; gq < 2 * MT; ++gq)
    if (q0 + 8 * gq + g < nq) live_q |= ((1u << (2 * NT)) - 1u) << (8 * gq);
  // the lane's distances of query 8 gq + g below cap[gq] (at or below it)
  auto below_caps = [&](bool or_at) {
    unsigned bits = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 2 * nt + (c & 1), gq = 2 * mt + (c >> 1);
          if (acc[mt][nt][c] < cap[gq] + or_at) bits |= 1u << (8 * gq + i);
        }
    return bits;
  };

  // slice it: stage st, its full barrier's phase ph, depth slice kslice of
  // the tile at tile0; the producer refills stage pst (slice it - 1's),
  // whose empty barrier completes phase pph
  int st = 0, kslice = 0, tile0 = r_begin, pst = stages - 1;
  unsigned ph = 0, pph = 1;
  for (int it = 0; it < total; ++it) {
    // refill the stage of slice it - 1 once every warp has read it
    if (tid == 0 && it > 0 && it - 1 + stages < total) {
      mbar_wait(bars + 8 * (stages + pst), pph);
      issue();
    }
    __syncwarp();
    mbar_wait(bars + 8 * st, ph);
    const int row0 = tile0 + warp * RPW + 2 * t;      // + 8 nt + u
    const unsigned char* xs = ring + st * SQ_STAGE;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (kslice * SQ_SLICE + 32 * ks >= d) break;    // zeros past d
      unsigned b[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, xs + swz(warp * RPW + np * 16 + (lane & 7) +
                                    (lane >> 4) * 8,
                                32 * ks + ((lane >> 3) & 1) * 16));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        if constexpr (NKR == 0) {
          ldmatrix_x4(a, qs + kslice * QB * SQ_SLICE +
                             swz(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 32 * ks + (lane >> 4) * 16));
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[r] = KR == 2 && kslice ? qa[mt][KR - 1][ks][r]
                                     : qa[mt][0][ks][r];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (ks == 0 && kslice == 0)
            mma_s8_first(acc[mt][nt], a, b[nt][0], b[nt][1]);
          else
            mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
    // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (stages + st));
    const bool last = kslice == nk - 1;
    pst = st;
    pph = ph;
    if (++st == stages) {
      st = 0;
      ph ^= 1u;
    }
    if (!last) {
      ++kslice;
      continue;
    }
    kslice = 0;

    // the tile's last slice: distances, then offers until every key below
    // its threshold is placed (the keys sq_scan_kernel offers).  Bit 8
    // (2 mt + h) + (2 nt + u) of `pend`: query 16 mt + 8 h + g, row 8 nt +
    // 2 t + u.  Every thread reaches each barrier.
    static_assert(2 * MT * 2 * NT <= 32, "one pending bit per key");
    // distances (masked rows far above every cap); the lanes whose least
    // distance of a valid query is at or below its cap find their pending
    // keys, the others have none
    int least[2 * MT];
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i)
      if (!okr[i]) norm[i] = SQ_MASKED_NORM;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        least[2 * mt + h] = INT_MAX;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            int& v = acc[mt][nt][2 * h + u];
            v = norm[2 * nt + u] - 2 * v;
            least[2 * mt + h] = min(least[2 * mt + h], v);
          }
      }
    bool some = false;
#pragma unroll
    for (int gq = 0; gq < 2 * MT; ++gq)
      some |= least[gq] < cap[gq] && ((live_q >> (8 * gq)) & 1u);
    unsigned pend = 0;
    bool busy = __any_sync(0xffffffffu, some);
    if (busy) pend = below_caps(false) & live_q;
    bool merged = false;
    auto key_of = [&](int gq, int i) {
      return pack_key(order_int(acc[gq >> 1][i >> 1][2 * (gq & 1) + (i & 1)]),
                      row0 + (i >> 1) * 8 + (i & 1));
    };
    // the pending keys whose distance equals their cap
    auto at_cap = [&]() {
      unsigned eq = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = 2 * nt + (c & 1), gq = 2 * mt + (c >> 1);
            if (acc[mt][nt][c] == cap[gq]) eq |= 1u << (8 * gq + i);
          }
      return eq & pend;
    };
    // keys at or above their thresholds (or, FLOOR, at or below their
    // floors) drop out; `chk`: the pending keys that need the key test
    auto settle = [&](unsigned chk) {
#pragma unroll
      for (int gq = 0; gq < 2 * MT; ++gq)
#pragma unroll
        for (int i = 0; i < 2 * NT; ++i)
          if ((chk >> (8 * gq + i)) & 1u) {
            const u64 key = key_of(gq, i);
            if (key >= sel.thr[8 * gq + g] || (FLOOR && key <= lo[gq]))
              pend &= ~(1u << (8 * gq + i));
          }
    };
    while (true) {
      if (busy) {
        const unsigned chk = FLOOR ? pend : merged ? at_cap() : 0u;
        if (chk) settle(chk);
        // a put for each group of queries that has a key in the warp
#pragma unroll
        for (int gq = 0; gq < 2 * MT; ++gq) {
          const unsigned mine = (pend >> (8 * gq)) & 0xffu;
          if (__any_sync(0xffffffffu, mine != 0)) {
            const int q[1] = {8 * gq + g};
            unsigned m[1] = {mine};
            sel.template put_groups<1, 2 * NT>(
                q, m, lane, 0xfu << (lane & ~3),
                [&](int, int i) { return key_of(gq, i); });
            pend = (pend & ~(0xffu << (8 * gq))) | (m[0] << (8 * gq));
          }
        }
      }
      // also merge a buffer that a pass left exactly full, so the next
      // tile meets the lower threshold
      if (!__syncthreads_or(pend != 0 || sel.full(tid))) break;
      sel.template merge_buffers<BUF_E>(tid, false);
      load_caps();
      merged = true;
      pend &= below_caps(true);   // the keys still at or below the caps
      busy = __any_sync(0xffffffffu, pend != 0);
    }
    tile0 += SQ_ROWS;
    load_rows(tile0);
  }
  sel.template merge_buffers<BUF_E>(tid, true);
  for (int i = tid; i < QB * kp; i += SQ_THREADS) {
    const int q = i / kp, j = i - q * kp;
    if (q0 + q < nq)
      part[((size_t)(q0 + q) * G + blockIdx.y) * kp + j] =
          sel.keys[(size_t)q * S + j];
  }
}

// W consecutive floats from shared memory (W = 4, 2 or 1).
template <int W>
__device__ __forceinline__ void load_entry(float (&v)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

// The codes of rows r0 .. r0 + 3 at subspace j, row r0 in the low byte;
// zero past r_end.  aligned: n % 4 == 0 and codes_t 4-byte aligned.
__device__ __forceinline__ unsigned codes4(const uint8_t* codes_t, int n,
                                           int j, int r0, int r_end,
                                           bool aligned) {
  const uint8_t* p = codes_t + (size_t)j * n + r0;
  if (aligned) return r0 < r_end ? *reinterpret_cast<const unsigned*>(p) : 0u;
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (r0 + b < r_end) v |= (unsigned)p[b] << (8 * b);
  return v;
}

// Stage 1 of K5: grid (query groups, row chunks).  The block's tables lie
// as [j][code][QB]: entry (j, code) of query q at float (j * 256 + code) *
// QB + q.  At QB = 8 two lanes share a row, lane h of the pair reading
// queries 4 h .. 4 h + 3 (16 bytes of the 32-byte entry), so the 8 lanes of
// a load phase touch 4 entries; below 8 a lane reads a row's whole entry.
//   thread tid: rows RPL * (tid / LPR) .. + RPL - 1 of each tile, queries
//   QPL * (tid % LPR) .. + QPL - 1, in acc[row][query].
// FLOOR: a later pass, which offers only the keys after floor[q].
template <int QB, bool FLOOR>
__global__ void __launch_bounds__(THREADS, 1)
pq_scan_kernel(const float* __restrict__ lut,
               const uint8_t* __restrict__ codes_t,
               const unsigned char* __restrict__ ok, u64* __restrict__ part,
               const u64* __restrict__ floor, int nq, int n, int m, int kp,
               int chunk_rows, int G, int aligned) {
  constexpr int LPR = QB == 8 ? 2 : 1;    // lanes a row
  constexpr int RPL = 4 * LPR;            // rows a lane
  constexpr int QPL = QB / LPR;           // queries a lane
  constexpr int GJ = 4;                   // subspaces a code prefetch
  static_assert(RPL * THREADS / LPR == PQ_ROWS, "a tile's rows");
  static_assert(QPL * RPL <= 32, "one pending bit per key");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, h = tid % LPR;
  const int q0 = blockIdx.x * QB;
  const int SC = scan_state_len(kp), S = SC + BUFFER;
  const int T = m * PQ_K;                 // one query's table
  float* tab = reinterpret_cast<float*>(smem + (size_t)QB * S * 8);
  Select sel = Select::at(smem, QB, kp, S, (size_t)QB * T * 4, SC);
  sel.init(tid);
  u64 lo[QPL];                      // floor keys of queries h QPL + w
#pragma unroll
  for (int w = 0; w < QPL; ++w)
    lo[w] = FLOOR && q0 + h * QPL + w < nq ? floor[q0 + h * QPL + w] : 0;
  for (int i = tid; i < QB * T; i += THREADS) {
    const int q = i / T, jc = i - q * T;
    tab[(size_t)jc * QB + q] = q0 + q < nq ? lut[(size_t)(q0 + q) * T + jc]
                                           : 0.f;
  }
  __syncthreads();

  const int r_begin = blockIdx.y * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const unsigned group = LPR == 2 ? 0x55555555u << h : 0xffffffffu;
  // The codes are loaded a group of GJ subspaces ahead, across tiles, and
  // ok a tile ahead (zero past the chunk).
  auto load_ok = [&](int r0, unsigned char (&okv)[RPL]) {
#pragma unroll
    for (int b = 0; b < RPL; ++b) okv[b] = r0 + b < r_end ? ok[r0 + b] : 0;
  };
  auto load_codes = [&](int r0, int j0, unsigned (&w)[GJ][RPL / 4]) {
#pragma unroll
    for (int u = 0; u < GJ; ++u)
#pragma unroll
      for (int x = 0; x < RPL / 4; ++x)
        w[u][x] = j0 + u < m
            ? codes4(codes_t, n, j0 + u, r0 + 4 * x, r_end, aligned) : 0u;
  };
  unsigned cur[GJ][RPL / 4], nxt[GJ][RPL / 4];
  unsigned char okr[RPL], ok_next[RPL];
  load_codes(r_begin + RPL * (tid / LPR), 0, cur);
  load_ok(r_begin + RPL * (tid / LPR), okr);
  for (int t0 = r_begin; t0 < r_end; t0 += PQ_ROWS) {
    const int r0 = t0 + RPL * (tid / LPR);
    load_ok(r0 + PQ_ROWS, ok_next);
    float acc[RPL][QPL];
#pragma unroll
    for (int b = 0; b < RPL; ++b)
#pragma unroll
      for (int w = 0; w < QPL; ++w) acc[b][w] = 0.f;
    for (int j0 = 0; j0 < m; j0 += GJ) {
      if (j0 + GJ < m) load_codes(r0, j0 + GJ, nxt);
      else load_codes(r0 + PQ_ROWS, 0, nxt);        // the next tile's
#pragma unroll
      for (int u = 0; u < GJ; ++u) {
        const int j = j0 + u;
        if (j >= m) break;
        const float* tj = tab + (size_t)j * PQ_K * QB + h * QPL;
#pragma unroll
        for (int b = 0; b < RPL; ++b) {
          const int code = (cur[u][b >> 2] >> (8 * (b & 3))) & 0xff;
          float v[QPL];
          load_entry<QPL>(v, tj + code * QB);
#pragma unroll
          for (int w = 0; w < QPL; ++w)
            acc[b][w] = __fadd_rn(acc[b][w], v[w]);
        }
      }
#pragma unroll
      for (int u = 0; u < GJ; ++u)
#pragma unroll
        for (int x = 0; x < RPL / 4; ++x) cur[u][x] = nxt[u][x];
    }

    // Bit RPL w + b of `pend`: query h QPL + w, row r0 + b.  Every thread
    // reaches each barrier.
    unsigned pend = 0;
#pragma unroll
    for (int w = 0; w < QPL; ++w)
#pragma unroll
      for (int b = 0; b < RPL; ++b)
        if (okr[b] && q0 + h * QPL + w < nq &&
            acc[b][w] < __int_as_float(FLOAT_INF_BITS) &&
            (!FLOOR || pack_key(order_float(acc[b][w]), r0 + b) > lo[w]))
          pend |= 1u << (RPL * w + b);
    while (true) {
      // keys at or above their thresholds drop out; the puts run only
      // where a lane of the warp has a key left
#pragma unroll
      for (int w = 0; w < QPL; ++w) {
        const u64 thr = sel.thr[h * QPL + w];
#pragma unroll
        for (int b = 0; b < RPL; ++b)
          if (pack_key(order_float(acc[b][w]), r0 + b) >= thr)
            pend &= ~(1u << (RPL * w + b));
      }
      if (__any_sync(0xffffffffu, pend != 0)) {
        constexpr unsigned ALL = (1u << RPL) - 1u;
        int q[QPL];
        unsigned mask[QPL];
#pragma unroll
        for (int w = 0; w < QPL; ++w) {
          q[w] = h * QPL + w;
          mask[w] = (pend >> (RPL * w)) & ALL;
        }
        sel.template put_groups<QPL, RPL>(
            q, mask, lane, group, [&](int w, int b) {
              return pack_key(order_float(acc[b][w]), r0 + b);
            });
        pend = 0;
#pragma unroll
        for (int w = 0; w < QPL; ++w) pend |= mask[w] << (RPL * w);
      }
      if (!__syncthreads_or(pend != 0 || sel.full(tid))) break;
      sel.template merge_buffers<BUF_E>(tid, false);
    }
#pragma unroll
    for (int b = 0; b < RPL; ++b) okr[b] = ok_next[b];
  }
  sel.template merge_buffers<BUF_E>(tid, true);
  for (int i = tid; i < QB * kp; i += THREADS) {
    const int q = i / kp, j = i - q * kp;
    if (q0 + q < nq)
      part[((size_t)(q0 + q) * G + blockIdx.y) * kp + j] =
          sel.keys[(size_t)q * S + j];
  }
}

// Stage 2 of both: one block per query selects the top kp of its G sorted
// partial lists and decodes them; with floor_out, it leaves there the
// query's last key (EMPTY if the valid rows ran out), the next pass's floor.
__global__ void __launch_bounds__(THREADS)
merge_kernel(const u64* __restrict__ part, unsigned* __restrict__ out_d,
             long long* __restrict__ out_i, u64* __restrict__ floor_out,
             int G, int kp, int is_float) {
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
      out_d[o] = is_float ? FLOAT_INF_BITS : (unsigned)INT_BIG;
      out_i[o] = -1;
    } else {
      out_d[o] = unorder((unsigned)(top >> 32), is_float);
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

cudaError_t launch_merge(const u64* part, unsigned* out_d, long long* out_i,
                         u64* floor_out, int nq, int G, int kp, int is_float,
                         cudaStream_t stream) {
  const size_t smem = Select::bytes(1, Select::merge_len(kp, G));
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(merge_kernel), smem);
  if (err != cudaSuccess) return err;
  merge_kernel<<<nq, THREADS, smem, stream>>>(part, out_d, out_i, floor_out,
                                              G, kp, is_float);
  return cudaGetLastError();
}

bool bad_plan(int n, int kp, int chunk_rows, int G, int tile) {
  return kp < 1 || kp > MAX_KP || kp > n || chunk_rows < tile ||
         chunk_rows % tile || (long long)chunk_rows * G < n ||
         (long long)chunk_rows * (G - 1) >= n || G > 65535 ||
         (long long)G * kp > (1LL << 31) - 1;
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return set_smem(reinterpret_cast<const void*>(kernel), smem);
}

// The stage-1 variants the entries launch, as pointers (the variants of
// one kernel take the same arguments): K4 by kp and floor (FLOOR only
// where kp > 256 takes 16 queries a block), K5 by queries a block and
// floor.
typedef void (*SqKernel)(const int8_t*, const int8_t*, const int*,
                         const unsigned char*, u64*, const u64*, int, int,
                         int, int, int, int, int);
typedef void (*PqKernel)(const float*, const uint8_t*, const unsigned char*,
                         u64*, const u64*, int, int, int, int, int, int, int);

SqKernel sq_kernel(int kp, bool floor) {
  const bool deep = sq_stages(kp) == SQ_DEEP;
  if (sq_queries_per_block(kp) == 32)
    return sq_scan_kernel<2, SQ_DEEP, false>;
  if (deep && floor) return sq_scan_kernel<1, SQ_DEEP, true>;
  if (deep) return sq_scan_kernel<1, SQ_DEEP, false>;
  if (floor) return sq_scan_kernel<1, SQ_SHALLOW, true>;
  return sq_scan_kernel<1, SQ_SHALLOW, false>;
}

// K4's TMA route by kp (queries a block), the query slices held in
// registers (0: shared memory) and floor.
typedef void (*SqTmaKernel)(CUtensorMap, const int8_t*, const int*,
                            const unsigned char*, u64*, const u64*, int, int,
                            int, int, int, int, int);

SqTmaKernel sq_tma_kernel(int kp, int qreg_slices, bool floor) {
  if (sq_queries_per_block(kp) == 32)
    return qreg_slices ? sq_tma_scan_kernel<2, 1, false>
                       : sq_tma_scan_kernel<2, 0, false>;
  switch (qreg_slices * 2 + floor) {
    case 0: return sq_tma_scan_kernel<1, 0, false>;
    case 1: return sq_tma_scan_kernel<1, 0, true>;
    case 2: return sq_tma_scan_kernel<1, 1, false>;
    case 3: return sq_tma_scan_kernel<1, 1, true>;
    case 4: return sq_tma_scan_kernel<1, 2, false>;
    default: return sq_tma_scan_kernel<1, 2, true>;
  }
}

// A TMA-route launch's shape, checked: queries in registers only where
// they fit, 2-4 stages.
bool bad_tma_route(int qb, int d, int qreg, int stages) {
  return d % 16 || (qreg && !sq_queries_in_registers(qb, d)) ||
         stages < 2 || stages > 4;
}

// cuTensorMapEncodeTiled (libcuda's), found through the runtime's entry
// point query, so the library links nothing beyond the runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

PqKernel pq_kernel(int qb, bool floor) {
  switch (qb * 2 + floor) {
    case 16: return pq_scan_kernel<8, false>;
    case 17: return pq_scan_kernel<8, true>;
    case 8: return pq_scan_kernel<4, false>;
    case 9: return pq_scan_kernel<4, true>;
    case 4: return pq_scan_kernel<2, false>;
    case 5: return pq_scan_kernel<2, true>;
    case 2: return pq_scan_kernel<1, false>;
    default: return pq_scan_kernel<1, true>;
  }
}

// K4's query operand: the int8 query codes on the codebook's grid,
// q8 = rint((q - offset) / scale) clipped to [-127, 127].
//
// Replaces no TPU kernel: the reference quantizes its queries on the host
// (src/repro/core/adc.py :: SQCodebook.encode_query, numpy), and so did
// the port, which then uploaded the codes from pageable memory, with the
// card idle: the int8 cell's largest host cost.  Here the float32
// queries go up and the card quantizes them on the stream, before K4.
// The codes must equal numpy's bit for bit (the codes of the rows were
// made by the same grid on the host): a subtract and a true division,
// each rounded to nearest (no reciprocal, no FMA: the intrinsics keep
// the compiler from either), then rint, round half to even, as np.rint.
// Bound by bytes: 5 bytes an element (4 read, 1 written), 0.66 MB at the
// int8 cell's 1024 x 128, 0.2 us at 3.35 TB/s; so the launch itself is
// most of its time.  A thread takes 4 elements of a row (16-byte loads,
// 4-byte stores) where d % 4 == 0 and the pointers allow, else one.
constexpr int ENC_THREADS = 256;
constexpr int ENC_MAX_BLOCKS = 4096;     // then a grid-stride loop

__device__ __forceinline__ signed char sq_code(float q, float offset,
                                               float scale) {
  const float v = rintf(__fdiv_rn(__fsub_rn(q, offset), scale));
  return (signed char)(int)fminf(fmaxf(v, -127.0f), 127.0f);
}

__global__ void __launch_bounds__(ENC_THREADS)
sq_encode_kernel(const float* __restrict__ q, const float* __restrict__ offset,
                 float scale, int8_t* __restrict__ q8, long long total, int d,
                 int vec) {
  const long long stride = (long long)gridDim.x * ENC_THREADS;
  long long i = (long long)blockIdx.x * ENC_THREADS + threadIdx.x;
  if (vec) {                             // 4 elements of one row a step
    for (; i < total / 4; i += stride) {
      const float4 x = reinterpret_cast<const float4*>(q)[i];
      const float4 o =
          reinterpret_cast<const float4*>(offset)[(int)(i % (d / 4))];
      char4 c;
      c.x = sq_code(x.x, o.x, scale);
      c.y = sq_code(x.y, o.y, scale);
      c.z = sq_code(x.z, o.z, scale);
      c.w = sq_code(x.w, o.w, scale);
      reinterpret_cast<char4*>(q8)[i] = c;
    }
  } else {
    for (; i < total; i += stride)
      q8[i] = sq_code(q[i], offset[(int)(i % d)], scale);
  }
}

}  // namespace

// Shared memory (bytes) that stage 1 of K4 (pq = 0, width = d) or K5
// (pq = 1, width = m) needs with qb queries a block at this kp; the
// wrapper takes K5's largest qb of 8, 4, 2, 1 that fits the device's
// per-block limit and refuses a call where none does.  K4 takes 32
// queries a block, 16 where kp > 256, at any d.
extern "C" long long repro_adc_smem_bytes(int pq, int qb, int kp, int width) {
  return (long long)(pq ? pq_smem(qb, kp, width) : sq_smem(qb, kp));
}

// Stage-1 blocks of K4 (pq = 0, width = d) or K5 (pq = 1, width = m, qb
// queries a block) that one SM of `device` holds at once, for the variant
// a pass at this kp launches (floor: a later pass of a call above MAX_KP;
// K4 with stages > 0: its TMA route with that ring and the queries in
// registers or not, qreg), at the shared memory it launches with; the
// wrapper's block plan counts the card's slots with it.  A negative
// cudaError_t on failure.
extern "C" int repro_adc_blocks_per_sm(int pq, int qb, int kp, int width,
                                       int floor, int qreg, int stages,
                                       int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  if (kp < 1 || kp > MAX_KP || width < 1 ||
      (pq && qb != 8 && qb != 4 && qb != 2 && qb != 1) ||
      (!pq && stages &&
       (width > MAX_D ||
        bad_tma_route(sq_queries_per_block(kp), width, qreg, stages))))
    return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  if (pq) {
    const PqKernel kernel = pq_kernel(qb, floor != 0);
    const size_t smem = pq_smem(qb, kp, width);
    err = prepare(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          THREADS, smem);
  } else if (stages) {
    const SqTmaKernel kernel =
        sq_tma_kernel(kp, qreg ? sq_slices(width) : 0, floor != 0);
    const size_t smem =
        sq_tma_smem(sq_queries_per_block(kp), kp, width, qreg, stages);
    err = prepare(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          SQ_THREADS, smem);
  } else {
    const SqKernel kernel = sq_kernel(kp, floor != 0);
    const size_t smem = sq_smem(sq_queries_per_block(kp), kp);
    err = prepare(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          SQ_THREADS, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

// Shared memory (bytes) of K4's TMA route with qb queries a block at this
// kp and d, the queries in registers (qreg) or not, `stages` ring stages;
// the wrapper takes the most stages (4, 3, 2) that fit the card's
// per-block limit, and the byte-staging route where none does.
extern "C" long long repro_sq_tma_smem_bytes(int qb, int kp, int d, int qreg,
                                             int stages) {
  return (long long)sq_tma_smem(qb, kp, d, qreg, stages);
}

// The tensor map of K4's TMA route over c8 (n, d) int8: boxes of 128
// bytes x 256 rows (a stage), the 128-byte swizzle, zeros past d and n;
// written to `out` (128 bytes), which the wrapper keeps per (c8, n, d)
// and hands to each launch.  d % 16 == 0 and c8 16-byte aligned.
extern "C" int repro_sq_tensor_map(const int8_t* c8, int n, int d,
                                   void* out) {
  if (n < 1 || d < 16 || d > MAX_D || d % 16 ||
      reinterpret_cast<uintptr_t>(c8) % 16)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d};
  const cuuint32_t box[2] = {(cuuint32_t)SQ_SLICE, (cuuint32_t)SQ_ROWS};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(c8), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  std::memcpy(out, &map, sizeof map);
  return cudaSuccess;
}

// q8 (nq, d) int8, c8 (n, d) int8, cn (n,) int32, ok (n,) uint8 (0 = row
// masked), part (nq, G, kp) uint64 scratch, out_d (nq, kp) int32, out_i
// (nq, kp) int64; all contiguous on `device`.  Rows are split into G
// chunks of chunk_rows (a multiple of 256), one block per (group of 32
// queries, or 16 where kp > 256, chunk).  A pass of a call above MAX_KP:
// floor_in (nq,) (nullptr on the first pass; kp > 256 on the others)
// holds each query's last key of the pass before, and only keys after it
// are offered; floor_out (or nullptr) gets this pass's last keys (it may
// be floor_in).  tmap: the codes' tensor map (repro_sq_tensor_map), which
// takes the TMA route with the queries in registers or not (qreg) and
// `stages` ring stages; nullptr takes the byte-staging route (qreg,
// stages ignored).  Launches both stages on `stream` and returns
// cudaGetLastError().
extern "C" int repro_sq_adc_topk(const int8_t* q8, const int8_t* c8,
                                 const int* cn, const unsigned char* ok,
                                 u64* part, unsigned* out_d, long long* out_i,
                                 const u64* floor_in, u64* floor_out, int nq,
                                 int n, int d, int kp, int chunk_rows, int G,
                                 const void* tmap, int qreg, int stages,
                                 int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq == 0) return cudaSuccess;
  if (bad_plan(n, kp, chunk_rows, G, SQ_ROWS) || d < 1 || d > MAX_D)
    return cudaErrorInvalidValue;
  const int qb = sq_queries_per_block(kp);
  if (floor_in && qb != 16) return cudaErrorInvalidValue;
  const dim3 grid((nq + qb - 1) / qb, G);
  if (tmap) {
    if (bad_tma_route(qb, d, qreg, stages)) return cudaErrorInvalidValue;
    const SqTmaKernel kernel =
        sq_tma_kernel(kp, qreg ? sq_slices(d) : 0, floor_in != nullptr);
    const size_t smem = sq_tma_smem(qb, kp, d, qreg, stages);
    err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    CUtensorMap map;
    std::memcpy(&map, tmap, sizeof map);
    kernel<<<grid, SQ_THREADS, smem, stream>>>(map, q8, cn, ok, part,
                                               floor_in, nq, n, d, kp,
                                               chunk_rows, G, stages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_merge(part, out_d, out_i, floor_out, nq, G, kp, 0, stream);
  }
  const size_t smem = sq_smem(qb, kp);
  const int vec = d % 16 == 0 && reinterpret_cast<uintptr_t>(c8) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q8) % 16 == 0;
  const SqKernel kernel = sq_kernel(kp, floor_in != nullptr);
  err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, SQ_THREADS, smem, stream>>>(q8, c8, cn, ok, part, floor_in,
                                             nq, n, d, kp, chunk_rows, G,
                                             vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part, out_d, out_i, floor_out, nq, G, kp, 0, stream);
}

// lut (nq, m, 256) float32, codes_t (m, n) uint8, ok (n,) uint8, part,
// out_d (nq, kp) float32, out_i (nq, kp) int64, floor_in, floor_out: as
// above, with qb (8, 4, 2 or 1) queries a block and chunks of a multiple
// of 1024 rows.
extern "C" int repro_pq_adc_topk(const float* lut, const uint8_t* codes_t,
                                 const unsigned char* ok, u64* part,
                                 unsigned* out_d, long long* out_i,
                                 const u64* floor_in, u64* floor_out, int nq,
                                 int n, int m, int kp, int qb, int chunk_rows,
                                 int G, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq == 0) return cudaSuccess;
  if (bad_plan(n, kp, chunk_rows, G, PQ_ROWS) || m < 1 ||
      (qb != 8 && qb != 4 && qb != 2 && qb != 1))
    return cudaErrorInvalidValue;
  const size_t smem = pq_smem(qb, kp, m);
  const int aligned =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(codes_t) % 4 == 0;
  const dim3 grid((nq + qb - 1) / qb, G);
  const PqKernel kernel = pq_kernel(qb, floor_in != nullptr);
  err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(lut, codes_t, ok, part, floor_in,
                                          nq, n, m, kp, chunk_rows, G,
                                          aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part, out_d, out_i, floor_out, nq, G, kp, 1, stream);
}

// q (nq, d) float32, offset (d,) float32, q8 (nq, d) int8 out, all
// contiguous on `device`: q8 = rint((q - offset) / scale) clipped to
// [-127, 127], scale the codebook's scale rounded to float32.  One launch
// on `stream`; returns cudaGetLastError().
extern "C" int repro_sq_encode_queries(const float* q, const float* offset,
                                       float scale, int8_t* q8, int nq, int d,
                                       int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq < 0 || d < 1) return cudaErrorInvalidValue;
  const long long total = (long long)nq * d;
  if (total == 0) return cudaSuccess;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(offset) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q8) % 4 == 0;
  const long long items = vec ? total / 4 : total;
  const long long want = (items + ENC_THREADS - 1) / ENC_THREADS;
  const int blocks = (int)(want < ENC_MAX_BLOCKS ? want : ENC_MAX_BLOCKS);
  sq_encode_kernel<<<blocks, ENC_THREADS, 0, stream>>>(q, offset, scale, q8,
                                                       total, d, vec);
  return cudaGetLastError();
}
