// The batched HNSW graph walk: upper-layer greedy descent and layer-0 beam
// search, one warp per query, in one launch.
//
// Replaces: src/repro/kernels/graph_expand/graph_expand.py :: expand_layer0
// (Pallas kernel _expand_kernel with _beam_insert: the layer-0 beam
// search) and, for the f32 perf walk, src/repro/graph/traverse.py ::
// upper_entry (the greedy descent, which the reference runs as XLA).
// Two entries share the kernel:
//   repro_graph_walk — the whole walk from the graph's entry point;
//   repro_graph_expand_layer0 — layer 0 alone, from given ep / ep_d.
// Per query, with the torch / XLA walk's rules exactly:
//   start: entry, at distance ok[entry] ? score : +inf; an entry < 0 or an
//       infinite start gives ep = -1 (0 hops, an empty beam);
//   upper layers LU-1 .. 0 of neigh_up, at most GREEDY_BOUND steps each: a
//       step scores the M neighbours with id >= 0 and ok, takes the first
//       minimum and moves only on a strict improvement; hops += 1 and
//       edges += the valid neighbours; the layer ends at the first step
//       that does not improve (an empty padded layer: one hop, no edges);
//       the upper layers set no visited bit;
//   layer 0, at most max_hops hops: select the closest unexpanded beam
//       entry (ties to the lowest slot); stop if there is none, or it is
//       +inf or worse than the ef-th entry; score its M0 neighbours; a
//       neighbour is fresh if its id is >= 0, its row is ok and its visited
//       bit is clear: every bit is read before any is set, so a row holding
//       one id twice inserts it twice; merge the fresh neighbours into the
//       beam in the order of a stable ascending sort of [beam | fresh] and
//       keep ef entries; hops += 1, edges += the fresh neighbours.
//
// What bounds it on the H100: latency.  A hop is a chain of dependent
// steps whatever its bytes (8.3 KB of rows a hop at M0 16, d 128); the
// batch ends with its longest chain (~110-160 hops on the 100k graph), so
// the time per hop is the figure to move.  At 32 queries the bytes bound
// of a batch is a few microseconds.
//
// What the design does about it:
//   * one warp owns a query, its beam and its control flow: warp
//     barriers only, one block of 32 threads per query;
//   * the beam stays ascending (the merge is a stable sort, slots >= ef
//     are inert +inf, every unexpanded entry is finite), so the closest
//     unexpanded entry is the first slot whose expanded flag is clear: a
//     ballot and __ffs, from the lowest slot that can hold one;
//   * adjacency on chip (POOL): when a neighbour is scored, its own M0-id
//     row is copied into a pool of ef + M0 rows in shared memory beside
//     its point row; a beam entry keeps the handle of its pool row, so the
//     selected entry's row is already on chip and a hop makes one
//     dependent device-memory round trip (the rows, their ok flags and
//     their adjacency, all in flight together).  Without the room for the
//     pool (ef 2048 at M0 32), the row is read at selection;
//   * the copies are bulk copies (the TMA unit): each wanted row's lane
//     issues its row and its adjacency row, all completing on one
//     mbarrier.  One warp's stream of 16-byte cp.async took several times
//     longer to issue than the bulk copies (PERF.md, PR 16).  A ragged d
//     or M0 (rows not a multiple of 16 bytes) takes cp.async;
//   * the visited bitmap in shared memory (SVIS) when its R / 8 bytes fit
//     (16 KB at R = 2^17, 128 KB at 2^20), written to the (nq, ceil(R/32))
//     output words at the end; above that size the bitmap stays in the
//     output (ld.global.cg reads issued with the row copies, atomicOr
//     sets), and every valid neighbour's row is copied;
//   * scores: 32 / M0 lanes a staged row (rows padded so the readers'
//     16-byte loads meet no bank twice) sum fp32 sum((x - q)^2), a partial
//     sum a component, and combine by shuffles;
//   * the merge by ranks, no serial loop over the beam: fresh neighbour
//     m with distance v goes to slot lb_m + rank_m, lb_m = #{s < ef :
//     bd[s] <= v} (a binary search of the ascending beam) and rank_m =
//     #{fresh m' : d < v, or d == v and m' < m}; beam entry s to s +
//     #{fresh m : lb_m <= s} (a binary search of the sorted lb): the
//     stable-sort tie order of the torch walk;
//   * the per-query state is kept in shared memory and registers: the
//     two beam buffers are swapped pointers, never an array indexed at
//     run time, which would put the walk's state in local memory.
// What still holds it back: one warp's chain of dependent shared-memory
// steps a hop (score, ranks, merge), longer than the memory round trip.
// An L2 prefetch of the next hop's rows (its entry is known once a hop is
// scored) saved less wait than it cost to issue, and is not kept.
//
// 16-bit rows.  The reference casts C to float32 before its kernel
// computes; here C may be float32, bfloat16 or float16 and is read in
// place (Q is float32: the wrapper converts it, as it is small).  A row
// lands in its staging slot as it is, by one bulk copy of 2d bytes where
// 2d is a multiple of 16 and C is 16-byte aligned (else plain loads:
// cp.async has no 2-byte size), and the scorers convert each value to
// float32 as they read it (8-byte reads of 4 values).  bf16 and f16
// values are exact in float32, so every difference and sum is the one the
// float32 kernel computes on a float32 copy of the rows, in the same
// order: beams, distances, hops, edges and visited bits are bit-equal to
// it.
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "row_elements.cuh"

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GREEDY_BOUND = 64;        // graph/traverse.py GREEDY_BOUND

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared-memory layout of one query's block.  Offsets in bytes.
struct Layout {
  size_t bar, qs, rows, bd, bi, hd, bx, nid, nd, nfr, lb, rk, fv, stage,
      pool, vis, total;
};

// ef beam slots; M0 layer-0 and M upper-layer neighbours; dpad = d rounded
// up to 4; G <= 32 point rows staged a group; pool: the adjacency pool; svis:
// the visited bitmap of RW words in shared memory.
__host__ __device__ inline Layout layout(int ef, int M0, int M, int dpad,
                                         int G, bool pool, bool svis,
                                         int RW) {
  const int mm = M0 > M ? M0 : M;
  const int pr = (M0 + 3) & ~3;          // pool row stride (ints)
  Layout L;
  size_t o = 0;
  L.bar = o;   o = up16(o + 8);
  L.qs = o;    o = up16(o + 4 * (size_t)dpad);
  L.rows = o;  o = up16(o + 4 * (size_t)G * (dpad + 32));
  L.bd = o;    o = up16(o + 2 * 4 * (size_t)ef);
  L.bi = o;    o = up16(o + 2 * 4 * (size_t)ef);
  L.hd = o;    o = up16(o + 2 * 4 * (size_t)ef);
  L.bx = o;    o = up16(o + 2 * (size_t)ef);
  L.nid = o;   o = up16(o + 4 * (size_t)mm);
  L.nd = o;    o = up16(o + 4 * (size_t)mm);
  L.nfr = o;   o = up16(o + 4 * (size_t)mm);
  L.lb = o;    o = up16(o + 4 * (size_t)mm);
  L.rk = o;    o = up16(o + 4 * (size_t)mm);
  L.fv = o;    o = up16(o + 4 * (size_t)mm);
  L.stage = o; o = up16(o + 2 * 4 * (size_t)M0);
  L.pool = o;  o = up16(o + (pool ? 4 * (size_t)(ef + M0) * pr : 0));
  L.vis = o;   o = up16(o + (svis ? 4 * (size_t)RW : 0));
  L.total = o;
  return L;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(s)), "l"(g));
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(s)), "l"(g));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// One bulk copy (the TMA unit) of `bytes` (a multiple of 16, both ends
// 16-byte aligned) into shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(bar)
      : "memory");
}

struct Args {
  const int* neigh0;           // (R, M0)
  const int* neigh_up;         // (LU, R, M) or nullptr
  const unsigned char* ok;     // (R,)
  const void* C;               // (R, d) of the kernel's element type
  const float* Q;              // (nq, d)
  const int* ep;               // (nq,) layer-0 entries, or nullptr
  const float* ep_d;
  int* beam_i;                 // (nq, ef_cap)
  float* beam_d;
  unsigned* vis;               // (nq, RW)
  int* hops_out;
  int* edges_out;
  int R, RW, M0, M, LU, d, ef, ef_cap, max_hops, entry, G;
  int vecC, vecN;              // 16-byte copies of C rows / neigh0 rows
};

// Lanes a row for `cnt` rows (a power of two, lpr * cnt <= 32), and the
// row stride (floats) that gives the lanes' 16-byte reads distinct banks:
// 16-byte units a row = lpr (mod 8).
__device__ __forceinline__ int lanes_per_row(int cnt) {
  int lpr = 1;
  while (lpr * 2 * cnt <= WARP) lpr *= 2;
  return lpr;
}

__device__ __forceinline__ int row_stride(int dpad, int lpr) {
  const int units = dpad / 4;
  return 4 * (units + (((lpr - units) % 8) + 8) % 8);
}

// E: the element type of C's rows (float, __nv_bfloat16 or __half).
template <typename E, bool POOL, bool SVIS>
struct Walk {
  const Args a;
  const E* C;
  int lane, dpad, pr;
  float* qs;
  float* rows;
  // the beam and the staging handles, two buffers each (the merge writes
  // the other); scalar members only, so the object stays in registers
  float *bd0, *bd1;
  int *bi0, *bi1, *hd0, *hd1, *st0, *st1;
  unsigned char *bx0, *bx1;
  int *nid, *nfr, *lb, *rk;
  float *nd, *fv;
  int* pool;
  unsigned* svis;
  unsigned* gvis;              // this query's output words
  unsigned bar, phase;         // the copies' mbarrier and its phase

  __device__ Walk(const Args& args, unsigned char* smem, int q)
      : a(args), C(static_cast<const E*>(args.C)), lane(threadIdx.x & 31) {
    dpad = (a.d + 3) & ~3;
    pr = (a.M0 + 3) & ~3;
    const Layout L = layout(a.ef, a.M0, a.M, dpad, a.G, POOL, SVIS, a.RW);
    qs = reinterpret_cast<float*>(smem + L.qs);
    rows = reinterpret_cast<float*>(smem + L.rows);
    bd0 = reinterpret_cast<float*>(smem + L.bd);
    bd1 = bd0 + a.ef;
    bi0 = reinterpret_cast<int*>(smem + L.bi);
    bi1 = bi0 + a.ef;
    hd0 = reinterpret_cast<int*>(smem + L.hd);
    hd1 = hd0 + a.ef;
    bx0 = smem + L.bx;
    bx1 = bx0 + a.ef;
    st0 = reinterpret_cast<int*>(smem + L.stage);
    st1 = st0 + a.M0;
    nid = reinterpret_cast<int*>(smem + L.nid);
    nd = reinterpret_cast<float*>(smem + L.nd);
    nfr = reinterpret_cast<int*>(smem + L.nfr);
    lb = reinterpret_cast<int*>(smem + L.lb);
    rk = reinterpret_cast<int*>(smem + L.rk);
    fv = reinterpret_cast<float*>(smem + L.fv);
    pool = reinterpret_cast<int*>(smem + L.pool);
    svis = reinterpret_cast<unsigned*>(smem + L.vis);
    gvis = a.vis + (size_t)q * a.RW;
    bar = smem_addr(smem + L.bar);
    phase = 0;
    if (lane == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int k = lane; k < dpad; k += WARP)
      qs[k] = k < a.d ? a.Q[(size_t)q * a.d + k] : 0.f;
    if (SVIS)
      for (int w = lane; w < a.RW; w += WARP) svis[w] = 0u;
    __syncwarp();
  }

  // Row id of C into the staging slot at dst, as it is: 16-byte cp.async
  // where vecC, else 4-byte cp.async (float32) or plain loads (16-bit).
  __device__ void copy_row(float* dst, int id) const {
    constexpr int VEC = 16 / sizeof(E);
    const E* src = C + (size_t)id * a.d;
    E* out = reinterpret_cast<E*>(dst);
    if (a.vecC) {
      for (int c = lane; c < a.d / VEC; c += WARP)
        cp_async16(out + VEC * c, src + VEC * c);
    } else if constexpr (sizeof(E) == 4) {
      for (int c = lane; c < a.d; c += WARP) cp_async4(out + c, src + c);
    } else {
      for (int c = lane; c < a.d; c += WARP) out[c] = src[c];
    }
  }

  __device__ void copy_adjacency(int* dst, int id) const {
    const int* src = a.neigh0 + (size_t)id * a.M0;
    if (a.vecN) {
      for (int c = lane; c < a.M0 / 4; c += WARP) cp_async16(dst + 4 * c, src + 4 * c);
    } else {
      for (int c = lane; c < a.M0; c += WARP) cp_async4(dst + c, src + c);
    }
  }

  // Scores of the neighbours nid[0, cnt): for those with nfr[m] set on
  // entry, copies their rows (and, with `adj`, their adjacency into pool
  // rows stage_h[m]) and reads their ok flags (and, with gseen, their
  // visited words), all in flight together, a group of G rows at a time.
  // On return nd[m] holds the score and nfr[m] = wanted && ok (&& not
  // seen, with gseen).  All lanes.
  __device__ void score(int cnt, bool adj, const int* stage_h, bool gseen) {
    for (int g0 = 0; g0 < cnt; g0 += a.G) {
      const int gc = min(a.G, cnt - g0);
      const int lpr = lanes_per_row(gc);
      const int rs = row_stride(dpad, lpr);
      // lane r holds row g0 + r's id; the ok flags and visited words are
      // read first, then the copies issued, all in flight together
      const int m_own = g0 + lane;
      const bool want = lane < gc && nfr[m_own];
      const int my_id = want ? nid[m_own] : 0;
      const int my_stage = want && POOL && adj ? stage_h[m_own] : 0;
      const unsigned char okv = want ? __ldg(a.ok + my_id) : 0;
      const unsigned word = want && gseen ? __ldcg(gvis + (my_id >> 5)) : 0u;
      const unsigned wanted = __ballot_sync(FULL, want);
      // 16-byte aligned rows: one bulk copy (TMA) a row, issued by the
      // row's own lane, all completing on one mbarrier; else cp.async
      const bool bulk_rows = a.vecC, bulk_adj = POOL && adj && a.vecN;
      if (wanted && (bulk_rows || bulk_adj)) {
        if (lane == 0) {
          const unsigned n = __popc(wanted);
          const unsigned bytes = (bulk_rows ? n * sizeof(E) * a.d : 0u) +
                                 (bulk_adj ? n * 4u * a.M0 : 0u);
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], "
                       "%1;\n" ::"r"(bar), "r"(bytes)
                       : "memory");
        }
        __syncwarp();
        if (want) {
          if (bulk_rows)
            bulk_copy(rows + (size_t)lane * rs, C + (size_t)my_id * a.d,
                      (unsigned)sizeof(E) * a.d, bar);
          if (bulk_adj)
            bulk_copy(pool + (size_t)my_stage * pr,
                      a.neigh0 + (size_t)my_id * a.M0, 4u * a.M0, bar);
        }
      }
      if (!bulk_rows || (POOL && adj && !bulk_adj)) {
#pragma unroll 4
        for (int r = 0; r < gc; ++r) {
          if (!((wanted >> r) & 1u)) continue;     // uniform: a ballot bit
          const int id = __shfl_sync(FULL, my_id, r);
          if (!bulk_rows) copy_row(rows + (size_t)r * rs, id);
          if (POOL && adj && !bulk_adj)
            copy_adjacency(pool + (size_t)__shfl_sync(FULL, my_stage, r) * pr,
                           id);
        }
      }
      if (wanted && (bulk_rows || bulk_adj)) {
        unsigned done = 0;
        while (!done)
          asm volatile(
              "{\n .reg .pred p;\n"
              " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
              " selp.u32 %0, 1, 0, p;\n}\n"
              : "=r"(done)
              : "r"(bar), "r"(phase)
              : "memory");
        phase ^= 1u;
      }
      cp_async_wait_all();
      __syncwarp();
      const int sub = lane & (lpr - 1);
      for (int base = 0; base < gc; base += WARP / lpr) {
        const int r = base + lane / lpr;
        // four partial sums, one per component: short dependent chains
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        if (r < gc && ((wanted >> r) & 1u)) {
          const E* xr = reinterpret_cast<const E*>(rows + (size_t)r * rs);
          const float4* q4 = reinterpret_cast<const float4*>(qs);
          const int whole = a.d >> 2;             // float4s inside d
#pragma unroll 4
          for (int k = sub; k < whole; k += lpr) {
            const float4 x = elem::load4(xr + 4 * k), y = q4[k];
            const float e0 = x.x - y.x, e1 = x.y - y.y;
            const float e2 = x.z - y.z, e3 = x.w - y.w;
            s0 = fmaf(e0, e0, s0);
            s1 = fmaf(e1, e1, s1);
            s2 = fmaf(e2, e2, s2);
            s3 = fmaf(e3, e3, s3);
          }
          if (whole < dpad / 4 && whole % lpr == sub) {
            // ragged d: the copies wrote [0, d) only
            const float4 x = elem::load4(xr + 4 * whole), y = q4[whole];
            const int past = a.d - 4 * whole;   // 1, 2 or 3 valid
            const float e0 = x.x - y.x;
            const float e1 = past > 1 ? x.y - y.y : 0.f;
            const float e2 = past > 2 ? x.z - y.z : 0.f;
            s0 = fmaf(e0, e0, s0);
            s1 = fmaf(e1, e1, s1);
            s2 = fmaf(e2, e2, s2);
          }
        }
        float acc = (s0 + s1) + (s2 + s3);
        for (int o = lpr / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
        if (sub == 0 && r < gc) nd[g0 + r] = acc;
      }
      if (lane < gc) {
        const bool seen = gseen && ((word >> (my_id & 31)) & 1u);
        nfr[m_own] = want && okv && !seen;
      }
      __syncwarp();
    }
  }

  // Reads the M ids of an upper-layer row (or M0 of a layer-0 row) into
  // nid, flags in nfr the ids >= 0.  All lanes.
  __device__ void load_ids(const int* row, int cnt) {
    for (int m = lane; m < cnt; m += WARP) {
      const int id = row[m];
      nid[m] = id;
      nfr[m] = id >= 0;
    }
    __syncwarp();
  }

  // Greedy descent of the upper layers from (cur, cur_d).
  __device__ void descend(int& cur, float& cur_d, int& hops, int& edges) {
    const float INF = __int_as_float(0x7f800000);
    for (int li = a.LU - 1; li >= 0; --li) {
      const int* layer = a.neigh_up + (size_t)li * a.R * a.M;
      for (int step = 0; step < GREEDY_BOUND; ++step) {
        load_ids(layer + (size_t)cur * a.M, a.M);
        score(a.M, false, nullptr, false);
        // first minimum over the valid neighbours
        float bv = INF;
        int bm = 0x7fffffff, valid = 0;
        for (int m = lane; m < a.M; m += WARP) {
          if (!nfr[m]) continue;
          ++valid;
          const float v = nd[m];
          if (v < bv || (v == bv && m < bm)) { bv = v; bm = m; }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(FULL, bv, o);
          const int om = __shfl_xor_sync(FULL, bm, o);
          valid += __shfl_xor_sync(FULL, valid, o);
          if (ov < bv || (ov == bv && om < bm)) { bv = ov; bm = om; }
        }
        ++hops;
        edges += valid;
        if (!(bv < cur_d)) break;             // inf, or no improvement
        cur = nid[bm];
        cur_d = bv;
        __syncwarp();
      }
    }
  }

  // The start of the walk: entry's distance if its row is ok, else +inf.
  __device__ float entry_distance(int entry) {
    if (lane == 0) { nid[0] = entry; nfr[0] = 1; }
    __syncwarp();
    score(1, false, nullptr, false);
    return nfr[0] ? nd[0] : __int_as_float(0x7f800000);
  }

  __device__ void set_visited(int id) {
    if (SVIS) atomicOr(&svis[id >> 5], 1u << (id & 31));
    else atomicOr(&gvis[id >> 5], 1u << (id & 31));
  }

  // Layer-0 beam search from (e, e_d), e >= 0; the beam ends in bi0, bd0.
  __device__ void layer0(int e, float e_d, int& hops, int& edges) {
    const float INF = __int_as_float(0x7f800000);
    const int ef = a.ef, M0 = a.M0;
    float *cbd = bd0, *nbd = bd1;
    int *cbi = bi0, *nbi = bi1, *chd = hd0, *nhd = hd1, *cst = st0, *nst = st1;
    unsigned char *cbx = bx0, *nbx = bx1;
    for (int s = lane; s < ef; s += WARP) {
      cbd[s] = s == 0 ? e_d : INF;
      cbi[s] = s == 0 ? e : -1;
      cbx[s] = s != 0;
      chd[s] = s;                               // pool rows 0 .. ef-1
    }
    for (int m = lane; m < M0; m += WARP) cst[m] = ef + m;
    if (lane == 0) set_visited(e);
    if (POOL) {
      copy_adjacency(pool, e);                  // slot 0's handle is row 0
      cp_async_wait_all();
    }
    __syncwarp();
    int start = 0;                  // every slot below it is expanded
    for (int t = 0; t < a.max_hops; ++t) {
      // 1. the first unexpanded slot
      int j = -1;
      for (int c = start & ~31; c < ef; c += WARP) {
        const int s = c + lane;
        const unsigned m = __ballot_sync(FULL, s < ef && s >= start && !cbx[s]);
        if (m) { j = c + __ffs(m) - 1; break; }
      }
      if (j < 0) break;
      const float bv = cbd[j];
      if (isinf(bv) || bv > cbd[ef - 1]) break;
      // 2. its neighbour row: on chip, or from device memory
      if (POOL) load_ids(pool + (size_t)chd[j] * pr, M0);
      else load_ids(a.neigh0 + (size_t)cbi[j] * M0, M0);
      // 3. visited bits (all read before any is set), then the scores
      if (SVIS) {
        for (int m = lane; m < M0; m += WARP) {
          const int id = nid[m];
          if (id >= 0 && ((svis[id >> 5] >> (id & 31)) & 1u)) nfr[m] = 0;
        }
        __syncwarp();
      }
      score(M0, true, cst, !SVIS);
      // 4. each fresh neighbour's slot: lb_m = #{s < ef : bd[s] <= v}
      // (the beam is ascending) + its rank among the fresh ones, kept in
      // rk[m]; lb[rank] holds the lb values in rank order, which is
      // ascending; the pool rows of the others are staged again
      int nf = 0;
      for (int m0 = 0; m0 < M0; m0 += WARP)
        nf += __popc(__ballot_sync(FULL, m0 + lane < M0 && nfr[m0 + lane]));
      // the fresh scores compacted in index order; the pool rows of the
      // others staged again
      const unsigned below = (1u << lane) - 1u;
      for (int m0 = 0, seen = 0; m0 < M0; m0 += WARP) {
        const int m = m0 + lane;
        const bool f = m < M0 && nfr[m];
        const unsigned bal = __ballot_sync(FULL, f);
        if (f) fv[seen + __popc(bal & below)] = nd[m];
        else if (m < M0)
          nst[nf + (m0 - seen) + __popc(~bal & below)] = cst[m];
        seen += __popc(bal);
      }
      __syncwarp();
      int first = ef;                           // the lowest fresh slot
      for (int m0 = 0, seen = 0; m0 < M0; m0 += WARP) {
        const int m = m0 + lane;
        const bool f = m < M0 && nfr[m];
        const unsigned bal = __ballot_sync(FULL, f);
        const int pos = seen + __popc(bal & below);
        seen += __popc(bal);
        if (!f) continue;
        const float v = fv[pos];
        int rank = 0;
#pragma unroll 4
        for (int r = 0; r < nf; ++r) {
          const float w = fv[r];
          rank += (w < v) | ((w == v) & (r < pos));
        }
        int lo = 0, hi = ef;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cbd[mid] <= v) lo = mid + 1;
          else hi = mid;
        }
        lb[rank] = lo;
        rk[m] = lo + rank;
        first = min(first, lo + rank);
      }
      // 5. the merge into the other buffer, by ranks: fresh m goes to
      // slot rk[m]; beam entry s to s + #{fresh m : lb_m <= s}; a slot
      // >= ef frees its pool row
      __syncwarp();
      for (int m = lane; m < M0; m += WARP) {
        if (!nfr[m]) continue;
        const int id = nid[m];
        set_visited(id);
        const int p = rk[m];
        if (p < ef) {
          nbd[p] = nd[m];
          nbi[p] = id;
          nbx[p] = 0;
          nhd[p] = cst[m];
        } else {
          nst[p - ef] = cst[m];
        }
      }
      for (int s = lane; s < ef; s += WARP) {
        int shift = 0, hi = nf;                 // #{r : lb[r] <= s}
        while (shift < hi) {
          const int mid = (shift + hi) >> 1;
          if (lb[mid] <= s) shift = mid + 1;
          else hi = mid;
        }
        const int p = s + shift;
        if (p < ef) {
          nbd[p] = cbd[s];
          nbi[p] = cbi[s];
          nbx[p] = cbx[s] | (s == j);
          nhd[p] = chd[s];
        } else {
          nst[p - ef] = chd[s];
        }
      }
      start = min(j, __reduce_min_sync(FULL, first));
      __syncwarp();
      float* tf = cbd; cbd = nbd; nbd = tf;
      int* ti = cbi; cbi = nbi; nbi = ti;
      ti = chd; chd = nhd; nhd = ti;
      ti = cst; cst = nst; nst = ti;
      unsigned char* tx = cbx; cbx = nbx; nbx = tx;
      ++hops;
      edges += nf;
    }
    for (int s = lane; s < ef; s += WARP) {
      bi0[s] = cbi[s];                          // the beam's last buffer
      bd0[s] = cbd[s];
    }
    __syncwarp();
  }
};

template <typename E, bool POOL, bool SVIS>
__global__ void __launch_bounds__(WARP)
walk_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const int lane = threadIdx.x;
  const float INF = __int_as_float(0x7f800000);
  Walk<E, POOL, SVIS> w(a, smem, q);
  int hops = 0, edges = 0;
  int e;
  float e_d;
  if (a.ep) {
    e = a.ep[q];
    e_d = a.ep_d[q];
  } else {
    e = a.entry;
    e_d = e >= 0 ? w.entry_distance(e) : INF;
    if (isinf(e_d)) e = -1;
    if (e >= 0 && a.LU > 0) w.descend(e, e_d, hops, edges);
  }
  if (e >= 0) w.layer0(e, e_d, hops, edges);
  int* out_i = a.beam_i + (size_t)q * a.ef_cap;
  float* out_d = a.beam_d + (size_t)q * a.ef_cap;
  for (int s = lane; s < a.ef_cap; s += WARP) {
    const bool live = e >= 0 && s < a.ef;
    out_i[s] = live ? w.bi0[s] : -1;
    out_d[s] = live ? w.bd0[s] : INF;
  }
  if (SVIS)
    for (int k = lane; k < a.RW; k += WARP) w.gvis[k] = w.svis[k];
  if (lane == 0) {
    a.hops_out[q] = hops;
    a.edges_out[q] = edges;
  }
}

template <typename E, bool POOL, bool SVIS>
cudaError_t launch(const Args& a, int nq, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<E, POOL, SVIS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  walk_kernel<E, POOL, SVIS><<<nq, WARP, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch(const Args& a, int nq, int pool, int svis, size_t smem,
                   cudaStream_t stream) {
  if (pool && svis) return launch<E, true, true>(a, nq, smem, stream);
  if (pool) return launch<E, true, false>(a, nq, smem, stream);
  if (svis) return launch<E, false, true>(a, nq, smem, stream);
  return launch<E, false, false>(a, nq, smem, stream);
}

// dtype: C's element type (0 float32, 1 bfloat16, 2 float16).
int run(Args a, int nq, int pool, int svis, int dtype, int device,
        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nq == 0) return cudaSuccess;
  if (a.ef < 1 || a.ef > a.ef_cap || a.M0 < 1 || a.d < 1 || a.G < 1 ||
      a.G > WARP || a.max_hops < 0 || (a.neigh_up && a.M < 1) || a.R < 1 ||
      dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  const int dpad = (a.d + 3) & ~3;
  const size_t smem =
      layout(a.ef, a.M0, a.M, dpad, a.G, pool, svis, a.RW).total;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  if (!svis) {
    err = cudaMemsetAsync(a.vis, 0, (size_t)nq * a.RW * sizeof(unsigned),
                          stream);
    if (err != cudaSuccess) return err;
  }
  // 16-byte copies of a row: 4 float32 or 8 16-bit values
  a.vecC = a.d % (dtype ? 8 : 4) == 0 &&
           reinterpret_cast<uintptr_t>(a.C) % 16 == 0;
  a.vecN = a.M0 % 4 == 0 && reinterpret_cast<uintptr_t>(a.neigh0) % 16 == 0;
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, nq, pool, svis, smem, stream);
  if (dtype == 2) return launch<__half>(a, nq, pool, svis, smem, stream);
  return launch<float>(a, nq, pool, svis, smem, stream);
}

}  // namespace

// Shared memory (bytes) a query's block takes with this plan: the wrapper
// picks the plan (shared bitmap where R allows, the adjacency pool where
// it fits, then G) and refuses one that exceeds the card's per-block limit.
extern "C" long long repro_graph_walk_smem(int ef, int M0, int M, int d,
                                           int G, int pool, int svis, int R) {
  return (long long)layout(ef, M0, M, (d + 3) & ~3, G, pool, svis,
                           (R + 31) / 32).total;
}

// neigh0 (R, M0) int32 (-1 padded); neigh_up (LU, R, M) int32; ok (R,)
// bytes 0/1; C (R, d) of element type `dtype` (0 float32, 1 bfloat16, 2
// float16); Q (nq, d) float32.  Outputs: beam_i
// (nq, ef_cap) int32, beam_d (nq, ef_cap) float32, vis (nq, ceil(R/32))
// uint32 words, hops, edges (nq,) int32: the walk from `entry` (-1: an
// empty graph).  pool, svis and G are the wrapper's plan.  All contiguous
// on `device`; 1 <= ef <= ef_cap.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int repro_graph_walk(
    const int* neigh0, const int* neigh_up, const unsigned char* ok,
    const void* C, const float* Q, int* beam_i, float* beam_d,
    unsigned* vis, int* hops, int* edges, int nq, int R, int M0, int M,
    int LU, int d, int entry, int ef, int ef_cap, int max_hops, int G,
    int pool, int svis, int dtype, int device, cudaStream_t stream) {
  Args a{neigh0, neigh_up, ok, C, Q, nullptr, nullptr, beam_i, beam_d, vis,
         hops, edges, R, (R + 31) / 32, M0, M, LU, d, ef, ef_cap, max_hops,
         entry, G, 0, 0};
  if (LU > 0 && !neigh_up) return cudaErrorInvalidValue;
  if (LU == 0) a.neigh_up = nullptr;
  return run(a, nq, pool, svis, dtype, device, stream);
}

// The layer-0 search alone, from ep (nq,) int32 (-1: an empty graph's
// query) at ep_d (nq,) float32; the hops and edges are layer 0's.
extern "C" int repro_graph_expand_layer0(
    const int* neigh0, const unsigned char* ok, const void* C,
    const float* Q, const int* ep, const float* ep_d, int* beam_i,
    float* beam_d, unsigned* vis, int* hops, int* edges, int nq, int R,
    int M0, int d, int ef, int ef_cap, int max_hops, int G, int pool,
    int svis, int dtype, int device, cudaStream_t stream) {
  Args a{neigh0, nullptr, ok, C, Q, ep, ep_d, beam_i, beam_d, vis, hops,
         edges, R, (R + 31) / 32, M0, 0, 0, d, ef, ef_cap, max_hops, -1, G,
         0, 0};
  return run(a, nq, pool, svis, dtype, device, stream);
}
