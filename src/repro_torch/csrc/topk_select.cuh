// Block-level running top-k selection by 64-bit keys, shared by the fused
// scan + top-k kernels (adc_topk.cu: K4, K5; l2_topk.cu: the fused flat
// scan) and by their merges of the blocks' partial top-k lists.
//
// A key is (orderable distance bits << 32) | row id, with the int32 sign
// bit flipped, or float32's sign-magnitude flip (-0 taken as +0).  Keys are
// distinct, and their unsigned order is the order of a stable ascending
// sort of the distances over the whole row, i.e. the order of the
// reference's lax.top_k(-d): the tie rule (lowest id first) needs no extra
// code anywhere.
//
// Select keeps, per query ("segment"), a sorted state of SC >= kp keys, a
// buffer behind it and a threshold (the kp-th best key so far) in shared
// memory.  A thread compares its key with the threshold and `try_put`s it
// into the buffer (shared atomic counter), or a warp `put_groups` the keys
// of lanes that share a query with one atomic per group; a key that finds
// its buffer full stays with its thread, which offers it again after the
// block has emptied the full buffers.  Three ways to empty them:
//   * `flush`: the whole block sorts every segment [state | buffer] with
//     one bitonic network, a barrier per stage.  Until the first flush the
//     state is empty and try_put fills the whole segment, so the first
//     flush sees S keys, not S - SC (the fused flat scan at k' > 256, and
//     the merges);
//   * `flush_warps`: the same for S = 32 E, a warp per segment in
//     registers, two barriers in all (the fused flat scan at k' <= 256);
//   * `merge_buffers` (segments made by `at` with an explicit SC: the
//     buffer is [SC, SC + 32 E) from the start): a warp takes each segment
//     whose buffer is full, and the warps left over take the fullest
//     others; each sorts the buffer in registers and merges it into the
//     sorted state, a bitonic merge of SC keys; the other segments keep
//     their buffers (K4, K5).
// `merge_runs` selects the top kp of the blocks' sorted partial lists.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace topk {

typedef unsigned long long u64;

constexpr u64 EMPTY = ~0ull;
constexpr unsigned FLOAT_INF_BITS = 0x7f800000u;
constexpr int MERGE_RUN = 8;       // merge_runs: keys read per list a round
constexpr int MERGE_KEYS = 4;      // merge_runs: keys a thread holds a batch

// Smallest power of two >= max(kp, 32): the sorted state of a segment.
__host__ __device__ inline int state_len(int kp) {
  int sc = 32;
  while (sc < kp) sc <<= 1;
  return sc;
}

// Smallest power of two >= n.
__host__ __device__ inline int pow2_at_least(int n) {
  int s = 1;
  while (s < n) s <<= 1;
  return s;
}

__device__ __forceinline__ u64 pack_key(unsigned ordered, int id) {
  return ((u64)ordered << 32) | (unsigned)id;
}

__device__ __forceinline__ unsigned order_int(int d) {
  return (unsigned)d ^ 0x80000000u;
}

__device__ __forceinline__ unsigned order_float(float d) {
  const unsigned u = __float_as_uint(d + 0.0f);    // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned unorder(unsigned k, bool is_float) {
  if (!is_float) return k ^ 0x80000000u;
  return (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
}

// The running top-kp of `nseg` queries in shared memory.  Segment q is
// keys[q*S, (q+1)*S): [0, SC) the state, ascending after a flush, and
// [SC, S) the buffer, EMPTY where unused.  S is a power of two for
// `flush` and `flush_warps`; the merge_buffers route takes S = SC + 32 E.
template <int THREADS>
struct Select {
  u64* keys;
  u64* thr;        // per query: keys below it are offered to the buffer
  int* cnt;        // per query: keys put in the buffer since the flush
  int nseg, S, SC, kp;
  int off;         // where try_put's buffer starts: 0 until the first flush
                   // (SC from the start on the merge_buffers route)

  // Shared memory (bytes) of `nseg` segments of S keys, with their
  // thresholds and counters.
  __host__ __device__ static size_t bytes(int nseg, int S) {
    return (size_t)nseg * S * 8 + (size_t)nseg * 12;
  }

  // The segments at `smem`; the thresholds and counters after
  // `tail_bytes` more bytes (a multiple of 8).  With sc > 0 the state
  // holds sc keys and the buffer [sc, S) is used from the start (the
  // merge_buffers route); else state_len(kp) keys, and try_put fills the
  // whole segment until the first flush.
  __device__ static Select at(unsigned char* smem, int nseg, int kp, int S,
                              size_t tail_bytes, int sc = 0) {
    Select s;
    s.nseg = nseg;
    s.kp = kp;
    s.S = S;
    s.SC = sc > 0 ? sc : state_len(kp);
    s.off = sc > 0 ? sc : 0;
    s.keys = reinterpret_cast<u64*>(smem);
    s.thr = reinterpret_cast<u64*>(smem + (size_t)nseg * S * 8 + tail_bytes);
    s.cnt = reinterpret_cast<int*>(s.thr + nseg);
    return s;
  }

  __device__ void init(int tid) {
    for (int i = tid; i < nseg * S; i += THREADS) keys[i] = EMPTY;
    if (tid < nseg) {
      thr[tid] = EMPTY;
      cnt[tid] = 0;
    }
  }

  // Warp, all lanes: puts the lane's keys key_of(m, i), for i in mask[m]
  // (all below the threshold), into segment q[m]'s buffer, for m < M; the
  // lanes of `group` (this lane's group, a lane mask) share each q[m].
  // One shared atomic per group and segment, by the group's lowest lane,
  // the M atomics in flight together; the offsets inside a group from
  // ballots.  mask[m] comes back holding the keys that found the buffer
  // full (the lane keeps them for after the merge).
  template <int M, int N, class KeyOf>
  __device__ __forceinline__ void put_groups(const int (&q)[M],
                                             unsigned (&mask)[M], int lane,
                                             unsigned group, KeyOf key_of) {
    const int leader = __ffs(group) - 1;
    const unsigned before_me = group & ((1u << lane) - 1u);
    int before[M], base[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = __popc(mask[m]);
      int total = 0;
      before[m] = 0;
#pragma unroll
      for (int b = 0; (1 << b) <= N; ++b) {
        const unsigned bits =
            __ballot_sync(0xffffffffu, (c >> b) & 1) & group;
        before[m] += __popc(bits & before_me) << b;
        total += __popc(bits) << b;
      }
      base[m] = 0;
      if (lane == leader && total > 0) base[m] = atomicAdd(&cnt[q[m]], total);
    }
    const int cap = S - off;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      int pos = __shfl_sync(0xffffffffu, base[m], leader) + before[m];
      unsigned left = 0;
#pragma unroll
      for (int i = 0; i < N; ++i)
        if ((mask[m] >> i) & 1u) {
          if (pos < cap) keys[(size_t)q[m] * S + off + pos] = key_of(m, i);
          else left |= 1u << i;
          ++pos;
        }
      mask[m] = left;
    }
  }

  // True for the threads tid < nseg whose segment's buffer is full.
  __device__ __forceinline__ bool full(int tid) const {
    return tid < nseg && cnt[tid] >= S - off;
  }

  // Puts a key that is below the threshold into its buffer; false if the
  // buffer is full (the caller keeps the key and offers it after a flush).
  __device__ __forceinline__ bool try_put(int q, u64 key) {
    const int pos = atomicAdd(&cnt[q], 1);
    if (pos >= S - off) return false;
    keys[q * S + off + pos] = key;
    return true;
  }

  // All threads: sort every segment (one bitonic network over all of
  // them), drop the buffer, and take each query's kp-th key as its new
  // threshold.
  __device__ void flush(int tid) {
    // S is a power of two: segment and offset by shift and mask
    const int log_half = __ffs(S) - 2;
    const int half = S >> 1;
    for (int k = 2; k <= S; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < nseg * half; i += THREADS) {
          const int t = i & (half - 1);
          const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          u64* base = keys + ((size_t)(i >> log_half) << (log_half + 1));
          const u64 a = base[lo], b = base[lo + j];
          if ((a > b) == ((lo & k) == 0)) {
            base[lo] = b;
            base[lo + j] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < nseg * S; i += THREADS)
      if ((i & (S - 1)) >= SC) keys[i] = EMPTY;
    if (tid < nseg) {
      cnt[tid] = 0;
      thr[tid] = keys[(size_t)tid * S + kp - 1];
    }
    off = SC;
    __syncthreads();
  }

  // All threads: `flush` for S = 32 E, a warp per segment in registers.
  template <int E>
  __device__ void flush_warps(int tid) {
    __syncthreads();
    const int lane = tid & 31;
    for (int q = tid >> 5; q < nseg; q += THREADS / 32) {
      u64* seg = keys + (size_t)q * S;
      u64 v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = seg[e * 32 + lane];
      warp_sort(v, lane);
#pragma unroll
      for (int e = 0; e < E; ++e)
        seg[e * 32 + lane] = e * 32 + lane < SC ? v[e] : EMPTY;
      __syncwarp();
      if (lane == 0) {
        cnt[q] = 0;
        thr[q] = seg[kp - 1];
      }
    }
    off = SC;
    __syncthreads();
  }

  // All threads, on the merge_buffers route (SC >= 32 E, S = SC + 32 E):
  // merge every full buffer into its state, and as many of the fullest
  // others (most keys first, then the lower segment) as fill the last
  // round of merges; with `all`, every buffer that holds a key.  The
  // segments due are dealt to the warps in turn, so a flush that finds c
  // buffers full costs ceil(c / warps) merges a warp, and the partial
  // buffers it empties on the idle warps' time do not call their own
  // flushes soon after.
  template <int E>
  __device__ void merge_buffers(int tid, bool all) {
    constexpr int WARPS = THREADS / 32;
    __syncthreads();
    const int lane = tid & 31, warp = tid >> 5;
    for (int base = 0; base < nseg; base += 32) {
      const int c = base + lane < nseg ? cnt[base + lane] : 0;
      unsigned due = __ballot_sync(0xffffffffu, c > 0);
      if (!all) {
        const int full = __popc(__ballot_sync(0xffffffffu, c >= S - SC));
        const int slots = (full + WARPS - 1) / WARPS * WARPS;
        int rank = 0;
        for (int j = 0; j < 32; ++j) {
          const int o = __shfl_sync(0xffffffffu, c, j);
          rank += o > c || (o == c && j < lane);
        }
        due &= __ballot_sync(0xffffffffu, rank < slots);
      }
      for (int i = 0; due; ++i, due &= due - 1)
        if (i % WARPS == warp) merge_segment<E>(base + __ffs(due) - 1, lane);
    }
    __syncthreads();
  }

  // One warp: the SC smallest keys of segment q's state and buffer, in
  // ascending order, as its new state; the buffer emptied, the threshold
  // lowered.  The buffer is sorted in registers; then state[i] takes
  // min(state[i], buffer[SC - 1 - i]), which leaves the SC smallest keys as
  // a sequence that rises and then falls, and one bitonic merge sorts it:
  // its stages of stride >= 32 E in shared memory, the rest a 32 E-key
  // chunk at a time in registers.
  template <int E>
  __device__ void merge_segment(int q, int lane) {
    u64* st = keys + (size_t)q * S;
    const int c = min(cnt[q], S - SC);
    u64 v[E];                       // unsorted: any order loads it
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = e * 32 + lane < c ? st[SC + e * 32 + lane] : EMPTY;
    warp_sort_blocked(v, lane);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      u64* p = st + SC - 1 - (lane * E + e);
      if (v[e] < *p) *p = v[e];
    }
    __syncwarp();
    for (int j = SC >> 1; j >= 32 * E; j >>= 1) {
      for (int i = lane; i < (SC >> 1); i += 32) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const u64 a = st[lo], b = st[lo + j];
        if (a > b) {
          st[lo] = b;
          st[lo + j] = a;
        }
      }
      __syncwarp();
    }
    for (int c0 = 0; c0 < SC; c0 += 32 * E) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = st[c0 + e * 32 + lane];
      warp_merge(v, lane);
#pragma unroll
      for (int e = 0; e < E; ++e) st[c0 + e * 32 + lane] = v[e];
    }
    __syncwarp();
    if (lane == 0) {
      thr[q] = st[kp - 1];
      cnt[q] = 0;
    }
  }

  // Keys of the one segment that merge_runs fills from G lists: the state
  // and room for a batch (at most a round's G * MERGE_RUN keys).
  __host__ __device__ static int merge_len(int kp, int G) {
    const int batch = G * MERGE_RUN < THREADS * MERGE_KEYS
                          ? G * MERGE_RUN : THREADS * MERGE_KEYS;
    return pow2_at_least(state_len(kp) + batch);
  }

  // All threads, one segment made by `at(smem, 1, kp, merge_len(kp, G), 0)`
  // and `init`: the kp smallest keys of G sorted lists of kp keys (list g
  // at src + g * kp) into keys[0, kp), ascending (EMPTY where the lists
  // run out).  The lists are read MERGE_RUN keys of each a round, with a
  // flush after each round so the threshold tightens, and the merge stops
  // after a round in which no key was below it: every later key of a list
  // is larger than the ones it had.  A single list is copied as it is.
  __device__ void merge_runs(const u64* src, int G, int tid) {
    if (G == 1) {                  // one list: it is the answer
      for (int i = tid; i < kp; i += THREADS) keys[i] = src[i];
      __syncthreads();
      return;
    }
    __syncthreads();
    const int per_round = G * MERGE_RUN;
    for (int p0 = 0; p0 < kp; p0 += MERGE_RUN) {
      int below = 0;
      for (int base = 0; base < per_round; base += THREADS * MERGE_KEYS) {
        u64 key[MERGE_KEYS];
        unsigned pend = 0;
        const u64 thr0 = thr[0];
#pragma unroll
        for (int u = 0; u < MERGE_KEYS; ++u) {
          const int idx = base + u * THREADS + tid;
          const int p = p0 + idx % MERGE_RUN;
          key[u] = EMPTY;
          if (idx < per_round && p < kp) {
            key[u] = src[(size_t)(idx / MERGE_RUN) * kp + p];
            if (key[u] < thr0) pend |= 1u << u;
          }
        }
        below |= pend != 0;
        while (true) {
          const u64 t = thr[0];
#pragma unroll
          for (int u = 0; u < MERGE_KEYS; ++u)
            if ((pend >> u) & 1u)
              if (key[u] >= t || try_put(0, key[u])) pend &= ~(1u << u);
          if (!__syncthreads_or(pend != 0)) break;
          flush(tid);
        }
      }
      if (!__syncthreads_or(below)) break;
      flush(tid);
    }
  }

  // Ascending bitonic sort of 32 E keys held by a warp, element lane * E +
  // e in v[e] of that lane: the strides below E stay in the lane, so half
  // of warp_sort's stages need no shuffle.
  template <int E>
  __device__ static void warp_sort_blocked(u64 (&v)[E], int lane) {
#pragma unroll
    for (int k = 2; k <= 32 * E; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (j < E) {                       // partners in the same lane
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int e2 = e ^ j;
            if (e2 > e) {
              const bool up = ((lane * E + e) & k) == 0;
              const u64 a = v[e], b = v[e2];
              const bool swap = (a > b) == up;
              v[e] = swap ? b : a;
              v[e2] = swap ? a : b;
            }
          }
        } else {                           // partners j / E lanes away
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const u64 other = __shfl_xor_sync(0xffffffffu, v[e], j / E);
            const bool up = ((lane * E + e) & k) == 0;
            const bool keep_min = ((lane * E) & j) == 0 ? up : !up;
            v[e] = keep_min == (other < v[e]) ? other : v[e];
          }
        }
      }
    }
  }

  // Ascending bitonic merge of 32 E keys held by a warp (element e * 32 +
  // lane in v[e] of that lane) that rise and then fall.
  template <int E>
  __device__ static void warp_merge(u64 (&v)[E], int lane) {
#pragma unroll
    for (int j = 16 * E; j >= 32; j >>= 1) {     // partners in the same lane
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int e2 = e ^ (j >> 5);
        if (e2 > e) {
          const u64 a = v[e], b = v[e2];
          v[e] = a < b ? a : b;
          v[e2] = a < b ? b : a;
        }
      }
    }
#pragma unroll
    for (int j = 16; j > 0; j >>= 1) {           // partners j lanes away
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const u64 other = __shfl_xor_sync(0xffffffffu, v[e], j);
        const bool keep_min = (lane & j) == 0;
        v[e] = keep_min == (other < v[e]) ? other : v[e];
      }
    }
  }

  // Ascending bitonic sort of 32 E keys held by a warp, element e * 32 +
  // lane in v[e] of that lane.
  template <int E>
  __device__ static void warp_sort(u64 (&v)[E], int lane) {
#pragma unroll
    for (int k = 2; k <= 32 * E; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (j >= 32) {                     // partners in the same lane
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int e2 = e ^ (j >> 5);
            if (e2 > e) {
              const bool up = ((e * 32 + lane) & k) == 0;
              const u64 a = v[e], b = v[e2];
              const bool swap = (a > b) == up;
              v[e] = swap ? b : a;
              v[e2] = swap ? a : b;
            }
          }
        } else {                           // partners j lanes away
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const u64 other = __shfl_xor_sync(0xffffffffu, v[e], j);
            const bool up = ((e * 32 + lane) & k) == 0;
            const bool keep_min = ((lane & j) == 0) == up;
            v[e] = keep_min == (other < v[e]) ? other : v[e];
          }
        }
      }
    }
  }
};

}  // namespace topk
