// Block-level running top-k selection by 64-bit keys, shared by the fused
// scan + top-k kernels (adc_topk.cu: K4, K5; l2_topk.cu: the fused flat
// scan).
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
// memory.  A key below the threshold goes to the buffer (shared atomic
// counter); `flush` sorts every segment [state | buffer] with one bitonic
// network, empties the buffers and lowers the thresholds.  Two ways to fill
// the buffers:
//   * offer + end_step: at most `step` offers a query between two
//     end_step calls, and a buffer of at least 2 * step keys (K4, K5);
//   * try_put: a key that finds its buffer full stays with its thread,
//     which offers it again after the flush that the block then runs (the
//     fused flat scan, whose tiles offer more keys a step than fit).  Until
//     the first flush the state is empty and try_put fills the whole
//     segment, so the first flush sees S keys, not S - SC.
// `flush` sorts with the whole block and a barrier per network stage;
// `flush_warps` gives each warp whole segments of S = 32 E keys and sorts
// them in registers (shuffles across lanes), two barriers in all.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace topk {

typedef unsigned long long u64;

constexpr u64 EMPTY = ~0ull;
constexpr unsigned FLOAT_INF_BITS = 0x7f800000u;

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
// [SC, S) the buffer, EMPTY where unused.  S is a power of two.
template <int THREADS>
struct Select {
  u64* keys;
  u64* thr;        // per query: keys below it are offered to the buffer
  int* cnt;        // per query: keys put in the buffer since the flush
  int nseg, S, SC, kp;
  int off;         // where try_put's buffer starts: 0 until the first flush

  // Shared memory (bytes) of `nseg` segments of S keys, with their
  // thresholds and counters.
  __host__ __device__ static size_t bytes(int nseg, int S) {
    return (size_t)nseg * S * 8 + (size_t)nseg * 12;
  }

  // The segments at `smem`; the thresholds and counters after
  // `tail_bytes` more bytes (a multiple of 8).
  __device__ static Select at(unsigned char* smem, int nseg, int kp, int S,
                              size_t tail_bytes) {
    Select s;
    s.nseg = nseg;
    s.kp = kp;
    s.S = S;
    s.SC = state_len(kp);
    s.off = 0;
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

  __device__ __forceinline__ void offer(int q, u64 key) {
    if (key < thr[q]) {
      const int pos = atomicAdd(&cnt[q], 1);
      keys[q * S + SC + pos] = key;
    }
  }

  // Puts a key that is below the threshold into its buffer; false if the
  // buffer is full (the caller keeps the key and offers it after a flush).
  __device__ __forceinline__ bool try_put(int q, u64 key) {
    const int pos = atomicAdd(&cnt[q], 1);
    if (pos >= S - off) return false;
    keys[q * S + off + pos] = key;
    return true;
  }

  // All threads, after a step of at most `step` offers per query: flush if
  // the next step could overflow a buffer.  Every thread reads the
  // counters between two barriers, so all take the same branch.
  __device__ void end_step(int tid, int step) {
    __syncthreads();
    bool due = false;
    for (int q = 0; q < nseg; ++q) due |= cnt[q] > S - SC - step;
    __syncthreads();
    if (due) flush(tid);
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
