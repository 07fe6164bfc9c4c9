// The block-wide selection the chunked scan kernels share: the scan's
// 64-bit key (order-preserving bits of the score, -0.0 read as +0.0, in
// the high word; ~index in the low word) and the selects over such keys
// (an arg-max, a radix select, and the radix select for keys stored in
// node order with ties on the score word taken in storage order). Used by
// the whole-scan kernel (chunked_scan.cu: one cluster a solve) and the
// sharded scan's step (chunked_shard.cu: one launch a step, a cluster of
// 8 CTAs a shard), so both pick exactly the winners the plain step's
// stable sort picks.
//
// Every function here is called by all THREADS threads of a block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512
#define WARPS (THREADS / 32)
#define FULL 0xffffffffu

struct SelectShared {
  int hist[2][256];
  uint64_t wmax[WARPS];
  uint64_t best;
  int wsum[WARPS];
  int digit, krem, bin_n;
};

__device__ __forceinline__ uint64_t scan_key(float score, int i) {
  uint32_t b = __float_as_uint(score == 0.0f ? 0.0f : score);
  uint32_t hi = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)hi << 32) | (uint64_t)(uint32_t)~(uint32_t)i;
}

__device__ __forceinline__ uint64_t max64(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

// The largest of keys[0, m): every thread calls it; uniform result.
__device__ uint64_t block_max(const uint64_t* keys, int m, SelectShared& sh) {
  uint64_t best = 0;
  for (int i = threadIdx.x; i < m; i += THREADS) best = max64(best, keys[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = max64(best, __shfl_xor_sync(FULL, best, o));
  if ((threadIdx.x & 31) == 0) sh.wmax[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x < 32) {
    uint64_t v = threadIdx.x < WARPS ? sh.wmax[threadIdx.x] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = max64(v, __shfl_xor_sync(FULL, v, o));
    if (threadIdx.x == 0) sh.best = v;
  }
  __syncthreads();
  return sh.best;
}

// Block-wide exclusive prefix sum of each thread's `c` in thread order
// (two barriers); *total gets the block's sum.
__device__ __forceinline__ int block_exclusive(int c, SelectShared& sh,
                                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) sh.wsum[warp] = incl;
  __syncthreads();
  int before = incl - c, all = 0;
  for (int w = 0; w < WARPS; ++w) {
    int v = sh.wsum[w];
    before += w < warp ? v : 0;
    all += v;
  }
  *total = all;
  __syncthreads();                 // wsum free for the next caller
  return before;
}

// Radix passes over the nonzero keys, bits `top` down to `low` of the
// 64-bit key in digits of up to 8 bits, within the keys that match
// `prefix` on `mask` (the bits above `top`): narrows prefix and `krem`
// (the keys still wanted) until a digit's bin holds exactly krem keys
// (returns true: every key >= prefix is in, exactly k of them) or the
// bits run out (returns false). Both histograms are zero on entry and on
// return.
__device__ bool radix_passes(const uint64_t* keys, int m, int top, int low,
                             uint64_t* prefix_io, uint64_t mask,
                             int* krem_io, SelectShared& sh) {
  uint64_t prefix = *prefix_io;
  int krem = *krem_io;
  bool whole = false;
  for (int pass = 0; top >= low && !whole; ++pass) {
    const int shift = max(top - 7, low);
    const uint64_t digit_mask = (2ull << (top - shift)) - 1;
    int* h = sh.hist[pass & 1];
    for (int base = 0; base < m; base += THREADS) {
      int i = base + threadIdx.x;
      int bin = 256;                        // no key, zero, or off-prefix
      if (i < m) {
        uint64_t key = keys[i];
        if (key != 0 && (key & mask) == prefix)
          bin = (int)((key >> shift) & digit_mask);
      }
      unsigned peers = __match_any_sync(FULL, bin);
      if (bin < 256 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&h[bin], __popc(peers));
    }
    if (threadIdx.x < 256) sh.hist[(pass & 1) ^ 1][threadIdx.x] = 0;
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds bins 255 - 8l .. 248 - 8l, from the top down
      const int lane = threadIdx.x;
      int c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = h[255 - 8 * lane - j];
        s += c[j];
      }
      int incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      int acc = incl - s;                          // keys in higher bins
      if (acc < krem && incl >= krem) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc + c[j] >= krem) {
            sh.digit = 255 - 8 * lane - j;
            sh.krem = krem - acc;
            sh.bin_n = c[j];
            break;
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
    prefix |= (uint64_t)sh.digit << shift;
    mask |= digit_mask << shift;
    krem = sh.krem;
    whole = sh.bin_n == krem;
    if (threadIdx.x < 256) h[threadIdx.x] = 0;     // read by warp 0 only
    top = shift - 1;
  }
  *prefix_io = prefix;
  *krem_io = krem;
  return whole;
}

// The threshold T with exactly k of the nonzero keys of keys[0, m) >= T
// (1 <= k <= their number), keys unique and in any order. Every thread
// calls it; it synchronises and returns T to all.
__device__ uint64_t block_select(const uint64_t* keys, int m, int k,
                                 SelectShared& sh) {
  if (k == 1) return block_max(keys, m, sh);
  uint64_t prefix = 0;
  radix_passes(keys, m, 63, 0, &prefix, 0, &k, sh);
  return prefix;
}

// The same threshold for keys stored in ascending node order (the low
// word ~index descending), given the largest and smallest score word
// (high word) of the nonzero keys: radix passes over the score word's
// bits from the first where they differ; then, among the keys tied on
// it, the krem wanted are the first krem in storage order, found by one
// block-wide count.
__device__ uint64_t block_select_ordered(const uint64_t* keys, int m, int k,
                                         uint32_t hi_max, uint32_t hi_min,
                                         SelectShared& sh) {
  if (k == 1) return block_max(keys, m, sh);
  int krem = k;
  uint32_t tie = hi_max;
  if (hi_max != hi_min) {
    const int top = 31 - __clz(hi_max ^ hi_min);
    const uint64_t mask = (uint64_t)(~0u << top << 1) << 32;
    uint64_t prefix = ((uint64_t)hi_max << 32) & mask;
    if (radix_passes(keys, m, 32 + top, 32, &prefix, mask, &krem, sh))
      return prefix;
    tie = (uint32_t)(prefix >> 32);
  }
  const int q = (m + THREADS - 1) / THREADS;
  const int j0 = min((int)threadIdx.x * q, m), j1 = min(j0 + q, m);
  int c = 0;
  for (int j = j0; j < j1; ++j) c += (uint32_t)(keys[j] >> 32) == tie;
  int total;
  int r = block_exclusive(c, sh, &total);
  if (r < krem && r + c >= krem) {
    for (int j = j0; j < j1; ++j) {
      if ((uint32_t)(keys[j] >> 32) == tie && ++r == krem) {
        sh.best = keys[j];
        break;
      }
    }
  }
  __syncthreads();
  return sh.best;
}
