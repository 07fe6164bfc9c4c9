// The convex solves' reduction helpers (convex_solve.cu, one cluster a
// solve; convex_shard.cu, a cluster a shard): shared-memory addresses for
// the pushed partials, and the warp butterfly in convex.py tree_sum's
// pairing, so both kernels sum in one order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of `addr` (a shared::cta address) in the
// block of cluster rank `rank`.
__device__ __forceinline__ uint32_t peer_u32(uint32_t addr, int rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__host__ __device__ constexpr int pow2_at_least(int k) {
  return k <= 1 ? 1 : 2 * pow2_at_least((k + 1) / 2);
}

// A warp's values v[0, K) (P = pow2_at_least(K) slots) reduced over its
// 32 lanes in tree_sum's pairing, lane l with l + o for o = 16, 8, ...,
// 1, by xor shuffles that split the values between the two lanes of a
// pair: each keeps one half of its slots and combines the partner's copy
// of that half (a + b and fminf are commutative, so either lane's result
// is the pair's, to the bit). A lane sends P/2 + P/4 + ... values, not
// 5 K. After the five levels v[0] holds the warp's result of value
// `base` (the return), on the 32 / P lanes that differ in their low bits.
// Values at or past K - NMIN are minima, the rest sums.
template <int K, int NMIN, int P, int C, int O>
__device__ __forceinline__ int butterfly(float (&v)[P], int lane,
                                         int base) {
  if constexpr (O == 0) {
    return base;
  } else {
    const bool upper = (lane & O) != 0;
    if constexpr (C > 1) {
      constexpr int H = C / 2;
      const int kept = base + (upper ? H : 0);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float mine = upper ? v[H + i] : v[i];
        const float got =
            __shfl_xor_sync(0xffffffffu, upper ? v[i] : v[H + i], O);
        v[i] = kept + i >= K - NMIN ? fminf(mine, got) : mine + got;
      }
      return butterfly<K, NMIN, P, H, O / 2>(v, lane, kept);
    } else {
      const float got = __shfl_xor_sync(0xffffffffu, v[0], O);
      v[0] = base >= K - NMIN ? fminf(v[0], got) : v[0] + got;
      return butterfly<K, NMIN, P, 1, O / 2>(v, lane, base);
    }
  }
}
