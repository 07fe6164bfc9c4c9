// One chunked-scan step's score of one node, shared by the single-step
// kernel (chunked_step.cu) and the whole-scan kernel (chunked_scan.cu), so
// that the step kernel's bit-for-bit check against kernels.chunked_step_ref
// also holds the scan kernel's score.
//
// The score is split by what it depends on:
//   chunked_fits / chunked_raw / chunked_pre
//              the node's own usage and placements: instance capacity and
//              max_per_node, the clipped fit term `raw`, then base + anti
//              as ONE fused multiply-add (the reference's compiled program
//              contracts them) plus the affinity boost where nonzero, and
//              the count of the components present so far;
//   chunked_distinct_ok, chunked_spread
//              the running [D, P] quotas and [S, P] spread counts;
//   chunked_final
//              the spread sum where nonzero, divided by the count of the
//              present components.
// Composed in that order they are the plain step's arithmetic, each
// operation rounded on its own (build with --fmad=false, no fast math).
//
// No score is NaN: every quotient divides by a value >= 1 (desired,
// max(n_present, 1), max(min count, 1)) or > 0 (a positive capacity, a
// positive ask, a positive spread target); the inputs are finite.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "pow10.cuh"

#define NUM_XR 5
#define MAX_STANZAS 16

// instance capacity max(0, min_r floor((cap - used) / ask_r)) > 0, and
// placed < max_per_node
__device__ __forceinline__ bool chunked_fits(const float* c, const float* u,
                                             const float* ask, int32_t pl,
                                             int32_t mpn) {
  float capacity = 1e9f;
#pragma unroll
  for (int r = 0; r < NUM_XR; ++r) {
    float a = ask[r];
    if (a > 0.0f) capacity = fminf(capacity, floorf((c[r] - u[r]) / a));
  }
  capacity = fmaxf(capacity, 0.0f);
  return (int32_t)capacity > 0 && pl < mpn;
}

// the fit term with the candidate placed: clip(20 - sum 10^(1 - (used +
// ask) / cap), 0, 18) over cpu and memory (binpack), or clip(sum - 2, 0,
// 18) under the spread algorithm
__device__ __forceinline__ float chunked_raw(const float* c, const float* u,
                                             const float* ask, int spread) {
  float safe0 = c[0] > 0.0f ? c[0] : 1.0f;
  float safe1 = c[1] > 0.0f ? c[1] : 1.0f;
  float fp0 = 1.0f - (u[0] + ask[0]) / safe0;
  float fp1 = 1.0f - (u[1] + ask[1]) / safe1;
  float total = pow10_f32(fp0) + pow10_f32(fp1);
  float raw = spread ? total - 2.0f : 20.0f - total;
  return fminf(fmaxf(raw, 0.0f), 18.0f);
}

// base + anti (one fused multiply-add; anti = -(collisions + 1) / desired
// where collisions > 0), then + the affinity boost where nonzero.
// *n_present: 1 + anti present + affinity present.
__device__ __forceinline__ float chunked_pre(float raw, int32_t coll,
                                             float desired, float aff,
                                             float* n_present) {
  bool anti_on = coll > 0;
  float anti = anti_on ? -((float)coll + 1.0f) / desired : 0.0f;
  const float kInvMaxScore = __int_as_float(0x3D638E39);   // float32(1/18)
  float score = __fmaf_rn(raw, kInvMaxScore, anti);
  bool aff_on = aff != 0.0f;
  score = score + (aff_on ? aff : 0.0f);
  *n_present = 1.0f + (anti_on ? 1.0f : 0.0f) + (aff_on ? 1.0f : 0.0f);
  return score;
}

// every distinct_property stanza live at the scan's start has the node's
// value (id >= 0) with quota left
__device__ __forceinline__ bool chunked_distinct_ok(
    int i, int n, const int32_t* __restrict__ dp_ids, const int32_t* dp_rem,
    const uint8_t* d_active, int n_d, int n_dp) {
  bool can = true;
  for (int d = 0; d < n_d; ++d) {
    if (!d_active[d]) continue;
    int id = dp_ids[(size_t)d * n + i];
    int safe = min(max(id, 0), n_dp - 1);
    can = can && id >= 0 && dp_rem[d * n_dp + safe] > 0;
  }
  return can;
}

// Block-wide: each stanza's (min, max, any) over its live columns (count
// >= 0) of the [S, P] spread counts, into shared s_min/s_max/s_any, one
// warp a stanza. Every thread of the block calls it; it synchronises
// once, after the reduction.
__device__ __forceinline__ void chunked_spread_stats(const int32_t* sp_counts,
                                                     int n_s, int n_p,
                                                     int* s_min, int* s_max,
                                                     int* s_any) {
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x >> 5; s < n_s; s += blockDim.x >> 5) {
    int lmin = 1 << 30, lmax = 0, lany = 0;
    for (int p = lane; p < n_p; p += 32) {
      int v = sp_counts[s * n_p + p];
      if (v >= 0) {
        lmin = min(lmin, v);
        lmax = max(lmax, v);
        lany = 1;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lmin = min(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
      lmax = max(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      lany |= __shfl_xor_sync(0xffffffffu, lany, o);
    }
    if (lane == 0) {
      s_min[s] = lmin;
      s_max[s] = lmax;
      s_any[s] = lany;
    }
  }
  __syncthreads();
}

// the sum over active spread stanzas: the even-spread boost, or the
// targeted ((desired - (count + 1)) / desired) * weight, -1 for a missing
// value; *any_spread: some stanza is active
__device__ __forceinline__ float chunked_spread(
    int i, int n, const int32_t* __restrict__ sp_ids, const int32_t* sp_counts,
    const float* __restrict__ sp_desired, const int32_t* __restrict__ sp_mode,
    const float* __restrict__ sp_weights, int n_s, int n_p, const int* s_min,
    const int* s_max, const int* s_any, bool* any_spread) {
  float st = 0.0f;
  bool any = false;
  for (int s = 0; s < n_s; ++s) {
    int mode = sp_mode[s];
    if (mode < 0) continue;
    any = true;
    int id = sp_ids[(size_t)s * n + i];
    float per;
    if (id < 0) {
      per = -1.0f;
    } else {
      int safe = min(id, n_p - 1);
      int pc = sp_counts[s * n_p + safe];
      if (mode == 1) {
        float dd = sp_desired[s * n_p + safe];
        per = dd > 0.0f ? ((dd - ((float)pc + 1.0f)) / dd) * sp_weights[s]
                        : -1.0f;
      } else {
        int min_c = s_any[s] ? s_min[s] : 0;
        int max_c = s_max[s];
        float div = (float)max(min_c, 1);
        float boost;
        if (pc == min_c)
          boost = min_c == max_c ? -1.0f
                  : min_c == 0   ? 1.0f
                                 : (float)(max_c - min_c) / div;
        else
          boost = min_c == 0 ? -1.0f : (float)(min_c - pc) / div;
        per = max_c > 0 ? boost : 0.0f;
      }
    }
    st = st + per;
  }
  *any_spread = any;
  return st;
}

// the mean over the present components
__device__ __forceinline__ float chunked_final(float pre, float n_pre,
                                               float st, bool any_spread) {
  bool spread_on = any_spread && st != 0.0f;
  float score = pre + (spread_on ? st : 0.0f);
  float n_present = n_pre + (spread_on ? 1.0f : 0.0f);
  return score / fmaxf(n_present, 1.0f);
}
