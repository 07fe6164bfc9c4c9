// Chunked-scan step kernel for Hopper, sm_90a.
//
// Replaces no Pallas kernel. The reference runs its chunked scan
// (nomad_tpu/solver/kernels.py `place_chunked`) as one XLA program whose
// lax.scan step scores every node with the running state; this kernel is
// that step's score pass, one launch per step (kernels.chunked_step_ref is
// its plain version). For every node:
//   can_place  instance capacity max(0, min_r floor((cap - used) / ask_r))
//              > 0 and feasible, placed < max_per_node, and for each
//              distinct_property stanza live at the scan's start: a value
//              (id >= 0) whose remaining quota is > 0;
//   score      the mean over the present components, summed in the
//              reference's order: base + anti as ONE fused multiply-add
//              (the reference's compiled program contracts them; base is
//              clip(20 - sum 10^(1 - (used + ask) / cap), 0, 18) times
//              float32(1/18), 10**x from pow10.cuh as in K2; anti is
//              -(collisions + 1) / desired where collisions > 0), then the
//              affinity boost where nonzero, then the sum over active
//              spread stanzas (even-spread boost or targeted
//              ((desired - (count + 1)) / desired) * weight, -1 for a
//              missing value) where nonzero, divided by max(n_present, 1).
// It writes -inf where can_place is false and the score elsewhere, and
// nothing else.
//
// What bounds it on this card: the launch. One step at the 16,384 bucket
// with two stanzas reads ~65 bytes for a feasible node (cap, used,
// feasible, collisions, placed, affinity, spread ids) and writes 4; an
// infeasible node (padding included) reads its feasible byte and writes
// -inf. With 10,000 live rows that is about 0.7 MB, 0.2 us at HBM rate,
// under the ~0.9 us launch floor. The 256-step scan is a chain of
// launches and host round trips, not of bytes.
//
// Design: one thread per node in 128-thread blocks. Each block first
// reduces the [S, P] spread counts to each stanza's (min, max, any live
// column) in shared memory (P is the value universe, small), so every
// block derives the even-spread boost's inputs itself and no second pass
// or global reduction is needed. The score's arithmetic lives in
// chunked_score.cuh, which the whole-scan kernel (chunked_scan.cu) shares.
// Build without fast math and without FMA contraction: the one fused
// multiply-add the reference computes is written as __fmaf_rn, every other
// operation rounds on its own, as in the plain version.
//
// The placer no longer runs the scan step by step: chunked_scan.cu runs a
// whole solve in one launch. This single-step entry stays to hold the
// shared score bit for bit against the plain step.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "chunked_score.cuh"

#define THREADS 128

__global__ void __launch_bounds__(THREADS) chunked_step_kernel(
    const float* __restrict__ cap, const float* __restrict__ used,
    const float* __restrict__ ask, const uint8_t* __restrict__ feasible,
    const int32_t* __restrict__ job_coll, const int32_t* __restrict__ placed,
    int n, int32_t mpn, float desired, int spread,
    const int32_t* __restrict__ sp_ids, const int32_t* __restrict__ sp_counts,
    const float* __restrict__ sp_desired, const int32_t* __restrict__ sp_mode,
    const float* __restrict__ sp_weights, int n_s, int n_p,
    const float* __restrict__ aff, const int32_t* __restrict__ dp_ids,
    const int32_t* __restrict__ dp_rem, const uint8_t* __restrict__ d_active,
    int n_d, int n_dp, float* __restrict__ out) {
  __shared__ int s_min[MAX_STANZAS], s_max[MAX_STANZAS], s_any[MAX_STANZAS];
  chunked_spread_stats(sp_counts, n_s, n_p, s_min, s_max, s_any);

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (feasible[i] == 0) {           // nothing else of the row is needed
    out[i] = -CUDART_INF_F;
    return;
  }

  float c[NUM_XR], u[NUM_XR];
#pragma unroll
  for (int r = 0; r < NUM_XR; ++r) {
    c[r] = cap[(size_t)i * NUM_XR + r];
    u[r] = used[(size_t)i * NUM_XR + r];
  }
  int32_t pl = placed[i];
  if (!chunked_fits(c, u, ask, pl, mpn) ||
      !chunked_distinct_ok(i, n, dp_ids, dp_rem, d_active, n_d, n_dp)) {
    out[i] = -CUDART_INF_F;
    return;
  }
  float n_pre;
  float pre = chunked_pre(chunked_raw(c, u, ask, spread), job_coll[i] + pl,
                          desired, aff[i], &n_pre);
  bool any_spread;
  float st = chunked_spread(i, n, sp_ids, sp_counts, sp_desired, sp_mode,
                            sp_weights, n_s, n_p, s_min, s_max, s_any,
                            &any_spread);
  out[i] = chunked_final(pre, n_pre, st, any_spread);
}

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// Shapes: cap/used [n, 5] f32, ask [5] f32, feasible [n] u8, job_coll and
// placed [n] i32, sp_ids [n_s, n] i32, sp_counts [n_s, n_p] i32,
// sp_desired [n_s, n_p] f32, sp_mode [n_s] i32, sp_weights [n_s] f32,
// aff [n] f32, dp_ids [n_d, n] i32, dp_rem [n_d, n_dp] i32, d_active
// [n_d] u8; out [n] f32. n_s <= 16 (MAX_STANZAS).
extern "C" int chunked_step_launch(
    const float* cap, const float* used, const float* ask,
    const uint8_t* feasible, const int32_t* job_coll, const int32_t* placed,
    int n, int max_per_node, float desired, int spread, const int32_t* sp_ids,
    const int32_t* sp_counts, const float* sp_desired, const int32_t* sp_mode,
    const float* sp_weights, int n_s, int n_p, const float* aff,
    const int32_t* dp_ids, const int32_t* dp_rem, const uint8_t* d_active,
    int n_d, int n_dp, float* out, void* stream) {
  if (n <= 0) return 0;
  if (n_s < 0 || n_s > MAX_STANZAS || n_p < 1 || n_d < 0 || n_dp < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  chunked_step_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      cap, used, ask, feasible, job_coll, placed, n, max_per_node, desired,
      spread, sp_ids, sp_counts, sp_desired, sp_mode, sp_weights, n_s, n_p,
      aff, dp_ids, dp_rem, d_active, n_d, n_dp, out);
  return (int)cudaGetLastError();
}
