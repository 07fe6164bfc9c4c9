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
// nothing else: selection and the state update run in torch on the card.
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
// or global reduction is needed. Build without fast math and without FMA
// contraction: the one fused multiply-add the reference computes is
// written as __fmaf_rn, every other operation rounds on its own, as in the
// plain version.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "pow10.cuh"

#define NUM_XR 5
#define THREADS 128
#define MAX_STANZAS 16

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
  if (threadIdx.x < n_s) {
    s_min[threadIdx.x] = 1 << 30;
    s_max[threadIdx.x] = 0;
    s_any[threadIdx.x] = 0;
  }
  __syncthreads();
  for (int s = 0; s < n_s; ++s) {
    int lmin = 1 << 30, lmax = 0, lany = 0;
    for (int p = threadIdx.x; p < n_p; p += blockDim.x) {
      int v = sp_counts[s * n_p + p];
      if (v >= 0) {
        lmin = min(lmin, v);
        lmax = max(lmax, v);
        lany = 1;
      }
    }
    if (lany) {
      atomicMin(&s_min[s], lmin);
      atomicMax(&s_max[s], lmax);
      s_any[s] = 1;
    }
  }
  __syncthreads();

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
  float capacity = 1e9f;
#pragma unroll
  for (int r = 0; r < NUM_XR; ++r) {
    float a = ask[r];
    if (a > 0.0f) capacity = fminf(capacity, floorf((c[r] - u[r]) / a));
  }
  capacity = fmaxf(capacity, 0.0f);
  int32_t pl = placed[i];
  bool can = (int32_t)capacity > 0 && pl < mpn;
  for (int d = 0; d < n_d; ++d) {
    if (!d_active[d]) continue;
    int id = dp_ids[(size_t)d * n + i];
    int safe = min(max(id, 0), n_dp - 1);
    can = can && id >= 0 && dp_rem[d * n_dp + safe] > 0;
  }
  if (!can) {
    out[i] = -CUDART_INF_F;
    return;
  }

  float safe0 = c[0] > 0.0f ? c[0] : 1.0f;
  float safe1 = c[1] > 0.0f ? c[1] : 1.0f;
  float fp0 = 1.0f - (u[0] + ask[0]) / safe0;
  float fp1 = 1.0f - (u[1] + ask[1]) / safe1;
  float total = pow10_f32(fp0) + pow10_f32(fp1);
  float raw = spread ? total - 2.0f : 20.0f - total;
  raw = fminf(fmaxf(raw, 0.0f), 18.0f);

  int32_t coll = job_coll[i] + pl;
  bool anti_on = coll > 0;
  float anti = anti_on ? -((float)coll + 1.0f) / desired : 0.0f;
  const float kInvMaxScore = __int_as_float(0x3D638E39);   // float32(1/18)
  float score = __fmaf_rn(raw, kInvMaxScore, anti);

  float a = aff[i];
  bool aff_on = a != 0.0f;
  score = score + (aff_on ? a : 0.0f);

  float st = 0.0f;
  bool any_spread = false;
  for (int s = 0; s < n_s; ++s) {
    int mode = sp_mode[s];
    if (mode < 0) continue;
    any_spread = true;
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
  bool spread_on = any_spread && st != 0.0f;
  score = score + (spread_on ? st : 0.0f);
  float n_present = 1.0f + (anti_on ? 1.0f : 0.0f) + (aff_on ? 1.0f : 0.0f) +
                    (spread_on ? 1.0f : 0.0f);
  out[i] = score / fmaxf(n_present, 1.0f);
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
