// Score/capacity kernel (K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel nomad_tpu/solver/pallas_kernels.py
// `_score_capacity_kernel` (reached through `score_capacity_fused` and
// `fill_greedy_binpack_fused`), the greedy solve's per-node inner pass:
// instance capacity max(0, min_r floor((cap - used) / ask_r)) masked by
// feasibility, and the binpack (or spread) fit score with the candidate
// instance placed, clip(20 - sum_{cpu,mem} 10^(1 - (used + ask) / cap),
// 0, 18), -1 where nothing fits.
//
// What bounds it on this card: bytes, and below them the launch. Each
// node reads 2 rows of 5 floats and a feasibility byte and writes 8 bytes,
// against two 10**x (pow10.cuh) — about 0.8 MB at the 16,384-node bucket,
// a fraction of a microsecond at HBM rate, so the launch and the
// elementwise launches around it are what a call costs.
//
// Design: one thread per node in 128-thread blocks, so the bucket is 128
// blocks and covers the SMs; the [N, 5] row-major matrices are read as
// the placer holds them, the ragged edge masked by the thread index. Two
// entries of one kernel:
//   score   (capacity i32, score f32) — score_capacity_fused;
//   greedy  the greedy solve's producer with its elementwise prologue
//           folded in: capacity clamped to max_per_node, and the sort key
//           -score where that capacity is > 0, else 1.0 (kernels.
//           _greedy_key), so the tail sorts the key directly and no
//           clamp, mask or negation launches run after it.
// The arithmetic follows the plain version (kernels.score_capacity_ref)
// operation for operation; build without fast math and without FMA
// contraction so each rounding matches.
//
// Gather entry (greedy only): the whole-eval fused route (the reference's
// kernels.fused_eval_greedy, one XLA program that inlines gather_rows)
// reads row idx[i] of the state cache's resident twins, or a zero row
// where valid[i] is 0 — the rows kernels.gather_rows builds — so the
// gathered [N, 5] copies are never written. An index outside the twins
// is clamped to them, as XLA's gather clamps.
//
// Output: one int32 [2, n] buffer: row 0 the capacity, row 1 the score or
// key (float32 bits).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pow10.cuh"

#define NUM_XR 5
#define THREADS 128

template <bool GREEDY, bool GATHER>
__global__ void __launch_bounds__(THREADS) score_capacity_kernel(
    const float* __restrict__ cap, const float* __restrict__ used,
    int n_res, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ valid,
    const float* __restrict__ ask, const uint8_t* __restrict__ feasible,
    int n, int spread, int32_t mpn, int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float c[NUM_XR], u[NUM_XR];
  const bool live = !GATHER || valid[i] != 0;
  const size_t src = GATHER ? (size_t)min(max(idx[i], 0), n_res - 1)
                            : (size_t)i;
#pragma unroll
  for (int r = 0; r < NUM_XR; ++r) {
    c[r] = live ? cap[src * NUM_XR + r] : 0.0f;
    u[r] = live ? used[src * NUM_XR + r] : 0.0f;
  }
  float capacity = 1e9f;
#pragma unroll
  for (int r = 0; r < NUM_XR; ++r) {
    float a = ask[r];
    if (a > 0.0f) capacity = fminf(capacity, floorf((c[r] - u[r]) / a));
  }
  if (feasible[i] == 0) capacity = 0.0f;
  capacity = fmaxf(capacity, 0.0f);
  int32_t cap_i = (int32_t)capacity;

  float safe0 = c[0] > 0.0f ? c[0] : 1.0f;
  float safe1 = c[1] > 0.0f ? c[1] : 1.0f;
  float fp0 = 1.0f - (u[0] + ask[0]) / safe0;
  float fp1 = 1.0f - (u[1] + ask[1]) / safe1;
  float total = pow10_f32(fp0) + pow10_f32(fp1);
  float raw = spread ? total - 2.0f : 20.0f - total;
  float score = fminf(fmaxf(raw, 0.0f), 18.0f);

  float second;
  if (GREEDY) {
    cap_i = min(cap_i, mpn);
    second = cap_i > 0 ? -score : 1.0f;
  } else {
    second = cap_i > 0 ? score : -1.0f;
  }
  out[i] = cap_i;
  out[(size_t)n + i] = __float_as_int(second);
}

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// greedy = 0: (capacity, score); greedy = 1: (capacity clamped to
// max_per_node, sort key). `out` is the int32 [2, n] output buffer.
extern "C" int score_capacity_launch(
    const float* cap, const float* used, const float* ask,
    const uint8_t* feasible, int n, int spread, int greedy,
    int max_per_node, int32_t* out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (greedy)
    score_capacity_kernel<true, false><<<blocks, THREADS, 0, st>>>(
        cap, used, 0, nullptr, nullptr, ask, feasible, n, spread,
        max_per_node, out);
  else
    score_capacity_kernel<false, false><<<blocks, THREADS, 0, st>>>(
        cap, used, 0, nullptr, nullptr, ask, feasible, n, spread,
        max_per_node, out);
  return (int)cudaGetLastError();
}

// The greedy entry over the resident twins cap_res/used_res ([n_res, 5]):
// row i is twin row idx[i], zero where valid[i] is 0 (idx, valid [n]).
extern "C" int score_capacity_gather_launch(
    const float* cap_res, const float* used_res, int n_res,
    const int32_t* idx, const uint8_t* valid, const float* ask,
    const uint8_t* feasible, int n, int spread, int max_per_node,
    int32_t* out, void* stream) {
  if (n_res <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  score_capacity_kernel<true, true>
      <<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          cap_res, used_res, n_res, idx, valid, ask, feasible, n, spread,
          max_per_node, out);
  return (int)cudaGetLastError();
}
