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
// What bounds it on this card: bytes. Each node reads 2 rows of 5 floats
// and a feasibility byte and writes 8 bytes, against two pow() — about
// 0.8 MB at the 16,384-node bucket, a fraction of a microsecond at HBM
// rate, so launch latency dominates in practice.
//
// Design: a simple, correct kernel comes first. One thread per node, the
// [N, 5] row-major matrices read as the placer holds them (no transpose
// into the TPU's resource-on-sublane layout), the ragged edge masked by
// the thread index. The arithmetic follows the plain version
// (kernels.score_capacity_ref) operation for operation, 10**x in float64
// rounded to float32; build without fast math and without FMA
// contraction so each rounding matches.

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_XR 5

__device__ __forceinline__ float pow10_f64(float x) {
  return (float)pow(10.0, (double)x);
}

__global__ void score_capacity_kernel(
    const float* __restrict__ cap, const float* __restrict__ used,
    const float* __restrict__ ask, const uint8_t* __restrict__ feasible,
    int n, int spread, int32_t* __restrict__ capacity_out,
    float* __restrict__ score_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

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
  if (feasible[i] == 0) capacity = 0.0f;
  capacity = fmaxf(capacity, 0.0f);
  int32_t cap_i = (int32_t)capacity;

  float safe0 = c[0] > 0.0f ? c[0] : 1.0f;
  float safe1 = c[1] > 0.0f ? c[1] : 1.0f;
  float fp0 = 1.0f - (u[0] + ask[0]) / safe0;
  float fp1 = 1.0f - (u[1] + ask[1]) / safe1;
  float total = pow10_f64(fp0) + pow10_f64(fp1);
  float raw = spread ? total - 2.0f : 20.0f - total;
  float score = fminf(fmaxf(raw, 0.0f), 18.0f);

  capacity_out[i] = cap_i;
  score_out[i] = cap_i > 0 ? score : -1.0f;
}

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
extern "C" int score_capacity_launch(
    const float* cap, const float* used, const float* ask,
    const uint8_t* feasible, int n, int spread, int32_t* capacity_out,
    float* score_out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  score_capacity_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cap, used, ask, feasible, n, spread, capacity_out, score_out);
  return (int)cudaGetLastError();
}
