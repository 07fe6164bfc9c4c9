// Depth-curve kernel (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel nomad_tpu/solver/pallas_kernels.py
// `_depth_curve_kernel` (reached through `fill_depth_fused`), the
// producer of the depth solver's per-node summaries: for every node, the
// exact instance capacity, the mean-score curve over depths k (binpack or
// spread base score with the k-th instance placed, job anti-affinity,
// affinity boost), its prefix sum F(k), and the best density F(k)/k.
//
// What bounds it on this card: arithmetic, not bytes. A node is 2 rows of
// 5 floats in, 3 words out (about 56 bytes); its curve costs two float64
// pow() per depth, up to K = 512 depths. At the 16,384-node bucket and
// K = 128 that is ~4M float64 pows against under 1 MB of traffic, so the
// float64 pipe, not HBM, sets the floor.
//
// Design: a simple, correct kernel comes first. One thread per node reads
// its row of the [N, 5] row-major cap/used matrices, computes the capacity
// once, then walks the depths with a running prefix sum and a running
// arg-max of F(k)/k (strict `>`, so the first arg-max wins as jnp.argmax
// does). The [N, K] curve never exists in memory, and the TPU's [K, K]
// lower-triangular prefix matmul becomes the per-thread running sum.
// Depths past the node's capacity do not fit, and fitting depths form a
// prefix of the depth axis, so the walk stops at the first depth that
// does not fit. The grid variant (the sampled DEPTH_GRID) gets its depths
// as a by-value argument and integrates across the gaps by trapezoids:
// F_t = F_0 + sum_{u<=t} (s_u + s_{u-1}) / 2 * (g_u - g_{u-1}).
// The arithmetic follows the plain version (kernels.depth_curve_ref)
// operation for operation: 10**x in float64 rounded to float32, prefix
// sums left to right in float32. Build without fast math and without
// FMA contraction so each rounding matches.

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_XR 5
#define MAX_GRID 32
#define NEG_BIG (-1e9f)

struct DepthGrid {
  int n;                  // 0 = dense depths 1..k_max
  float g[MAX_GRID];
};

__device__ __forceinline__ float pow10_f64(float x) {
  return (float)pow(10.0, (double)x);
}

__global__ void depth_curve_kernel(
    const float* __restrict__ cap, const float* __restrict__ used,
    const float* __restrict__ ask, const uint8_t* __restrict__ feasible,
    const int32_t* __restrict__ coll, const float* __restrict__ aff,
    int n, float desired, float mpn, int k_max, DepthGrid grid,
    int spread, float* __restrict__ d_star, int32_t* __restrict__ k_star,
    int32_t* __restrict__ k_cap) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float c[NUM_XR], u[NUM_XR];
#pragma unroll
  for (int r = 0; r < NUM_XR; ++r) {
    c[r] = cap[(size_t)i * NUM_XR + r];
    u[r] = used[(size_t)i * NUM_XR + r];
  }
  // exact instance capacity: min over asked dims of floor(free / ask)
  float capacity = 1e9f;
#pragma unroll
  for (int r = 0; r < NUM_XR; ++r) {
    float a = ask[r];
    if (a > 0.0f) {
      float per = floorf(((c[r] - u[r]) + 1e-6f) / a);
      capacity = fminf(capacity, per);
    }
  }
  capacity = fmaxf(capacity, 0.0f);
  bool feas = feasible[i] != 0;
  k_cap[i] = feas ? (int32_t)fminf(capacity, mpn) : 0;

  float safe0 = c[0] > 0.0f ? c[0] : 1.0f;
  float safe1 = c[1] > 0.0f ? c[1] : 1.0f;
  float a0 = ask[0], a1 = ask[1];
  float cf = (float)coll[i];
  float af = aff[i];
  float aff_on = af != 0.0f ? 1.0f : 0.0f;
  float aff_term = af != 0.0f ? af : 0.0f;

  bool dense = grid.n == 0;
  int depths = dense ? k_max : grid.n;
  float best = NEG_BIG;
  float kbest = dense ? 1.0f : grid.g[0];
  float F = 0.0f;          // dense: running prefix sum
  float C = 0.0f;          // grid: running sum of trapezoids
  float s0 = 0.0f, s_prev = 0.0f, g_prev = 0.0f;
  for (int t = 0; t < depths; ++t) {
    float jf = dense ? (float)(t + 1) : grid.g[t];
    if (!(feas && jf <= mpn && jf <= capacity)) break;
    float fp0 = 1.0f - (u[0] + jf * a0) / safe0;
    float fp1 = 1.0f - (u[1] + jf * a1) / safe1;
    float tot = pow10_f64(fp0) + pow10_f64(fp1);
    float raw = spread ? tot - 2.0f : 20.0f - tot;
    float base = fminf(fmaxf(raw, 0.0f), 18.0f) / 18.0f;
    float cb = cf + (jf - 1.0f);
    bool anti_on = cb > 0.0f;
    float anti = -(cb + 1.0f) / desired;
    float s = ((base + (anti_on ? anti : 0.0f)) + aff_term) /
              ((1.0f + (anti_on ? 1.0f : 0.0f)) + aff_on);
    if (dense) {
      F = F + s;
    } else if (t == 0) {
      s0 = s;
      F = s;
    } else {
      C = C + ((s + s_prev) * 0.5f) * (jf - g_prev);
      F = s0 + C;
    }
    float dens = F / jf;
    if (dens > best) {
      best = dens;
      kbest = jf;
    }
    s_prev = s;
    g_prev = jf;
  }
  d_star[i] = best;
  k_star[i] = (int32_t)kbest;
}

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// `grid_depths` is a host array of `grid_n` depths (grid_n = 0: dense).
extern "C" int depth_curve_launch(
    const float* cap, const float* used, const float* ask,
    const uint8_t* feasible, const int32_t* coll, const float* aff, int n,
    float desired, float mpn, int k_max, const float* grid_depths,
    int grid_n, int spread, float* d_star, int32_t* k_star, int32_t* k_cap,
    void* stream) {
  if (grid_n < 0 || grid_n > MAX_GRID) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  DepthGrid grid;
  grid.n = grid_n;
  for (int t = 0; t < MAX_GRID; ++t)
    grid.g[t] = t < grid_n ? grid_depths[t] : 0.0f;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  depth_curve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cap, used, ask, feasible, coll, aff, n, desired, mpn, k_max, grid,
      spread, d_star, k_star, k_cap);
  return (int)cudaGetLastError();
}
