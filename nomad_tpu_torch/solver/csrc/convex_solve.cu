// The convex placement tier's solve in one launch, for Hopper, sm_90a.
//
// Replaces the iteration of the reference's convex program,
// nomad_tpu/solver/convex.py:141-184 `convex_eval` (one XLA program with
// a lax.while_loop, no Pallas kernel): per node the instance capacity u
// (capped at max_per_node) and the cost (the binpack or spread fit score
// with the instance placed, as a [0, 1] cost, less the affinity boost);
// the budget min(count, quota, sum u); the start x0 = u * budget / sum u;
// then, while it < max_iters and gap > tolerance, one projected-gradient
// step: g = cost + curv x + w_f (coll + x), y = x - step g, x' = the
// projection of y onto {0 <= x <= u, sum x = budget} by PROJECT_ITERS
// halvings of the water-filling threshold, gap = |f(x) - f(x')| /
// (1 + |f(x')|). convex.py `convex_solve_ref` is the plain version; this
// kernel returns what it returns, bit for bit: the final iterate, u, the
// cost, the integral budget, the iteration count and the gap. The
// rounding, the greedy baseline (K2's greedy entry) and the selection
// run after it on the same stream. u and the cost are computed here, on
// pow10.cuh as K2 computes them: K2's score entry writes -1 where a node
// has no capacity, and the reference's cost keeps the score of every
// row (those rows still move the projection's bracket).
//
// What bounds it on this card: the chain of dependent reductions, not
// bytes or operations. A solve reads about 0.6 MB once at the 16,384-row
// bucket and then works from shared memory; each iteration is 52
// cluster-wide reductions (the bracket, 50 halvings, the objective), each
// waiting on the one before it, so a solve costs iterations x 52 x (a
// block reduction and one cluster barrier). The same loop as torch ops
// from the host would need a host read per halving to test the bracket,
// or would run every halving of max_iters iterations blind.
//
// Design: one cluster of 8 CTAs (the portable cluster size) of 1,024
// threads. Thread t = 1,024 r + threadIdx.x of CTA r owns the rows t,
// t + 8,192, t + 16,384, ... and keeps them in shared memory (global
// scratch where a bucket's rows do not fit): the iterate (y in place of
// x during a step), u, the cost and the collisions. Each reduction adds
// a thread's rows in order, then halves across the lanes of a warp by
// shuffles, across the warps of a block through shared memory, and
// across the 8 blocks: each block's partial goes to its shared memory,
// one cluster barrier, and every thread reads the 8 partials through
// distributed shared memory and combines them in the same fixed order, so
// every thread of the cluster holds the same sum and takes the same
// branch. convex.py `tree_sum` is that order. Partials are double-
// buffered: a block writes slot s again two reductions later, after a
// barrier that every block reaches only once it has read slot s. The
// min and max of the bracket are one reduction (max y = -min -y).
// Where XLA's CPU backend contracts the reference's multiply-adds, this
// kernel calls __fmaf_rn (the plain version rounds once there too);
// everything else builds without FMA contraction or fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "pow10.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 8
#define THREADS 1024
#define WARPS (THREADS / 32)
#define SPAN (CLUSTER * THREADS)   // rows one pass over the cluster covers
#define NUM_XR 5
#define PROJECT_ITERS 50
#define FIELDS 4                   // iterate, u, cost, collisions
#define ROWS_SMEM_LIMIT (200 * 1024)
#define FULL 0xffffffffu

struct ConvexArgs {
  const float* cap;
  const float* used;
  const float* ask;
  const uint8_t* feasible;
  const int32_t* coll;
  const float* aff;
  float* rows_global;    // CLUSTER slices of FIELDS x rows_c floats
  float* x_out;
  int32_t* u_out;
  float* cost_out;
  int32_t* scalars_out;  // budget_int, iterations, gap (float bits)
  int n;
  int mpn;
  int count;
  int max_iters;
  int spread;
  int rows_in_smem;
  float tol;
  float w_f;
  float quota;
  float curv;
  float step_c;          // float32(curv + 1e-6)
  float inv_max_score;   // float32(1 / 18)
};

struct ReduceShared {
  float warp_part[WARPS][3];
  float cta_part[2][3];
};

// Reduce K values over the cluster: sums in the fixed order above (MIN
// false) or minima (MIN true). Every thread calls it; every thread gets
// the cluster's results in v.
template <int K, bool MIN>
__device__ __forceinline__ void cluster_reduce(float (&v)[K],
                                               ReduceShared& sh,
                                               cg::cluster_group& cluster,
                                               int& slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_down_sync(FULL, v[k], o);
      v[k] = MIN ? fminf(v[k], w) : v[k] + w;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) sh.warp_part[warp][k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float p = sh.warp_part[lane][k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float w = __shfl_down_sync(FULL, p, o);
        p = MIN ? fminf(p, w) : p + w;
      }
      if (lane == 0) sh.cta_part[slot][k] = p;
    }
  }
  cluster.sync();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float p[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r)
      p[r] = *cluster.map_shared_rank(&sh.cta_part[slot][k], r);
    if (MIN) {
      float m = p[0];
#pragma unroll
      for (int r = 1; r < CLUSTER; ++r) m = fminf(m, p[r]);
      v[k] = m;
    } else {
      const float q0 = p[0] + p[4], q1 = p[1] + p[5];
      const float q2 = p[2] + p[6], q3 = p[3] + p[7];
      v[k] = (q0 + q2) + (q1 + q3);
    }
  }
  slot ^= 1;
}

// f(x) = <cost, x> + (curv / 2)|x|^2 + (w_f / 2)|coll + x|^2 over the
// cluster's rows, with the reference's two contracted multiply-adds.
__device__ __forceinline__ float objective(const float* xs, const float* costs,
                                           const float* colls, int rows,
                                           int row0, int n, float half_curv,
                                           float half_w, ReduceShared& sh,
                                           cg::cluster_group& cluster,
                                           int& slot) {
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < rows; ++k) {
    if (row0 + k * SPAN >= n) break;
    const int j = k * THREADS + threadIdx.x;
    const float x = xs[j];
    const float t = colls[j] + x;
    acc[0] += costs[j] * x;
    acc[1] += x * x;
    acc[2] += t * t;
  }
  cluster_reduce<3, false>(acc, sh, cluster, slot);
  return __fmaf_rn(half_w, acc[2], __fmaf_rn(acc[1], half_curv, acc[0]));
}

__global__ void __launch_bounds__(THREADS, 1)
    convex_solve_kernel(const ConvexArgs a) {
  extern __shared__ float rows_smem[];
  __shared__ ReduceShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = a.n;
  const int rows = (n + SPAN - 1) / SPAN;      // rows a thread owns
  const int rows_c = rows * THREADS;            // rows a CTA owns
  const int row0 = rank * THREADS + threadIdx.x;
  float* base = a.rows_in_smem
                    ? rows_smem
                    : a.rows_global + (size_t)rank * FIELDS * rows_c;
  float* xs = base;
  float* us = base + rows_c;
  float* costs = base + 2 * rows_c;
  float* colls = base + 3 * rows_c;
  int slot = 0;

  // per node: capacity and cost, as score_capacity.cu computes them
  float ask[NUM_XR];
#pragma unroll
  for (int r = 0; r < NUM_XR; ++r) ask[r] = a.ask[r];
  float sum_u[1] = {0.0f};
  for (int k = 0; k < rows; ++k) {
    const int i = row0 + k * SPAN;
    if (i >= n) break;
    const int j = k * THREADS + threadIdx.x;
    float c[NUM_XR], u[NUM_XR];
#pragma unroll
    for (int r = 0; r < NUM_XR; ++r) {
      c[r] = a.cap[(size_t)i * NUM_XR + r];
      u[r] = a.used[(size_t)i * NUM_XR + r];
    }
    float capacity = 1e9f;
#pragma unroll
    for (int r = 0; r < NUM_XR; ++r)
      if (ask[r] > 0.0f) capacity = fminf(capacity, floorf((c[r] - u[r]) / ask[r]));
    if (a.feasible[i] == 0) capacity = 0.0f;
    const int32_t cap_i = min((int32_t)fmaxf(capacity, 0.0f), (int32_t)a.mpn);
    const float safe0 = c[0] > 0.0f ? c[0] : 1.0f;
    const float safe1 = c[1] > 0.0f ? c[1] : 1.0f;
    const float fp0 = 1.0f - (u[0] + ask[0]) / safe0;
    const float fp1 = 1.0f - (u[1] + ask[1]) / safe1;
    const float total = pow10_f32(fp0) + pow10_f32(fp1);
    const float raw = a.spread ? total - 2.0f : 20.0f - total;
    const float pref = fminf(fmaxf(raw, 0.0f), 18.0f);
    us[j] = (float)cap_i;
    costs[j] = __fmaf_rn(18.0f - pref, a.inv_max_score, -a.aff[i]);
    colls[j] = (float)a.coll[i];
    sum_u[0] += (float)cap_i;
  }
  cluster_reduce<1, false>(sum_u, sh, cluster, slot);
  float budget = fminf(fminf((float)a.count, a.quota), sum_u[0]);
  budget = fmaxf(budget, 0.0f);
  const float scale = budget / fmaxf(sum_u[0], 1.0f);
  const float step = 1.0f / (a.w_f + a.step_c);
  const float half_curv = 0.5f * a.curv;
  const float half_w = a.w_f * 0.5f;
  for (int k = 0; k < rows; ++k) {
    if (row0 + k * SPAN >= n) break;
    const int j = k * THREADS + threadIdx.x;
    xs[j] = us[j] * scale;
  }
  float f_old = objective(xs, costs, colls, rows, row0, n, half_curv, half_w,
                          sh, cluster, slot);

  int it = 0;
  float gap = CUDART_INF_F;
  while (it < a.max_iters && gap > a.tol) {
    // gradient step, y in place of x; the bracket from min(y - u), max y
    float m[2] = {CUDART_INF_F, CUDART_INF_F};
    for (int k = 0; k < rows; ++k) {
      if (row0 + k * SPAN >= n) break;
      const int j = k * THREADS + threadIdx.x;
      const float x = xs[j];
      const float g = __fmaf_rn(colls[j] + x, a.w_f,
                                __fmaf_rn(x, a.curv, costs[j]));
      const float y = __fmaf_rn(-step, g, x);
      xs[j] = y;
      m[0] = fminf(m[0], y - us[j]);
      m[1] = fminf(m[1], -y);
    }
    cluster_reduce<2, true>(m, sh, cluster, slot);
    float lo = m[0] - 1.0f, hi = -m[1] + 1.0f;
    for (int h = 0; h < PROJECT_ITERS; ++h) {
      const float mid = 0.5f * (lo + hi);
      float s[1] = {0.0f};
      for (int k = 0; k < rows; ++k) {
        if (row0 + k * SPAN >= n) break;
        const int j = k * THREADS + threadIdx.x;
        s[0] += fminf(fmaxf(xs[j] - mid, 0.0f), us[j]);
      }
      cluster_reduce<1, false>(s, sh, cluster, slot);
      if (s[0] > budget) lo = mid;
      else hi = mid;
    }
    const float tau = 0.5f * (lo + hi);
    for (int k = 0; k < rows; ++k) {
      if (row0 + k * SPAN >= n) break;
      const int j = k * THREADS + threadIdx.x;
      xs[j] = fminf(fmaxf(xs[j] - tau, 0.0f), us[j]);
    }
    const float f_new = objective(xs, costs, colls, rows, row0, n, half_curv,
                                  half_w, sh, cluster, slot);
    gap = fabsf(f_old - f_new) / (1.0f + fabsf(f_new));
    f_old = f_new;
    ++it;
  }

  for (int k = 0; k < rows; ++k) {
    const int i = row0 + k * SPAN;
    if (i >= n) break;
    const int j = k * THREADS + threadIdx.x;
    a.x_out[i] = xs[j];
    a.u_out[i] = (int32_t)us[j];
    a.cost_out[i] = costs[j];
  }
  if (rank == 0 && threadIdx.x == 0) {
    a.scalars_out[0] = (int32_t)budget;
    a.scalars_out[1] = it;
    a.scalars_out[2] = __float_as_int(gap);
  }
  // no block may leave while another can still read its partials
  cluster.sync();
}

static void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           size_t smem, void* stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CLUSTER, 1, 1);
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

static long long rows_bytes_of(int n) {
  const long long rows = (n + SPAN - 1) / SPAN;
  return (long long)FIELDS * rows * THREADS * 4;
}

// Bytes of global scratch a solve of n rows needs: 0 where a CTA's rows
// fit its shared memory (every bucket up to 65,536 rows).
extern "C" long long convex_solve_scratch_bytes(int n) {
  const long long per_cta = rows_bytes_of(n);
  return per_cta <= ROWS_SMEM_LIMIT ? 0 : CLUSTER * per_cta;
}

// Launch one solve on `stream`; returns the launch's cudaError_t (0 =
// success), or cudaErrorInvalidConfiguration when the card cannot place
// the cluster. Shapes: cap, used [n, 5] f32; ask [5] f32; feasible [n]
// u8; coll [n] i32; aff [n] f32; x_out, cost_out [n] f32; u_out [n] i32;
// scalars_out [4] i32; scratch of convex_solve_scratch_bytes(n) bytes.
extern "C" int convex_solve_launch(
    const float* cap, const float* used, const float* ask,
    const uint8_t* feasible, const int32_t* coll, const float* aff, int n,
    int max_per_node, int count, int max_iters, int spread, float tol,
    float w_f, float quota, float curv, float step_c, float inv_max_score,
    void* scratch, float* x_out, int32_t* u_out, float* cost_out,
    int32_t* scalars_out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  ConvexArgs a;
  a.cap = cap;
  a.used = used;
  a.ask = ask;
  a.feasible = feasible;
  a.coll = coll;
  a.aff = aff;
  a.rows_global = (float*)scratch;
  a.x_out = x_out;
  a.u_out = u_out;
  a.cost_out = cost_out;
  a.scalars_out = scalars_out;
  a.n = n;
  a.mpn = max_per_node;
  a.count = count;
  a.max_iters = max_iters;
  a.spread = spread;
  a.tol = tol;
  a.w_f = w_f;
  a.quota = quota;
  a.curv = curv;
  a.step_c = step_c;
  a.inv_max_score = inv_max_score;
  const long long per_cta = rows_bytes_of(n);
  a.rows_in_smem = per_cta <= ROWS_SMEM_LIMIT;
  const size_t smem = a.rows_in_smem ? (size_t)per_cta : 0;

  cudaError_t err = cudaFuncSetAttribute(
      convex_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, smem, stream);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, convex_solve_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, convex_solve_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
