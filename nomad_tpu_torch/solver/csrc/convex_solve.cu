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
// What bounds it on this card: the chain of dependent cluster-wide
// reductions, not bytes or operations. A solve reads about 0.6 MB once at
// the 16,384-row bucket and then works from shared memory on a couple of
// rows a thread; every halving of the bracket waits on the sum of the one
// before it. The plain order of that chain (the reference's loop) is an
// iteration of 52 reductions: the bracket, 50 halvings, the objective.
//
// Design: one cluster of 8 CTAs (the portable cluster size) of 1,024
// threads. Thread t = 1,024 r + threadIdx.x of CTA r owns the rows t,
// t + 8,192, t + 16,384, ... and keeps them in shared memory (global
// scratch where a bucket's rows do not fit): the iterate x, the next
// gradient step y, u, the cost and the collisions. Each reduction adds a
// thread's rows in order, then halves across the lanes of a warp by
// shuffles, across the warps of a block through shared memory, and
// combines the 8 blocks' partials in one fixed order, so every thread of
// the cluster holds the same sums and takes the same branches.
// convex.py `tree_sum` is that order. Fewer reductions, each as cheap as
// the card allows:
//   * Speculative halvings. A round of LEVELS = 3 levels computes, before
//     any sum is known, the 7 midpoints of the bisection subtree below
//     (lo, hi): each is the sequential loop's own 0.5f * (lo + hi) of
//     operands that are already known. One reduction returns all their
//     clipped sums (each in its own tree order), and every thread walks
//     the subtree with the loop's `s > budget` tests to the new
//     (lo, hi). 50 halvings take 17 reductions (16 rounds of 3, one of
//     2), to the bit the loop's. 1, 2 and 4 levels measured slower on an
//     H100 (PERF.md).
//   * One reduction for an iterate's objective and the next bracket: the
//     pass that projects y onto x' also sums f(x')'s three terms, takes
//     the next gradient step y' = x' - step g(x') and its two minima,
//     min(y' - u) and min(-y'); one reduction sums the first three and
//     takes the minima of the last two. x' stays in its own field: where
//     the gap test stops the loop, x', not y', is the result.
//   * Fewer shuffles a value: a warp reduces its K values by an xor
//     butterfly that splits them between the two lanes of each pair
//     (`butterfly`), P/2 + P/4 + ... shuffles a lane for P = K rounded up
//     to a power of two, not 5 K; the same pairs, so the same bits.
//   * Pushed partials in place of a cluster barrier: warp 0 of each
//     block stores its partials into every block's shared memory with
//     st.async, and each block waits on its own transaction barrier,
//     then reads a value's 8 partials as two 16-byte loads. A cluster
//     barrier after which every thread read the partials through
//     distributed shared memory measured about twice as slow (PERF.md).
// So a solve of i iterations is 2 + 18 i reductions
// against the reference loop's order of 2 + 52 i. Partials are
// double-buffered: a block's slot s is written again two reductions later,
// after every block has read it (each block sends the next reduction's
// partials only once its own threads are past the last one's reads). The
// min and max of the bracket are minima (max y = -min -y). Where XLA's
// CPU backend contracts the reference's multiply-adds, this kernel calls
// __fmaf_rn (the plain version rounds once there too); everything else
// builds without FMA contraction or fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cluster_reduce.cuh"
#include "pow10.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 8
#define THREADS 1024
#define WARPS (THREADS / 32)
#define SPAN (CLUSTER * THREADS)   // rows one pass over the cluster covers
#define NUM_XR 5
#define PROJECT_ITERS 50
#define FIELDS 5                   // x, next y, u, cost, collisions
#define ROWS_SMEM_LIMIT (200 * 1024)
#define LEVELS 3                   // halvings one reduction resolves
#define MAX_K ((1 << LEVELS) - 1)  // values one reduction carries

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

#define ROW_K (MAX_K + 1)            // a warp's partials: 32 bytes

struct __align__(16) ReduceShared {
  float warp_part[WARPS][ROW_K];
  float part[2][ROW_K][CLUSTER];     // every block's partials
  unsigned long long bar[2];         // one transaction barrier a slot
};

// Reductions over the cluster in tree_sum's order. Every thread calls
// exchange() with its K values (sums, then NMIN minima); it returns the
// slot whose partials hold the 8 blocks' results, which sum() and
// minimum() combine.
struct Cluster {
  ReduceShared& sh;
  cg::cluster_group& cluster;
  int rank;
  int slot;
  unsigned parity;       // the phase bit each slot's barrier waits on

  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < 2; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(smem_u32(&sh.bar[s])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster.sync();      // no block pushes before every barrier exists
  }

  template <int K, int NMIN>
  __device__ __forceinline__ int exchange(const float (&in)[K]) {
    static_assert(K <= MAX_K, "a reduction carries at most MAX_K values");
    constexpr int P = pow2_at_least(K);
    constexpr int GROUP = 32 / P;            // lanes holding each result
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float v[P];
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = i < K ? in[i] : 0.0f;
    int k = butterfly<K, NMIN, P, P, 16>(v, lane, 0);
    if ((lane & (GROUP - 1)) == 0 && k < K) sh.warp_part[warp][k] = v[0];
    __syncthreads();
    const int s = slot;
    const uint32_t bar = smem_u32(&sh.bar[s]);
    if (warp == 0) {
      if constexpr (P >= 4) {
        const float4* row = reinterpret_cast<const float4*>(
            sh.warp_part[lane]);
#pragma unroll
        for (int q = 0; q < P / 4; ++q) {
          const float4 t = row[q];
          v[4 * q] = t.x;
          v[4 * q + 1] = t.y;
          v[4 * q + 2] = t.z;
          v[4 * q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) v[i] = sh.warp_part[lane][i];
      }
      k = butterfly<K, NMIN, P, P, 16>(v, lane, 0);
      // the GROUP lanes holding value k share its 8 stores
      if (k < K) {
        const uint32_t dst = smem_u32(&sh.part[s][k][rank]);
        for (int r = lane & (GROUP - 1); r < CLUSTER; r += GROUP)
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
              " [%0], %1, [%2];"
              :: "r"(peer_u32(dst, r)), "r"(__float_as_uint(v[0])),
                 "r"(peer_u32(bar, r)) : "memory");
      }
      if (lane == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
            :: "r"(bar), "r"(CLUSTER * K * 4) : "memory");
    }
    const uint32_t want = (parity >> s) & 1u;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
          " p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bar), "r"(want) : "memory");
    }
    parity ^= 1u << s;
    slot ^= 1;
    return s;
  }

  // the 8 blocks' partials of value k in slot s
  __device__ __forceinline__ void partials(int s, int k, float (&p)[CLUSTER]) {
    const float4 a = *reinterpret_cast<const float4*>(&sh.part[s][k][0]);
    const float4 b = *reinterpret_cast<const float4*>(&sh.part[s][k][4]);
    p[0] = a.x, p[1] = a.y, p[2] = a.z, p[3] = a.w;
    p[4] = b.x, p[5] = b.y, p[6] = b.z, p[7] = b.w;
  }

  __device__ __forceinline__ float sum(int s, int k) {
    float p[CLUSTER];
    partials(s, k, p);
    const float q0 = p[0] + p[4], q1 = p[1] + p[5];
    const float q2 = p[2] + p[6], q3 = p[3] + p[7];
    return (q0 + q2) + (q1 + q3);
  }

  __device__ __forceinline__ float minimum(int s, int k) {
    float p[CLUSTER];
    partials(s, k, p);
    float m = p[0];
#pragma unroll
    for (int r = 1; r < CLUSTER; ++r) m = fminf(m, p[r]);
    return m;
  }
};

// Rows of the thread's slice of the cluster's fields.
struct Rows {
  float* xs;
  float* ys;
  const float* us;
  const float* costs;
  const float* colls;
  int rows;
  int row0;
  int n;
};

// One round of `DEPTH` halvings of (lo, hi) in one reduction: the
// subtree's midpoints in heap order (node i's children 2i + 1 below its
// midpoint, 2i + 2 above it), a clipped sum for each, then the walk.
template <int DEPTH>
__device__ __forceinline__ void bisect_round(const Rows& w, Cluster& c,
                                             float budget, float& lo,
                                             float& hi) {
  constexpr int K = (1 << DEPTH) - 1;
  float mid[K], nlo[K], nhi[K];
  nlo[0] = lo;
  nhi[0] = hi;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    mid[i] = 0.5f * (nlo[i] + nhi[i]);
    if (2 * i + 2 < K) {
      nlo[2 * i + 1] = nlo[i];
      nhi[2 * i + 1] = mid[i];
      nlo[2 * i + 2] = mid[i];
      nhi[2 * i + 2] = nhi[i];
    }
  }
  float s[K];
#pragma unroll
  for (int i = 0; i < K; ++i) s[i] = 0.0f;
  for (int k = 0; k < w.rows; ++k) {
    if (w.row0 + k * SPAN >= w.n) break;
    const int j = k * THREADS + threadIdx.x;
    const float y = w.ys[j], u = w.us[j];
#pragma unroll
    for (int i = 0; i < K; ++i) s[i] += fminf(fmaxf(y - mid[i], 0.0f), u);
  }
  const int slot = c.exchange<K, 0>(s);
  int node = 0;
#pragma unroll
  for (int l = 0; l < DEPTH; ++l) {
    const float m = 0.5f * (lo + hi);
    if (c.sum(slot, node) > budget) {
      lo = m;
      node = 2 * node + 2;
    } else {
      hi = m;
      node = 2 * node + 1;
    }
  }
}

// The pass that ends an iterate: x = the projection of y at tau (PROJECT)
// or u * scale (the start), its objective's three partial sums, the next
// gradient step and its two minima, in one reduction. -> f(x); m_yu,
// m_ny: min(y' - u), min(-y').
template <bool PROJECT>
__device__ __forceinline__ float iterate_pass(
    const Rows& w, Cluster& c, float tau_or_scale, float curv,
    float w_f, float step, float half_curv, float half_w, float& m_yu,
    float& m_ny) {
  float v[5] = {0.0f, 0.0f, 0.0f, CUDART_INF_F, CUDART_INF_F};
  for (int k = 0; k < w.rows; ++k) {
    if (w.row0 + k * SPAN >= w.n) break;
    const int j = k * THREADS + threadIdx.x;
    const float u = w.us[j], cost = w.costs[j], coll = w.colls[j];
    const float x = PROJECT ? fminf(fmaxf(w.ys[j] - tau_or_scale, 0.0f), u)
                            : u * tau_or_scale;
    w.xs[j] = x;
    const float t = coll + x;
    v[0] += cost * x;
    v[1] += x * x;
    v[2] += t * t;
    const float g = __fmaf_rn(coll + x, w_f, __fmaf_rn(x, curv, cost));
    const float y = __fmaf_rn(-step, g, x);
    w.ys[j] = y;
    v[3] = fminf(v[3], y - u);
    v[4] = fminf(v[4], -y);
  }
  const int s = c.exchange<5, 2>(v);
  m_yu = c.minimum(s, 3);
  m_ny = c.minimum(s, 4);
  return __fmaf_rn(half_w, c.sum(s, 2), __fmaf_rn(c.sum(s, 1), half_curv,
                                                  c.sum(s, 0)));
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
  float* ys = base + rows_c;
  float* us = base + 2 * rows_c;
  float* costs = base + 3 * rows_c;
  float* colls = base + 4 * rows_c;
  Cluster c{sh, cluster, rank, 0, 0u};
  c.init();

  // per node: capacity and cost, as score_capacity.cu computes them
  float ask[NUM_XR];
#pragma unroll
  for (int r = 0; r < NUM_XR; ++r) ask[r] = a.ask[r];
  float sum_u[1] = {0.0f};
  for (int k = 0; k < rows; ++k) {
    const int i = row0 + k * SPAN;
    if (i >= n) break;
    const int j = k * THREADS + threadIdx.x;
    float cp[NUM_XR], u[NUM_XR];
#pragma unroll
    for (int r = 0; r < NUM_XR; ++r) {
      cp[r] = a.cap[(size_t)i * NUM_XR + r];
      u[r] = a.used[(size_t)i * NUM_XR + r];
    }
    float capacity = 1e9f;
#pragma unroll
    for (int r = 0; r < NUM_XR; ++r)
      if (ask[r] > 0.0f)
        capacity = fminf(capacity, floorf((cp[r] - u[r]) / ask[r]));
    if (a.feasible[i] == 0) capacity = 0.0f;
    const int32_t cap_i = min((int32_t)fmaxf(capacity, 0.0f), (int32_t)a.mpn);
    const float safe0 = cp[0] > 0.0f ? cp[0] : 1.0f;
    const float safe1 = cp[1] > 0.0f ? cp[1] : 1.0f;
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
  const float total_u = c.sum(c.exchange<1, 0>(sum_u), 0);
  float budget = fminf(fminf((float)a.count, a.quota), total_u);
  budget = fmaxf(budget, 0.0f);
  const float scale = budget / fmaxf(total_u, 1.0f);
  const float step = 1.0f / (a.w_f + a.step_c);
  const float half_curv = 0.5f * a.curv;
  const float half_w = a.w_f * 0.5f;
  const Rows w{xs, ys, us, costs, colls, rows, row0, n};

  float m_yu, m_ny;
  float f_old = iterate_pass<false>(w, c, scale, a.curv, a.w_f, step,
                                    half_curv, half_w, m_yu, m_ny);
  int it = 0;
  float gap = CUDART_INF_F;
  while (it < a.max_iters && gap > a.tol) {
    float lo = m_yu - 1.0f, hi = -m_ny + 1.0f;
    for (int r = 0; r < PROJECT_ITERS / LEVELS; ++r)
      bisect_round<LEVELS>(w, c, budget, lo, hi);
    if constexpr (PROJECT_ITERS % LEVELS != 0)
      bisect_round<PROJECT_ITERS % LEVELS>(w, c, budget, lo, hi);
    const float tau = 0.5f * (lo + hi);
    const float f_new = iterate_pass<true>(w, c, tau, a.curv, a.w_f, step,
                                           half_curv, half_w, m_yu, m_ny);
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
  // no block may leave while another can still read or write its shared
  // memory
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
