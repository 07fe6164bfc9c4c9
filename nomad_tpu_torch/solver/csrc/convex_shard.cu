// The convex placement tier's solve with its node axis sharded: one
// reduction round of every shard a device holds in one launch, for Hopper,
// sm_90a.
//
// Replaces the reference's sharded convex solve, nomad_tpu/solver/
// sharding.py:546 `sharded_convex`: convex_eval's lax.while_loop
// (nomad_tpu/solver/convex.py:129, loop :182; one XLA program, no Pallas
// kernel) under a node-axis sharding, where GSPMD turns every global sum of
// the iteration into a psum. convex.py `convex_solve_sharded_ref` is the
// plain version: this kernel returns what it returns, bit for bit (the
// final iterate, u, the cost, the integral budget, the iteration count and
// the gap), in the sharded sum order convex.py `sharded_tree_sum` defines:
// on each shard, the solo kernel's own tree over the shard's row block
// (row j to thread j mod 8,192: a thread adds its rows in order, then
// halving across the lanes of a warp, the warps of a block, the 8 blocks);
// then the S shard partials halving in shard order where S is a power of
// two, else left to right. The placements it leads to equal the solo
// solve's (the reference's own sharded solve also sums in another order
// than its solo one, and its tests hold the placements alike).
//
// What bounds it on this card: the chain of dependent reductions, as the
// solo solve (convex_solve.cu); each round's launch is the barrier across
// the shards. Design: one launch a round a device; in it one cluster of 8
// CTAs x 1,024 threads a shard, the shard named by the cluster's index, so
// the shards' rounds run side by side and each shard's reduction is the
// solo kernel's: row j of the shard's block to CTA (j / 1,024) mod 8,
// thread j mod 1,024, each thread adding its rows in order, then
// convex_solve.cu's butterfly over the lanes and over the warps, and its
// pushed partials (st.async into a transaction barrier, `mbarrier`) to
// CTA 0, which combines the 8 blocks' partials in tree_sum's order and
// writes the shard's values into its slot. Only CTA 0 needs the shard's
// sums within the round (every CTA of every shard reads the S slots at the
// start of the next launch), so the blocks push to it alone. Each CTA
// reads the S partials of the round before, combines them in the sharded
// order itself (every CTA holds the same sums and takes the same branches,
// as every CTA of the solo cluster does), advances the solve and adds its
// rows into this round's sums:
//   INIT      u, the cost and the collisions of its rows; sum u;
//   START     the budget and x0 = u budget / sum u; the first iterate pass;
//   ITERATE   f(x'), the gap and the stopping test; the next bracket and
//             the first bisection round, or the outputs and the done flag;
//   BISECT    the walk of a round's 7 midpoints (LEVELS = 3 halvings; the
//             last of 17 rounds resolves 2), then the next round's 7 sums,
//             or after 50 halvings the iterate pass (x' = the projection,
//             f(x')'s three sums, y' and its two minima).
// A solve of i iterations is 3 + 18 i launches a device; the launcher
// queues rounds in blocks and every launch past the done flag exits at
// once. Slots are double-buffered by round parity: a shard writes round
// r + 2's slot only after every shard's round r + 1 read round r's, which
// the kernel boundary between the two rounds' launches keeps. On several
// cards each device keeps its own slot buffer and launches its own shards;
// its slots are peer-copied to the others after each launch, behind an
// event. Where XLA's CPU backend contracts the reference's multiply-adds,
// this kernel calls __fmaf_rn; everything else builds without FMA
// contraction or fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
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
#define LEVELS 3
#define ROUNDS ((PROJECT_ITERS + LEVELS - 1) / LEVELS)   // 17
#define MAX_K ((1 << LEVELS) - 1)  // values one reduction carries
#define ROW_K (MAX_K + 1)          // a warp's partials: 32 bytes
#define SLOT 8                     // floats a shard's partials take
#define MAX_SHARDS 16

enum { PH_INIT, PH_START, PH_ITER_FIRST, PH_ITER, PH_BISECT };

// the per-shard pointer table the launcher takes, NPTR entries a shard
enum {
  P_CAP, P_USED, P_ASK, P_FEAS, P_COLL, P_AFF, P_SCRATCH, P_SLOTS, P_X,
  P_U, P_COST, P_SCALARS, P_STREAM, NPTR
};

// a CTA's running state; the shard's scratch starts with CLUSTER of them
// (CTA 0's first: the launcher's caller reads its done flag)
struct CvxState {
  int phase, rno, round, it, done, early_exits, pad[2];
  float lo, hi, budget, step, f_old, gap, m_yu, m_ny;
};

struct CvxPtrs {
  const float* cap;
  const float* used;
  const float* ask;
  const uint8_t* feasible;
  const int32_t* coll;
  const float* aff;
  unsigned char* scratch;       // states, then x, y, u, cost, coll [n] each
  float* slots;                 // [2][n_shards][SLOT]
  float* x_out;
  int32_t* u_out;
  float* cost_out;
  int32_t* scalars_out;         // budget_int, iterations, gap (float bits)
  int shard;                    // the shard's index in the solve
  int pad;
};

// one launch: the shards of one device, a cluster each
struct CvxBatch {
  CvxPtrs sh[MAX_SHARDS];
  int n, n_shards, mpn, count, max_iters, spread;
  float tol, w_f, quota, curv, step_c, inv_max_score;
};

struct __align__(16) ReduceShared {
  float warp_part[WARPS][ROW_K];
  float part[ROW_K][CLUSTER];   // CTA 0: every block's partials
  unsigned long long bar;       // CTA 0: the partials' transaction barrier
};

// A shard's reduction in its cluster, convex_solve.cu's `Cluster` with one
// reduction a launch and one receiver: begin() makes CTA 0's transaction
// barrier and arrives at the cluster barrier (the rows' pass overlaps it);
// exchange() reduces a CTA's K values over its warps, pushes them into CTA
// 0's shared memory, and CTA 0 combines the 8 blocks' partials into `out`.
struct ShardReduce {
  ReduceShared& sh;
  int rank;

  __device__ void begin() {
    if (rank == 0 && threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&sh.bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  }

  template <int K, int NMIN>
  __device__ __forceinline__ void exchange(const float (&in)[K],
                                           float* out) {
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
    // CTA 0's barrier exists before any block pushes into it
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
    const uint32_t bar = smem_u32(&sh.bar);
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
      if (k < K && (lane & (GROUP - 1)) == 0)
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
            " [%0], %1, [%2];"
            :: "r"(peer_u32(smem_u32(&sh.part[k][rank]), 0)),
               "r"(__float_as_uint(v[0])), "r"(peer_u32(bar, 0))
            : "memory");
      if (rank == 0 && lane == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
            :: "r"(bar), "r"(CLUSTER * K * 4) : "memory");
    }
    if (rank != 0) return;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
          " p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bar), "r"(0u) : "memory");
    }
    if (threadIdx.x < K) {
      k = threadIdx.x;
      const float4 a = *reinterpret_cast<const float4*>(&sh.part[k][0]);
      const float4 b = *reinterpret_cast<const float4*>(&sh.part[k][4]);
      const float p[CLUSTER] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      float r;
      if (k >= K - NMIN) {
        r = p[0];
#pragma unroll
        for (int c = 1; c < CLUSTER; ++c) r = fminf(r, p[c]);
      } else {
        const float q0 = p[0] + p[4], q1 = p[1] + p[5];
        const float q2 = p[2] + p[6], q3 = p[3] + p[7];
        r = (q0 + q2) + (q1 + q3);
      }
      out[k] = r;
    }
  }
};

// K values (sums, then NMIN minima) over the rows this thread owns in its
// shard's block (rank x 1,024 + threadIdx.x + k x 8,192, in order), then
// the shard's reduction; `row(j, v)` adds row j into v. Every thread of
// the cluster calls it; CTA 0 writes the shard's values into `out`.
template <int K, int NMIN, class F>
__device__ __forceinline__ void reduce_rows(ShardReduce& red, int n, F row,
                                            float* out) {
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = k < K - NMIN ? 0.0f : CUDART_INF_F;
  for (int j = red.rank * THREADS + threadIdx.x; j < n; j += SPAN) row(j, v);
  red.exchange<K, NMIN>(v, out);
}

// The S shards' partial k of a round, combined in the sharded order: a sum
// halving in shard order (S a power of two) or left to right; a minimum.
__device__ __forceinline__ float combine(const float* slots, int S, int k,
                                         bool minimum) {
  float p[MAX_SHARDS];
  for (int s = 0; s < S; ++s) p[s] = slots[s * SLOT + k];
  if (minimum) {
    float m = p[0];
    for (int s = 1; s < S; ++s) m = fminf(m, p[s]);
    return m;
  }
  if ((S & (S - 1)) == 0) {
    for (int h = S / 2; h >= 1; h /= 2)
      for (int i = 0; i < h; ++i) p[i] = p[i] + p[i + h];
    return p[0];
  }
  float acc = p[0];
  for (int s = 1; s < S; ++s) acc = acc + p[s];
  return acc;
}

struct Fields {
  float* xs;
  float* ys;
  float* us;
  float* costs;
  float* colls;
};

// The pass that ends an iterate: x = the projection of y at tau (PROJECT)
// or u * scale (the start), f(x)'s three sums, the next gradient step and
// its two minima, min(y' - u) and min(-y').
template <bool PROJECT>
__device__ void iterate_pass(const CvxBatch& b, const Fields& w,
                             ShardReduce& red, float tau_or_scale,
                             float step, float* out) {
  const float curv = b.curv, w_f = b.w_f;
  reduce_rows<5, 2>(red, b.n, [&](int j, float (&v)[5]) {
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
  }, out);
}

// One bisection round of DEPTH halvings below (lo, hi): the subtree's
// midpoints in heap order, a clipped sum for each.
template <int DEPTH>
__device__ void bisect_sums(const CvxBatch& b, const Fields& w,
                            ShardReduce& red, float lo, float hi,
                            float* out) {
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
  reduce_rows<K, 0>(red, b.n, [&](int j, float (&v)[K]) {
    const float y = w.ys[j], u = w.us[j];
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] += fminf(fmaxf(y - mid[i], 0.0f), u);
  }, out);
}

// The walk of a round of `depth` halvings with the round's sums.
__device__ __forceinline__ void bisect_walk(const float* slots, int S,
                                            int depth, float budget,
                                            float& lo, float& hi) {
  int node = 0;
  for (int l = 0; l < depth; ++l) {
    const float m = 0.5f * (lo + hi);
    if (combine(slots, S, node, false) > budget) {
      lo = m;
      node = 2 * node + 2;
    } else {
      hi = m;
      node = 2 * node + 1;
    }
  }
}

__device__ __forceinline__ int round_depth(int round) {
  return round < PROJECT_ITERS / LEVELS ? LEVELS : PROJECT_ITERS % LEVELS;
}

__global__ void __launch_bounds__(THREADS, 1)
    convex_shard_kernel(const __grid_constant__ CvxBatch b, int r) {
  __shared__ ReduceShared rs;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const CvxPtrs& a = b.sh[blockIdx.x / CLUSTER];
  CvxState* st = (CvxState*)a.scratch + rank;
  if (r > 0 && st->done) {
    if (rank == 0 && threadIdx.x == 0) st->early_exits += 1;
    return;
  }
  const int n = b.n, S = b.n_shards;
  float* base = (float*)(a.scratch + CLUSTER * sizeof(CvxState));
  const Fields w{base, base + n, base + 2 * n, base + 3 * n, base + 4 * n};
  CvxState s = r == 0 ? CvxState{} : *st;
  const float* prev = a.slots + (size_t)((s.rno + 1) & 1) * S * SLOT;
  float* mine = a.slots + ((size_t)(s.rno & 1) * S + a.shard) * SLOT;
  ShardReduce red{rs, rank};

  // an iterate's objective and stopping test come first: a round that
  // ends the solve reduces nothing
  bool reduced = true;
  if (s.phase == PH_ITER_FIRST || s.phase == PH_ITER) {
    const float half_curv = 0.5f * b.curv, half_w = b.w_f * 0.5f;
    const float f = __fmaf_rn(
        half_w, combine(prev, S, 2, false),
        __fmaf_rn(combine(prev, S, 1, false), half_curv,
                  combine(prev, S, 0, false)));
    s.m_yu = combine(prev, S, 3, true);
    s.m_ny = combine(prev, S, 4, true);
    if (s.phase == PH_ITER_FIRST) {
      s.gap = CUDART_INF_F;
    } else {
      s.gap = fabsf(s.f_old - f) / (1.0f + fabsf(f));
      ++s.it;
    }
    s.f_old = f;
    reduced = s.it < b.max_iters && s.gap > b.tol;
  }
  if (reduced) red.begin();

  if (s.phase == PH_INIT) {
    float ask[NUM_XR];
#pragma unroll
    for (int x = 0; x < NUM_XR; ++x) ask[x] = a.ask[x];
    reduce_rows<1, 0>(red, n, [&](int i, float (&v)[1]) {
      float cp[NUM_XR], u[NUM_XR];
#pragma unroll
      for (int x = 0; x < NUM_XR; ++x) {
        cp[x] = a.cap[(size_t)i * NUM_XR + x];
        u[x] = a.used[(size_t)i * NUM_XR + x];
      }
      float capacity = 1e9f;
#pragma unroll
      for (int x = 0; x < NUM_XR; ++x)
        if (ask[x] > 0.0f)
          capacity = fminf(capacity, floorf((cp[x] - u[x]) / ask[x]));
      if (a.feasible[i] == 0) capacity = 0.0f;
      const int32_t cap_i =
          min((int32_t)fmaxf(capacity, 0.0f), (int32_t)b.mpn);
      const float safe0 = cp[0] > 0.0f ? cp[0] : 1.0f;
      const float safe1 = cp[1] > 0.0f ? cp[1] : 1.0f;
      const float fp0 = 1.0f - (u[0] + ask[0]) / safe0;
      const float fp1 = 1.0f - (u[1] + ask[1]) / safe1;
      const float total = pow10_f32(fp0) + pow10_f32(fp1);
      const float raw = b.spread ? total - 2.0f : 20.0f - total;
      const float pref = fminf(fmaxf(raw, 0.0f), 18.0f);
      w.us[i] = (float)cap_i;
      w.costs[i] = __fmaf_rn(18.0f - pref, b.inv_max_score, -a.aff[i]);
      w.colls[i] = (float)a.coll[i];
      v[0] += (float)cap_i;
    }, mine);
    s.phase = PH_START;
  } else if (s.phase == PH_START) {
    const float total_u = combine(prev, S, 0, false);
    float budget = fminf(fminf((float)b.count, b.quota), total_u);
    s.budget = fmaxf(budget, 0.0f);
    s.step = 1.0f / (b.w_f + b.step_c);
    iterate_pass<false>(b, w, red, s.budget / fmaxf(total_u, 1.0f), s.step,
                        mine);
    s.phase = PH_ITER_FIRST;
  } else if (s.phase == PH_ITER_FIRST || s.phase == PH_ITER) {
    if (reduced) {
      s.lo = s.m_yu - 1.0f;
      s.hi = -s.m_ny + 1.0f;
      bisect_sums<LEVELS>(b, w, red, s.lo, s.hi, mine);
      s.round = 1;
      s.phase = PH_BISECT;
    } else {
      // the solve is over: this CTA's rows and the scalars out
      for (int j = rank * THREADS + threadIdx.x; j < n; j += SPAN) {
        a.x_out[j] = w.xs[j];
        a.u_out[j] = (int32_t)w.us[j];
        a.cost_out[j] = w.costs[j];
      }
      if (rank == 0 && threadIdx.x == 0) {
        a.scalars_out[0] = (int32_t)s.budget;
        a.scalars_out[1] = s.it;
        a.scalars_out[2] = __float_as_int(s.gap);
      }
      s.done = 1;
    }
  } else {
    bisect_walk(prev, S, round_depth(s.round - 1), s.budget, s.lo, s.hi);
    if (s.round < ROUNDS) {
      if (round_depth(s.round) == LEVELS)
        bisect_sums<LEVELS>(b, w, red, s.lo, s.hi, mine);
      else
        bisect_sums<PROJECT_ITERS % LEVELS>(b, w, red, s.lo, s.hi, mine);
      ++s.round;
    } else {
      iterate_pass<true>(b, w, red, 0.5f * (s.lo + s.hi), s.step, mine);
      s.phase = PH_ITER;
    }
  }
  if (threadIdx.x == 0) {
    if (reduced) ++s.rno;
    *st = s;
  }
}

// Bytes of scratch a shard of n rows needs: its CTAs' states and five
// fields.
extern "C" long long convex_shard_scratch_bytes(int n) {
  return (long long)CLUSTER * sizeof(CvxState) + 5LL * 4 * n;
}

// The byte offset of the done flag in a shard's scratch (the launcher's
// caller copies the lead's to the host once a block of rounds).
extern "C" long long convex_shard_done_offset(void) {
  return (long long)offsetof(CvxState, done);
}

// Queue `n_rounds` rounds of one sharded solve, rounds `first_round`.. of
// the solve (round 0 starts every CTA from a zeroed state), one launch a
// device a round, each a cluster of CLUSTER x THREADS for every shard the
// device holds. No host wait. `ptrs` is [n_shards][NPTR] (the enum above;
// P_STREAM the shard's cudaStream_t), `devs` the shards' device ordinals.
// Shards of one device share its P_SLOTS buffer ([2][n_shards][8] floats)
// and its stream (the first of its shards' P_STREAM); where the shards
// span several devices each device's slots travel to the others by peer
// copy. Per shard: cap, used [n, 5] f32; ask [5]; feasible [n] u8; coll
// [n] i32; aff [n] f32; x, cost [n] f32 and u [n] i32 out; scalars [4] i32
// out; scratch of convex_shard_scratch_bytes(n). *launches_out gets the
// launches queued. Returns a cudaError_t.
extern "C" int convex_shard_launch(
    const unsigned long long* ptrs, const int* devs, int n_shards, int n,
    int max_per_node, int count, int max_iters, int spread, float tol,
    float w_f, float quota, float curv, float step_c, float inv_max_score,
    int first_round, int n_rounds, int* launches_out) {
  *launches_out = 0;
  if (n <= 0 || n_shards < 1 || n_shards > MAX_SHARDS || n_rounds < 0 ||
      first_round < 0)
    return (int)cudaErrorInvalidValue;
  // the devices in order of their first shard, and each one's shards
  int dev_of[MAX_SHARDS], group[MAX_SHARDS], n_dev = 0;
  for (int s = 0; s < n_shards; ++s) {
    int g = 0;
    while (g < n_dev && dev_of[g] != devs[s]) ++g;
    if (g == n_dev) dev_of[n_dev++] = devs[s];
    group[s] = g;
  }
  int prev_dev = 0;
  cudaError_t err = cudaGetDevice(&prev_dev);
  if (err != cudaSuccess) return (int)err;
  CvxBatch batch[MAX_SHARDS];
  cudaStream_t stream[MAX_SHARDS];
  float* slots[MAX_SHARDS];
  int local[MAX_SHARDS] = {};
  for (int s = 0; s < n_shards; ++s) {
    const unsigned long long* p = ptrs + (size_t)s * NPTR;
    const int g = group[s];
    CvxBatch& b = batch[g];
    if (local[g] == 0) {
      stream[g] = (cudaStream_t)p[P_STREAM];
      slots[g] = (float*)p[P_SLOTS];
      b.n = n;
      b.n_shards = n_shards;
      b.mpn = max_per_node;
      b.count = count;
      b.max_iters = max_iters;
      b.spread = spread;
      b.tol = tol;
      b.w_f = w_f;
      b.quota = quota;
      b.curv = curv;
      b.step_c = step_c;
      b.inv_max_score = inv_max_score;
    }
    CvxPtrs& a = b.sh[local[g]++];
    a.cap = (const float*)p[P_CAP];
    a.used = (const float*)p[P_USED];
    a.ask = (const float*)p[P_ASK];
    a.feasible = (const uint8_t*)p[P_FEAS];
    a.coll = (const int32_t*)p[P_COLL];
    a.aff = (const float*)p[P_AFF];
    a.scratch = (unsigned char*)p[P_SCRATCH];
    a.slots = slots[g];
    a.x_out = (float*)p[P_X];
    a.u_out = (int32_t*)p[P_U];
    a.cost_out = (float*)p[P_COST];
    a.scalars_out = (int32_t*)p[P_SCALARS];
    a.shard = s;
    a.pad = 0;
  }
  cudaEvent_t ev[MAX_SHARDS] = {};
  for (int g = 0; g < n_dev && n_dev > 1 && err == cudaSuccess; ++g) {
    err = cudaSetDevice(dev_of[g]);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&ev[g], cudaEventDisableTiming);
    // the rounds of an earlier call on every other device's stream come
    // before this call's first round
    if (err == cudaSuccess) err = cudaEventRecord(ev[g], stream[g]);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int launches = 0;
  const size_t slot = SLOT * sizeof(float);
  for (int r = first_round; r < first_round + n_rounds && err == cudaSuccess;
       ++r) {
    for (int g = 0; g < n_dev && err == cudaSuccess; ++g) {
      if (n_dev > 1) {
        err = cudaSetDevice(dev_of[g]);
        for (int h = 0; h < n_dev && err == cudaSuccess; ++h)
          if (h != g) err = cudaStreamWaitEvent(stream[g], ev[h], 0);
        if (err != cudaSuccess) break;
      }
      cfg.gridDim = dim3(CLUSTER * local[g], 1, 1);
      cfg.stream = stream[g];
      err = cudaLaunchKernelEx(&cfg, convex_shard_kernel, batch[g], r);
      if (err == cudaSuccess) err = cudaGetLastError();
      if (err != cudaSuccess) break;
      ++launches;
      if (n_dev > 1) {
        // this device's partials of round r into every other device's
        // buffer (rounds past the done flag write none; their copies are
        // idle)
        for (int i = 0; i < local[g] && err == cudaSuccess; ++i) {
          const size_t off =
              ((size_t)(r & 1) * n_shards + batch[g].sh[i].shard) * SLOT;
          for (int h = 0; h < n_dev && err == cudaSuccess; ++h)
            if (h != g)
              err = cudaMemcpyPeerAsync(slots[h] + off, dev_of[h],
                                        slots[g] + off, dev_of[g], slot,
                                        stream[g]);
        }
        if (err == cudaSuccess) err = cudaEventRecord(ev[g], stream[g]);
      }
    }
  }
  for (int g = 0; g < n_dev; ++g)
    if (ev[g]) cudaEventDestroy(ev[g]);
  cudaSetDevice(prev_dev);
  *launches_out = launches;
  return (int)err;
}
