// The convex placement tier's solve with its node axis sharded: one
// reduction round on one shard, for Hopper, sm_90a.
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
// Design: the solo kernel's rounds (convex_solve.cu), with a kernel
// boundary for each cluster reduction. Each launch of a shard (one block
// of 1,024 threads, emulating the solo kernel's 8 x 1,024 threads over its
// block) reads the S partials of the round before from the shared slot
// buffer, combines them in the sharded order itself (every shard holds the
// same sums and takes the same branches, as every CTA of the solo
// cluster does), advances the solve and writes this round's partials into
// its slot:
//   INIT      u, the cost and the collisions of its rows; sum u;
//   START     the budget and x0 = u budget / sum u; the first iterate pass;
//   ITERATE   f(x'), the gap and the stopping test; the next bracket and
//             the first bisection round, or the outputs and the done flag;
//   BISECT    the walk of a round's 7 midpoints (LEVELS = 3 halvings; the
//             last of 17 rounds resolves 2), then the next round's 7 sums,
//             or after 50 halvings the iterate pass (x' = the projection,
//             f(x')'s three sums, y' and its two minima).
// A solve of i iterations is 3 + 18 i launches a shard; the launcher
// queues rounds in blocks and every launch past the done flag exits at
// once. Slots are double-buffered by round parity: a shard writes round
// r + 2's slot only after every shard's round r + 1 launch read round r's.
// On several cards each shard keeps its own slot buffer and its slot is
// peer-copied to the others after each launch, behind an event.
// Where XLA's CPU backend contracts the reference's multiply-adds, this
// kernel calls __fmaf_rn; everything else builds without FMA contraction or
// fast math.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "pow10.cuh"

#define THREADS 1024
#define WARPS (THREADS / 32)
#define VCTAS 8                    // the solo kernel's CTAs, emulated
#define SPAN (VCTAS * THREADS)     // rows one pass over the 8 x 1,024 covers
#define NUM_XR 5
#define PROJECT_ITERS 50
#define LEVELS 3
#define ROUNDS ((PROJECT_ITERS + LEVELS - 1) / LEVELS)   // 17
#define SLOT 8                     // floats a shard's partials take
#define MAX_SHARDS 16
#define FULL 0xffffffffu

enum { PH_INIT, PH_START, PH_ITER_FIRST, PH_ITER, PH_BISECT };

// the per-shard pointer table the launcher takes, NPTR entries a shard
enum {
  P_CAP, P_USED, P_ASK, P_FEAS, P_COLL, P_AFF, P_SCRATCH, P_SLOTS, P_X,
  P_U, P_COST, P_SCALARS, P_STREAM, NPTR
};

// a shard's running state, at the start of its scratch
struct CvxState {
  int phase, rno, round, it, done, early_exits, pad[2];
  float lo, hi, budget, step, f_old, gap, m_yu, m_ny;
};

struct CvxArgs {
  const float* cap;
  const float* used;
  const float* ask;
  const uint8_t* feasible;
  const int32_t* coll;
  const float* aff;
  unsigned char* scratch;       // state, then x, y, u, cost, coll [n] each
  float* slots;                 // [2][n_shards][SLOT]
  float* x_out;
  int32_t* u_out;
  float* cost_out;
  int32_t* scalars_out;         // budget_int, iterations, gap (float bits)
  int n, shard, n_shards, mpn, count, max_iters, spread;
  float tol, w_f, quota, curv, step_c, inv_max_score;
};

struct RedShared {
  float wp[VCTAS][7][WARPS];    // a virtual CTA's warp partials
  float cp[7][VCTAS];           // a virtual CTA's partial
};

// K values (sums, then NMIN minima) over this shard's rows in the solo
// kernel's tree: virtual thread c x 1,024 + threadIdx.x adds rows c x
// 1,024 + threadIdx.x + k x 8,192 in order; then xor halving over the
// lanes, over the warps, over the 8 virtual CTAs. `row(j, v)` adds row j
// into v. Every thread calls it; out[k] (the slot) gets the results.
template <int K, int NMIN, class F>
__device__ void reduce_rows(int n, RedShared& rs, F row, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < VCTAS; ++c) {
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = k < K - NMIN ? 0.0f : CUDART_INF_F;
    for (int j = c * THREADS + threadIdx.x; j < n; j += SPAN) row(j, v);
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float w = __shfl_xor_sync(FULL, v[k], o);
        v[k] = k >= K - NMIN ? fminf(v[k], w) : v[k] + w;
      }
      if (lane == 0) rs.wp[c][k][warp] = v[k];
    }
  }
  __syncthreads();
  if (warp < VCTAS) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = rs.wp[warp][k][lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float w = __shfl_xor_sync(FULL, v, o);
        v = k >= K - NMIN ? fminf(v, w) : v + w;
      }
      if (lane == 0) rs.cp[k][warp] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < K) {
    const int k = threadIdx.x;
    const float* p = rs.cp[k];
    float r;
    if (k >= K - NMIN) {
      r = p[0];
      for (int c = 1; c < VCTAS; ++c) r = fminf(r, p[c]);
    } else {
      const float q0 = p[0] + p[4], q1 = p[1] + p[5];
      const float q2 = p[2] + p[6], q3 = p[3] + p[7];
      r = (q0 + q2) + (q1 + q3);
    }
    out[k] = r;
  }
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
__device__ void iterate_pass(const CvxArgs& a, const Fields& w, RedShared& rs,
                             float tau_or_scale, float step, float* out) {
  const float curv = a.curv, w_f = a.w_f;
  reduce_rows<5, 2>(a.n, rs, [&](int j, float (&v)[5]) {
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
__device__ void bisect_sums(const CvxArgs& a, const Fields& w, RedShared& rs,
                            float lo, float hi, float* out) {
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
  reduce_rows<K, 0>(a.n, rs, [&](int j, float (&v)[K]) {
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
    convex_shard_kernel(const CvxArgs a) {
  __shared__ RedShared rs;
  CvxState* st = (CvxState*)a.scratch;
  if (st->done) {
    if (threadIdx.x == 0) st->early_exits += 1;
    return;
  }
  const int n = a.n, S = a.n_shards;
  float* base = (float*)(a.scratch + sizeof(CvxState));
  const Fields w{base, base + n, base + 2 * n, base + 3 * n, base + 4 * n};
  CvxState s = *st;
  const float* prev = a.slots + (size_t)((s.rno + 1) & 1) * S * SLOT;
  float* mine = a.slots + ((size_t)(s.rno & 1) * S + a.shard) * SLOT;
  bool reduced = true;

  if (s.phase == PH_INIT) {
    float ask[NUM_XR];
#pragma unroll
    for (int r = 0; r < NUM_XR; ++r) ask[r] = a.ask[r];
    reduce_rows<1, 0>(n, rs, [&](int i, float (&v)[1]) {
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
      const int32_t cap_i =
          min((int32_t)fmaxf(capacity, 0.0f), (int32_t)a.mpn);
      const float safe0 = cp[0] > 0.0f ? cp[0] : 1.0f;
      const float safe1 = cp[1] > 0.0f ? cp[1] : 1.0f;
      const float fp0 = 1.0f - (u[0] + ask[0]) / safe0;
      const float fp1 = 1.0f - (u[1] + ask[1]) / safe1;
      const float total = pow10_f32(fp0) + pow10_f32(fp1);
      const float raw = a.spread ? total - 2.0f : 20.0f - total;
      const float pref = fminf(fmaxf(raw, 0.0f), 18.0f);
      w.us[i] = (float)cap_i;
      w.costs[i] = __fmaf_rn(18.0f - pref, a.inv_max_score, -a.aff[i]);
      w.colls[i] = (float)a.coll[i];
      v[0] += (float)cap_i;
    }, mine);
    s.phase = PH_START;
  } else if (s.phase == PH_START) {
    const float total_u = combine(prev, S, 0, false);
    float budget = fminf(fminf((float)a.count, a.quota), total_u);
    s.budget = fmaxf(budget, 0.0f);
    s.step = 1.0f / (a.w_f + a.step_c);
    iterate_pass<false>(a, w, rs, s.budget / fmaxf(total_u, 1.0f), s.step,
                        mine);
    s.phase = PH_ITER_FIRST;
  } else if (s.phase == PH_ITER_FIRST || s.phase == PH_ITER) {
    const float half_curv = 0.5f * a.curv, half_w = a.w_f * 0.5f;
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
    if (s.it < a.max_iters && s.gap > a.tol) {
      s.lo = s.m_yu - 1.0f;
      s.hi = -s.m_ny + 1.0f;
      bisect_sums<LEVELS>(a, w, rs, s.lo, s.hi, mine);
      s.round = 1;
      s.phase = PH_BISECT;
    } else {
      // the solve is over: this shard's rows and the scalars out
      for (int j = threadIdx.x; j < n; j += THREADS) {
        a.x_out[j] = w.xs[j];
        a.u_out[j] = (int32_t)w.us[j];
        a.cost_out[j] = w.costs[j];
      }
      if (threadIdx.x == 0) {
        a.scalars_out[0] = (int32_t)s.budget;
        a.scalars_out[1] = s.it;
        a.scalars_out[2] = __float_as_int(s.gap);
      }
      s.done = 1;
      reduced = false;
    }
  } else {
    bisect_walk(prev, S, round_depth(s.round - 1), s.budget, s.lo, s.hi);
    if (s.round < ROUNDS) {
      if (round_depth(s.round) == LEVELS)
        bisect_sums<LEVELS>(a, w, rs, s.lo, s.hi, mine);
      else
        bisect_sums<PROJECT_ITERS % LEVELS>(a, w, rs, s.lo, s.hi, mine);
      ++s.round;
    } else {
      iterate_pass<true>(a, w, rs, 0.5f * (s.lo + s.hi), s.step, mine);
      s.phase = PH_ITER;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (reduced) ++s.rno;
    *st = s;
  }
}

// Bytes of scratch a shard of n rows needs: its state and five fields.
extern "C" long long convex_shard_scratch_bytes(int n) {
  return (long long)sizeof(CvxState) + 5LL * 4 * n;
}

// The byte offset of the done flag in a shard's scratch (the launcher's
// caller copies the lead's to the host once a block of rounds).
extern "C" long long convex_shard_done_offset(void) {
  return (long long)offsetof(CvxState, done);
}

// Queue `n_rounds` rounds of one sharded solve, one launch a shard a round
// in shard order; rounds `first_round`.. of the solve (the first call of a
// solve passes 0: its launch 0 of each shard starts from a zeroed state).
// No host wait. `ptrs` is [n_shards][NPTR] (the enum above; P_STREAM the
// shard's cudaStream_t), `devs` the shards' device ordinals: where they
// are all equal every P_SLOTS names one shared [2][n_shards][8] float
// buffer; else each shard's own, and slots travel by peer copy. Per shard:
// cap, used [n, 5] f32; ask [5]; feasible [n] u8; coll [n] i32; aff [n]
// f32; x, cost [n] f32 and u [n] i32 out; scalars [4] i32 out; scratch of
// convex_shard_scratch_bytes(n), its state zeroed before round 0.
// *launches_out gets the launches queued. Returns a cudaError_t.
extern "C" int convex_shard_launch(
    const unsigned long long* ptrs, const int* devs, int n_shards, int n,
    int max_per_node, int count, int max_iters, int spread, float tol,
    float w_f, float quota, float curv, float step_c, float inv_max_score,
    int first_round, int n_rounds, int* launches_out) {
  *launches_out = 0;
  if (n <= 0 || n_shards < 1 || n_shards > MAX_SHARDS || n_rounds < 0 ||
      first_round < 0)
    return (int)cudaErrorInvalidValue;
  bool shared = true;
  for (int s = 1; s < n_shards; ++s) shared = shared && devs[s] == devs[0];
  int prev_dev = 0;
  cudaError_t err = cudaGetDevice(&prev_dev);
  if (err != cudaSuccess) return (int)err;
  CvxArgs args[MAX_SHARDS];
  cudaEvent_t ev[MAX_SHARDS] = {};
  for (int s = 0; s < n_shards; ++s) {
    const unsigned long long* p = ptrs + (size_t)s * NPTR;
    CvxArgs& a = args[s];
    a.cap = (const float*)p[P_CAP];
    a.used = (const float*)p[P_USED];
    a.ask = (const float*)p[P_ASK];
    a.feasible = (const uint8_t*)p[P_FEAS];
    a.coll = (const int32_t*)p[P_COLL];
    a.aff = (const float*)p[P_AFF];
    a.scratch = (unsigned char*)p[P_SCRATCH];
    a.slots = (float*)p[P_SLOTS];
    a.x_out = (float*)p[P_X];
    a.u_out = (int32_t*)p[P_U];
    a.cost_out = (float*)p[P_COST];
    a.scalars_out = (int32_t*)p[P_SCALARS];
    a.n = n;
    a.shard = s;
    a.n_shards = n_shards;
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
    if (!shared) {
      err = cudaSetDevice(devs[s]);
      if (err == cudaSuccess)
        err = cudaEventCreateWithFlags(&ev[s], cudaEventDisableTiming);
      // the rounds of an earlier call on every other shard's stream come
      // before this call's first round
      if (err == cudaSuccess)
        err = cudaEventRecord(ev[s], (cudaStream_t)p[P_STREAM]);
      if (err != cudaSuccess) break;
    }
  }
  int launches = 0;
  const size_t slot = SLOT * sizeof(float);
  for (int r = first_round; r < first_round + n_rounds && err == cudaSuccess;
       ++r) {
    for (int s = 0; s < n_shards && err == cudaSuccess; ++s) {
      cudaStream_t stream = (cudaStream_t)ptrs[(size_t)s * NPTR + P_STREAM];
      if (!shared) {
        err = cudaSetDevice(devs[s]);
        for (int q = 0; q < n_shards && err == cudaSuccess; ++q)
          if (q != s) err = cudaStreamWaitEvent(stream, ev[q], 0);
        if (err != cudaSuccess) break;
      }
      convex_shard_kernel<<<1, THREADS, 0, stream>>>(args[s]);
      err = cudaGetLastError();
      if (err != cudaSuccess) break;
      ++launches;
      if (!shared) {
        // this shard's partials of round r into every other shard's buffer
        // (rounds past the done flag write none; their copies are idle)
        const size_t off = ((size_t)(r & 1) * n_shards + s) * SLOT;
        for (int q = 0; q < n_shards && err == cudaSuccess; ++q)
          if (q != s)
            err = cudaMemcpyPeerAsync(args[q].slots + off, devs[q],
                                      args[s].slots + off, devs[s], slot,
                                      stream);
        if (err == cudaSuccess) err = cudaEventRecord(ev[s], stream);
      }
    }
  }
  for (int s = 0; s < n_shards; ++s)
    if (ev[s]) cudaEventDestroy(ev[s]);
  cudaSetDevice(prev_dev);
  *launches_out = launches;
  return (int)err;
}
