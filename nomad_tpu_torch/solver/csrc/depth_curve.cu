// Depth-curve kernel (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel nomad_tpu/solver/pallas_kernels.py
// `_depth_curve_kernel` (reached through `fill_depth_fused`), the
// producer of the depth solver's per-node summaries: for every node, the
// exact instance capacity, the mean-score curve over depths k (binpack or
// spread base score with the k-th instance placed, job anti-affinity,
// affinity boost), its prefix sum F(k), and the best density F(k)/k.
//
// What bounds it on this card: the latency of each block's phases and the
// float64 pipe, not bytes. A node is 2 rows of 5 floats in and 3 words out
// (about 56 bytes); its curve costs two 10**x per fitting depth, up to
// K = 512 depths. On the 50k eval's inputs that is ~350k fitting depths
// over 10,000 live nodes (~35 each, at most 128). A first design with one
// thread per node ran each warp as long as its deepest node, with every
// float64 pow on one thread's dependent chain and 4 warps per SM to hide
// it (0.126 ms on an H100); spreading the same pows over (node, depth)
// left the float64 pipe as the limit, so 10**x now comes from pow10.cuh's
// cheap estimate, exact by construction and checked on every float32
// input.
//
// Design: parallel over (node, depth), the prefix scan serial per node.
// A block owns GROUP = 8 nodes and runs THREADS = 128 threads, so the
// 16,384-node bucket is 2,048 blocks (1,250 with live nodes), ~10 per SM:
// while one block walks its prefix sums, others evaluate scores. (GROUP
// must stay a power of two <= 32: warp 0 holds the group.)
//   phase 0  warp 0 reads one node per lane: capacity, k_cap, the node's
//            count of fitting depths (fitting depths are a prefix of the
//            depth axis), and the per-node score terms into shared memory.
//   per chunk of CHUNK depths (the block walks only as deep as its deepest
//   node, so K = 256 and 512 take more chunks, not more shared memory):
//   phase A  warp 0 scans the group's depth counts within the chunk
//            (exclusive, integer shuffles), and all threads evaluate the
//            flattened (node, depth) pairs of the chunk, so no thread
//            idles on a shallow node while a deep one runs. Scores go to
//            shared memory as [GROUP][CHUNK + 1] floats: the +1 makes
//            phase B's column reads hit distinct banks.
//   phase B  one lane per node runs the float32 prefix sum (dense) or
//            trapezoid sum (grid) along its row, left to right, in place:
//            a chain of adds only, eight loads ahead. Its running state
//            carries across chunks in registers.
//   phase C  one warp per node divides the row by its depths and takes the
//            first arg-max (the largest density, the lowest depth among
//            equals: what a strict `>` walk and jnp.argmax give), merged
//            with the earlier chunks' best by strict `>`.
// Rounding order is the invariant: every score is computed with the same
// float32 operations as the plain version (kernels.depth_curve_ref) and
// the prefix sums run left to right in float32, so d_star and k_star keep
// every rounding. A parallel (shuffle) scan would change the summation
// order, and with it k_star on near ties; the arg-max has no rounding, so
// it may run in parallel. Build without fast math and without FMA
// contraction so each rounding matches.
// The grid variant (the sampled DEPTH_GRID, at most MAX_GRID depths, one
// chunk) gets its depths by value and integrates across the gaps by
// trapezoids: F_t = F_0 + sum_{u<=t} (s_u + s_{u-1}) / 2 * (g_u - g_{u-1}).
// d_star is written as -inf where no depth fits.
//
// Output: one int32 [3, n] buffer: row 0 d_star (float32 bits), row 1
// k_star, row 2 k_cap.
//
// Lanes: the eval-stream micro-batch window, which the reference runs as
// one jit(vmap(fill_depth)) program (nomad_tpu/solver/microbatch.py
// `_batched_fn`), is one launch here: a second grid axis over L lanes of
// stacked [L, n, 5] / [L, n] inputs, each lane with its own ask row,
// desired count and max_per_node (the solve's other statics, k_max, the
// grid and the algorithm, are one key of the window). Block (x, y) runs
// exactly what block x runs on lane y's slices, so every lane's output is
// bit-equal to a launch of that lane alone. A solo solve is a launch of
// one lane. The window has only its live lanes: a launch takes any lane
// count up to MAX_LANES, so nothing is padded to a fixed shape.
//
// Gather entry: the whole-eval fused route (the reference's
// kernels.fused_eval_depth, one XLA program that inlines gather_rows into
// the solve) reads the state cache's resident twins directly. Lane l's
// row b is row idx[l, b] of the twins, or a zero row where valid[l, b] is
// false, exactly the rows kernels.gather_rows would build; the gathered
// [B, 5] copies are never written to memory. The twins are one pair for
// every lane (they are not offset by the lane); idx, valid and the
// lane's other columns are. Only phase 0 reads cap and used, so the
// entry changes nothing after it, and every output equals the plain
// entry's on the gathered rows bit for bit. An index outside the twins
// is clamped to them, as XLA's gather clamps (the placer never passes
// one).
//
// ptxas (CUDA 12.8, sm_90a, -Xptxas -v): 48 registers, 4,488 bytes of
// shared memory, no spills, for both entries.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pow10.cuh"

#define NUM_XR 5
#define MAX_GRID 32
#define GROUP 8
#define THREADS 128
#define WARPS (THREADS / 32)
#define CHUNK 128
#define ROW (CHUNK + 1)
#define UNROLL 8
#define FULL_MASK 0xffffffffu
#define MAX_LANES 8        // buckets.BATCH_LANES: the largest window

struct DepthGrid {
  int n;                  // 0 = dense depths 1..k_max
  float g[MAX_GRID];
};

// per-lane scalars, by value (lane y reads entry y). The kernel takes it
// as a __grid_constant__ parameter, so entry blockIdx.y is one indexed
// load from the parameter bank; passed as a plain by-value struct of 8
// entries, nvcc split it into scalars and picked entry y through chains
// of compares and predicated loads, which made every launch ~7% slower
// on an H100 (PERF.md §6).
struct LaneScalars {
  float desired[MAX_LANES];
  float mpn[MAX_LANES];
};

template <bool GATHER>
__global__ void __launch_bounds__(THREADS) depth_curve_kernel(
    const float* __restrict__ cap, const float* __restrict__ used,
    int n_res, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ valid,
    const float* __restrict__ ask, const uint8_t* __restrict__ feasible,
    const int32_t* __restrict__ coll, const float* __restrict__ aff,
    int n, const __grid_constant__ LaneScalars lanes, int k_max,
    DepthGrid grid, int spread, int32_t* __restrict__ out) {
  __shared__ float s_u0[GROUP], s_u1[GROUP], s_safe0[GROUP], s_safe1[GROUP];
  __shared__ float s_cf[GROUP], s_aff[GROUP], s_aff_on[GROUP];
  __shared__ float s_best[GROUP], s_kbest[GROUP];
  __shared__ int s_depth[GROUP];
  __shared__ int s_off[GROUP + 1];
  __shared__ int s_max_depth;
  __shared__ float s_curve[GROUP * ROW];

  // the lane's slices (a solo solve is one lane, y = 0)
  const int ly = blockIdx.y;
  if (GATHER) {
    idx += (size_t)ly * n;         // the twins are shared by every lane
    valid += (size_t)ly * n;
  } else {
    cap += (size_t)ly * n * NUM_XR;
    used += (size_t)ly * n * NUM_XR;
  }
  ask += (size_t)ly * NUM_XR;
  feasible += (size_t)ly * n;
  coll += (size_t)ly * n;
  aff += (size_t)ly * n;
  out += (size_t)ly * 3 * n;
  const float desired = lanes.desired[ly];
  const float mpn = lanes.mpn[ly];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool mine = tid < GROUP;               // warp 0: a lane with a node
  const int i = blockIdx.x * GROUP + tid;      // ... and that node
  const bool dense = grid.n == 0;
  const float a0 = ask[0], a1 = ask[1];

  // ---- phase 0: one node per lane of warp 0
  if (warp == 0) {
    int depth = 0;
    float u0 = 0.0f, u1 = 0.0f, safe0 = 1.0f, safe1 = 1.0f;
    float cf = 0.0f, af = 0.0f;
    if (mine && i < n) {
      float c[NUM_XR], u[NUM_XR];
      // the row: row i of this lane's matrices, or (gather entry) twin
      // row idx[i], zero where the row is not valid
      const bool live = !GATHER || valid[i] != 0;
      const size_t src = GATHER ? (size_t)min(max(idx[i], 0), n_res - 1)
                                : (size_t)i;
#pragma unroll
      for (int r = 0; r < NUM_XR; ++r) {
        c[r] = live ? cap[src * NUM_XR + r] : 0.0f;
        u[r] = live ? used[src * NUM_XR + r] : 0.0f;
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
      out[2 * (size_t)n + i] = feas ? (int32_t)fminf(capacity, mpn) : 0;
      // depth j fits iff j <= capacity and j <= mpn: a prefix of the axis
      float lim = fminf(capacity, mpn);
      if (feas) {
        if (dense) {
          depth = lim >= (float)k_max ? k_max : (int)floorf(lim);
        } else {
          while (depth < grid.n && grid.g[depth] <= lim) ++depth;
        }
      }
      u0 = u[0];
      u1 = u[1];
      safe0 = c[0] > 0.0f ? c[0] : 1.0f;
      safe1 = c[1] > 0.0f ? c[1] : 1.0f;
      cf = (float)coll[i];
      af = aff[i];
    }
    if (mine) {
      s_u0[tid] = u0;
      s_u1[tid] = u1;
      s_safe0[tid] = safe0;
      s_safe1[tid] = safe1;
      s_cf[tid] = cf;
      s_aff[tid] = af != 0.0f ? af : 0.0f;
      s_aff_on[tid] = af != 0.0f ? 1.0f : 0.0f;
      s_depth[tid] = depth;
      s_best[tid] = -INFINITY;
      s_kbest[tid] = dense ? 1.0f : grid.g[0];
    }
    int deepest = __reduce_max_sync(FULL_MASK, depth);
    if (tid == 0) s_max_depth = deepest;
  }
  __syncthreads();
  const int max_depth = s_max_depth;

  // phase B's serial state, carried across chunks by warp 0
  float F = 0.0f;          // running prefix sum (grid: s_0 + trapezoids)
  float C = 0.0f;          // grid: running sum of trapezoids
  float s0 = 0.0f, s_prev = 0.0f, g_prev = 0.0f;

  for (int c0 = 0; c0 < max_depth; c0 += CHUNK) {
    // ---- phase A: scan the chunk's per-node depth counts, then evaluate
    // every fitting (node, depth) of the chunk across the block
    if (warp == 0) {
      int cnt = mine ? min(max(s_depth[tid] - c0, 0), CHUNK) : 0;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        int v = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += v;
      }
      if (mine) s_off[tid] = incl - cnt;
      if (tid == GROUP - 1) s_off[GROUP] = incl;
    }
    __syncthreads();
    const int total = s_off[GROUP];
    for (int e = tid; e < total; e += THREADS) {
      // the node owning flat index e: the largest k with s_off[k] <= e
      int k = 0;
#pragma unroll
      for (int step = GROUP / 2; step > 0; step >>= 1)
        if (s_off[k + step] <= e) k += step;
      int tt = e - s_off[k];
      int t = c0 + tt;
      float jf = dense ? (float)(t + 1) : grid.g[t];
      float fp0 = 1.0f - (s_u0[k] + jf * a0) / s_safe0[k];
      float fp1 = 1.0f - (s_u1[k] + jf * a1) / s_safe1[k];
      float tot = pow10_f32(fp0) + pow10_f32(fp1);
      float raw = spread ? tot - 2.0f : 20.0f - tot;
      float base = fminf(fmaxf(raw, 0.0f), 18.0f) / 18.0f;
      float cb = s_cf[k] + (jf - 1.0f);
      bool anti_on = cb > 0.0f;
      float anti = -(cb + 1.0f) / desired;
      float s = ((base + (anti_on ? anti : 0.0f)) + s_aff[k]) /
                ((1.0f + (anti_on ? 1.0f : 0.0f)) + s_aff_on[k]);
      s_curve[k * ROW + tt] = s;
    }
    __syncthreads();

    // ---- phase B: one lane per node, its row's prefix sum in place
    if (mine) {
      const int cnt = s_off[tid + 1] - s_off[tid];
      float* row = s_curve + tid * ROW;
      if (dense) {
        int tt = 0;
        for (; tt + UNROLL <= cnt; tt += UNROLL) {
          float v[UNROLL];
#pragma unroll
          for (int q = 0; q < UNROLL; ++q) v[q] = row[tt + q];
#pragma unroll
          for (int q = 0; q < UNROLL; ++q) {
            F = F + v[q];
            v[q] = F;
          }
#pragma unroll
          for (int q = 0; q < UNROLL; ++q) row[tt + q] = v[q];
        }
        for (; tt < cnt; ++tt) {
          F = F + row[tt];
          row[tt] = F;
        }
      } else {
        for (int tt = 0; tt < cnt; ++tt) {
          int t = c0 + tt;
          float jf = grid.g[t];
          float s = row[tt];
          if (t == 0) {
            s0 = s;
            F = s;
          } else {
            C = C + ((s + s_prev) * 0.5f) * (jf - g_prev);
            F = s0 + C;
          }
          s_prev = s;
          g_prev = jf;
          row[tt] = F;
        }
      }
    }
    __syncthreads();

    // ---- phase C: one warp per node, the first arg-max of F(k)/k
    for (int k = warp; k < GROUP; k += WARPS) {
      const int cnt = s_off[k + 1] - s_off[k];
      if (cnt == 0) continue;
      const float* row = s_curve + k * ROW;
      float v = -INFINITY;
      int idx = CHUNK;
      for (int tt = lane; tt < cnt; tt += 32) {
        int t = c0 + tt;
        float jf = dense ? (float)(t + 1) : grid.g[t];
        float dens = row[tt] / jf;
        if (dens > v) {
          v = dens;
          idx = tt;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        float ov = __shfl_down_sync(FULL_MASK, v, o);
        int oi = __shfl_down_sync(FULL_MASK, idx, o);
        if (ov > v || (ov == v && oi < idx)) {
          v = ov;
          idx = oi;
        }
      }
      if (lane == 0 && v > s_best[k]) {
        int t = c0 + idx;
        s_best[k] = v;
        s_kbest[k] = dense ? (float)(t + 1) : grid.g[t];
      }
    }
    __syncthreads();       // the next chunk rewrites s_off and s_curve
  }

  if (mine && i < n) {
    out[i] = __float_as_int(s_best[tid]);
    out[(size_t)n + i] = (int32_t)s_kbest[tid];
  }
}

template <bool GATHER>
static int launch(const float* cap, const float* used, int n_res,
                  const int32_t* idx, const uint8_t* valid, const float* ask,
                  const uint8_t* feasible, const int32_t* coll,
                  const float* aff, int n, int n_lanes, const float* desired,
                  const float* mpn, int k_max, const float* grid_depths,
                  int grid_n, int spread, int32_t* out, void* stream) {
  if (grid_n < 0 || grid_n > MAX_GRID) return (int)cudaErrorInvalidValue;
  if (n_lanes < 0 || n_lanes > MAX_LANES) return (int)cudaErrorInvalidValue;
  if (GATHER && n_res <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_lanes == 0) return 0;
  DepthGrid grid;
  grid.n = grid_n;
  for (int t = 0; t < MAX_GRID; ++t)
    grid.g[t] = t < grid_n ? grid_depths[t] : 0.0f;
  LaneScalars ls;
  for (int l = 0; l < MAX_LANES; ++l) {
    ls.desired[l] = l < n_lanes ? desired[l] : 1.0f;
    ls.mpn[l] = l < n_lanes ? mpn[l] : 0.0f;
  }
  const dim3 blocks((n + GROUP - 1) / GROUP, n_lanes);
  depth_curve_kernel<GATHER><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      cap, used, n_res, idx, valid, ask, feasible, coll, aff, n, ls, k_max,
      grid, spread, out);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// `n_lanes` solves of `n` rows each, stacked lane-major (cap/used
// [L, n, 5], ask [L, 5], feasible/coll/aff [L, n]); `desired` and `mpn`
// host arrays of L scalars; `grid_depths` a host array of `grid_n` depths
// (grid_n = 0: dense); `out` the int32 [L, 3, n] output buffer.
extern "C" int depth_curve_launch(
    const float* cap, const float* used, const float* ask,
    const uint8_t* feasible, const int32_t* coll, const float* aff, int n,
    int n_lanes, const float* desired, const float* mpn, int k_max,
    const float* grid_depths, int grid_n, int spread, int32_t* out,
    void* stream) {
  return launch<false>(cap, used, 0, nullptr, nullptr, ask, feasible, coll,
                       aff, n, n_lanes, desired, mpn, k_max, grid_depths,
                       grid_n, spread, out, stream);
}

// The gather entry: as depth_curve_launch, but lane l's rows are rows
// idx[l, :] of the resident twins cap_res/used_res ([n_res, 5], one pair
// for every lane), zero where valid[l, :] is 0 (idx and valid [L, n]).
extern "C" int depth_curve_gather_launch(
    const float* cap_res, const float* used_res, int n_res,
    const int32_t* idx, const uint8_t* valid, const float* ask,
    const uint8_t* feasible, const int32_t* coll, const float* aff, int n,
    int n_lanes, const float* desired, const float* mpn, int k_max,
    const float* grid_depths, int grid_n, int spread, int32_t* out,
    void* stream) {
  return launch<true>(cap_res, used_res, n_res, idx, valid, ask, feasible,
                      coll, aff, n, n_lanes, desired, mpn, k_max,
                      grid_depths, grid_n, spread, out, stream);
}
