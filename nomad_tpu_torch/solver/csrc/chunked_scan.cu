// The whole chunked scan in one launch, for Hopper, sm_90a.
//
// Replaces the reference's chunked scan, nomad_tpu/solver/kernels.py:345
// `place_chunked`: a lax.scan (one XLA program, no Pallas kernel) whose
// step scores every node with the running state, takes the best `chunk`
// nodes with lax.top_k and places one instance on each. kernels.py
// `place_chunked` is the plain version; this kernel returns what it
// returns, bit for bit: placements, usage, spread counts and distinct
// quotas. Each step:
//   1. score every node (chunked_score.cuh, the score chunked_step.cu
//      computes; -inf where the node cannot take an instance now);
//   2. select the first take_now = min(chunk, remaining) nodes with a
//      finite score, by score descending, then node index ascending (a
//      stable descending sort; lax.top_k's order);
//   3. used += ask on each selected node (one rounding), placed += 1,
//      remaining -= selected, spread_counts[s, id] += 1 and
//      distinct_remaining[d, id] -= 1 for each selected node's values
//      (a quota may go below 0 within a step, as index_add makes it).
// It stops when remaining reaches 0 or a step selects nothing: every
// later step of the plain loop changes nothing (a node that cannot take
// an instance never can again: usage and placements only grow, quotas
// only shrink, and spread counts do not enter feasibility).
//
// What bounds it on this card: the chain of steps, not bytes. A web-shaped
// solve (16,384 rows, 10,000 live, S = 2, D = 1) reads about 1.4 MB once
// and then works from shared memory; each step depends on the one before
// through the selection, so the solve costs steps x (score, local select,
// one cluster barrier, merge, update), each a few block-wide barriers.
// The per-step launch chain it replaces (one score launch, a sort, a
// scatter and four updates issued from the host) took ~0.5 ms of host a
// step for ~0.1 ms of device work.
//
// Design: one cluster of 8 CTAs (the portable cluster size), 512 threads
// each. CTA r owns the nodes r, r + 8, r + 16, ...: the live rows of a
// bucket (its first rows) spread evenly over the CTAs.
//   - Records. At the start each CTA compacts the nodes it owns that can
//     take an instance into records in shared memory (or its slice of the
//     scratch where they do not fit), in ascending node order: usage,
//     capacity, placements, collisions, affinity, value ids, and the
//     pre-score, the part of the score that changes only when the node is
//     selected (chunked_pre: fit term, anti-affinity, affinity). Each step
//     recomputes the distinct check and the spread term for every record
//     from the running tables, and the pre-score only for the selected
//     nodes: the same functions of the same values in the same order, so
//     the scores are bit-equal to the plain step's. A node that cannot
//     take an instance never can again, so the records never grow.
//   - Keys. A node with a finite score gets the 64-bit key (order-
//     preserving bits of the score, -0.0 read as +0.0, in the high word;
//     ~index in the low word): unique, and ordered exactly as the stable
//     descending sort orders. 0 marks "no candidate"; no finite score maps
//     to it. No score is NaN (chunked_score.cuh).
//   - Local select. Each CTA finds its top-take_now keys: an arg-max for
//     take_now = 1; else a radix select over the score word, 8 bits a
//     pass from the first bit where the step's scores differ, stopping at
//     the first pass whose bin holds exactly the keys still wanted; keys
//     tied on the score word are taken in record (node) order by one
//     block-wide count. It writes them, with their value ids, to a
//     candidate list in shared memory and arrives at ONE cluster barrier.
//   - Merge. Every CTA reads the eight lists through distributed shared
//     memory in one round trip (slot r x take_now + s) and ranks each
//     candidate by counting the larger ones (a radix select past 512
//     slots): every CTA finds the same global top-take_now.
//   - Update. Every CTA applies the same update to its own copy of the
//     [S, P] counts and [D, P] quotas (the ids come with the candidates),
//     and the used/placed/pre-score update to the selected nodes it owns:
//     no second exchange. The live rows go back to the outputs at the end.
//   - Barriers. The candidate lists are double-buffered by step parity:
//     a CTA writes list t + 2 only after the barrier of step t + 1, which
//     every CTA reaches after reading list t.
// Build without fast math and without FMA contraction, as chunked_step.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "chunked_score.cuh"
#include "chunked_select.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 8
#define MAX_CHUNK 256            // k = min(N, 256): lax.top_k's static k
// dynamic shared memory: candidates (2 x chunk), their union (CLUSTER x
// chunk) and the candidates' value ids, then the tables and the node
// records where they fit
#define SMEM_LIMIT (216 * 1024)
#define TABLE_SMEM_LIMIT (64 * 1024)

struct ScanArgs {
  const float* cap;
  float* used;                  // in/out: the output buffer, inputs copied
  const float* ask;
  const uint8_t* feasible;
  const int32_t* job_coll;
  int32_t* placed;              // in/out, as used
  const int32_t* sp_ids;
  const int32_t* sp_counts_in;
  const float* sp_desired;
  const int32_t* sp_mode;
  const float* sp_weights;
  const float* aff;
  const int32_t* dp_ids;
  const int32_t* dp_rem_in;
  int32_t* sp_counts_out;
  int32_t* dp_rem_out;
  unsigned char* slices;        // scratch: each CTA's tables and node
                                // records, where shared memory lacks room
  int32_t* steps_out;           // scratch: the steps run
  long long slice_bytes, tab_bytes;
  int n, mpn, spread, n_s, n_p, n_d, n_dp, count, chunk, max_steps;
  float desired;
  int tabs_in_smem, nodes_in_smem;
};

// One CTA's records of the nodes that could take an instance at the
// start, in ascending node order (structure of arrays, m_cap entries
// each): the key of the step, the node's index, its pre-score (-inf once
// it can take no more) and the components present so far, its job
// collisions, affinity and placements, its capacity and usage rows, and
// its spread and distinct value ids.
struct Nodes {
  uint64_t* key;
  int32_t* idx;
  float* pre;
  float* npre;
  int32_t* coll;
  float* aff;
  int32_t* placed;
  float* cap;                   // [NUM_XR][m_cap]
  float* used;                  // [NUM_XR][m_cap]
  int32_t* ids;                 // [n_s + n_d][m_cap]: spread, then distinct
};

// bytes of one record
__host__ __device__ __forceinline__ long long node_record_bytes(int n_ids) {
  return 8 + 4 * 6 + 4 * 2 * NUM_XR + 4LL * n_ids;
}

// bytes of the candidate buffers: keys (2 x chunk), their union (CLUSTER
// x chunk), value ids (2 x chunk x n_ids, rounded to 16 bytes)
__host__ __device__ __forceinline__ long long cand_bytes(int chunk,
                                                         int n_ids) {
  return (2LL + CLUSTER) * chunk * 8 + (8LL * chunk * n_ids + 15) / 16 * 16;
}

// the part of the score that changes only when the node is selected;
// false where the node can take no instance (capacity, max_per_node)
__device__ __forceinline__ bool scan_pre(const ScanArgs& a, const float* ask,
                                         const float* c, const float* u,
                                         int32_t pl, int32_t coll, float aff,
                                         float* pre, float* n_pre) {
  if (!chunked_fits(c, u, ask, pl, a.mpn)) return false;
  *pre = chunked_pre(chunked_raw(c, u, ask, a.spread), coll + pl, a.desired,
                     aff, n_pre);
  return true;
}

__global__ void __launch_bounds__(THREADS, 1)
    chunked_scan_kernel(ScanArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = a.n, n_s = a.n_s, n_p = a.n_p, n_d = a.n_d, n_dp = a.n_dp;
  const int n_ids = n_s + n_d;
  // CTA r owns the nodes r, r + 8, r + 16, ...: live rows spread evenly
  const int m = rank < n ? (n - rank + CLUSTER - 1) / CLUSTER : 0;
  const int m_cap = (n + CLUSTER - 1) / CLUSTER;
  const int sp_len = n_s * n_p, dp_len = n_d * n_dp;

  // dynamic shared memory: candidates, their union and their value ids,
  // then the tables and the node records where they fit (else this CTA's
  // scratch slice)
  const int ck = a.chunk;
  extern __shared__ __align__(16) unsigned char dsmem[];
  uint64_t* cand = (uint64_t*)dsmem;                 // [2][ck]
  uint64_t* uni = cand + 2 * ck;                     // [CLUSTER][ck]
  int32_t* cand_ids = (int32_t*)(uni + CLUSTER * ck);  // [2][ck][n_ids]
  unsigned char* free_sm = dsmem + cand_bytes(ck, n_ids);
  unsigned char* slice = a.slices + (size_t)rank * a.slice_bytes;
  unsigned char* tabs = a.tabs_in_smem ? free_sm : slice;
  if (a.tabs_in_smem) free_sm += a.tab_bytes;
  unsigned char* recs = a.nodes_in_smem ? free_sm : slice + a.tab_bytes;
  int32_t* sp_tab = (int32_t*)tabs;                  // [n_s][n_p] counts
  int32_t* dr_tab = sp_tab + sp_len;                 // [n_d][n_dp] quotas
  float* sp_des = (float*)(dr_tab + dp_len);         // [n_s][n_p] targets
  Nodes nd;
  nd.key = (uint64_t*)recs;
  nd.idx = (int32_t*)(nd.key + m_cap);
  nd.pre = (float*)(nd.idx + m_cap);
  nd.npre = nd.pre + m_cap;
  nd.coll = (int32_t*)(nd.npre + m_cap);
  nd.aff = (float*)(nd.coll + m_cap);
  nd.placed = (int32_t*)(nd.aff + m_cap);
  nd.cap = (float*)(nd.placed + m_cap);
  nd.used = nd.cap + NUM_XR * m_cap;
  nd.ids = (int32_t*)(nd.used + NUM_XR * m_cap);
  const int32_t* nd_sp = nd.ids;
  const int32_t* nd_dp = nd.ids + (size_t)n_s * m_cap;

  __shared__ SelectShared sh;
  __shared__ int s_mode[MAX_STANZAS];
  __shared__ int s_min[MAX_STANZAS], s_max[MAX_STANZAS], s_any[MAX_STANZAS];
  __shared__ float s_w[MAX_STANZAS], s_ask[NUM_XR];
  __shared__ uint8_t d_act[MAX_STANZAS];
  __shared__ int cand_n[2], cand_j[2][MAX_CHUNK], cnt[CLUSTER];
  __shared__ int n_valid_sh, slot_sh;
  __shared__ unsigned hi_max_sh, hi_min_sh;

  // set-up: this CTA's copy of the tables, the live distinct stanzas
  for (int j = threadIdx.x; j < sp_len; j += THREADS) {
    sp_tab[j] = a.sp_counts_in[j];
    sp_des[j] = a.sp_desired[j];
  }
  for (int j = threadIdx.x; j < dp_len; j += THREADS)
    dr_tab[j] = a.dp_rem_in[j];
  if (threadIdx.x < n_s) {
    s_mode[threadIdx.x] = a.sp_mode[threadIdx.x];
    s_w[threadIdx.x] = a.sp_weights[threadIdx.x];
  }
  if (threadIdx.x < NUM_XR) s_ask[threadIdx.x] = a.ask[threadIdx.x];
  if (threadIdx.x < n_d)
    d_act[threadIdx.x] = a.dp_rem_in[threadIdx.x * n_dp] >= 0;
  if (threadIdx.x < 256)
    sh.hist[0][threadIdx.x] = sh.hist[1][threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    n_valid_sh = slot_sh = 0;
    hi_max_sh = 0;
    hi_min_sh = ~0u;
  }
  __syncthreads();

  // the records of the nodes that can take an instance, compacted in node
  // order: each thread takes a contiguous run of the CTA's nodes. The
  // plain loop adds 0 * ask to every unselected row each step it runs;
  // once is enough (x + 0 * a is idempotent), and it turns -0.0 usage
  // into +0.0 as the plain loop does.
  const bool touch = a.max_steps > 0 && a.count != 0;
  const int q = (m + THREADS - 1) / THREADS;
  const int j0 = min((int)threadIdx.x * q, m), j1 = min(j0 + q, m);
  int live = 0, m_live = 0;
  for (int pass = 0; pass < 2; ++pass) {
    // pass 0 counts this thread's live nodes, pass 1 writes their records
    int w = pass == 1 ? block_exclusive(live, sh, &m_live) : 0;
    for (int j = j0; j < j1; ++j) {
      const int i = rank + CLUSTER * j;
      float c[NUM_XR], u[NUM_XR];
#pragma unroll
      for (int r = 0; r < NUM_XR; ++r) {
        c[r] = a.cap[(size_t)i * NUM_XR + r];
        u[r] = a.used[(size_t)i * NUM_XR + r];
        if (touch) {
          u[r] = u[r] + 0.0f * s_ask[r];
          if (pass == 1) a.used[(size_t)i * NUM_XR + r] = u[r];
        }
      }
      const int32_t pl = a.placed[i], coll = a.job_coll[i];
      const float aff = a.aff[i];
      float pre, n_pre;
      if (a.feasible[i] == 0 ||
          !scan_pre(a, s_ask, c, u, pl, coll, aff, &pre, &n_pre))
        continue;
      if (pass == 0) {
        ++live;
        continue;
      }
      nd.idx[w] = i;
      nd.pre[w] = pre;
      nd.npre[w] = n_pre;
      nd.coll[w] = coll;
      nd.aff[w] = aff;
      nd.placed[w] = pl;
#pragma unroll
      for (int r = 0; r < NUM_XR; ++r) {
        nd.cap[r * m_cap + w] = c[r];
        nd.used[r * m_cap + w] = u[r];
      }
      for (int s = 0; s < n_s; ++s)
        nd.ids[(size_t)s * m_cap + w] = a.sp_ids[(size_t)s * n + i];
      for (int d = 0; d < n_d; ++d)
        nd.ids[(size_t)(n_s + d) * m_cap + w] = a.dp_ids[(size_t)d * n + i];
      ++w;
    }
  }
  __syncthreads();

  int remaining = a.count, t = 0;
  for (; t < a.max_steps; ++t) {
    const int take = min(remaining, a.chunk);
    if (take <= 0) break;
    const int par = t & 1;

    // 1. score and key every live node this CTA owns, noting the largest
    // and smallest score word for the select
    chunked_spread_stats(sp_tab, n_s, n_p, s_min, s_max, s_any);
    int nv = 0;
    uint32_t hmax = 0, hmin = ~0u;
    for (int j = threadIdx.x; j < m_live; j += THREADS) {
      uint64_t key = 0;
      const float p = nd.pre[j];
      if (p != -CUDART_INF_F &&
          chunked_distinct_ok(j, m_cap, nd_dp, dr_tab, d_act, n_d, n_dp)) {
        bool any_spread;
        float st = chunked_spread(j, m_cap, nd_sp, sp_tab, sp_des, s_mode,
                                  s_w, n_s, n_p, s_min, s_max, s_any,
                                  &any_spread);
        float score = chunked_final(p, nd.npre[j], st, any_spread);
        if (isfinite(score)) {
          key = scan_key(score, nd.idx[j]);
          hmax = max(hmax, (uint32_t)(key >> 32));
          hmin = min(hmin, (uint32_t)(key >> 32));
          ++nv;
        }
      }
      nd.key[j] = key;
    }
    nv = __reduce_add_sync(FULL, nv);
    hmax = __reduce_max_sync(FULL, hmax);
    hmin = __reduce_min_sync(FULL, hmin);
    if ((threadIdx.x & 31) == 0 && nv) {
      atomicAdd(&n_valid_sh, nv);
      atomicMax(&hi_max_sh, hmax);
      atomicMin(&hi_min_sh, hmin);
    }
    __syncthreads();

    // 2a. this CTA's top-take candidates (all of its keys >= t_local) with
    // their value ids
    const int n_valid = n_valid_sh;
    const uint64_t t_local =
        n_valid > take ? block_select_ordered(nd.key, m_live, take,
                                              hi_max_sh, hi_min_sh, sh)
                       : 1;
    for (int j = threadIdx.x; j < m_live; j += THREADS) {
      uint64_t key = nd.key[j];
      if (key >= t_local) {
        int slot = atomicAdd(&slot_sh, 1);
        cand[par * ck + slot] = key;
        cand_j[par][slot] = j;
        int32_t* ids = cand_ids + (size_t)(par * ck + slot) * n_ids;
        for (int v = 0; v < n_ids; ++v)
          ids[v] = nd.ids[(size_t)v * m_cap + j];
      }
    }
    if (threadIdx.x == 0) cand_n[par] = min(n_valid, take);
    cluster.sync();

    // 2b. the union: slot r * take + s holds list r's s-th candidate (0
    // past its count), read in one round trip; then its top-take
    const int u_slots = CLUSTER * take;
    for (int j = threadIdx.x; j < u_slots; j += THREADS) {
      const int r = j / take, s = j - r * take;
      const int cn = cluster.map_shared_rank(cand_n, r)[par];
      const uint64_t key = cluster.map_shared_rank(cand, r)[par * ck + s];
      uni[j] = s < cn ? key : 0;
    }
    if (threadIdx.x < CLUSTER)
      cnt[threadIdx.x] = cluster.map_shared_rank(cand_n, threadIdx.x)[par];
    if (threadIdx.x == 0) {
      n_valid_sh = slot_sh = 0;
      hi_max_sh = 0;
      hi_min_sh = ~0u;
    }
    __syncthreads();
    int u_valid = 0;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) u_valid += cnt[r];
    const int n_sel = min(u_valid, take);
    // up to THREADS slots: each thread ranks its own candidate by counting
    // the larger ones; more: a radix select over the union
    const uint64_t t_global =
        u_valid > take && u_slots > THREADS
            ? block_select(uni, u_slots, take, sh) : 0;

    // 3. the update: the tables in every CTA, the rows by their owner
    for (int j = threadIdx.x; j < u_slots; j += THREADS) {
      const uint64_t key = uni[j];
      if (key == 0) continue;
      bool sel = u_valid <= take;
      if (!sel && u_slots <= THREADS) {
        int above = 0;
        for (int k = 0; k < u_slots; ++k) above += uni[k] > key;
        sel = above < take;
      } else if (!sel) {
        sel = key >= t_global;
      }
      if (!sel) continue;
      const int r = j / take, s = j - r * take;
      const int32_t* ids = cluster.map_shared_rank(cand_ids, r) +
                           (size_t)(par * ck + s) * n_ids;
      for (int v = 0; v < n_s; ++v) {
        int id = ids[v];
        if (id >= 0) atomicAdd(&sp_tab[v * n_p + min(id, n_p - 1)], 1);
      }
      for (int d = 0; d < n_d; ++d) {
        int id = ids[n_s + d];
        if (id >= 0) atomicSub(&dr_tab[d * n_dp + min(id, n_dp - 1)], 1);
      }
      if (r == rank) {
        const int w = cand_j[par][s];
        float c[NUM_XR], u[NUM_XR];
#pragma unroll
        for (int x = 0; x < NUM_XR; ++x) {
          c[x] = nd.cap[x * m_cap + w];
          u[x] = nd.used[x * m_cap + w] + s_ask[x];
          nd.used[x * m_cap + w] = u[x];
        }
        const int32_t pl = nd.placed[w] + 1;
        nd.placed[w] = pl;
        float pre = -CUDART_INF_F, n_pre = 1.0f;
        scan_pre(a, s_ask, c, u, pl, nd.coll[w], nd.aff[w], &pre, &n_pre);
        nd.pre[w] = pre;
        nd.npre[w] = n_pre;
      }
    }
    remaining -= n_sel;
    __syncthreads();
    if (n_sel == 0) {
      ++t;
      break;
    }
  }

  // the live rows' usage and placements back to the outputs; no CTA
  // leaves while another may still read its candidates
  for (int j = threadIdx.x; j < m_live; j += THREADS) {
    const int i = nd.idx[j];
    a.placed[i] = nd.placed[j];
#pragma unroll
    for (int x = 0; x < NUM_XR; ++x)
      a.used[(size_t)i * NUM_XR + x] = nd.used[x * m_cap + j];
  }
  cluster.sync();
  if (rank == 0) {
    for (int j = threadIdx.x; j < sp_len; j += THREADS)
      a.sp_counts_out[j] = sp_tab[j];
    for (int j = threadIdx.x; j < dp_len; j += THREADS)
      a.dp_rem_out[j] = dr_tab[j];
    if (threadIdx.x == 0) a.steps_out[0] = t;
  }
}

// An empty persistent loop of `steps` cluster barriers on a cluster of
// CLUSTER CTAs of up to 1,024 threads: the dependency floor of a
// persistent solve of that many dependent steps (for measurement only;
// the scan's shape is 512 threads, the convex solve's 1,024).
__global__ void __launch_bounds__(1024, 1) cluster_barrier_kernel(
    int steps) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int t = 0; t < steps; ++t) cluster.sync();
}

static void scan_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
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

// A CTA's tables (spread counts, distinct quotas, spread targets) and
// node records, in bytes.
static long long tab_bytes_of(int n_s, int n_p, int n_d, int n_dp) {
  return ((4LL * (2 * n_s * n_p + n_d * n_dp)) + 15) / 16 * 16;
}
static long long node_bytes_of(int n, int n_s, int n_d) {
  const long long m_cap = (n + CLUSTER - 1) / CLUSTER;
  return (m_cap * node_record_bytes(n_s + n_d) + 15) / 16 * 16;
}

// Bytes of scratch the launch needs: a slice of tables and node records
// for each CTA (used where shared memory lacks room), then the step
// count.
extern "C" long long chunked_scan_scratch_bytes(int n, int n_s, int n_p,
                                                int n_d, int n_dp) {
  return CLUSTER * (tab_bytes_of(n_s, n_p, n_d, n_dp) +
                    node_bytes_of(n, n_s, n_d)) + 16;
}

// Launch one solve on `stream`; returns the launch's cudaError_t (0 =
// success), or cudaErrorInvalidConfiguration when the card cannot place
// the cluster with the shared memory it asks for. Shapes: cap [n, 5] f32;
// used_out [n, 5] f32 and placed_out [n] i32 hold the inputs and are
// updated in place; ask [5] f32, feasible [n] u8, job_coll [n] i32,
// sp_ids [n_s, n] i32, sp_counts [n_s, n_p] i32, sp_desired [n_s, n_p]
// f32, sp_mode [n_s] i32, sp_weights [n_s] f32, aff [n] f32, dp_ids
// [n_d, n] i32, dp_rem [n_d, n_dp] i32; sp_counts_out and dp_rem_out as
// sp_counts and dp_rem; scratch of chunked_scan_scratch_bytes(n, n_s,
// n_p, n_d, n_dp) bytes, 16-byte aligned, the step count in its last 16.
// n_s, n_d <= 16 (MAX_STANZAS), 1 <= chunk <= min(n, 256).
extern "C" int chunked_scan_launch(
    const float* cap, float* used_out, const float* ask,
    const uint8_t* feasible, const int32_t* job_coll, int32_t* placed_out,
    int n, int max_per_node, float desired, int spread, const int32_t* sp_ids,
    const int32_t* sp_counts, const float* sp_desired, const int32_t* sp_mode,
    const float* sp_weights, int n_s, int n_p, const float* aff,
    const int32_t* dp_ids, const int32_t* dp_rem, int n_d, int n_dp,
    int count, int chunk, int max_steps, int32_t* sp_counts_out,
    int32_t* dp_rem_out, void* scratch, void* stream) {
  if (n <= 0 || n_s < 1 || n_s > MAX_STANZAS || n_p < 1 || n_d < 1 ||
      n_d > MAX_STANZAS || n_dp < 1 || chunk < 1 || chunk > MAX_CHUNK ||
      chunk > n || max_steps < 0)
    return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.cap = cap;
  a.used = used_out;
  a.ask = ask;
  a.feasible = feasible;
  a.job_coll = job_coll;
  a.placed = placed_out;
  a.sp_ids = sp_ids;
  a.sp_counts_in = sp_counts;
  a.sp_desired = sp_desired;
  a.sp_mode = sp_mode;
  a.sp_weights = sp_weights;
  a.aff = aff;
  a.dp_ids = dp_ids;
  a.dp_rem_in = dp_rem;
  a.sp_counts_out = sp_counts_out;
  a.dp_rem_out = dp_rem_out;
  a.tab_bytes = tab_bytes_of(n_s, n_p, n_d, n_dp);
  const long long node_bytes = node_bytes_of(n, n_s, n_d);
  a.slice_bytes = a.tab_bytes + node_bytes;
  a.slices = (unsigned char*)scratch;
  a.steps_out =
      (int32_t*)((unsigned char*)scratch + CLUSTER * a.slice_bytes);
  a.n = n;
  a.mpn = max_per_node;
  a.spread = spread;
  a.n_s = n_s;
  a.n_p = n_p;
  a.n_d = n_d;
  a.n_dp = n_dp;
  a.count = count;
  a.chunk = chunk;
  a.max_steps = max_steps;
  a.desired = desired;
  long long smem = cand_bytes(chunk, n_s + n_d);
  a.tabs_in_smem = a.tab_bytes <= TABLE_SMEM_LIMIT;
  if (a.tabs_in_smem) smem += a.tab_bytes;
  a.nodes_in_smem = smem + node_bytes <= SMEM_LIMIT;
  if (a.nodes_in_smem) smem += node_bytes;

  cudaError_t err = cudaFuncSetAttribute(
      chunked_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  scan_config(&cfg, &attr, (size_t)smem, stream);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, chunked_scan_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, chunked_scan_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `steps` cluster barriers in one launch of 8 CTAs of `threads` threads
// (the scan's 512, the convex solve's 1,024), for measurement only.
extern "C" int chunked_scan_barrier_launch(int steps, int threads,
                                           void* stream) {
  if (threads < 1 || threads > 1024) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  scan_config(&cfg, &attr, 0, stream);
  cfg.blockDim = dim3(threads, 1, 1);
  cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, steps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
