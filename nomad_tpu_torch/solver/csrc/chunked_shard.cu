// The chunked scan with its node axis sharded: one step of every shard a
// device holds in one launch, for Hopper, sm_90a.
//
// Replaces the reference's sharded scan, nomad_tpu/solver/sharding.py:442
// `sharded_place_chunked`: place_chunked's lax.scan (nomad_tpu/solver/
// kernels.py:345, one XLA program, no Pallas kernel) under a node-axis
// sharding, where GSPMD all-gathers each step's winners. kernels.py
// `chunked_shard_ref` is the plain version: this kernel returns what it
// returns, bit for bit, and so what the solo scan returns (chunked_scan.cu:
// placements, usage, spread counts and distinct quotas).
//
// What bounds it on this card: the chain of steps, as the solo scan; each
// step's launch is the barrier across the shards. A step takes ~15 us on
// an NVIDIA H100 80GB HBM3 at 700 W, the solo kernel's 11.75 us (PERF.md):
// the step's own chain of block and cluster barriers, not the launch (an
// early exit takes 1.3 us). Design: one launch a
// step a device; in it one cluster of 8 CTAs (512 threads each) a shard,
// the shard named by the cluster's index, so the shards' steps run side by
// side on the card and each shard's step has the solo kernel's cluster
// (chunked_scan.cu). Shard s owns the rows [s R, (s + 1) R) of the bucket,
// and CTA r of its cluster the shard's rows r, r + 8, r + 16, .... Launch
// t, in each CTA:
//   1. (t > 0) reads the S shard lists of step t - 1, ranks the S x take
//      candidates by key (every CTA of every shard ranks them alike, so
//      all find the same winners: no merge on the lead), applies the
//      winners' value ids to its own copy of the [S, P] spread counts and
//      [D, P] quotas (integer atomics: their order cannot change them),
//      and the used/placed/pre-score update to the winners it owns;
//   2. stops where the solo kernel stops (remaining 0, a step that
//      selected nothing, max_steps): sets its done flag and writes its
//      rows out (CTA 0 the tables); every later launch of the solve finds
//      the flag and exits at once (the launcher queues max_steps + 1
//      launches and never waits);
//   3. else scores its records (chunked_score.cuh, unchanged) and selects
//      its local top take = min(chunk, remaining) into shared memory; one
//      cluster barrier; every CTA reads the 8 local lists' keys through
//      distributed shared memory in one round (as chunked_scan.cu's
//      merge) and ranks them alike, then writes its own share of the
//      shard's top take, with the value ids and each candidate's owner
//      (record index x 8 + CTA), into the shard's slot of the step's
//      candidate buffer (double-buffered by step parity), after the
//      shares of the CTAs before it. The barrier's wait, split from its
//      arrival, keeps every CTA's list alive until all have read it.
// Records. Launch 0 compacts each CTA's rows that can take an instance
// into records in global scratch (its own slice, which L2 holds), in
// ascending row order, as the solo kernel does in shared memory: a row
// that cannot take an instance never can again, so they never grow. A
// record's key carries ~(global row) in its low word (the shard's row
// offset plus the local row), so keys are unique over the bucket and
// order exactly as the stable descending sort, whatever the split. A
// step's keys live in shared memory where the CTA's records fit.
// Candidate lists. On one card every shard of the launch shares one
// buffer. On several cards each device has its own buffer and launches
// its own shards; after each launch its shards' slots are copied into
// every other device's buffer (cudaMemcpyPeerAsync on its stream) and an
// event orders the other devices' next launches behind it.
// Build without fast math and without FMA contraction, as chunked_scan.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "chunked_score.cuh"
#include "chunked_select.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 8
#define MAX_CHUNK 256            // k = min(N, 256): lax.top_k's static k
#define MAX_SHARDS 16
#define SMEM_LIMIT (200 * 1024)

// the per-shard pointer table the launcher takes, NPTR entries a shard
enum {
  P_CAP, P_USED, P_ASK, P_FEAS, P_COLL, P_PLACED, P_SP_IDS, P_SP_COUNTS,
  P_SP_DES, P_SP_MODE, P_SP_W, P_AFF, P_DP_IDS, P_DP_REM, P_SP_OUT,
  P_DP_OUT, P_SCRATCH, P_CAND, P_STREAM, NPTR
};

// a CTA's running state, at the start of its slice of the shard's
// scratch (CTA 0's at the start of the scratch: the launcher's caller
// reads its steps and early exits)
struct ShardState {
  int remaining;
  int done;
  int steps;
  int take;          // the last scored step's take
  int m_live;
  int early_exits;   // launches that found the solve done (CTA 0)
  int pad[2];
};

struct ShardPtrs {
  const float* cap;
  float* used;                  // in/out: the output block, inputs copied
  const float* ask;
  const uint8_t* feasible;
  const int32_t* job_coll;
  int32_t* placed;              // in/out, as used
  const int32_t* sp_ids;        // [n_s][n]: this shard's columns
  const int32_t* sp_counts_in;
  const float* sp_desired;
  const int32_t* sp_mode;
  const float* sp_weights;
  const float* aff;
  const int32_t* dp_ids;        // [n_d][n]
  const int32_t* dp_rem_in;
  int32_t* sp_counts_out;
  int32_t* dp_rem_out;
  unsigned char* scratch;       // CLUSTER slices of slice_bytes
  unsigned char* cand;          // [2][n_shards] slots of slot_bytes
  int shard;                    // the shard's index in the solve
  int pad;
};

// one launch: the shards of one device, a cluster each
struct ShardBatch {
  ShardPtrs sh[MAX_SHARDS];
  long long slot_bytes, slice_bytes;
  int n, n_shards, mpn, spread, n_s, n_p, n_d, n_dp, count, chunk,
      max_steps, keys_in_smem;
  float desired;
};

__host__ __device__ __forceinline__ long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// bytes of one record: key, index, pre-score and its count, collisions,
// affinity, placements, capacity and usage rows, value ids
__host__ __device__ __forceinline__ long long record_bytes(int n_ids) {
  return 8 + 4 * 6 + 4 * 2 * NUM_XR + 4LL * n_ids;
}

// a slot: chunk keys, their value ids, their owners (record index x
// CLUSTER + CTA), then the list's count in its last 16 bytes
__host__ __device__ __forceinline__ long long slot_bytes_of(int chunk,
                                                            int n_ids) {
  return align16(8LL * chunk + 4LL * chunk * n_ids + 4LL * chunk) + 16;
}

// a CTA's slice of the scratch: state, tables, records
__host__ __device__ __forceinline__ long long rec_offset(int n_s, int n_p,
                                                         int n_d, int n_dp) {
  return align16(sizeof(ShardState)) +
         align16(4LL * (n_s * n_p + n_d * n_dp));
}

__host__ __device__ __forceinline__ int cta_rows(int n) {
  return (n + CLUSTER - 1) / CLUSTER;
}

// dynamic shared memory: the union of S (or CLUSTER) lists; this CTA's
// local list (keys, value ids, record indices); the step's winners, the
// owners of this shard's last list and the merge's flags; then the
// step's keys where they fit
__host__ __device__ __forceinline__ long long list_smem(int n_shards,
                                                        int chunk,
                                                        int n_ids) {
  const int lists = n_shards > CLUSTER ? n_shards : CLUSTER;
  return 8LL * lists * chunk + 8LL * chunk +
         align16(4LL * chunk * (n_ids + 3) + CLUSTER * chunk);
}

struct Records {
  uint64_t* key;
  int32_t* idx;                 // the local row
  float* pre;
  float* npre;
  int32_t* coll;
  float* aff;
  int32_t* placed;
  float* cap;                   // [NUM_XR][m_cap]
  float* used;                  // [NUM_XR][m_cap]
  int32_t* ids;                 // [n_s + n_d][m_cap]: spread, then distinct
};

__device__ __forceinline__ Records records_of(unsigned char* base,
                                              int m_cap) {
  Records r;
  r.key = (uint64_t*)base;
  r.idx = (int32_t*)(r.key + m_cap);
  r.pre = (float*)(r.idx + m_cap);
  r.npre = r.pre + m_cap;
  r.coll = (int32_t*)(r.npre + m_cap);
  r.aff = (float*)(r.coll + m_cap);
  r.placed = (int32_t*)(r.aff + m_cap);
  r.cap = (float*)(r.placed + m_cap);
  r.used = r.cap + NUM_XR * m_cap;
  r.ids = (int32_t*)(r.used + NUM_XR * m_cap);
  return r;
}

// the part of the score that changes only when the node is selected;
// false where the node can take no instance (capacity, max_per_node)
__device__ __forceinline__ bool shard_pre(const ShardBatch& b,
                                          const float* ask, const float* c,
                                          const float* u, int32_t pl,
                                          int32_t coll, float aff, float* pre,
                                          float* n_pre) {
  if (!chunked_fits(c, u, ask, pl, b.mpn)) return false;
  *pre = chunked_pre(chunked_raw(c, u, ask, b.spread), coll + pl, b.desired,
                     aff, n_pre);
  return true;
}

// Launch 0: this CTA's tables and the records of the rows it owns.
__device__ void shard_init(const ShardBatch& b, const ShardPtrs& a, int rank,
                           ShardState* st, int32_t* sp_tab, int32_t* dr_tab,
                           const Records& nd, const float* s_ask,
                           SelectShared& sh) {
  const int n = b.n, n_s = b.n_s, n_d = b.n_d, m_cap = cta_rows(n);
  for (int j = threadIdx.x; j < n_s * b.n_p; j += THREADS)
    sp_tab[j] = a.sp_counts_in[j];
  for (int j = threadIdx.x; j < n_d * b.n_dp; j += THREADS)
    dr_tab[j] = a.dp_rem_in[j];
  // the plain loop adds 0 * ask to every unselected row each step it
  // runs; once is enough (x + 0 * a is idempotent), and it turns -0.0
  // usage into +0.0 as the plain loop does
  const bool touch = b.max_steps > 0 && b.count != 0;
  const int m = rank < n ? (n - rank + CLUSTER - 1) / CLUSTER : 0;
  const int q = (m + THREADS - 1) / THREADS;
  const int j0 = min((int)threadIdx.x * q, m), j1 = min(j0 + q, m);
  int live = 0, m_live = 0;
  for (int pass = 0; pass < 2; ++pass) {
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
          !shard_pre(b, s_ask, c, u, pl, coll, aff, &pre, &n_pre))
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
  if (threadIdx.x == 0) {
    st->remaining = b.count;
    st->done = 0;
    st->steps = 0;
    st->take = 0;
    st->m_live = m_live;
    st->early_exits = 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
    chunked_shard_kernel(const __grid_constant__ ShardBatch b, int t) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const ShardPtrs& a = b.sh[blockIdx.x / CLUSTER];
  const int n = b.n, n_s = b.n_s, n_p = b.n_p, n_d = b.n_d, n_dp = b.n_dp;
  const int n_ids = n_s + n_d, ck = b.chunk, S = b.n_shards;
  const int m_cap = cta_rows(n);
  unsigned char* slice = a.scratch + (size_t)rank * b.slice_bytes;
  ShardState* st = (ShardState*)slice;
  int32_t* sp_tab = (int32_t*)(slice + align16(sizeof(ShardState)));
  int32_t* dr_tab = sp_tab + n_s * n_p;
  const Records nd = records_of(slice + rec_offset(n_s, n_p, n_d, n_dp),
                                m_cap);
  const int32_t* nd_sp = nd.ids;
  const int32_t* nd_dp = nd.ids + (size_t)n_s * m_cap;

  __shared__ SelectShared sh;
  __shared__ int s_mode[MAX_STANZAS];
  __shared__ int s_min[MAX_STANZAS], s_max[MAX_STANZAS], s_any[MAX_STANZAS];
  __shared__ float s_w[MAX_STANZAS], s_ask[NUM_XR];
  __shared__ uint8_t d_act[MAX_STANZAS];
  __shared__ int cnt[MAX_SHARDS];
  __shared__ int n_valid_sh, local_n, local_sh, slot_sh, n_win, before_sh;
  __shared__ unsigned hi_max_sh, hi_min_sh;
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int lists = S > CLUSTER ? S : CLUSTER;
  uint64_t* uni = (uint64_t*)dsmem;                   // [lists][take]
  uint64_t* lk = uni + (size_t)lists * ck;            // [ck] local keys
  int32_t* lids = (int32_t*)(lk + ck);                // [ck][n_ids]
  int32_t* lw = lids + (size_t)ck * n_ids;            // [ck] record index
  int32_t* win = lw + ck;                             // [ck] union slots
  int32_t* prev_own = win + ck;                       // [ck] owners
  uint8_t* flag = (uint8_t*)(prev_own + ck);          // [CLUSTER][take]
  uint64_t* keys = b.keys_in_smem
                       ? (uint64_t*)(dsmem + list_smem(S, ck, n_ids))
                       : nd.key;
  // step t - 1's lists
  const unsigned char* prev =
      a.cand + (size_t)((t + 1) & 1) * S * b.slot_bytes;

  // the state's two words this launch needs first, read together
  const int done0 = t > 0 ? st->done : 0, take0 = t > 0 ? st->take : 0;
  if (done0) {
    if (rank == 0 && threadIdx.x == 0) st->early_exits += 1;
    return;
  }
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
    n_valid_sh = local_sh = slot_sh = n_win = before_sh = 0;
    hi_max_sh = 0;
    hi_min_sh = ~0u;
  }
  // the S lists of step t - 1 in one round of reads: union slot r x ck +
  // s holds list r's s-th key (0 past its count); this shard's own list
  // brings each candidate's owner
  if (t > 0) {
    if (threadIdx.x < S)
      cnt[threadIdx.x] = *(const int32_t*)(prev + threadIdx.x * b.slot_bytes +
                                           b.slot_bytes - 16);
    for (int j = threadIdx.x; j < S * ck; j += THREADS) {
      const int r = j / ck, s = j - r * ck;
      const unsigned char* slot = prev + r * b.slot_bytes;
      const int c = *(const int32_t*)(slot + b.slot_bytes - 16);
      const uint64_t key = ((const uint64_t*)slot)[s];
      uni[j] = s < c ? key : 0;
      if (r == a.shard)
        prev_own[s] = ((const int32_t*)(slot + 8LL * ck +
                                        4LL * ck * n_ids))[s];
    }
  }
  __syncthreads();
  if (t == 0) shard_init(b, a, rank, st, sp_tab, dr_tab, nd, s_ask, sh);
  const int m_live = st->m_live;
  int remaining = st->remaining;
  bool done = t == 0 && (remaining <= 0 || b.max_steps <= 0);

  // 1. the winners of step t - 1, from every shard's list
  if (t > 0) {
    const int take = take0, u_slots = S * ck;
    int u_valid = 0;
    for (int r = 0; r < S; ++r) u_valid += cnt[r];
    const int n_sel = min(u_valid, take);
    // up to THREADS slots: each thread ranks its own candidate by counting
    // the larger ones; more: a radix select over the union
    const uint64_t t_global =
        u_valid > take && u_slots > THREADS
            ? block_select(uni, u_slots, take, sh) : 0;
    for (int j = threadIdx.x; j < u_slots; j += THREADS) {
      const uint64_t key = uni[j];
      if (key == 0) continue;
      bool sel = u_valid <= take;
      if (!sel && u_slots <= THREADS) {
        int above = 0;
#pragma unroll 8
        for (int k = 0; k < u_slots; ++k) above += uni[k] > key;
        sel = above < take;
      } else if (!sel) {
        sel = key >= t_global;
      }
      if (sel) win[atomicAdd(&n_win, 1)] = j;
    }
    __syncthreads();
    // a thread an item: a winner's value id into the tables, or its row
    // update where this CTA owns it
    const int per = n_ids + 1, items = n_win * per;
    for (int i = threadIdx.x; i < items; i += THREADS) {
      const int q = i / per, v = i - q * per;
      const int j = win[q], r = j / ck, s = j - r * ck;
      if (v < n_ids) {
        const int id = ((const int32_t*)(prev + r * b.slot_bytes +
                                         8LL * ck))[s * n_ids + v];
        if (id < 0) continue;
        if (v < n_s)
          atomicAdd(&sp_tab[v * n_p + min(id, n_p - 1)], 1);
        else
          atomicSub(&dr_tab[(v - n_s) * n_dp + min(id, n_dp - 1)], 1);
      } else if (r == a.shard && prev_own[s] % CLUSTER == rank) {
        const int w = prev_own[s] / CLUSTER;
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
        shard_pre(b, s_ask, c, u, pl, nd.coll[w], nd.aff[w], &pre, &n_pre);
        nd.pre[w] = pre;
        nd.npre[w] = n_pre;
      }
    }
    remaining -= n_sel;
    done = n_sel == 0 || remaining <= 0 || t >= b.max_steps;
    __syncthreads();
  }

  // 2. the solve is over: the rows and the tables back to the outputs
  if (done) {
    for (int j = threadIdx.x; j < m_live; j += THREADS) {
      const int i = nd.idx[j];
      a.placed[i] = nd.placed[j];
#pragma unroll
      for (int x = 0; x < NUM_XR; ++x)
        a.used[(size_t)i * NUM_XR + x] = nd.used[x * m_cap + j];
    }
    if (rank == 0) {
      for (int j = threadIdx.x; j < n_s * n_p; j += THREADS)
        a.sp_counts_out[j] = sp_tab[j];
      for (int j = threadIdx.x; j < n_d * n_dp; j += THREADS)
        a.dp_rem_out[j] = dr_tab[j];
    }
    if (threadIdx.x == 0) {
      st->remaining = remaining;
      st->steps = t;
      st->done = 1;
    }
    return;
  }

  // 3. score and key every live record, then this CTA's top take
  const int take = min(remaining, ck);
  chunked_spread_stats(sp_tab, n_s, n_p, s_min, s_max, s_any);
  int nv = 0;
  uint32_t hmax = 0, hmin = ~0u;
  for (int j = threadIdx.x; j < m_live; j += THREADS) {
    uint64_t key = 0;
    const float p = nd.pre[j];
    if (p != -CUDART_INF_F &&
        chunked_distinct_ok(j, m_cap, nd_dp, dr_tab, d_act, n_d, n_dp)) {
      bool any_spread;
      float st_s = chunked_spread(j, m_cap, nd_sp, sp_tab, a.sp_desired,
                                  s_mode, s_w, n_s, n_p, s_min, s_max, s_any,
                                  &any_spread);
      float score = chunked_final(p, nd.npre[j], st_s, any_spread);
      if (isfinite(score)) {
        key = scan_key(score, a.shard * n + nd.idx[j]);
        hmax = max(hmax, (uint32_t)(key >> 32));
        hmin = min(hmin, (uint32_t)(key >> 32));
        ++nv;
      }
    }
    keys[j] = key;
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
  const int n_valid = n_valid_sh;
  const uint64_t t_local =
      n_valid > take ? block_select_ordered(keys, m_live, take, hi_max_sh,
                                            hi_min_sh, sh)
                     : 1;
  for (int j = threadIdx.x; j < m_live; j += THREADS) {
    const uint64_t key = keys[j];
    if (key >= t_local) {
      const int k = atomicAdd(&local_sh, 1);
      lk[k] = key;
      lw[k] = j;
      for (int v = 0; v < n_ids; ++v)
        lids[k * n_ids + v] = nd.ids[(size_t)v * m_cap + j];
    }
  }
  if (threadIdx.x == 0) {
    local_n = min(n_valid, take);
    st->take = take;
    st->remaining = remaining;
  }
  cluster.sync();

  // 4. the shard's top take of the 8 local lists: every CTA reads their
  // keys through distributed shared memory in one round and ranks them
  // alike, then writes its own winners into the shard's slot, after the
  // winners of the CTAs before it
  const int u8 = CLUSTER * take;
  if (threadIdx.x < CLUSTER)
    cnt[threadIdx.x] = *cluster.map_shared_rank(&local_n, threadIdx.x);
  for (int j = threadIdx.x; j < u8; j += THREADS) {
    const int r = j / take, s = j - r * take;
    const int c = *cluster.map_shared_rank(&local_n, r);
    const uint64_t key = cluster.map_shared_rank(lk, r)[s];
    uni[j] = s < c ? key : 0;
  }
  // this CTA reads no other CTA's memory past here
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  __syncthreads();
  int u_valid = 0;
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) u_valid += cnt[r];
  const uint64_t t_merge =
      u_valid > take && u8 > THREADS ? block_select(uni, u8, take, sh) : 0;
  for (int j = threadIdx.x; j < u8; j += THREADS) {
    const uint64_t key = uni[j];
    bool sel = key != 0 && u_valid <= take;
    if (key != 0 && !sel && u8 <= THREADS) {
      int above = 0;
#pragma unroll 8
      for (int k = 0; k < u8; ++k) above += uni[k] > key;
      sel = above < take;
    } else if (key != 0 && !sel) {
      sel = key >= t_merge;
    }
    flag[j] = sel;
    if (sel && j < rank * take) atomicAdd(&before_sh, 1);
  }
  __syncthreads();
  unsigned char* slot = a.cand + ((size_t)(t & 1) * S + a.shard) * b.slot_bytes;
  uint64_t* out_keys = (uint64_t*)slot;
  int32_t* out_ids = (int32_t*)(slot + 8LL * ck);
  int32_t* out_own = out_ids + (size_t)ck * n_ids;
  for (int s = threadIdx.x; s < cnt[rank]; s += THREADS) {
    if (!flag[rank * take + s]) continue;
    const int k = before_sh + atomicAdd(&slot_sh, 1);
    out_keys[k] = lk[s];
    for (int v = 0; v < n_ids; ++v)
      out_ids[k * n_ids + v] = lids[s * n_ids + v];
    out_own[k] = lw[s] * CLUSTER + rank;
  }
  if (rank == 0 && threadIdx.x == 0)
    *(int32_t*)(slot + b.slot_bytes - 16) = min(u_valid, take);
  // no CTA leaves while another may still read its list
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// Bytes of scratch a shard of n rows needs (16-byte aligned), for
// chunked_shard_launch: a slice a CTA.
static long long slice_bytes_of(int n, int n_s, int n_p, int n_d, int n_dp) {
  return rec_offset(n_s, n_p, n_d, n_dp) +
         align16((long long)cta_rows(n) * record_bytes(n_s + n_d));
}

extern "C" long long chunked_shard_scratch_bytes(int n, int n_s, int n_p,
                                                 int n_d, int n_dp) {
  return CLUSTER * slice_bytes_of(n, n_s, n_p, n_d, n_dp);
}

// Bytes of a candidate buffer: [2][n_shards] slots.
extern "C" long long chunked_shard_cand_bytes(int n_shards, int chunk,
                                              int n_ids) {
  return 2LL * n_shards * slot_bytes_of(chunk, n_ids);
}

// One sharded solve: max_steps + 1 launches a device, each a cluster of
// CLUSTER CTAs for every shard the device holds, queued in step order and
// device order, no host wait. `ptrs` is [n_shards][NPTR] (the enum above;
// P_STREAM the shard's cudaStream_t), `devs` the shards' device ordinals.
// Shards of one device share its P_CAND buffer and its stream (the first
// of its shards' P_STREAM); where the shards span several devices each
// device's slots travel to the others by peer copy. Per shard: cap [n, 5]
// f32; used/placed the output blocks holding the inputs; ask [5];
// feasible [n] u8; coll [n] i32; sp_ids [n_s, n] i32; sp_counts,
// sp_desired [n_s, n_p]; sp_mode, sp_weights [n_s]; aff [n] f32; dp_ids
// [n_d, n]; dp_rem [n_d, n_dp]; the table outputs as their inputs; scratch
// of chunked_shard_scratch_bytes. The global row offset of shard s is s n.
// *launches_out gets the launches queued. Returns a cudaError_t.
extern "C" int chunked_shard_launch(
    const unsigned long long* ptrs, const int* devs, int n_shards, int n,
    int max_per_node, float desired, int spread, int n_s, int n_p, int n_d,
    int n_dp, int count, int chunk, int max_steps, int* launches_out) {
  *launches_out = 0;
  if (n <= 0 || n_shards < 1 || n_shards > MAX_SHARDS || n_s < 1 ||
      n_s > MAX_STANZAS || n_p < 1 || n_d < 1 || n_d > MAX_STANZAS ||
      n_dp < 1 || chunk < 1 || chunk > MAX_CHUNK || chunk > n * n_shards ||
      max_steps < 0)
    return (int)cudaErrorInvalidValue;
  // the devices in order of their first shard, and each one's shards
  int dev_of[MAX_SHARDS], n_dev = 0;
  ShardBatch batch[MAX_SHARDS];
  int group[MAX_SHARDS];
  for (int s = 0; s < n_shards; ++s) {
    int g = 0;
    while (g < n_dev && dev_of[g] != devs[s]) ++g;
    if (g == n_dev) {
      dev_of[n_dev++] = devs[s];
      batch[g] = ShardBatch{};
    }
    group[s] = g;
  }
  int prev_dev = 0;
  cudaError_t err = cudaGetDevice(&prev_dev);
  if (err != cudaSuccess) return (int)err;
  const int n_ids = n_s + n_d;
  const long long slot = slot_bytes_of(chunk, n_ids);
  long long smem = list_smem(n_shards, chunk, n_ids);
  const bool keys_in_smem = smem + 8LL * cta_rows(n) <= SMEM_LIMIT;
  if (keys_in_smem) smem += 8LL * cta_rows(n);
  cudaStream_t stream[MAX_SHARDS];
  unsigned char* cand[MAX_SHARDS];
  int local[MAX_SHARDS] = {};
  for (int s = 0; s < n_shards; ++s) {
    const unsigned long long* p = ptrs + (size_t)s * NPTR;
    const int g = group[s];
    ShardBatch& b = batch[g];
    if (local[g] == 0) {
      stream[g] = (cudaStream_t)p[P_STREAM];
      cand[g] = (unsigned char*)p[P_CAND];
      b.slot_bytes = slot;
      b.slice_bytes = slice_bytes_of(n, n_s, n_p, n_d, n_dp);
      b.n = n;
      b.n_shards = n_shards;
      b.mpn = max_per_node;
      b.spread = spread;
      b.n_s = n_s;
      b.n_p = n_p;
      b.n_d = n_d;
      b.n_dp = n_dp;
      b.count = count;
      b.chunk = chunk;
      b.max_steps = max_steps;
      b.keys_in_smem = keys_in_smem;
      b.desired = desired;
    }
    ShardPtrs& a = b.sh[local[g]++];
    a.cap = (const float*)p[P_CAP];
    a.used = (float*)p[P_USED];
    a.ask = (const float*)p[P_ASK];
    a.feasible = (const uint8_t*)p[P_FEAS];
    a.job_coll = (const int32_t*)p[P_COLL];
    a.placed = (int32_t*)p[P_PLACED];
    a.sp_ids = (const int32_t*)p[P_SP_IDS];
    a.sp_counts_in = (const int32_t*)p[P_SP_COUNTS];
    a.sp_desired = (const float*)p[P_SP_DES];
    a.sp_mode = (const int32_t*)p[P_SP_MODE];
    a.sp_weights = (const float*)p[P_SP_W];
    a.aff = (const float*)p[P_AFF];
    a.dp_ids = (const int32_t*)p[P_DP_IDS];
    a.dp_rem_in = (const int32_t*)p[P_DP_REM];
    a.sp_counts_out = (int32_t*)p[P_SP_OUT];
    a.dp_rem_out = (int32_t*)p[P_DP_OUT];
    a.scratch = (unsigned char*)p[P_SCRATCH];
    a.cand = cand[g];
    a.shard = s;
  }
  cudaEvent_t ev[MAX_SHARDS] = {};
  for (int g = 0; g < n_dev && err == cudaSuccess; ++g) {
    err = cudaSetDevice(dev_of[g]);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chunked_shard_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err == cudaSuccess && n_dev > 1)
      err = cudaEventCreateWithFlags(&ev[g], cudaEventDisableTiming);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int launches = 0;
  for (int t = 0; t <= max_steps && err == cudaSuccess; ++t) {
    for (int g = 0; g < n_dev && err == cudaSuccess; ++g) {
      if (n_dev > 1) {
        err = cudaSetDevice(dev_of[g]);
        for (int h = 0; h < n_dev && err == cudaSuccess && t > 0; ++h)
          if (h != g) err = cudaStreamWaitEvent(stream[g], ev[h], 0);
        if (err != cudaSuccess) break;
      }
      cfg.gridDim = dim3(CLUSTER * local[g], 1, 1);
      cfg.stream = stream[g];
      err = cudaLaunchKernelEx(&cfg, chunked_shard_kernel, batch[g], t);
      if (err == cudaSuccess) err = cudaGetLastError();
      if (err != cudaSuccess) break;
      ++launches;
      if (n_dev > 1) {
        // this device's lists of step t into every other device's buffer
        for (int i = 0; i < local[g] && err == cudaSuccess; ++i) {
          const size_t off =
              ((size_t)(t & 1) * n_shards + batch[g].sh[i].shard) * slot;
          for (int h = 0; h < n_dev && err == cudaSuccess; ++h)
            if (h != g)
              err = cudaMemcpyPeerAsync(cand[h] + off, dev_of[h],
                                        cand[g] + off, dev_of[g], slot,
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
