// The chunked scan with its node axis sharded: one step on one shard, for
// Hopper, sm_90a.
//
// Replaces the reference's sharded scan, nomad_tpu/solver/sharding.py:442
// `sharded_place_chunked`: place_chunked's lax.scan (nomad_tpu/solver/
// kernels.py:345, one XLA program, no Pallas kernel) under a node-axis
// sharding, where GSPMD all-gathers each step's winners. kernels.py
// `chunked_shard_ref` is the plain version: this kernel returns what it
// returns, bit for bit, and so what the solo scan returns (chunked_scan.cu:
// placements, usage, spread counts and distinct quotas).
//
// Design: the solo kernel's cluster of 8 CTAs, with a shard for a CTA and
// a kernel boundary for the cluster barrier. Shard s owns the rows
// [s R, (s + 1) R) of the bucket. Launch t of a shard (one block of 512
// threads):
//   1. (t > 0) reads the S candidate lists of step t - 1, ranks the S x
//      take candidates by key (every shard ranks them alike, so every
//      shard finds the same winners: no merge on the lead), applies the
//      winners' value ids to its own copy of the [S, P] spread counts and
//      [D, P] quotas, and the used/placed/pre-score update to the winners
//      it owns;
//   2. stops where the solo kernel stops (remaining 0, a step that
//      selected nothing, max_steps): sets the shard's done flag and writes
//      its rows and its tables out; every later launch of the solve exits
//      at once (the launcher queues max_steps + 1 launches a shard and
//      never waits);
//   3. else scores its records (chunked_score.cuh, unchanged) and writes
//      its local top take = min(chunk, remaining) keys, with their value
//      ids, into its slot of the step's candidate buffer (double-buffered
//      by step parity).
// Records. Launch 0 compacts the shard's rows that can take an instance
// into records in global scratch, in ascending row order, as the solo
// kernel does in shared memory: a row that cannot take an instance never
// can again, so they never grow. A record's key carries ~(global row) in
// its low word (the shard's row offset plus the local row), so keys are
// unique over the bucket and order exactly as the stable descending sort.
// Candidate lists. On virtual shards (one card listed S times) every shard
// shares one buffer and its launches run in shard order on one stream. On
// several cards each shard has its own buffer; after each launch its slot
// is copied into every other shard's buffer (cudaMemcpyPeerAsync on its
// stream) and an event orders the next step's launches behind it.
// Build without fast math and without FMA contraction, as chunked_scan.cu.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "chunked_score.cuh"
#include "chunked_select.cuh"

#define MAX_CHUNK 256            // k = min(N, 256): lax.top_k's static k
#define MAX_SHARDS 16

// the per-shard pointer table the launcher takes, NPTR entries a shard
enum {
  P_CAP, P_USED, P_ASK, P_FEAS, P_COLL, P_PLACED, P_SP_IDS, P_SP_COUNTS,
  P_SP_DES, P_SP_MODE, P_SP_W, P_AFF, P_DP_IDS, P_DP_REM, P_SP_OUT,
  P_DP_OUT, P_SCRATCH, P_CAND, P_STREAM, NPTR
};

// a shard's running state, at the start of its scratch
struct ShardState {
  int remaining;
  int done;
  int steps;
  int take;          // the last scored step's take
  int m_live;
  int early_exits;   // launches that found the solve done
  int pad[2];
};

struct ShardArgs {
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
  unsigned char* scratch;
  unsigned char* cand;          // [2][n_shards] slots of slot_bytes
  long long slot_bytes;
  int n, offset, shard, n_shards, mpn, spread, n_s, n_p, n_d, n_dp, count,
      chunk, max_steps;
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

// a slot: chunk keys, their value ids, then the list's count in its
// last 16 bytes
__host__ __device__ __forceinline__ long long slot_bytes_of(int chunk,
                                                            int n_ids) {
  return align16(8LL * chunk + 4LL * chunk * n_ids) + 16;
}

// scratch layout: state, own candidates' record indices [2][chunk],
// tables, records
__host__ __device__ __forceinline__ long long tab_offset(int chunk) {
  return align16(sizeof(ShardState) + 8LL * chunk);
}
__host__ __device__ __forceinline__ long long rec_offset(int chunk, int n_s,
                                                         int n_p, int n_d,
                                                         int n_dp) {
  return tab_offset(chunk) + align16(4LL * (n_s * n_p + n_d * n_dp));
}

struct Records {
  uint64_t* key;
  int32_t* idx;                 // the local row
  float* pre;
  float* npre;
  int32_t* coll;
  float* aff;
  int32_t* placed;
  float* cap;                   // [NUM_XR][n]
  float* used;                  // [NUM_XR][n]
  int32_t* ids;                 // [n_s + n_d][n]: spread, then distinct
};

__device__ __forceinline__ Records records_of(const ShardArgs& a) {
  const int m = a.n;
  Records r;
  r.key = (uint64_t*)(a.scratch +
                      rec_offset(a.chunk, a.n_s, a.n_p, a.n_d, a.n_dp));
  r.idx = (int32_t*)(r.key + m);
  r.pre = (float*)(r.idx + m);
  r.npre = r.pre + m;
  r.coll = (int32_t*)(r.npre + m);
  r.aff = (float*)(r.coll + m);
  r.placed = (int32_t*)(r.aff + m);
  r.cap = (float*)(r.placed + m);
  r.used = r.cap + NUM_XR * m;
  r.ids = (int32_t*)(r.used + NUM_XR * m);
  return r;
}

// the part of the score that changes only when the node is selected;
// false where the node can take no instance (capacity, max_per_node)
__device__ __forceinline__ bool shard_pre(const ShardArgs& a,
                                          const float* ask, const float* c,
                                          const float* u, int32_t pl,
                                          int32_t coll, float aff, float* pre,
                                          float* n_pre) {
  if (!chunked_fits(c, u, ask, pl, a.mpn)) return false;
  *pre = chunked_pre(chunked_raw(c, u, ask, a.spread), coll + pl, a.desired,
                     aff, n_pre);
  return true;
}

// Launch 0: the shard's tables and records.
__device__ void shard_init(const ShardArgs& a, ShardState* st,
                           const float* s_ask, SelectShared& sh) {
  int32_t* sp_tab = (int32_t*)(a.scratch + tab_offset(a.chunk));
  int32_t* dr_tab = sp_tab + a.n_s * a.n_p;
  for (int j = threadIdx.x; j < a.n_s * a.n_p; j += THREADS)
    sp_tab[j] = a.sp_counts_in[j];
  for (int j = threadIdx.x; j < a.n_d * a.n_dp; j += THREADS)
    dr_tab[j] = a.dp_rem_in[j];
  Records nd = records_of(a);
  const int n = a.n, n_s = a.n_s, n_d = a.n_d;
  // the plain loop adds 0 * ask to every unselected row each step it
  // runs; once is enough (x + 0 * a is idempotent), and it turns -0.0
  // usage into +0.0 as the plain loop does
  const bool touch = a.max_steps > 0 && a.count != 0;
  const int q = (n + THREADS - 1) / THREADS;
  const int j0 = min((int)threadIdx.x * q, n), j1 = min(j0 + q, n);
  int live = 0, m_live = 0;
  for (int pass = 0; pass < 2; ++pass) {
    int w = pass == 1 ? block_exclusive(live, sh, &m_live) : 0;
    for (int i = j0; i < j1; ++i) {
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
          !shard_pre(a, s_ask, c, u, pl, coll, aff, &pre, &n_pre))
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
        nd.cap[r * n + w] = c[r];
        nd.used[r * n + w] = u[r];
      }
      for (int s = 0; s < n_s; ++s)
        nd.ids[(size_t)s * n + w] = a.sp_ids[(size_t)s * n + i];
      for (int d = 0; d < n_d; ++d)
        nd.ids[(size_t)(n_s + d) * n + w] = a.dp_ids[(size_t)d * n + i];
      ++w;
    }
  }
  if (threadIdx.x == 0) {
    st->remaining = a.count;
    st->done = 0;
    st->steps = 0;
    st->take = 0;
    st->m_live = m_live;
    st->early_exits = 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
    chunked_shard_kernel(ShardArgs a, int t) {
  ShardState* st = (ShardState*)a.scratch;
  int32_t* cand_j = (int32_t*)(a.scratch + sizeof(ShardState));  // [2][ck]
  int32_t* sp_tab = (int32_t*)(a.scratch + tab_offset(a.chunk));
  int32_t* dr_tab = sp_tab + a.n_s * a.n_p;
  const int n = a.n, n_s = a.n_s, n_p = a.n_p, n_d = a.n_d, n_dp = a.n_dp;
  const int n_ids = n_s + n_d, ck = a.chunk, S = a.n_shards;

  __shared__ SelectShared sh;
  __shared__ int s_mode[MAX_STANZAS];
  __shared__ int s_min[MAX_STANZAS], s_max[MAX_STANZAS], s_any[MAX_STANZAS];
  __shared__ float s_w[MAX_STANZAS], s_ask[NUM_XR];
  __shared__ uint8_t d_act[MAX_STANZAS];
  __shared__ int cnt[MAX_SHARDS];
  __shared__ int n_valid_sh, slot_sh;
  __shared__ unsigned hi_max_sh, hi_min_sh;
  extern __shared__ uint64_t uni[];                   // [S][take]

  if (t > 0 && st->done) {
    if (threadIdx.x == 0) st->early_exits += 1;
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
    n_valid_sh = slot_sh = 0;
    hi_max_sh = 0;
    hi_min_sh = ~0u;
  }
  __syncthreads();
  if (t == 0) shard_init(a, st, s_ask, sh);
  Records nd = records_of(a);
  const int32_t* nd_sp = nd.ids;
  const int32_t* nd_dp = nd.ids + (size_t)n_s * n;
  const int m_live = st->m_live;
  int remaining = st->remaining;
  bool done = t == 0 && (remaining <= 0 || a.max_steps <= 0);

  // 1. the winners of step t - 1, from every shard's list
  if (t > 0) {
    const int par = (t - 1) & 1, take = st->take;
    const unsigned char* base = a.cand + (size_t)par * S * a.slot_bytes;
    if (threadIdx.x < S)
      cnt[threadIdx.x] = *(const int32_t*)(base + threadIdx.x * a.slot_bytes +
                                           a.slot_bytes - 16);
    __syncthreads();
    const int u_slots = S * take;
    for (int j = threadIdx.x; j < u_slots; j += THREADS) {
      const int r = j / take, s = j - r * take;
      const uint64_t* keys = (const uint64_t*)(base + r * a.slot_bytes);
      uni[j] = s < cnt[r] ? keys[s] : 0;
    }
    __syncthreads();
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
        for (int k = 0; k < u_slots; ++k) above += uni[k] > key;
        sel = above < take;
      } else if (!sel) {
        sel = key >= t_global;
      }
      if (!sel) continue;
      const int r = j / take, s = j - r * take;
      const int32_t* ids =
          (const int32_t*)(base + r * a.slot_bytes + 8LL * ck) + s * n_ids;
      for (int v = 0; v < n_s; ++v) {
        int id = ids[v];
        if (id >= 0) atomicAdd(&sp_tab[v * n_p + min(id, n_p - 1)], 1);
      }
      for (int d = 0; d < n_d; ++d) {
        int id = ids[n_s + d];
        if (id >= 0) atomicSub(&dr_tab[d * n_dp + min(id, n_dp - 1)], 1);
      }
      if (r == a.shard) {
        const int w = cand_j[par * ck + s];
        float c[NUM_XR], u[NUM_XR];
#pragma unroll
        for (int x = 0; x < NUM_XR; ++x) {
          c[x] = nd.cap[x * n + w];
          u[x] = nd.used[x * n + w] + s_ask[x];
          nd.used[x * n + w] = u[x];
        }
        const int32_t pl = nd.placed[w] + 1;
        nd.placed[w] = pl;
        float pre = -CUDART_INF_F, n_pre = 1.0f;
        shard_pre(a, s_ask, c, u, pl, nd.coll[w], nd.aff[w], &pre, &n_pre);
        nd.pre[w] = pre;
        nd.npre[w] = n_pre;
      }
    }
    remaining -= n_sel;
    done = n_sel == 0 || remaining <= 0 || t >= a.max_steps;
    __syncthreads();
  }

  // 2. the solve is over: the rows and the tables back to the outputs
  if (done) {
    for (int j = threadIdx.x; j < m_live; j += THREADS) {
      const int i = nd.idx[j];
      a.placed[i] = nd.placed[j];
#pragma unroll
      for (int x = 0; x < NUM_XR; ++x)
        a.used[(size_t)i * NUM_XR + x] = nd.used[x * n + j];
    }
    for (int j = threadIdx.x; j < n_s * n_p; j += THREADS)
      a.sp_counts_out[j] = sp_tab[j];
    for (int j = threadIdx.x; j < n_d * n_dp; j += THREADS)
      a.dp_rem_out[j] = dr_tab[j];
    if (threadIdx.x == 0) {
      st->remaining = remaining;
      st->steps = t;
      st->done = 1;
    }
    return;
  }

  // 3. score and key every live record, then this shard's top take
  const int take = min(remaining, ck);
  const int par = t & 1;
  chunked_spread_stats(sp_tab, n_s, n_p, s_min, s_max, s_any);
  int nv = 0;
  uint32_t hmax = 0, hmin = ~0u;
  for (int j = threadIdx.x; j < m_live; j += THREADS) {
    uint64_t key = 0;
    const float p = nd.pre[j];
    if (p != -CUDART_INF_F &&
        chunked_distinct_ok(j, n, nd_dp, dr_tab, d_act, n_d, n_dp)) {
      bool any_spread;
      float st_s = chunked_spread(j, n, nd_sp, sp_tab, a.sp_desired, s_mode,
                                  s_w, n_s, n_p, s_min, s_max, s_any,
                                  &any_spread);
      float score = chunked_final(p, nd.npre[j], st_s, any_spread);
      if (isfinite(score)) {
        key = scan_key(score, a.offset + nd.idx[j]);
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
  const int n_valid = n_valid_sh;
  const uint64_t t_local =
      n_valid > take ? block_select_ordered(nd.key, m_live, take, hi_max_sh,
                                            hi_min_sh, sh)
                     : 1;
  unsigned char* slot = a.cand + ((size_t)par * S + a.shard) * a.slot_bytes;
  uint64_t* keys = (uint64_t*)slot;
  int32_t* ids = (int32_t*)(slot + 8LL * ck);
  for (int j = threadIdx.x; j < m_live; j += THREADS) {
    const uint64_t key = nd.key[j];
    if (key >= t_local) {
      const int k = atomicAdd(&slot_sh, 1);
      keys[k] = key;
      cand_j[par * ck + k] = j;
      for (int v = 0; v < n_ids; ++v)
        ids[k * n_ids + v] = nd.ids[(size_t)v * n + j];
    }
  }
  if (threadIdx.x == 0) {
    *(int32_t*)(slot + a.slot_bytes - 16) = min(n_valid, take);
    st->take = take;
    st->remaining = remaining;
  }
}

// Bytes of scratch a shard of n rows needs (16-byte aligned), for
// chunked_shard_launch.
extern "C" long long chunked_shard_scratch_bytes(int n, int n_s, int n_p,
                                                 int n_d, int n_dp,
                                                 int chunk) {
  return rec_offset(chunk, n_s, n_p, n_d, n_dp) +
         align16((long long)n * record_bytes(n_s + n_d));
}

// Bytes of a candidate buffer: [2][n_shards] slots.
extern "C" long long chunked_shard_cand_bytes(int n_shards, int chunk,
                                              int n_ids) {
  return 2LL * n_shards * slot_bytes_of(chunk, n_ids);
}

// One sharded solve: max_steps + 1 launches a shard, queued in step order
// and shard order, no host wait. `ptrs` is [n_shards][NPTR] (the enum
// above; P_STREAM the shard's cudaStream_t), `devs` the shards' device
// ordinals: where they are all equal (virtual shards) every P_CAND names
// one shared buffer; else each shard's own, and slots travel by peer copy.
// Per shard: cap [n, 5] f32; used/placed the output blocks holding the
// inputs; ask [5]; feasible [n] u8; coll [n] i32; sp_ids [n_s, n] i32;
// sp_counts, sp_desired [n_s, n_p]; sp_mode, sp_weights [n_s]; aff [n] f32;
// dp_ids [n_d, n]; dp_rem [n_d, n_dp]; the table outputs as their inputs;
// scratch of chunked_shard_scratch_bytes. The global row offset of shard s
// is s n. *launches_out gets the launches queued. Returns a cudaError_t.
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
  bool shared = true;
  for (int s = 1; s < n_shards; ++s) shared = shared && devs[s] == devs[0];
  int prev_dev = 0;
  cudaError_t err = cudaGetDevice(&prev_dev);
  if (err != cudaSuccess) return (int)err;
  const long long slot = slot_bytes_of(chunk, n_s + n_d);
  const size_t smem = (size_t)n_shards * chunk * 8;
  ShardArgs args[MAX_SHARDS];
  cudaEvent_t ev[MAX_SHARDS] = {};
  for (int s = 0; s < n_shards; ++s) {
    const unsigned long long* p = ptrs + (size_t)s * NPTR;
    ShardArgs& a = args[s];
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
    a.cand = (unsigned char*)p[P_CAND];
    a.slot_bytes = slot;
    a.n = n;
    a.offset = s * n;
    a.shard = s;
    a.n_shards = n_shards;
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
    if (!shared) {
      err = cudaSetDevice(devs[s]);
      if (err == cudaSuccess)
        err = cudaEventCreateWithFlags(&ev[s], cudaEventDisableTiming);
      if (err != cudaSuccess) break;
    }
  }
  int launches = 0;
  for (int t = 0; t <= max_steps && err == cudaSuccess; ++t) {
    for (int s = 0; s < n_shards && err == cudaSuccess; ++s) {
      cudaStream_t stream = (cudaStream_t)ptrs[(size_t)s * NPTR + P_STREAM];
      if (!shared) {
        err = cudaSetDevice(devs[s]);
        for (int r = 0; r < n_shards && err == cudaSuccess && t > 0; ++r)
          if (r != s) err = cudaStreamWaitEvent(stream, ev[r], 0);
        if (err != cudaSuccess) break;
      }
      chunked_shard_kernel<<<1, THREADS, smem, stream>>>(args[s], t);
      err = cudaGetLastError();
      if (err != cudaSuccess) break;
      ++launches;
      if (!shared) {
        // this shard's list of step t into every other shard's buffer
        const size_t off = ((size_t)(t & 1) * n_shards + s) * slot;
        for (int r = 0; r < n_shards && err == cudaSuccess; ++r)
          if (r != s)
            err = cudaMemcpyPeerAsync(args[r].cand + off, devs[r],
                                      args[s].cand + off, devs[s], slot,
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
