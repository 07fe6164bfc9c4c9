// Fit-verdict kernel for Hopper, sm_90a.
//
// Replaces no Pallas kernel: it is the plan-evaluate verdict of the
// reference's whole-eval fused program (nomad_tpu/solver/kernels.py
// `plan_fit_verdict` inside `fused_eval_depth` / `fused_eval_greedy`,
// one XLA program there). Per row b of an eval (and per lane l of a
// micro-batch window) it answers whether the node still fits its
// placements after the solve:
//   fit[l, b] = all_r  used[idx[l, b], r] + k[l, b] * ask[l, r]
//                        <= cap[idx[l, b], r] + FIT_EPS
// reading the state cache's resident twins through idx (a zero row where
// valid[l, b] is 0), as kernels.gather_rows builds the eval's rows. The
// applier takes a True row as proof of fit (plan_apply's verdict fast
// path), so the compare must be the reference's to the bit: XLA's CPU
// backend contracts `used + k * ask` into one fused multiply-add, so this
// kernel calls __fmaf_rn there (kernels.fused_fit_verdict is the plain
// version) and builds without FMA contraction elsewhere; cap + FIT_EPS is
// a float32 add.
//
// It also copies the placement vector beside the verdict, so the eval's
// two results lie in one buffer and reach the host in one copy: placed
// as int32 [L, n] at `out_placed`, the verdict as bytes [L, n] at
// `out_fit` (the wrapper points both into one allocation).
//
// What bounds it on this card: the launch. A row reads its index, valid
// byte and placement (9 bytes) and two gathered twin rows (40 bytes) and
// writes 5 bytes: about 0.9 MB at the 16,384-row bucket, a quarter of a
// microsecond at HBM rate, against a launch of a few microseconds.
//
// Design: one thread per row in 128-thread blocks, a second grid axis
// over the lanes; the ragged edge masked by the thread index. ptxas
// (CUDA 12.8, sm_90a): 32 registers, no spills. launch_floor.cu's gather
// entry runs this grid through idx, one gathered float a row and a
// store: the floor the kernel is held to. Four rows a thread (40 gathers
// in flight), two, and 32- or 64-thread blocks measured no faster on an
// H100 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_XR 5
#define THREADS 128
#define MAX_LANES 8          // buckets.BATCH_LANES: the largest window
#define FIT_EPS 1e-3f        // kernels.FIT_EPS == plan_apply._FIT_EPS

__global__ void __launch_bounds__(THREADS) fit_verdict_kernel(
    const float* __restrict__ cap, const float* __restrict__ used,
    int n_res, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ valid, const float* __restrict__ ask,
    const int32_t* __restrict__ placed, int n,
    int32_t* __restrict__ out_placed, uint8_t* __restrict__ out_fit) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)blockIdx.y * n + i;
  const float* a = ask + (size_t)blockIdx.y * NUM_XR;
  const int32_t k = placed[o];
  const float kf = (float)k;
  const bool live = valid[o] != 0;
  const size_t src = (size_t)min(max(idx[o], 0), n_res - 1);
  bool fit = true;
#pragma unroll
  for (int r = 0; r < NUM_XR; ++r) {
    const float c = live ? cap[src * NUM_XR + r] : 0.0f;
    const float u = live ? used[src * NUM_XR + r] : 0.0f;
    const float post = __fmaf_rn(kf, a[r], u);
    fit = fit && post <= c + FIT_EPS;
  }
  out_placed[o] = k;
  out_fit[o] = fit ? 1 : 0;
}

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// cap_res/used_res [n_res, 5]; idx, valid and placed [n_lanes, n]; ask
// [n_lanes, 5]; out_placed int32 [n_lanes, n], out_fit uint8 [n_lanes, n].
extern "C" int fit_verdict_launch(
    const float* cap_res, const float* used_res, int n_res,
    const int32_t* idx, const uint8_t* valid, const float* ask,
    const int32_t* placed, int n, int n_lanes, int32_t* out_placed,
    uint8_t* out_fit, void* stream) {
  if (n_res <= 0) return (int)cudaErrorInvalidValue;
  if (n_lanes < 0 || n_lanes > MAX_LANES) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_lanes == 0) return 0;
  const dim3 blocks((n + THREADS - 1) / THREADS, n_lanes);
  fit_verdict_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      cap_res, used_res, n_res, idx, valid, ask, placed, n, out_placed,
      out_fit);
  return (int)cudaGetLastError();
}
