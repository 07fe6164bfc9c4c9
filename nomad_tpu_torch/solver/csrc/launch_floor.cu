// Floors for telling a kernel at its floor from a slow one. Built beside
// the placement kernels; nothing on the placement path launches them.
//
//   launch_floor_launch          an empty kernel: the device time of
//                                the smallest launch
//   launch_floor_gather_launch   the fit verdict's grid (csrc/
//                                fit_verdict.cu: one row a thread in
//                                128-thread blocks, a grid axis over the
//                                lanes) doing only its dependent chain:
//                                idx, one gathered float a row, a store

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_XR 5
#define THREADS 128          // fit_verdict.cu's block

__global__ void launch_floor_kernel() {}

__global__ void __launch_bounds__(THREADS) gather_floor_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ src, int n,
    float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)blockIdx.y * n + i;
  out[o] = src[(size_t)idx[o] * NUM_XR];
}

extern "C" int launch_floor_launch(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// idx int32 [n_lanes, n], every entry a valid row of `src` (float32
// [n_res, 5]: the first column is read); out float32 [n_lanes, n].
extern "C" int launch_floor_gather_launch(const int32_t* idx,
                                          const float* src, int n,
                                          int n_lanes, float* out,
                                          void* stream) {
  if (n <= 0 || n_lanes <= 0) return (int)cudaErrorInvalidValue;
  const dim3 blocks((n + THREADS - 1) / THREADS, n_lanes);
  gather_floor_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      idx, src, n, out);
  return (int)cudaGetLastError();
}
