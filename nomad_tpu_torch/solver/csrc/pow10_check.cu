// Exhaustive check of pow10.cuh: pow10_f32 (what the placement kernels
// call) against pow10_ref (10**x in float64, rounded once to float32) on
// every float32 whose bit pattern lies in [first, last]. Counts, summed
// over the range into counts[0..2]:
//   0  mismatches: results that differ in any bit
//   1  inputs the cheap estimate left to the float64 pow
//   2  inputs where either result is nonzero
// Built beside the placement kernels; chip_smoke.py's pow10 phase runs it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pow10.cuh"

#define THREADS 256
#define FULL_MASK 0xffffffffu

__global__ void __launch_bounds__(THREADS) pow10_check_kernel(
    uint32_t first, uint32_t last, unsigned long long* __restrict__ counts) {
  unsigned long long mismatches = 0, undecided = 0, nonzero = 0;
  const uint64_t n = (uint64_t)last - first + 1;
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t j = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    float x = __uint_as_float(first + (uint32_t)j);
    float got = pow10_f32(x);
    float ref = pow10_ref(x);
    float est;
    mismatches += __float_as_uint(got) != __float_as_uint(ref);
    undecided += !pow10_estimate(x, &est);
    nonzero += got != 0.0f || ref != 0.0f;
  }
  for (int o = 16; o > 0; o >>= 1) {
    mismatches += __shfl_down_sync(FULL_MASK, mismatches, o);
    undecided += __shfl_down_sync(FULL_MASK, undecided, o);
    nonzero += __shfl_down_sync(FULL_MASK, nonzero, o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&counts[0], mismatches);
    atomicAdd(&counts[1], undecided);
    atomicAdd(&counts[2], nonzero);
  }
}

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// `counts` is a device array of 3 zeroed 64-bit counters.
extern "C" int pow10_check_launch(unsigned first, unsigned last,
                                  unsigned long long* counts, void* stream) {
  if (last < first) return (int)cudaErrorInvalidValue;
  const int blocks = 132 * 16;
  pow10_check_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      first, last, counts);
  return (int)cudaGetLastError();
}
