// An empty kernel: the card's launch floor, the device time of the
// smallest launch, for telling a kernel at the floor from a slow one.
// Built beside the placement kernels; nothing on the placement path
// launches it.

#include <cuda_runtime.h>

__global__ void launch_floor_kernel() {}

extern "C" int launch_floor_launch(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
