// An empty kernel at a caller-chosen grid, block and dynamic shared memory:
// what a launch of that shape costs on this card before it does any work.
// A measuring aid (chip_smoke.py times it beside the peaks kernel, whose
// bytes bound lies below it); nothing of the package's paths calls it.

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int launch_floor(int blocks, int threads, int smem_bytes, void* stream) {
  empty_kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
