// Peak primitives: the local-maximum mask (plateau midpoint, edges excluded)
// and the scipy prominence at every bin of a batch of spectra.
//
// Replaces: pitchvis_tpu/ops/peaks_pallas.py::local_maxima_and_prominences_pallas
// (body _peaks_kernel), whose outputs equal pitchvis_tpu/ops/peaks.py's
// local_maxima / prominences exactly. The JAX package lets XLA fuse the
// O(n^2) masked reductions of ops/peaks.py instead; eager PyTorch would
// materialize eight (B, n/2, n) planes a hop (1.4 GB each at B=2048, n=588).
//
// Bound on this card: operations, not bytes (B*n*4 bytes in, B*n*5 out).
// The reference formulation is four masked reductions over all (i, j) bin
// pairs, n^2 per frame.
//
// Design: one block per frame with the spectrum in shared memory and one
// thread per bin i (a block-stride loop covers n > blockDim). Each thread
// scans outward from i only as far as it must: along its plateau for the run
// bounds, then to the nearest strictly greater sample on each side, taking
// the running minimum of the window on the way. On a spectrum that is the
// distance to the next higher peak, far less than n for most bins, so the
// work is a fraction of the n^2 reductions. The result takes only compares,
// a min, a max and one subtraction, so it equals the plain version bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void peaks_kernel(const float* __restrict__ x, int n,
                             uint8_t* __restrict__ mask,
                             float* __restrict__ prom) {
  extern __shared__ float xs[];
  const int64_t row = (int64_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = x[row + i];
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float xi = xs[i];

    // plateau run [s, e] of samples equal to x[i]
    int s = i;
    while (s > 0 && xs[s - 1] == xi) --s;
    int e = i;
    while (e < n - 1 && xs[e + 1] == xi) ++e;
    const bool prev_less = s > 0 && xs[s - 1] < xi;
    const bool next_less = e < n - 1 && xs[e + 1] < xi;
    mask[row + i] = (prev_less && next_less && i == (s + e) / 2) ? 1 : 0;

    // left: window (left_bound, i], left_bound = nearest j < i with x[j] > x[i]
    float left_min = xi;
    for (int j = i - 1; j >= 0; --j) {
      const float v = xs[j];
      if (v > xi) break;
      left_min = fminf(left_min, v);
    }
    // right: window [i, right_bound)
    float right_min = xi;
    for (int j = i + 1; j < n; ++j) {
      const float v = xs[j];
      if (v > xi) break;
      right_min = fminf(right_min, v);
    }
    prom[row + i] = xi - fmaxf(left_min, right_min);
  }
}

extern "C" int peaks_f32(const float* x, int B, int n, uint8_t* mask, float* prom,
                         void* stream) {
  if (B == 0 || n == 0) return 0;
  int threads = ((n + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  size_t smem = (size_t)n * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        peaks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  peaks_kernel<<<B, threads, smem, s>>>(x, n, mask, prom);
  return (int)cudaGetLastError();
}
