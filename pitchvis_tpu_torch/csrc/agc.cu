// AGC kernel: the dagc MonoAgc recurrence over one chunk of samples per stream.
//
// Replaces: pitchvis_tpu/ops/agc.py::agc_chunk, a lax.scan over the chunk's
// time axis (not a Pallas kernel). As eager PyTorch the recurrence is about
// five launches per sample, some 1800 launches a 367-sample hop.
//
// Bound on this card: neither bytes (B*T*4 in, B*T*4 out: 6 MB at B=2048,
// T=367, under 2 us at 3.35 TB/s) nor operations, but the dependent chain of
// T steps per stream, each a handful of dependent float operations.
//
// Design: one thread per stream walks its T samples in order, carrying the
// gain in a register, so a hop is one launch. Small blocks (64 threads) spread
// the few thousand streams over many SMs, so more loads are in flight while
// each thread waits on its chain. Rounding follows the CPU reference bit for
// bit: XLA on the CPU contracts 1 - y*c and 1 + k*(1 - y) into two fused
// multiply-adds, so the kernel spells those two as __fmaf_rn and every other
// product and sum as __fmul_rn/__fadd_rn, and the file is compiled with
// -fmad=false so nvcc adds no contraction of its own.

#include <cuda_runtime.h>

__global__ void agc_chunk_kernel(const float* __restrict__ chunk,
                                 const float* __restrict__ gain_in,
                                 float* __restrict__ out,
                                 float* __restrict__ gain_out,
                                 int B, int T, float k, float inv_rms,
                                 float silence) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* x = chunk + (size_t)b * T;
  float* y = out + (size_t)b * T;

  // silence freeze on the pre-gain chunk energy
  float energy = 0.f;
  for (int t = 0; t < T; ++t) energy = __fadd_rn(energy, __fmul_rn(x[t], x[t]));
  const bool frozen = energy < silence;

  float g = gain_in[b];
  for (int t = 0; t < T; ++t) {
    float o = __fmul_rn(x[t], g);
    y[t] = o;
    float sq = __fmul_rn(o, o);
    float one_minus_y = __fmaf_rn(-sq, inv_rms, 1.f);
    float upd = __fmaf_rn(one_minus_y, k, 1.f);
    upd = (upd >= k || upd != upd) ? upd : k;  // jnp.maximum, NaN-propagating
    if (!frozen) g = __fmul_rn(g, upd);
  }
  gain_out[b] = g;
}

extern "C" int agc_chunk_f32(const float* chunk, const float* gain_in, float* out,
                             float* gain_out, int B, int T, float k, float inv_rms,
                             float silence, void* stream) {
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  if (blocks > 0) {
    agc_chunk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        chunk, gain_in, out, gain_out, B, T, k, inv_rms, silence);
  }
  return (int)cudaGetLastError();
}
