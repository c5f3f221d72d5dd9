// Ring push and AGC: one launch a hop takes every stream's ring buffer, gain
// and chunk of new samples to its new buffer and gain.
//
// Replaces: pitchvis_tpu/ops/agc.py::agc_chunk, a lax.scan over the chunk's
// time axis (not a Pallas kernel), and the XLA fusion around it in
// pitchvis_tpu/stream/ring.py::ring_push: the non-finite test, the
// concatenate-then-select roll of the (B, L) buffer and the gain select. As
// eager PyTorch those are some eight launches around the recurrence, two of
// which read the whole ring.
//
// Bound on this card: bytes. A push reads the ring once and writes the new
// one once (2 x 268 MB at B=2048, L=32768: 0.16 ms at 3.35 TB/s). The
// recurrence is a chain of T dependent steps of some six dependent float
// operations a stream (a few microseconds at T=367), short enough to run
// under the stream's 128 KB copy.
//
// Design: one block a stream (one row).
// 1. All threads vote on the chunk: a row with any non-finite sample
//    (__syncthreads_or) copies its buffer unchanged and keeps its gain.
// 2. Otherwise the roles split. Warp 0 sums the chunk's energy (the silence
//    freeze), then stages the chunk through shared memory a tile at a time;
//    lane 0 runs the recurrence on the tile in place and the warp appends it
//    at new_buffer[L-T:L]. Meanwhile the other warps shift buffer[T:L] to
//    new_buffer[0:L-T]. No barrier joins the two: they write disjoint ranges.
// 3. The shift: T is odd at the default hop, so its source and destination
//    are never both 16-byte aligned. Each thread stores aligned float4s, each
//    built from the two aligned float4 loads that hold its four source
//    samples, with a scalar head and tail to the row's alignment.
// The chunk mode (RING=false, ops/agc.py::agc_chunk) is the same function with
// L = T, no buffer and no vote, one warp a block: it writes the processed
// chunk and the gain. It takes the freeze flags from the caller where they
// are given (agc_chunk(frozen=)), else computes them from the energy.
//
// The signal mode (agc_signal_kernel, ops/agc.py::agc_signal) replaces the
// dataset's AGC, pitchvis_tpu/train/device_dataset.py::agc_signal_device and
// the scan inside _render_agc_jit (lax.scans of agc_chunk over the chunks of
// a whole signal, not Pallas). One warp a row runs agc_row over the row's C
// chunks in order, each with its own freeze, carries the gain from chunk to
// chunk in lane 0's register and writes the gain after each chunk: one launch
// for all chunks of every row, where the chunk mode would take one a chunk.
// Bound on this card: latency. The bytes are 8 a sample (10.6 MB for a
// 60-second file, about 3 us at 3.35 TB/s), but the recurrence is one chain
// of six dependent float operations a sample (fmul, fmul, fma, fma, max,
// fmul) through the gain, 1.33 M samples long for that file: some tens of
// milliseconds whatever the kernel does, unless rows are batched (B rows run
// side by side, one a block).
//
// Rounding follows the JAX package's CPU scan bit for bit: XLA contracts
// 1 - y*c and 1 + k*(1 - y) into two fused multiply-adds, so the kernel spells
// those two as __fmaf_rn and every other product as __fmul_rn, and the file is
// compiled with -fmad=false so nvcc adds no contraction of its own. The energy
// is summed in the warp's own order (the same in both modes); it decides only
// the freeze, which can differ from the JAX package's only on a chunk whose
// energy lies within rounding of 1e-6.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kRingThreads = 256;  // warp 0 runs the chunk, the other warps the shift
constexpr int kTile = 1024;        // chunk samples a stage of warp 0
constexpr int kUnroll = 8;         // float4 loads in flight a thread before its stores

// The four source floats src[4i .. 4i+3] from aligned float4s: s4 = src - r is
// 16-byte aligned. Each float4 read holds at least one sample of the source
// range, so it lies inside the allocation.
__device__ __forceinline__ float4 funnel(const float4* __restrict__ s4, int i, int r) {
  const float4 a = s4[i];
  if (r == 0) return a;
  const float4 c = s4[i + 1];
  if (r == 1) return make_float4(a.y, a.z, a.w, c.x);
  if (r == 2) return make_float4(a.z, a.w, c.x, c.y);
  return make_float4(a.w, c.x, c.y, c.z);
}

// dst[0:n] = src[0:n] by threads t of nt: aligned float4 stores between a
// scalar head (to dst's 16-byte boundary) and a scalar tail.
__device__ __forceinline__ void copy_row(float* __restrict__ dst, const float* __restrict__ src, int n,
                                         int t, int nt) {
  const int head = min(n, (int)(((16u - ((uint32_t)(uintptr_t)dst & 15u)) & 15u) >> 2));
  if (t < head) dst[t] = src[t];
  dst += head;
  src += head;
  n -= head;
  const int nv = n >> 2;
  const int r = (int)(((uintptr_t)src >> 2) & 3);
  const float4* s4 = reinterpret_cast<const float4*>(src - r);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i0 = t; i0 < nv; i0 += kUnroll * nt) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < nv) v[u] = funnel(s4, i, r);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < nv) d4[i] = v[u];
    }
  }
  if (t < (n & 3)) dst[4 * nv + t] = src[4 * nv + t];
}

// Warp 0: the freeze and the recurrence over x[0:T], written to y[0:T];
// returns the new gain in lane 0.
// frozen_in: 0 or 1 as the caller gives it, or -1 for the silence freeze.
__device__ __forceinline__ float agc_row(const float* __restrict__ x, float* __restrict__ y, float* tile,
                                         int T, float g, float k, float inv_rms, float silence,
                                         int frozen_in) {
  const int lane = threadIdx.x & 31;
  bool frozen = frozen_in > 0;
  if (frozen_in < 0) {
    float energy = 0.f;
    for (int i = lane; i < T; i += 32) energy = __fadd_rn(energy, __fmul_rn(x[i], x[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) energy = __fadd_rn(energy, __shfl_xor_sync(0xffffffffu, energy, off));
    frozen = energy < silence;
  }

  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    for (int i = lane; i < n; i += 32) tile[i] = x[base + i];
    __syncwarp();
    if (lane == 0) {
      for (int t = 0; t < n; ++t) {
        const float o = __fmul_rn(tile[t], g);
        tile[t] = o;
        const float sq = __fmul_rn(o, o);
        const float one_minus_y = __fmaf_rn(-sq, inv_rms, 1.f);
        float upd = __fmaf_rn(one_minus_y, k, 1.f);
        upd = (upd >= k || upd != upd) ? upd : k;  // jnp.maximum, NaN-propagating
        if (!frozen) g = __fmul_rn(g, upd);
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) y[base + i] = tile[i];
    __syncwarp();
  }
  return g;
}

// Row b of the output is out + b * L, its last T floats the processed chunk.
template <bool RING>
__global__ void __launch_bounds__(RING ? kRingThreads : 32)
ring_push_kernel(const float* __restrict__ chunk, int64_t chunk_stride, const float* __restrict__ gain_in,
                 const float* __restrict__ buffer, int64_t buffer_stride, float* __restrict__ out,
                 float* __restrict__ gain_out, const uint8_t* __restrict__ frozen, int L, int T, float k,
                 float inv_rms, float silence) {
  __shared__ float tile[kTile];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* x = chunk + (int64_t)b * chunk_stride;
  float* row = out + (int64_t)b * L;

  if (RING) {
    const float* src = buffer + (int64_t)b * buffer_stride;
    bool bad = false;
    for (int i = tid; i < T; i += kRingThreads) bad |= !isfinite(x[i]);
    if (__syncthreads_or(bad)) {
      copy_row(row, src, L, tid, kRingThreads);
      if (tid == 0) gain_out[b] = gain_in[b];
      return;
    }
    if (tid >= 32) {
      copy_row(row, src + T, L - T, tid - 32, kRingThreads - 32);
      return;
    }
  }
  const float g = agc_row(x, row + (L - T), tile, T, gain_in[b], k, inv_rms, silence, frozen ? frozen[b] : -1);
  if (tid == 0) gain_out[b] = g;
}

// Signal mode: row b of x holds C chunks of T samples; y is (B, C * T) and
// gains (B, C). The gain starts at 1.
__global__ void __launch_bounds__(32)
agc_signal_kernel(const float* __restrict__ x, int64_t x_stride, float* __restrict__ y, float* __restrict__ gains,
                  int C, int T, float k, float inv_rms, float silence) {
  __shared__ float tile[kTile];
  const int b = blockIdx.x;
  const float* xr = x + (int64_t)b * x_stride;
  float* yr = y + (int64_t)b * C * T;
  float g = 1.f;  // lane 0's is the gain; the other lanes' copies are not read
  for (int c = 0; c < C; ++c) {
    g = agc_row(xr + (int64_t)c * T, yr + (int64_t)c * T, tile, T, g, k, inv_rms, silence, -1);
    if (threadIdx.x == 0) gains[(int64_t)b * C + c] = g;
  }
}

extern "C" int agc_ring_push_f32(const float* buffer, long long buffer_stride, const float* gain,
                                 const float* chunk, long long chunk_stride, float* new_buffer,
                                 float* new_gain, int B, int L, int T, float k, float inv_rms,
                                 float silence, void* stream) {
  ring_push_kernel<true><<<B, kRingThreads, 0, (cudaStream_t)stream>>>(
      chunk, chunk_stride, gain, buffer, buffer_stride, new_buffer, new_gain, nullptr, L, T, k, inv_rms, silence);
  return (int)cudaGetLastError();
}

// frozen: (B,) bytes, or null for the silence freeze.
extern "C" int agc_chunk_f32(const float* chunk, long long chunk_stride, const float* gain,
                             const uint8_t* frozen, float* out, float* gain_out, int B, int T, float k,
                             float inv_rms, float silence, void* stream) {
  ring_push_kernel<false><<<B, 32, 0, (cudaStream_t)stream>>>(
      chunk, chunk_stride, gain, nullptr, 0, out, gain_out, frozen, T, T, k, inv_rms, silence);
  return (int)cudaGetLastError();
}

extern "C" int agc_signal_f32(const float* x, long long x_stride, float* y, float* gains, int B, int C, int T,
                              float k, float inv_rms, float silence, void* stream) {
  agc_signal_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(x, x_stride, y, gains, C, T, k, inv_rms, silence);
  return (int)cudaGetLastError();
}
