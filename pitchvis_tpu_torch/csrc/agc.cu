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
// a whole signal, not Pallas): every chunk of every row in one launch, each
// chunk with its own freeze, the gain carried from chunk to chunk and written
// after each. Bound on this card: latency. The bytes are 8 a sample (10.6 MB
// for a 60-second file, about 3 us at 3.35 TB/s), but the recurrence is one
// chain through the gain of six dependent float operations a sample (fmul,
// fmul, fma, fma, max, fmul; the max on a min/max unit of longer latency than
// an FMA's), 1.33 M samples long for that file. Design: one block a row (B
// rows side by side, a row an SM at B <= 132), two warps, and nothing but the
// chain on the chain:
// 1. The consumer warp: lane 0 runs the chain alone (agc_step). The freeze is
//    tested once a piece, outside the loop; the max is one max.NaN.f32; the
//    loop takes 8 samples a turn as two float4s from shared memory and loads
//    the next turn's two before it starts the chain, so no load waits on it.
//    A frozen chunk walks no chain: its output is x*g with the gain held,
//    which the warp's 32 lanes compute side by side.
// 2. The producer warp does everything else, ahead of the chain: the freeze
//    flag of each chunk (the energy summed as in agc_row: lane-strided, then
//    an xor butterfly), the staging of x a piece at a time (a chunk's pieces
//    are kTile samples but its last) into a ring of kSlots slots by cp.async,
//    and, once the consumer has released a slot, the store of the processed
//    piece and of the chunk's gain to global memory. Two mbarriers a slot
//    hand it over: full (producer to consumer) and done (back). The same
//    chain in one warp a row, the warp summing, staging and storing between
//    its chunks (pitchvis_tpu_torch/tools/agc_signal_one_warp.py), takes
//    16-28% longer on an H100 80GB HBM3 at 700 W.
// A row padded with zeros after its own chunks (train/device_dataset.py
// batches files of unequal lengths that way) gets the same outputs for its
// own chunks: a zero chunk comes after them, has energy 0 < 1e-6, freezes,
// and costs no chain.
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
constexpr int kTileStride = kTile + 8;  // a tile and the 8 floats the chain's last prefetch may read
constexpr int kSlots = 4;          // signal mode: tiles staged ahead of the chain

// jnp.maximum(a, b) for finite b: a NaN a gives NaN (the canonical one)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One step of the recurrence: returns x * g and moves g on.
__device__ __forceinline__ float agc_step(float x, float& g, float k, float inv_rms) {
  const float o = __fmul_rn(x, g);
  const float sq = __fmul_rn(o, o);
  const float one_minus_y = __fmaf_rn(-sq, inv_rms, 1.f);
  g = __fmul_rn(g, max_nan(__fmaf_rn(one_minus_y, k, 1.f), k));
  return o;
}

// The chain over s[0:n] in place, from gain g; returns the gain after it.
// Eight samples a turn as two float4s, the next turn's loaded first: the
// loads read at most s[n + 7], inside a tile's stride.
__device__ __forceinline__ float chain(float* s, int n, float g, float k, float inv_rms) {
  float4* s4 = reinterpret_cast<float4*>(s);
  const int turns = n >> 3;
  float4 a = s4[0], b = s4[1];
  for (int i = 0; i < turns; ++i) {
    const float4 na = s4[2 * i + 2], nb = s4[2 * i + 3];
    a.x = agc_step(a.x, g, k, inv_rms);
    a.y = agc_step(a.y, g, k, inv_rms);
    a.z = agc_step(a.z, g, k, inv_rms);
    a.w = agc_step(a.w, g, k, inv_rms);
    b.x = agc_step(b.x, g, k, inv_rms);
    b.y = agc_step(b.y, g, k, inv_rms);
    b.z = agc_step(b.z, g, k, inv_rms);
    b.w = agc_step(b.w, g, k, inv_rms);
    s4[2 * i] = a;
    s4[2 * i + 1] = b;
    a = na;
    b = nb;
  }
  for (int t = 8 * turns; t < n; ++t) s[t] = agc_step(s[t], g, k, inv_rms);
  return g;
}

// The pre-gain energy of x[0:T] < silence, in every lane of the warp: lane
// strided sums, then an xor butterfly.
__device__ __forceinline__ bool silent(const float* __restrict__ x, int T, float silence) {
  const int lane = threadIdx.x & 31;
  float energy = 0.f;
#pragma unroll 8
  for (int i = lane; i < T; i += 32) energy = __fadd_rn(energy, __fmul_rn(x[i], x[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) energy = __fadd_rn(energy, __shfl_xor_sync(0xffffffffu, energy, off));
  return energy < silence;
}

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
// returns the new gain in lane 0. A frozen row is x*g across the lanes; else
// lane 0 runs the chain over tiles that the warp stages in shared memory.
// frozen_in: 0 or 1 as the caller gives it, or -1 for the silence freeze.
__device__ __forceinline__ float agc_row(const float* __restrict__ x, float* __restrict__ y, float* tile,
                                         int T, float g, float k, float inv_rms, float silence,
                                         int frozen_in) {
  const int lane = threadIdx.x & 31;
  if (frozen_in < 0 ? silent(x, T, silence) : frozen_in > 0) {
    for (int i = lane; i < T; i += 32) y[i] = __fmul_rn(x[i], g);
    return g;
  }
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    for (int i = lane; i < n; i += 32) tile[i] = x[base + i];
    __syncwarp();
    if (lane == 0) g = chain(tile, n, g, k, inv_rms);
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
  __shared__ __align__(16) float tile[kTileStride];
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

// ---- signal mode ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Row b of x holds C chunks of T samples; y is (B, C * T) and gains (B, C).
// The gain starts at 1. Piece q of a row is piece q % per_chunk of chunk
// q / per_chunk, staged in slot q % kSlots for the (q / kSlots)-th time.
__global__ void __launch_bounds__(64)
agc_signal_kernel(const float* __restrict__ x, int64_t x_stride, float* __restrict__ y, float* __restrict__ gains,
                  int C, int T, float k, float inv_rms, float silence) {
  __shared__ __align__(16) float ring[kSlots * kTileStride];
  __shared__ __align__(8) uint64_t full[kSlots];  // the producer's 32 lanes arrive: staged
  __shared__ __align__(8) uint64_t done[kSlots];  // the consumer's lane 0 arrives: processed
  __shared__ int slot_frozen[kSlots];
  __shared__ float slot_gain[kSlots];  // the gain after the chunk, on its last piece
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const float* xr = x + (int64_t)b * x_stride;
  float* yr = y + (int64_t)b * C * T;
  const int per_chunk = (T + kTile - 1) / kTile;
  const int pieces = C * per_chunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&done[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // consumer
    float g = 1.f;  // lane 0's is the gain
    for (int q = 0; q < pieces; ++q) {
      const int slot = q % kSlots;
      const int off = (q % per_chunk) * kTile;
      const int n = min(kTile, T - off);
      float* s = ring + slot * kTileStride;
      mbar_wait(&full[slot], (q / kSlots) & 1);
      if (slot_frozen[slot]) {
        const float held = __shfl_sync(0xffffffffu, g, 0);
        for (int i = lane; i < n; i += 32) s[i] = __fmul_rn(s[i], held);
      } else if (lane == 0) {
        g = chain(s, n, g, k, inv_rms);
      }
      __syncwarp();
      if (lane == 0) {
        if (off + n == T) slot_gain[slot] = g;
        mbar_arrive(&done[slot]);
      }
    }
    return;
  }

  // producer
  bool frozen = false;
  auto stage = [&](int q) {
    const int c = q / per_chunk;
    const int off = (q % per_chunk) * kTile;
    const int n = min(kTile, T - off);
    const float* src = xr + (int64_t)c * T;
    if (off == 0) frozen = silent(src, T, silence);
    const uint32_t dst = smem_u32(ring + (q % kSlots) * kTileStride);
    for (int i = lane; i < n; i += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst + 4 * i), "l"(src + off + i) : "memory");
    asm volatile("cp.async.wait_all;" ::: "memory");
    if (lane == 0) slot_frozen[q % kSlots] = frozen;
    mbar_arrive(&full[q % kSlots]);
  };
  for (int q = 0; q < min(kSlots, pieces); ++q) stage(q);
  for (int q = 0; q < pieces; ++q) {
    const int slot = q % kSlots;
    const int c = q / per_chunk;
    const int off = (q % per_chunk) * kTile;
    const int n = min(kTile, T - off);
    const float* s = ring + slot * kTileStride;
    mbar_wait(&done[slot], (q / kSlots) & 1);
    float* dst = yr + (int64_t)c * T + off;
    for (int i = lane; i < n; i += 32) dst[i] = s[i];
    if (lane == 0 && off + n == T) gains[(int64_t)b * C + c] = slot_gain[slot];
    // each lane restages only the floats it has just stored
    if (q + kSlots < pieces) stage(q + kSlots);
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
  agc_signal_kernel<<<B, 64, 0, (cudaStream_t)stream>>>(x, x_stride, y, gains, C, T, k, inv_rms, silence);
  return (int)cudaGetLastError();
}
