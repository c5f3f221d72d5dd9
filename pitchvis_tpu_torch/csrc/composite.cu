// Back-to-front patch composite: K square patches of P x P pixels, each with
// its own origin, alpha-blended in order k = 0..K-1 over an RGB raster.
//
// Replaces: the two lax.scan loops of pitchvis_tpu/models/render.py, the
// ball composite of _render_frame_impl (render.py:999-1006) and the debug
// peak disks of _debug_world_panels (render.py:829-836). Each step there is
// a dynamic_slice of the patch window, the blend and a dynamic_update_slice;
// in eager PyTorch that would be some eight launches a patch. The order
// matters wherever patches overlap, so the loop over k stays sequential;
// the pixels are independent.
//
// Bound on this card: bytes. The raster is read once and written once and
// every patch (colour and alpha) is read once: at 64 streams of 640x360
// with 64 patches of 96 x 96 that is some 0.96 GB, 0.29 ms at 3.35 TB/s.
// The blend is three multiply-adds a channel, far below the FFMA rate.
//
// Design: one thread a raster pixel, one block a (stream, 32 x 8 tile).
// The block stages its stream's K origins in shared memory; each thread
// keeps its pixel in registers, walks k in order and blends wherever its
// pixel lies inside patch k, then writes the pixel once. The output is a
// separate buffer (out of place) and no intermediate is allocated. Patch
// colour and alpha are read through strides, so a colour broadcast over the
// patch (a stride-0 view, one colour a disk) needs no copy. Neighbouring
// threads read neighbouring patch pixels, so a warp's loads of one patch row
// are coalesced.
//
// Rounding: out = rgb * a + out * (1 - a) with every product, difference
// and sum rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn) in the order
// of the plain PyTorch version, and the file is compiled with -fmad=false:
// the kernel equals ops/composite.py::composite_patches_plain bit for bit.
//
// Preconditions, checked by the wrapper where it can do so without reading
// the card: float32 raster (B, Hp, Wp, 3), contiguous (any 4-byte aligned
// base); alpha (B, K, P, P) and colour (B, K, P, P, 3) by strides; int32
// origins (B, K), contiguous, K at most 6144 (the origins fill the 48 KB of
// shared memory a launch takes without an opt-in). Each patch window lies
// inside the raster (the caller clips the origins); a patch pixel outside it
// is simply not drawn.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kTileW = 32;
constexpr int kTileH = 8;

__global__ void __launch_bounds__(kTileW * kTileH)
composite_kernel(const float* __restrict__ img, float* __restrict__ out,
                 const float* __restrict__ rgb, const float* __restrict__ alpha,
                 const int* __restrict__ si, const int* __restrict__ sj,
                 int Hp, int Wp, int K, int P,
                 int64_t c_b, int64_t c_k, int64_t c_y, int64_t c_x, int64_t c_c,
                 int64_t a_b, int64_t a_k, int64_t a_y, int64_t a_x) {
  extern __shared__ int origins[];  // [0, K): column origins, [K, 2K): row origins
  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < K; i += kTileW * kTileH) {
    origins[i] = si[(int64_t)b * K + i];
    origins[K + i] = sj[(int64_t)b * K + i];
  }
  __syncthreads();

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= Wp || y >= Hp) return;
  const int64_t p = (((int64_t)b * Hp + y) * Wp + x) * 3;
  float r = img[p], g = img[p + 1], bl = img[p + 2];

  const float* c_stream = rgb + b * c_b;
  const float* a_stream = alpha + b * a_b;
  for (int k = 0; k < K; ++k) {
    const int dx = x - origins[k];
    const int dy = y - origins[K + k];
    if ((unsigned)dx >= (unsigned)P || (unsigned)dy >= (unsigned)P) continue;
    const float a = a_stream[k * a_k + dy * a_y + dx * a_x];
    const float* c = c_stream + k * c_k + dy * c_y + dx * c_x;
    const float keep = __fsub_rn(1.0f, a);
    r = __fadd_rn(__fmul_rn(c[0], a), __fmul_rn(r, keep));
    g = __fadd_rn(__fmul_rn(c[c_c], a), __fmul_rn(g, keep));
    bl = __fadd_rn(__fmul_rn(c[2 * c_c], a), __fmul_rn(bl, keep));
  }
  out[p] = r;
  out[p + 1] = g;
  out[p + 2] = bl;
}

extern "C" int composite_patches_f32(const float* img, float* out, const float* rgb, const float* alpha,
                                     const int* si, const int* sj, int B, int Hp, int Wp, int K, int P,
                                     long long c_b, long long c_k, long long c_y, long long c_x,
                                     long long c_c, long long a_b, long long a_k, long long a_y,
                                     long long a_x, void* stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((Wp + kTileW - 1) / kTileW, (Hp + kTileH - 1) / kTileH, B);
  composite_kernel<<<grid, block, 2 * K * sizeof(int), (cudaStream_t)stream>>>(
      img, out, rgb, alpha, si, sj, Hp, Wp, K, P, c_b, c_k, c_y, c_x, c_c, a_b, a_k, a_y, a_x);
  return (int)cudaGetLastError();
}
