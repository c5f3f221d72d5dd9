// Fused multi-group VQT power kernel: |x_tail[:, off_g : off_g + w_g] @ W_g|^2
// for every window group g, written side by side into (B, n_buckets) power.
//
// Replaces: pitchvis_tpu/ops/vqt_pallas.py::vqt_power_pallas, both of its
// Pallas bodies: _vqt_resident_kernel_body (bf16 weights resident in VMEM,
// one dot per group) and _vqt_kernel_body (K-tiles of 1024 streamed by DMA,
// f32 weights at Precision.HIGHEST, short final tile). One kernel with a
// dtype switch serves both.
//
// Bound on this card: operations. At default parameters and B=2048 a hop is
// ~20 GFLOP of multiply-adds against ~50-90 MB of input, weights and output,
// so the float32 mode is bound by the 67 TFLOP/s of the FFMA units. In the
// bfloat16 mode this kernel still multiplies in float32 FFMA (each bf16 x
// bf16 product is exact in float32), so it is bound by the same rate and
// reaches none of the tensor cores' 989 TFLOP/s; moving that mode onto
// mma/wgmma is later work.
//
// Design: one block per tile of 64 frames x 64 filters of one group (the
// block computes both the real and the imaginary column of each filter, 128
// accumulator columns). The block walks the group's window in K-tiles of 32
// samples: it stages the frames' input slice (transposed, padded against
// bank conflicts) and the weight K-tile through shared memory, converted to
// float32, and each of 256 threads accumulates a 4 x (4 re + 4 im) tile in
// registers with FFMA, in ascending sample order. No TF32 anywhere: the f32
// mode must stay within 3e-4 dB of the float64 oracle. The last K-tile of a
// group may be short (any window size works; the rest of the tile is zero),
// and the odd group offsets (3975, 4999, 5511 at default parameters) are
// read with scalar loads, so no access assumes an aligned address. The
// epilogue writes re*re + im*im (each product and the sum rounded on its
// own, as the plain version does) for the true filter columns only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_GROUPS 16
#define BM 64   // frames per block
#define BN 64   // filters per block (2*BN accumulator columns)
#define KT 32   // samples per K-tile
#define THREADS 256

struct VqtGroups {
  int n;
  int tile_start[MAX_GROUPS + 1];  // first blockIdx.x of each group's filter tiles
  int off[MAX_GROUPS];             // window offset within the tail
  int size[MAX_GROUPS];            // window size (rows of W_g)
  int nf[MAX_GROUPS];              // true filter count
  int nfp[MAX_GROUPS];             // padded filter count (W_g has 2*nfp columns)
  int col[MAX_GROUPS];             // first output column of the group
  const void* w[MAX_GROUPS];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// MIN_BLOCKS blocks of 256 threads per SM. The bf16 mode runs at 2 (at most
// 128 registers a thread, 16 warps an SM to hide the latency of its narrower
// loads) despite a few spilled registers; the f32 mode is faster at 1. The
// macros let pitchvis_tpu_torch/tools/vqt_sweep.py build and time other
// choices (its results are in PERF.md).
#ifndef VQT_F32_MIN_BLOCKS
#define VQT_F32_MIN_BLOCKS 1
#endif
#ifndef VQT_BF16_MIN_BLOCKS
#define VQT_BF16_MIN_BLOCKS 2
#endif
#ifndef VQT_K_UNROLL
#define VQT_K_UNROLL 8
#endif
// #pragma unroll takes a constant expression but expands no macro
constexpr int K_UNROLL = VQT_K_UNROLL;
template <typename T, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
vqt_power_kernel(const T* __restrict__ x, int B, int ldx, VqtGroups groups,
                 float* __restrict__ out, int n_buckets) {
  __shared__ float xs[KT][BM + 1];
  __shared__ __align__(16) float ws[KT][2 * BN];

  int g = 0;
  while (g + 1 < groups.n && (int)blockIdx.x >= groups.tile_start[g + 1]) ++g;
  const int off = groups.off[g];
  const int size = groups.size[g];
  const int nf = groups.nf[g];
  const int nfp = groups.nfp[g];
  const int wcols = 2 * nfp;
  const T* __restrict__ w = static_cast<const T*>(groups.w[g]);
  const int c0 = ((int)blockIdx.x - groups.tile_start[g]) * BN;
  const int b0 = (int)blockIdx.y * BM;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // filter quad
  const int ty = tid / 16;  // frame quad

  float acc_re[4][4];
  float acc_im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_re[i][j] = 0.f;
      acc_im[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < size; k0 += KT) {
    // stage the input slice: 64 frames x 32 samples, consecutive threads
    // on consecutive samples of one frame
#pragma unroll
    for (int r = 0; r < (BM * KT) / THREADS; ++r) {
      int idx = tid + r * THREADS;
      int m = idx / KT;
      int kk = idx % KT;
      int b = b0 + m;
      int k = k0 + kk;
      float v = 0.f;
      if (b < B && k < size) v = to_f32(x[(int64_t)b * ldx + off + k]);
      xs[kk][m] = v;
    }
    // stage the weight K-tile: re columns [c0, c0+BN) then im columns
    // [nfp + c0, nfp + c0 + BN)
#pragma unroll
    for (int r = 0; r < (KT * 2 * BN) / THREADS; ++r) {
      int idx = tid + r * THREADS;
      int kk = idx / (2 * BN);
      int c = idx % (2 * BN);
      int k = k0 + kk;
      int col = c < BN ? c0 + c : nfp + c0 + (c - BN);
      float v = 0.f;
      if (k < size) v = to_f32(w[(int64_t)k * wcols + col]);
      ws[kk][c] = v;
    }
    __syncthreads();

#pragma unroll K_UNROLL
    for (int kk = 0; kk < KT; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
      float4 wr = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      float4 wi = *reinterpret_cast<const float4*>(&ws[kk][BN + tx * 4]);
      float br[4] = {wr.x, wr.y, wr.z, wr.w};
      float bi[4] = {wi.x, wi.y, wi.z, wi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_re[i][j] = fmaf(a[i], br[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(a[i], bi[j], acc_im[i][j]);
        }
    }
    __syncthreads();
  }

  const int col_out = groups.col[g];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int b = b0 + ty * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int f = c0 + tx * 4 + j;
      if (f < nf) {
        float re = acc_re[i][j];
        float im = acc_im[i][j];
        out[(int64_t)b * n_buckets + col_out + f] =
            __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      }
    }
  }
}

// dtype: 0 = float32 input and weights, 1 = bfloat16 input and weights.
// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// geometry the kernel does not take.
extern "C" int vqt_power(int dtype, const void* x, int B, int ldx, int n_groups,
                         const void* const* w, const int* off, const int* size,
                         const int* nf, const int* nfp, float* out, int n_buckets,
                         void* stream) {
  if (n_groups < 1 || n_groups > MAX_GROUPS) return -1;
  VqtGroups groups;
  groups.n = n_groups;
  int tiles = 0;
  int col = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (nfp[g] % BN != 0 || nf[g] > nfp[g]) return -1;
    groups.tile_start[g] = tiles;
    groups.off[g] = off[g];
    groups.size[g] = size[g];
    groups.nf[g] = nf[g];
    groups.nfp[g] = nfp[g];
    groups.col[g] = col;
    groups.w[g] = w[g];
    tiles += (nf[g] + BN - 1) / BN;
    col += nf[g];
  }
  groups.tile_start[n_groups] = tiles;
  if (col != n_buckets) return -1;
  if (B == 0 || tiles == 0) return 0;
  dim3 grid(tiles, (B + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    vqt_power_kernel<float, VQT_F32_MIN_BLOCKS><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), B, ldx, groups, out, n_buckets);
  } else if (dtype == 1) {
    vqt_power_kernel<__nv_bfloat16, VQT_BF16_MIN_BLOCKS><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), B, ldx, groups, out, n_buckets);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
