// Fused multi-group VQT power kernel: |x_tail[:, off_g : off_g + w_g] @ W_g|^2
// for every window group g, written side by side into (B, n_buckets) power,
// all groups in one launch, only power leaving the kernel.
//
// Replaces: pitchvis_tpu/ops/vqt_pallas.py::vqt_power_pallas, both of its
// Pallas bodies: _vqt_resident_kernel_body (bf16 weights resident in VMEM,
// one dot per group) -> the bf16 mode here, and _vqt_kernel_body (K-tiles of
// 1024 streamed by DMA, f32 weights at Precision.HIGHEST) -> the f32 mode.
//
// Bound on this card. At default parameters and B=2048 a call is 19.85 GFLOP
// of multiply-adds on the true filters against 82-92 MB of f32 frames,
// weights and power. bf16: 0.020 ms of operations at the tensor cores' 989
// TFLOP/s, 0.025 ms of bytes at 3.35 TB/s, so bytes bound it by a little.
// f32 makes three tf32 products for each f32 one (3xTF32, never single-pass
// TF32: it must stay within 3e-4 dB of the float64 oracle): 59.5 GFLOP at
// 495 TFLOP/s, 0.120 ms of operations.
//
// Design, one kernel for both modes (vqt_kernel<Mode, ..>):
// * Work is cut into tiles of 64 x WGS frames x 64 filters of one group. The
//   weights come in a kernel-side layout made once at pack time
//   (ops/vqt_pallas.py::kernel_side_layout): per filter tile and K-tile one
//   contiguous block of 128 rows x 128 bytes, K-major (W^T), rows 0..63 the
//   real parts of 64 filters and rows 64..127 their imaginary parts, so that
//   re and im of one filter end in the same thread's accumulator fragment
//   and re^2 + im^2 needs no exchange. A K-tile is 128 bytes of weights: 64
//   samples in bf16, 32 in f32. In f32 a block has 256 rows: the 128 of hi =
//   tf32(w), then the 128 of lo = tf32(w - hi).
// * One producer thread copies the tiles global -> shared memory with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle) through a ring of STAGES stages;
//   full/empty mbarriers hand the stages between it and the consumer warps,
//   so copies and arithmetic overlap and no __syncthreads() is in the loop.
//   The frames are read as f32 in both modes, in place from the caller's
//   tensor (the streaming ring's window, a strided view).
// * Each consumer warpgroup owns 64 frames. A thread reads its A fragment of
//   a K-tile from the swizzled tile and makes the mode's operands in
//   registers: bf16 rounds pairs of samples to bf16 (to nearest even, as a
//   cast before the launch would) for wgmma.mma_async m64n128k16; f32 splits
//   every sample into tf32 hi and lo for three wgmma m64n128k8 a step, lo*hi
//   + hi*lo + hi*hi. The weights are read from shared memory, the f32
//   accumulators stay in registers. Two register sets: one feeds the batch in
//   flight while the next K-tile is read into the other.
// * The tensor cores' accumulate truncates, so every few K-tiles the wgmma
//   accumulator is added to the thread's own sum by a rounded FADD and
//   zeroed (see flush()).
// * What limits it as it stands: the bytes each SM takes into shared memory.
//   Every 64-frame block fetches its own copy of its weight tiles, and both
//   modes, at every tiling tried, run at 63-70 GB/s into each SM (8-9 TB/s
//   over the card). Two warpgroups a block halve the weight bytes but leave
//   160 blocks for 132 SMs with the longest at 1.7 times the mean, and come
//   out slower. Sharing each weight tile between the two blocks of a cluster
//   by TMA multicast was built and measured and changed nothing (the SMs
//   take in the same bytes), so it is not here.
// * Built and measured on the way, on an H100 SXM at 700 W and B=2048, and
//   not kept: f32 as a register-blocked FFMA GEMM on the same ring (8 x 8 a
//   thread, float4 reads along K), 0.60-0.78 ms a call against 0.19 ms for
//   3xTF32; bf16 with both operands from shared memory and the frames cast to
//   bf16 before the launch, 0.052 ms a launch but 0.102 ms with its cast,
//   against 0.083 ms for the call that rounds in registers.
//
// Where trouble lay, and what the design does about it:
// * Odd group offsets (3975, 4999, 5511 at default parameters): a group
//   reads from its offset rounded down to a multiple of 8 samples, and its
//   kernel-side weights carry that many zero rows in front. Every TMA
//   coordinate is then 32-byte aligned. The wrapper checks the
//   base address and the row stride of x and copies where they are not
//   multiples of 16 bytes.
// * Window ends: K is zero-padded to whole K-tiles, so a group reads samples
//   beyond its window (weights there are zero) and, for short tails, beyond
//   the row or the batch, where TMA fills zeros. A zero weight contributes
//   exactly 0 for a finite sample. A non-finite sample in the padding would
//   make this group's bins NaN where the plain version keeps them finite;
//   such a sample lies inside the largest group's window, so that frame's
//   spectrum is non-finite in either version. The streaming ring rejects
//   non-finite chunks before they reach the kernel.
// * Load imbalance (filter tiles of K = 8192 / 4096 / 2048 / 1024): the tile
//   table is sorted by descending K and the block index walks it in that
//   order, so the long tiles start first and the short ones fill the gaps;
//   with 64-frame blocks the longest block is under the mean work of an SM.
//   No split-K: re^2 + im^2 is not linear in K.
// * wgmma: tiles are 1024-byte aligned, the descriptors name the 128-byte
//   swizzle the tensor maps write (SBO 1024), wgmma.fence precedes each
//   batch (its registers were written by other instructions), and a stage or
//   a register set is reused only after wait_group has retired the batch
//   that read it.
// The epilogue writes re*re + im*im (each product and the sum rounded on its
// own, as the plain version does) for the true filter columns only.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

// Tunables; pitchvis_tpu_torch/tools/vqt_sweep.py builds and times others.
// A block is WGS consumer warpgroups (64 frames each) and one producer warp.
#ifndef VQT_BF16_WGS
#define VQT_BF16_WGS 1
#endif
#ifndef VQT_BF16_STAGES
#define VQT_BF16_STAGES 6  // 32 KB each at one warpgroup
#endif
#ifndef VQT_BF16_FLUSH
#define VQT_BF16_FLUSH 16  // K-tiles between two flushes of the wgmma accumulator
#endif
#ifndef VQT_F32_WGS
#define VQT_F32_WGS 1  // at 2 the f32 mode spills registers
#endif
#ifndef VQT_F32_STAGES
#define VQT_F32_STAGES 4  // 40 KB each at one warpgroup
#endif
#ifndef VQT_F32_FLUSH
#define VQT_F32_FLUSH 8  // K-tiles between two flushes of the wgmma accumulator
#endif

constexpr int TILE_ROWS = 128;      // weight tile rows: 64 re, then 64 im
constexpr int ROW_BYTES = 128;      // one K-tile of one row, one swizzle row
constexpr int TILE_BYTES = TILE_ROWS * ROW_BYTES;
constexpr int TILE_INTS = 8;        // ints a tile-table row

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor of a K-major tile with 128-byte rows under
// the 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  uint64_t d = (saddr & 0x3FFFFu) >> 4;
  d |= uint64_t(1) << 16;           // leading byte offset: unused with a swizzle
  d |= uint64_t(1024 >> 4) << 32;   // stride byte offset
  d |= uint64_t(1) << 62;           // 128-byte swizzle
  return d;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// wgmma reads and writes its register operands asynchronously, after the
// instruction itself. Naming them here, after the wait that retires the batch, keeps the
// compiler from reading accumulators, or reusing A registers, before it.
template <int N>
__device__ __forceinline__ void wgmma_regs_settled(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wgmma_regs_settled(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// d (64 x 128, f32) += A (64 x 16 bf16, this thread's fragment in registers) *
// B (128 x 16 bf16, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t* a,
                                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 8 tf32, this thread's fragment in registers) *
// B (128 x 8 tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t* a,
                                                     uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- the pipeline both modes share ------------------------------------------

// One row of the tile table (ops/vqt_pallas.py::kernel_side_layout), sorted
// by descending n_k.
struct Tile {
  int w_tile0;  // first (128 x 128 byte) block of this filter tile's weights
  int n_k;      // K-tiles to walk
  int x_col;    // first sample read in the tail (a multiple of 8)
  int out_col;  // first output column
  int n_valid;  // true filters in the tile (1..64)
};

__device__ __forceinline__ Tile load_tile(const int* __restrict__ tiles, int i) {
  const int* t = tiles + i * TILE_INTS;
  return Tile{t[0], t[1], t[2], t[3], t[4]};
}

template <int STAGES, int X_BYTES, int W_BYTES>
struct Ring {
  static constexpr int N_STAGES = STAGES;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  uint32_t base;  // 1024-byte aligned shared address of stage 0

  __device__ explicit Ring(const uint8_t* raw) : base((smem_u32(raw) + 1023u) & ~1023u) {}
  __device__ uint32_t x(int s) const { return base + s * STAGE_BYTES; }
  __device__ uint32_t w(int s) const { return base + s * STAGE_BYTES + X_BYTES; }
  __device__ uint32_t full(int s) const { return base + STAGES * STAGE_BYTES + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + STAGES * STAGE_BYTES + 8 * (STAGES + s); }

  // by one thread, before the block's first __syncthreads()
  __device__ void init(int consumer_warps) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }

  // the producer thread's whole life: keep STAGES K-tiles in flight. The
  // frames of a K-tile come as x_boxes boxes of box_elems samples, one under
  // the other in the stage.
  __device__ void produce(const CUtensorMap* map_x, const CUtensorMap* map_w, const Tile& t,
                          int box_elems, int x_boxes, int row0) const {
    for (int k = 0; k < t.n_k; ++k) {
      const int s = k % STAGES;
      mbar_wait(empty(s), ((k / STAGES) & 1) ^ 1);
      mbar_expect_tx(full(s), STAGE_BYTES);
      for (int i = 0; i < x_boxes; ++i)
        tma_load_2d(x(s) + i * (X_BYTES / x_boxes), map_x, full(s),
                    t.x_col + (k * x_boxes + i) * box_elems, row0);
      tma_load_2d(w(s), map_w, full(s), 0, (t.w_tile0 + k) * (W_BYTES / ROW_BYTES));
    }
  }
};

// The tensor cores add each product block to the f32 accumulator with
// truncation, not rounding to nearest: over the 3072 wgmma of an 8192-sample
// window in f32 the bias reaches 2^-14 of a tonal bin (measured: 1.4e-3 dB
// from the plain version), and it grows with the window. So wgmma
// accumulates only a few K-tiles (VQT_*_FLUSH) into d, which is then added to
// the thread's own sum with a rounded FADD and zeroed: the truncations happen
// at the magnitude of a short partial sum. Call after wgmma_wait<0>().
__device__ __forceinline__ void flush(float (&acc)[64], float (&d)[64]) {
  wgmma_regs_settled(d);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = __fadd_rn(acc[i], d[i]);
    d[i] = 0.f;
  }
}

// The epilogue of both modes. A thread's m64n128 accumulator fragment holds
// rows r and r + 8 of its warp's 16; d[4*j + 2*h + e] is row r + 8*h, column
// 8*j + 2*(lane % 4) + e. Columns 0..63 are re, 64..127 im of the same
// filters, so d[4*j + ..] and d[4*(j + 8) + ..] pair up. Each product and the
// sum are rounded on their own, as the plain version rounds them.
__device__ __forceinline__ void store_power(const float (&d)[64], const Tile& t, int row,
                                            int lane, int B, float* __restrict__ out,
                                            int n_buckets) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = row + 8 * h;
    if (b >= B) continue;
    float* __restrict__ o = out + (int64_t)b * n_buckets + t.out_col;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = 8 * j + 2 * (lane % 4) + e;
        const float re = d[4 * j + 2 * h + e];
        const float im = d[4 * (j + 8) + 2 * h + e];
        if (f < t.n_valid) o[f] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      }
  }
}

// ---- frames split or converted in registers: both modes' kernel -----------------
// The frames arrive in shared memory as f32. A consumer thread reads its A
// fragment of a K-tile, makes the mode's operands of it in registers, and
// the warpgroup runs the mode's batch of wgmma (A from registers, weights
// from shared memory).

// f32 mode, 3xTF32. A K-tile is 32 samples. The weights arrive split at pack
// time into hi = tf32(w) and lo = tf32(w - hi) (rows 0..127 and 128..255 of a
// block); the frames are split the same way here, and lo*hi + hi*lo + hi*hi
// is accumulated in f32.
struct Tf32x3Mode {
  static constexpr int K_TILE = 32;
  static constexpr int X_BOXES = 1;              // boxes of 32 f32 samples a K-tile
  static constexpr int W_BYTES = 2 * TILE_BYTES;  // hi block, then lo block
  static constexpr int A_REGS = 32;               // 4 steps x 4 registers, hi then lo
  static constexpr int FLUSH = VQT_F32_FLUSH;

  static __device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
  }
  // fragment of step j: (row, k), (row + 8, k), (row, k + 4), (row + 8, k + 4)
  static __device__ __forceinline__ void load(const uint8_t* xs, int box_bytes, int row, int lane,
                                              uint32_t (&a)[A_REGS]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * (e & 1);
        const int chunk = 2 * j + (e >> 1);
        const float v = *reinterpret_cast<const float*>(
            xs + r * ROW_BYTES + ((chunk ^ (r & 7)) << 4) + (lane & 3) * 4);
        const uint32_t h = to_tf32(v);
        a[4 * j + e] = h;
        a[16 + 4 * j + e] = to_tf32(v - __uint_as_float(h));
      }
  }
  static __device__ __forceinline__ void batch(float (&d)[64], const uint32_t (&a)[A_REGS],
                                               uint32_t w) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_m64n128k8_tf32(d, &a[16 + 4 * j], wgmma_desc(w + j * 32));          // lo * hi
      wgmma_m64n128k8_tf32(d, &a[4 * j], wgmma_desc(w + TILE_BYTES + j * 32));  // hi * lo
      wgmma_m64n128k8_tf32(d, &a[4 * j], wgmma_desc(w + j * 32));               // hi * hi
    }
  }
};

// bf16 mode. A K-tile is 64 samples: two boxes of 32 f32 samples, one under
// the other. The frames are rounded to bf16 here (to nearest even, as
// tensor.to(torch.bfloat16) rounds), so no cast pass over the frames runs
// before the launch.
struct Bf16Mode {
  static constexpr int K_TILE = 64;
  static constexpr int X_BOXES = 2;
  static constexpr int W_BYTES = TILE_BYTES;
  static constexpr int A_REGS = 16;  // 4 steps x 4 registers of two bf16
  static constexpr int FLUSH = VQT_BF16_FLUSH;

  // fragment of step j: (row, k..k+1), (row + 8, k..k+1), (row, k+8..k+9),
  // (row + 8, k+8..k+9), the lower sample in the lower half of a register
  static __device__ __forceinline__ void load(const uint8_t* xs, int box_bytes, int row, int lane,
                                              uint32_t (&a)[A_REGS]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * (e & 1);
        const int chunk = 4 * (j & 1) + 2 * (e >> 1) + ((lane & 3) >> 1);
        const float2 v = *reinterpret_cast<const float2*>(
            xs + (j >> 1) * box_bytes + r * ROW_BYTES + ((chunk ^ (r & 7)) << 4) + (lane & 1) * 8);
        asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(a[4 * j + e]) : "f"(v.y), "f"(v.x));
      }
  }
  static __device__ __forceinline__ void batch(float (&d)[64], const uint32_t (&a)[A_REGS],
                                               uint32_t w) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_m64n128k16_rs(d, &a[4 * j], wgmma_desc(w + j * 32));
  }
};

// Batch k is in flight on the cur registers. Reads K-tile k + 1 into the free
// set, starts its batch, retires batch k and hands its stage back. At a
// flush, batch k retires first.
template <class Mode, class R>
__device__ __forceinline__ void step(int k, int n_k, const R& ring, const uint8_t* stage0,
                                     int box_bytes, int frag_row, int lane, float (&acc)[64],
                                     float (&d)[64], uint32_t (&cur)[Mode::A_REGS],
                                     uint32_t (&next)[Mode::A_REGS]) {
  const bool more = k + 1 < n_k;
  const int n = (k + 1) % R::N_STAGES;
  if (more) {
    mbar_wait(ring.full(n), ((k + 1) / R::N_STAGES) & 1);
    Mode::load(stage0 + n * R::STAGE_BYTES, box_bytes, frag_row, lane, next);
  }
  if (!more || (k + 1) % Mode::FLUSH == 0) {
    wgmma_wait<0>();
    flush(acc, d);
    if (more) {
      wgmma_fence();
      Mode::batch(d, next, ring.w(n));
      wgmma_commit();
    }
  } else {
    wgmma_fence();
    Mode::batch(d, next, ring.w(n));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_regs_settled(cur);
  if (lane == 0) mbar_arrive(ring.empty(k % R::N_STAGES));
}

template <class Mode, int WGS, int STAGES>
__global__ void __launch_bounds__(WGS * 128 + 32, 1)
vqt_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
           const int* __restrict__ tiles, int n_mtiles, int B, float* __restrict__ out,
           int n_buckets) {
  constexpr int BM = WGS * 64;
  constexpr int BOX_BYTES = BM * ROW_BYTES;  // one box of 32 f32 samples of the block's frames
  using R = Ring<STAGES, Mode::X_BOXES * BOX_BYTES, Mode::W_BYTES>;
  extern __shared__ uint8_t smem_raw[];
  const R ring(smem_raw);
  const Tile t = load_tile(tiles, blockIdx.x / n_mtiles);
  const int row0 = (blockIdx.x % n_mtiles) * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) ring.init(WGS * 4);
  __syncthreads();

  if (warp == WGS * 4) {
    if (lane == 0) ring.produce(&map_x, &map_w, t, ROW_BYTES / 4, Mode::X_BOXES, row0);
    return;
  }

  const int frag_row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const uint8_t* stage0 = smem_raw + (ring.base - smem_u32(smem_raw));
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
  uint32_t a0[Mode::A_REGS], a1[Mode::A_REGS];

  // The batch of K-tile k runs on one register set while K-tile k + 1 is
  // read into the other; step() hands them over.
  mbar_wait(ring.full(0), 0);
  Mode::load(stage0, BOX_BYTES, frag_row, lane, a0);
  wgmma_fence();
  Mode::batch(d, a0, ring.w(0));
  wgmma_commit();
  for (int k = 0; k < t.n_k; k += 2) {
    step<Mode>(k, t.n_k, ring, stage0, BOX_BYTES, frag_row, lane, acc, d, a0, a1);
    if (k + 1 < t.n_k)
      step<Mode>(k + 1, t.n_k, ring, stage0, BOX_BYTES, frag_row, lane, acc, d, a1, a0);
  }

  store_power(acc, t, row0 + frag_row, lane, B, out, n_buckets);
}

// ---- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process already has loaded
// (no link-time dependency on it)
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) lib = dlopen("libcuda.so", RTLD_NOW | RTLD_GLOBAL);
    if (lib) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a (rows x cols) matrix of `type`, row stride in bytes, read in boxes of
// (box_rows x 128 bytes) under the 128-byte swizzle; out of bounds reads zero
static int make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
                    uint64_t cols, uint64_t rows, uint64_t stride_bytes, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return -2;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {stride_bytes};
  cuuint32_t box[2] = {(cuuint32_t)(ROW_BYTES / elem_bytes), box_rows};
  cuuint32_t elem_strides[2] = {1, 1};
  CUresult rc = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : -3;
}

// Allows the kernel its dynamic shared memory once a device, at its first
// launch there: a later launch, which a CUDA graph capture may record, sets
// no attribute.
template <typename Mode, int WGS, int STAGES>
static int launch(int threads, int smem, const CUtensorMap& map_x, const CUtensorMap& map_w,
                  const int* tiles, int n_tiles, int n_mtiles, int B, float* out, int n_buckets,
                  cudaStream_t stream) {
  auto kernel = vqt_kernel<Mode, WGS, STAGES>;
  static const int n_devices = [] {
    int n = 0;
    return cudaGetDeviceCount(&n) == cudaSuccess ? n : 0;
  }();
  // one flag a device, all false
  static std::atomic<bool>* const smem_set = new std::atomic<bool>[n_devices > 0 ? n_devices : 1]();
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= n_devices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev].load()) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    smem_set[dev].store(true);
  }
  kernel<<<n_tiles * n_mtiles, threads, smem, stream>>>(map_x, map_w, tiles, n_mtiles, B, out,
                                                        n_buckets);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 weights, 1 = bfloat16 weights. x: (B, tail) float32
// frames with a row stride of ldx elements; base address and row stride must
// be multiples of 16 bytes. w: the kernel-side weights, n_w_tiles blocks of (128 x 128 bytes) in
// bf16, of (256 x 128 bytes: tf32 hi rows, then lo rows) in f32. tiles: the
// device tile table, n_tiles rows of 8 ints. Returns cudaGetLastError() after
// the launch (0 on success), -1 for arguments the kernel does not take, -2
// if libcuda has no cuTensorMapEncodeTiled, -3 if it refused a tensor map.
extern "C" int vqt_power(int dtype, const void* x, int B, int tail, long long ldx, const void* w,
                         int n_w_tiles, const int* tiles, int n_tiles, float* out,
                         int n_buckets, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (B < 0 || tail < 1 || n_w_tiles < 1 || n_tiles < 1 || n_buckets < 1) return -1;
  if (B == 0) return 0;
  const int w_elem = dtype == 0 ? 4 : 2;
  if ((uintptr_t)x % 16 != 0 || ((uint64_t)ldx * 4) % 16 != 0 || (uintptr_t)w % 16 != 0)
    return -1;
  const int w_rows = dtype == 0 ? 2 * TILE_ROWS : TILE_ROWS;  // f32: hi and lo halves
  const int bm = 64 * (dtype == 0 ? VQT_F32_WGS : VQT_BF16_WGS);
  CUtensorMap map_x, map_w;
  int rc = make_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, tail, B, (uint64_t)ldx * 4, bm);
  if (rc != 0) return rc;
  rc = make_map(&map_w,
                dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                w_elem, w, ROW_BYTES / w_elem, (uint64_t)n_w_tiles * w_rows, ROW_BYTES, w_rows);
  if (rc != 0) return rc;
  const int n_mtiles = (B + bm - 1) / bm;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    using R = Ring<VQT_F32_STAGES, 64 * VQT_F32_WGS * ROW_BYTES, Tf32x3Mode::W_BYTES>;
    return launch<Tf32x3Mode, VQT_F32_WGS, VQT_F32_STAGES>(VQT_F32_WGS * 128 + 32, R::SMEM_BYTES,
                                                           map_x, map_w, tiles, n_tiles, n_mtiles,
                                                           B, out, n_buckets, s);
  }
  using R = Ring<VQT_BF16_STAGES, 2 * 64 * VQT_BF16_WGS * ROW_BYTES, Bf16Mode::W_BYTES>;
  return launch<Bf16Mode, VQT_BF16_WGS, VQT_BF16_STAGES>(VQT_BF16_WGS * 128 + 32, R::SMEM_BYTES,
                                                         map_x, map_w, tiles, n_tiles, n_mtiles, B,
                                                         out, n_buckets, s);
}
