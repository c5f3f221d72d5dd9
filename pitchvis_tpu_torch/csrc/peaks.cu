// Peak selection in one launch: from a batch of dB spectra to the peak masks
// of up to two PeakDetectionParameters, and on request the peak primitives
// (local-maximum mask and scipy prominence at every bin).
//
// Replaces: pitchvis_tpu/ops/peaks_pallas.py::local_maxima_and_prominences_pallas
// (body _peaks_kernel), whose outputs equal pitchvis_tpu/ops/peaks.py's
// local_maxima / prominences exactly. The JAX package lets XLA fuse the
// filters of pitchvis_tpu/ops/peaks.py::find_peaks_mask behind that kernel
// (height, min-distance suppression, prominence, first allowed bin); eager
// PyTorch cannot, so this kernel goes on through them itself and the
// analysis step gets finished masks without ever asking the host whether
// the suppression has converged.
//
// Bound on this card: bytes (B*n*4 in, one byte a bin and configuration out;
// with the primitive outputs B*n*5 out). That is a few microseconds at
// B=2048, n=588, below what a launch of 2048 blocks costs, so the design aims
// at little work a block and no second launch rather than at bandwidth:
//
// * one block a spectrum, the row loaded once into shared memory with 16-byte
//   loads where the rows' addresses allow and scalar loads where not;
// * local maxima by scatter: only a thread whose bin starts a plateau
//   (x[i-1] < x[i]) walks the plateau and flags its midpoint;
// * the candidates of a row (a handful on music) stand in a list, and the
//   stages after the local maxima walk that list, not the bins;
// * the min-distance suppression as Jacobi rounds on one flag byte a bin in
//   shared memory, both configurations in the bits of one byte, double
//   buffered, one barrier a round; exact mode ends on a block-wide vote
//   (__syncthreads_or), bounded mode runs its rounds with no vote. Every
//   round computes, from the previous round's state only, what
//   ops/peaks.py::_suppress_by_distance computes, so the bounded mode's
//   unconverged states match too;
// * the prominence only at bins that survived height and distance, a warp a
//   survivor: 32 lanes read outward together, a ballot finds the nearest
//   strictly greater sample, a shuffle reduction takes the window minimum.
//   No warp waits on one long thread;
// * the masks leave as 4-byte words where n allows.
//
// Only compares, min, max and one subtraction touch the data, so masks and
// prominences equal the plain versions bit for bit.
//
// With ALL_BINS (the caller passed pointers for the primitive outputs) the
// same function also writes the local-maximum mask and the prominence at
// every bin, one thread a bin scanning outward as far as it must.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

// Minimum of x over the window from i towards DIR up to (not including)
// the nearest sample strictly greater than h = x[i], or the row's end; the
// warp reads 32 samples a step. Beyond the row a lane holds h, which neither
// ends the window nor lowers the minimum. Every lane returns the minimum.
template <int DIR>
__device__ __forceinline__ float window_min(const float* xs, int n, int i, float h, int lane) {
  float m = h;
  for (int base = i + DIR; base >= 0 && base < n; base += 32 * DIR) {
    const int j = base + DIR * lane;
    const float v = (j >= 0 && j < n) ? xs[j] : h;
    const unsigned greater = __ballot_sync(kFullWarp, v > h);
    const int stop = greater ? __ffs(greater) - 1 : 32;
    if (lane < stop) m = fminf(m, v);
    if (greater) break;
  }
  for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(kFullWarp, m, o));
  return m;
}

// Flag byte of a bin: bit 0 local maximum, bit 1 + c candidate of
// configuration c (local maximum at or above its min_height). Suppression
// and result bytes: bit c for configuration c. The candidates of any
// configuration also stand in a list, in no particular order, so that the
// rounds and the prominence stage cost by the candidate and not by the bin.
template <bool ALL_BINS>
__global__ void peaks_kernel(const float* __restrict__ x, int64_t row_stride, int n, int vec_ok,
                             int ncfg, float h0, float p0, float h1, float p1, int distance,
                             int rounds, int min_bin, uint8_t* __restrict__ out0,
                             uint8_t* __restrict__ out1, uint8_t* __restrict__ lmax_out,
                             float* __restrict__ prom_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_candidates;
  const int n4 = (n + 3) & ~3;
  float* xs = reinterpret_cast<float*>(smem);
  int* candidates = reinterpret_cast<int*>(smem + (size_t)n4 * 4);
  uint8_t* flag = smem + (size_t)n4 * 4 + (size_t)(n / 2 + 1) * 4;
  uint8_t* sup[2] = {flag + n4, flag + 2 * n4};
  uint8_t* res = flag + 3 * n4;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* xr = x + (int64_t)blockIdx.x * row_stride;

  // 1. the row into shared memory
  int done = 0;
  if (vec_ok) {
    const int nv = n >> 2;
    for (int q = tid; q < nv; q += nt)
      reinterpret_cast<float4*>(xs)[q] = __ldg(reinterpret_cast<const float4*>(xr) + q);
    done = nv << 2;
  }
  for (int i = done + tid; i < n; i += nt) xs[i] = __ldg(xr + i);
  // flag, both suppression buffers and the result: 4 * n4 bytes in a row
  for (int q = tid; q < n4; q += nt) reinterpret_cast<uint32_t*>(flag)[q] = 0;
  if (tid == 0) n_candidates = 0;
  __syncthreads();

  // 2. local maxima: the thread at a plateau's first bin s (x[s-1] < x[s])
  // walks to its last bin e and flags the midpoint if x[e+1] < x[e]
  for (int i = tid; i < n; i += nt) {
    if (i == 0 || !(xs[i - 1] < xs[i])) continue;
    const float xi = xs[i];
    int e = i;
    while (e < n - 1 && xs[e + 1] == xi) ++e;
    if (e < n - 1 && xs[e + 1] < xi) {
      unsigned f = 1;
      if (ncfg > 0 && xi >= h0) f |= 2;
      if (ncfg > 1 && xi >= h1) f |= 4;
      flag[(i + e) >> 1] = (uint8_t)f;
      if (f > 1) candidates[atomicAdd(&n_candidates, 1)] = (i + e) >> 1;
    }
  }
  __syncthreads();
  const int total = n_candidates;

  if (ALL_BINS) {
    uint8_t* lrow = lmax_out + (int64_t)blockIdx.x * n;
    float* prow = prom_out + (int64_t)blockIdx.x * n;
    for (int i = tid; i < n; i += nt) {
      const float xi = xs[i];
      lrow[i] = flag[i] & 1;
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
      prow[i] = xi - fmaxf(left_min, right_min);
    }
  }
  if (ncfg == 0) return;

  // 3. min-distance suppression, Jacobi rounds: a candidate is suppressed in
  // the new state iff an unsuppressed candidate of the old state with higher
  // priority (height, then index) lies strictly within `distance`. Only
  // candidates' bytes are ever written; the others stay 0 in both buffers.
  int p = 0;
  if (distance >= 2) {
    const int pad = distance - 1;
    for (int r = 0; rounds < 0 || r < rounds; ++r) {
      int changed = 0;
      for (int k = tid; k < total; k += nt) {
        const int i = candidates[k];
        const float xi = xs[i];
        const int lo = max(0, i - pad), hi = min(n - 1, i + pad);
        unsigned hit = 0;
        for (int j = lo; j <= hi; ++j) {
          if (j == i) continue;
          const unsigned alive = (flag[j] >> 1) & ~(unsigned)sup[p][j] & 3u;
          if (!alive) continue;
          const float xj = xs[j];
          if (xj > xi || (xj == xi && j > i)) hit |= alive;
        }
        hit &= (flag[i] >> 1) & 3u;
        changed |= hit != sup[p][i];
        sup[p ^ 1][i] = (uint8_t)hit;
      }
      p ^= 1;
      if (rounds < 0) {
        if (!__syncthreads_or(changed)) break;
      } else {
        __syncthreads();
      }
    }
  }

  // 4. prominence at the survivors, a warp each
  const int lane = tid & 31;
  for (int k = tid >> 5; k < total; k += nt >> 5) {
    const int i = candidates[k];
    const unsigned alive = (flag[i] >> 1) & ~(unsigned)sup[p][i] & 3u;
    if (!alive || i < min_bin) continue;
    const float h = xs[i];
    const float left_min = window_min<-1>(xs, n, i, h, lane);
    const float right_min = window_min<+1>(xs, n, i, h, lane);
    if (lane == 0) {
      const float prom = h - fmaxf(left_min, right_min);
      unsigned r = 0;
      if ((alive & 1u) && prom >= p0) r |= 1u;
      if ((alive & 2u) && prom >= p1) r |= 2u;
      res[i] = (uint8_t)r;
    }
  }
  __syncthreads();

  // 5. one byte mask a configuration
  const int64_t orow = (int64_t)blockIdx.x * n;
  if ((n & 3) == 0) {
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(res);
    for (int q = tid; q < (n >> 2); q += nt) {
      const uint32_t w = rw[q];
      reinterpret_cast<uint32_t*>(out0 + orow)[q] = w & 0x01010101u;
      if (ncfg > 1) reinterpret_cast<uint32_t*>(out1 + orow)[q] = (w >> 1) & 0x01010101u;
    }
  } else {
    for (int i = tid; i < n; i += nt) {
      out0[orow + i] = res[i] & 1;
      if (ncfg > 1) out1[orow + i] = (res[i] >> 1) & 1;
    }
  }
}

template <bool ALL_BINS>
int launch(const float* x, int64_t row_stride, int B, int n, int vec_ok, int ncfg, float h0,
           float p0, float h1, float p1, int distance, int rounds, int min_bin, uint8_t* out0,
           uint8_t* out1, uint8_t* lmax_out, float* prom_out, cudaStream_t stream) {
  // candidates only: four bins a thread; all bins: one bin a thread, whose
  // outward scans are the work
  int threads = ALL_BINS ? n : (n + 3) / 4;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t n4 = ((size_t)n + 3) & ~(size_t)3;
  const size_t smem = n4 * 4 + ((size_t)n / 2 + 1) * 4 + 4 * n4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        peaks_kernel<ALL_BINS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  peaks_kernel<ALL_BINS><<<B, threads, smem, stream>>>(x, row_stride, n, vec_ok, ncfg, h0, p0, h1,
                                                       p1, distance, rounds, min_bin, out0, out1,
                                                       lmax_out, prom_out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: B rows of n f32, `row_stride` elements apart, unit stride inside a row.
// ncfg in 0..2 configurations (min_height h, min_prominence p); out0/out1:
// (B, n) bytes, contiguous, 4-byte aligned. rounds < 0: suppression to
// convergence; otherwise exactly that many rounds. lmax_out/prom_out: both
// null, or (B, n) bytes and (B, n) f32 for the primitive outputs.
extern "C" int peaks_f32(const float* x, int64_t row_stride, int B, int n, int ncfg, float h0,
                         float p0, float h1, float p1, int distance, int rounds, int min_bin,
                         uint8_t* out0, uint8_t* out1, uint8_t* lmax_out, float* prom_out,
                         void* stream) {
  if (B == 0 || n == 0) return 0;
  if (ncfg < 0 || ncfg > 2 || (lmax_out == nullptr) != (prom_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vec_ok = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (row_stride % 4 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  if (lmax_out != nullptr)
    return launch<true>(x, row_stride, B, n, vec_ok, ncfg, h0, p0, h1, p1, distance, rounds,
                        min_bin, out0, out1, lmax_out, prom_out, s);
  return launch<false>(x, row_stride, B, n, vec_ok, ncfg, h0, p0, h1, p1, distance, rounds,
                       min_bin, out0, out1, lmax_out, prom_out, s);
}
