// The viewer stage of a hop in one launch: the pitch balls with their fade
// carry, the chroma vector, the bloom, the VQT-mode spectrogram row, the
// bass spiral and the calmness contour of every stream.
//
// Replaces: no Pallas kernel. The JAX package computes these in
// pitchvis_tpu/models/viewer.py (update_balls, chroma_vector,
// bloom_intensity, spectrogram_row_vqt, bass_spiral, calmness_histogram),
// which XLA fuses. The port's plain versions (models/viewer.py, composed by
// ops/viewer_stage.py::viewer_stage_plain) take some 400 eager kernels a
// hop, each one pass over a (B, n) array.
//
// Bound on this card: bytes. Each stream's row is read once and every
// output written once: at 12,288 streams of 588 bins some 0.35 GB read (the
// peak mask, centers, sizes, calmness, smoothed spectrum and the carry) and
// 0.47 GB written (the new carry, positions, visibility, the u8 row, the
// contour and its colours), 0.25 ms at 3.35 TB/s. The arithmetic is a few
// pow/cos/sin a bin.
//
// Design: one block of kThreads threads a stream row. The block stages the
// row's peak mask, peak centers and sizes, calmness and spectrum in shared
// memory (33 bytes a bin), with coalesced loads, and reduces the row there:
// the largest peak size (balls and bass spiral), the spectrum's maximum, the
// first peak (bass spiral). Each thread then walks bins tid, tid + kThreads,
// ...: the neighbour reads (the key shifts d in {1, 0, -1}, the hiding
// window, the contour's midpoints) come from shared memory, every per-bin
// formula runs in registers, and each output is written once. The carry's
// rgba moves as one 16-byte load and store a bin; the (n, 3) positions are
// staged in shared memory and stored as one contiguous run of floats; the
// segment colours are written in their own contiguous order. The 12 chroma
// sums are taken by 12 threads, each over its pitch class's bins in the
// order of the class table. Nothing is allocated and nothing is carried
// between blocks.
//
// Rounding: every product, sum, difference and quotient is rounded on its
// own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) in the order PyTorch's
// eager kernels compute the plain version on the card, and the file is
// compiled with -fmad=false. Where the plain version divides by a Python
// number, PyTorch's CUDA kernel multiplies by the float reciprocal, and so
// does this one; where it divides by a 0-d tensor (utils/rounding.py::
// exact_div) it divides. A Python number is rounded from its double to
// float, as PyTorch does (F32 below). pow, cos, sin and floor are the CUDA
// math library's, as in PyTorch's kernels. So every output equals the plain
// version's on the card bit for bit, but for the chroma sums, which add in
// another order than PyTorch's reduction.
//
// Preconditions, checked by the wrapper (ops/viewer_stage.py::_check):
// float32 carries (B, n) and rgba (B, n, 4) with a 16-byte aligned base;
// bool peaks and float32 (B, n) analysis rows; float32 (B,) scene calmness;
// float32 (B,) frame times with stride 0 or 1; every array contiguous and on
// one card. The launcher refuses a row too long for kMaxSharedBytes
// (cudaErrorInvalidValue).
//
// The balls are update_balls' defaults, the display's Normal mode: the
// shader parameters kept and a ball scale factor of 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define F32(x) ((float)(x))  // a Python float as PyTorch hands it to a float32 kernel

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 227 * 1024;
// the staged row: centers, sizes, calmness, spectrum, power (5 floats a
// bin), positions (3 floats) and the peak mask (1 byte)
constexpr int kSharedBytesPerBin = 8 * 4 + 1;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp / clamp_min: NaN passes through
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
// torch.amax: NaN wins
__device__ __forceinline__ float max_nan(float a, float b) { return (isnan(a) || a > b) ? a : b; }

// torch.remainder of floats (Python's %): fmod, moved to the divisor's sign
__device__ __forceinline__ float py_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = add(m, b);
  return m;
}

struct Tables {
  const float* palette_lch;  // (12, 3) L, C, h of the pitch-class colours
  const float* color_consts;  // the XYZ -> linear sRGB matrix (9), the white point (3)
};

// ops/colors.py::calculate_color at one fractional bucket: RGB in [0, 1]
__device__ void pitch_color(int bpo, float bucket, const Tables& t, float rgb[3]) {
  const float pc = quo(mul(bucket, 12.0f), (float)bpo);
  const float nearest = floorf(add(pc, 0.5f));
  long long cls = (long long)nearest % 12;
  if (cls < 0) cls += 12;
  const float L = t.palette_lch[3 * cls], C = t.palette_lch[3 * cls + 1], H = t.palette_lch[3 * cls + 2];
  const float sat = sub(1.0f, powf(mul(fabsf(sub(pc, nearest)), 2.0f), F32(1.3)));
  const float l = add(mul(sat, L), mul(sub(1.0f, sat), 60.0f));
  const float c = mul(C, sat);
  const float a = mul(c, cosf(H));
  const float b = mul(c, sinf(H));
  // lab_to_srgb_u8
  const float eps = F32(216.0 / 24389.0), kappa = F32(24389.0 / 27.0);
  const float fy = quo(add(l, 16.0f), 116.0f);
  const float fx = add(fy, quo(a, 500.0f));
  const float fz = sub(fy, quo(b, 200.0f));
  const float fx3 = mul(mul(fx, fx), fx), fy3 = mul(mul(fy, fy), fy), fz3 = mul(mul(fz, fz), fz);
  const float xr = fx3 > eps ? fx3 : quo(sub(mul(fx, 116.0f), 16.0f), kappa);
  const float yr = l > F32((24389.0 / 27.0) * (216.0 / 24389.0)) ? fy3 : quo(l, kappa);
  const float zr = fz3 > eps ? fz3 : quo(sub(mul(fz, 116.0f), 16.0f), kappa);
  const float* m = t.color_consts;
  const float X = mul(xr, m[9]), Y = mul(yr, m[10]), Z = mul(zr, m[11]);
  for (int i = 0; i < 3; ++i) {
    const float lin = add(add(mul(X, m[3 * i]), mul(Y, m[3 * i + 1])), mul(Z, m[3 * i + 2]));
    const float s = lin > F32(0.0031308) ? sub(mul(powf(lin, F32(1.0 / 2.4)), F32(1.055)), F32(0.055))
                                         : mul(lin, F32(12.92));
    rgb[i] = quo(clamp(floorf(add(mul(s, 255.0f), 0.5f)), 0.0f, 255.0f), 255.0f);
  }
}

struct Args {
  // the ball carry
  const float* scale;
  const float* z_offset;
  const float* center;
  const float4* rgba;
  const float* calm;
  // the analysis outputs
  const uint8_t* peaks;
  const float* peak_center;
  const float* peak_size;
  const float* calmness;
  const float* x_vqt;
  const float* scene_calmness;
  const float* dt;
  long long dt_stride;
  // static tables (ops/colors.py::static_table)
  const float* dropoff_base;  // (n,)
  const uint8_t* spec_rgb;  // (n, 3) u8 colours of the spectrogram row
  const long long* chroma_index;  // (12, chroma_width) bins of each pitch class, n where padded
  int chroma_width;
  const float* calm_palette;  // (3, 3)
  Tables tables;
  // outputs
  float* new_scale;
  float* new_z_offset;
  float* new_center;
  float4* new_rgba;
  float* new_calm;
  float* position;  // (B, n, 3)
  uint8_t* visible;
  float* chroma;  // (B, 12)
  float* bloom;  // (B,)
  uchar4* spectrogram;  // (B, n) RGBA8
  uint8_t* bass_visible;  // (B, n_segments)
  float4* bass_rgba;  // (B,)
  float* heights;
  float* segment_rgb;  // (B, n - 1, 3)
  // geometry
  int n;
  int bpo;
  int rotation;  // models/viewer.py::pitch_color_rotation
  int n_segments;  // bass cylinders
  float hide_radius;  // (bpo // 12) * 0.23
  int hide_span;  // int(hide_radius) + 2
};

__global__ void __launch_bounds__(kThreads) viewer_stage_kernel(const Args p) {
  extern __shared__ float smem[];
  const int n = p.n;
  float* s_center = smem;
  float* s_size = s_center + n;
  float* s_calm = s_size + n;
  float* s_x = s_calm + n;
  float* s_power = s_x + n;
  float* s_pos = s_power + n;  // 3n
  uint8_t* s_peaks = reinterpret_cast<uint8_t*>(s_pos + 3 * n);
  __shared__ float red_size[kWarps], red_x[kWarps], s_chroma[12], s_lit;
  __shared__ int red_first[kWarps];

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long base = row * n;

  // stage the row; reduce the largest peak size, the spectrum's maximum and
  // the first peak
  const float inv_ten = quo(1.0f, 10.0f);
  float my_size = -INFINITY, my_x = -INFINITY;
  int my_first = n;
  for (int i = tid; i < n; i += kThreads) {
    const bool pk = p.peaks[base + i] != 0;
    const float c = p.peak_center[base + i], s = p.peak_size[base + i], x = p.x_vqt[base + i];
    s_peaks[i] = pk;
    s_center[i] = c;
    s_size[i] = s;
    s_calm[i] = p.calmness[base + i];
    s_x[i] = x;
    s_power[i] = powf(10.0f, mul(x, inv_ten));
    my_size = max_nan(my_size, pk ? s : 0.0f);
    my_x = max_nan(my_x, x);
    if (pk && i < my_first) my_first = i;
  }
  for (int o = 16; o > 0; o >>= 1) {
    my_size = max_nan(my_size, __shfl_xor_sync(0xffffffffu, my_size, o));
    my_x = max_nan(my_x, __shfl_xor_sync(0xffffffffu, my_x, o));
    my_first = min(my_first, __shfl_xor_sync(0xffffffffu, my_first, o));
  }
  if ((tid & 31) == 0) {
    red_size[tid >> 5] = my_size;
    red_x[tid >> 5] = my_x;
    red_first[tid >> 5] = my_first;
  }
  __syncthreads();
  float max_size = red_size[0], mx = red_x[0];
  int first = red_first[0];
  for (int w = 1; w < kWarps; ++w) {
    max_size = max_nan(max_size, red_size[w]);
    mx = max_nan(mx, red_x[w]);
    first = min(first, red_first[w]);
  }
  max_size = clamp_min(max_size, F32(1e-30));
  const bool has_peak = first < n;

  // the balls, the spectrogram row and the contour's heights, bin by bin
  const int bpo = p.bpo;
  const float fbpo = (float)bpo;
  const float inv_bpo = quo(1.0f, fbpo);
  const float dt = p.dt[row * p.dt_stride];
  const float fade_exp = mul(dt, 30.0f);
  const float drift = mul(dt, F32(0.001 * 30.0));
  const float spec_den = add(mx, F32(0.001));
  const float r = p.hide_radius;
  for (int i = tid; i < n; i += kThreads) {
    // the fade
    const float dropoff = powf(p.dropoff_base[i], fade_exp);
    const float scale = mul(p.scale[base + i], dropoff);
    const float z_offset = sub(p.z_offset[base + i], drift);
    // the peak that keys this bin: source bins i + 1, i, i - 1, the higher
    // winning
    bool active = false;
    float center_at = 0.0f, size_at = 0.0f;
    for (int j = min(i + 1, n - 1); j >= max(i - 1, 0) && !active; --j) {
      if (!s_peaks[j]) continue;
      long long key = (long long)s_center[j];
      key = key < 0 ? 0 : (key > n - 1 ? n - 1 : key);
      if (key == i) {
        active = true;
        center_at = s_center[j];
        size_at = s_size[j];
      }
    }
    const float calm_param = clamp(sub(s_calm[i], F32(0.27)), 0.0f, 1.0f);
    const float4 old_rgba = p.rgba[base + i];
    float new_scale, z_order, new_z, new_center, new_calm;
    float4 new_rgba;
    if (active) {
      const float q = quo(size_at, max_size);
      const float t = sub(1.0f, q);
      const float coefficient = sub(1.0f, mul(t, t));
      float rgb[3];
      pitch_color(bpo, py_mod(add(center_at, (float)p.rotation), fbpo), p.tables, rgb);
      const float calmness_scale = add(mul(calm_param, F32(0.2)), 1.0f);
      new_scale = mul(mul(size_at, F32(1.0 / 305.0)), calmness_scale);
      z_order = mul(sub(q, F32(1.01)), 12.5f);
      new_z = 0.0f;
      new_center = center_at;
      new_rgba = make_float4(rgb[0], rgb[1], rgb[2], coefficient);
      new_calm = calm_param;
    } else {
      new_scale = scale;
      z_order = z_offset;
      new_z = z_offset;
      new_center = p.center[base + i];
      new_rgba = make_float4(old_rgba.x, old_rgba.y, old_rgba.z, clamp_min(mul(old_rgba.w, dropoff), F32(0.7)));
      new_calm = p.calm[base + i];
    }
    // the spiral position (models/viewer.py::bin_to_spiral)
    const float radius = mul(add(powf(mul(new_center, inv_bpo), 0.75f), F32(0.3)), 2.0f);
    const float angle = mul(mul(mul(add(new_center, fbpo), inv_bpo), 2.0f), F32(M_PI));
    s_pos[3 * i] = mul(-cosf(angle), radius);
    s_pos[3 * i + 1] = mul(sinf(angle), radius);
    s_pos[3 * i + 2] = z_order;
    // visibility, then the bins hidden around each peak but the balls placed
    bool visible = new_scale >= F32(0.019) || (active && new_scale >= F32(0.002));
    if (visible && !active) {
      const float fi = (float)i;
      for (int s = max(i - p.hide_span, 0); s <= min(i + p.hide_span, n - 1); ++s) {
        if (!s_peaks[s]) continue;
        const float lo = floorf(add(sub(s_center[s], r), 0.5f));
        const float hi = floorf(add(add(s_center[s], r), 0.5f));
        if (lo <= fi && fi <= hi) {
          visible = false;
          break;
        }
      }
    }
    p.new_scale[base + i] = new_scale;
    p.new_z_offset[base + i] = new_z;
    p.new_center[base + i] = new_center;
    p.new_rgba[base + i] = new_rgba;
    p.new_calm[base + i] = new_calm;
    p.visible[base + i] = visible;
    // the spectrogram row (models/viewer.py::spectrogram_row_vqt)
    const float t = sub(1.0f, quo(s_x[i], spec_den));
    const float brightness = mx > 0.0f ? clamp(mul(sub(1.0f, mul(t, t)), 1.5f), 0.0f, 1.0f) : 0.0f;
    const float alpha = floorf(clamp(mul(mul(brightness, F32(1.2)), 255.0f), 0.0f, 255.0f));
    p.spectrogram[base + i] =
        make_uchar4(p.spec_rgb[3 * i], p.spec_rgb[3 * i + 1], p.spec_rgb[3 * i + 2], (unsigned char)alpha);
    p.heights[base + i] = mul(s_calm[i], 0.5f);
  }

  // the chroma sums, one pitch class a thread
  if (tid < 12) {
    float sum = 0.0f;
    const long long* idx = p.chroma_index + tid * p.chroma_width;
    for (int k = 0; k < p.chroma_width; ++k) sum = add(sum, idx[k] < n ? s_power[idx[k]] : 0.0f);
    s_chroma[tid] = sum;
  }
  // the bass spiral and the bloom
  if (tid == kThreads - 1) {
    const float c = has_peak ? s_center[first] : 0.0f;
    const float size = has_peak ? s_size[first] : 0.0f;
    const float rounded = floorf(add(mul(quo(c, fbpo), 12.0f), 0.5f));
    const float n_lit = mul(rounded, 6.0f);
    float rgb[3];
    pitch_color(bpo, py_mod(add(quo(mul(rounded, fbpo), 12.0f), (float)p.rotation), fbpo), p.tables, rgb);
    const float t = sub(1.0f, quo(size, max_size));
    p.bass_rgba[row] = make_float4(rgb[0], rgb[1], rgb[2], sub(1.0f, mul(t, t)));
    s_lit = n_lit;
    p.bloom[row] = clamp(mul(p.scene_calmness[row], F32(1.3)), 0.0f, 1.0f);
  }
  __syncthreads();

  // staged and per-row outputs
  for (int k = tid; k < 3 * n; k += kThreads) p.position[base * 3 + k] = s_pos[k];
  const float n_lit = s_lit;
  const bool lit_any = has_peak && n_lit < (float)p.n_segments;
  const long long lit = (long long)n_lit;
  for (int s = tid; s < p.n_segments; s += kThreads)
    p.bass_visible[row * p.n_segments + s] = lit_any && (long long)s < lit;
  for (int k = tid; k < 3 * (n - 1); k += kThreads) {
    const int seg = k / 3;
    const float mid = mul(add(s_calm[seg], s_calm[seg + 1]), 0.5f);
    const int level = (mid > F32(0.3)) + (mid > F32(0.7));
    p.segment_rgb[row * 3 * (n - 1) + k] = p.calm_palette[3 * level + (k - 3 * seg)];
  }
  if (tid < 32) {
    float c = tid < 12 ? s_chroma[tid] : -INFINITY;
    float cmax = c;
    for (int o = 8; o > 0; o >>= 1) cmax = max_nan(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
    if (tid < 12) p.chroma[row * 12 + tid] = cmax > 0.0f ? quo(c, clamp_min(cmax, F32(1e-30))) : c;
  }
}

extern "C" int viewer_stage_f32(
    const float* scale, const float* z_offset, const float* center, const float* rgba, const float* calm,
    const uint8_t* peaks, const float* peak_center, const float* peak_size, const float* calmness,
    const float* x_vqt, const float* scene_calmness, const float* dt, long long dt_stride,
    const float* dropoff_base, const uint8_t* spec_rgb, const long long* chroma_index, int chroma_width,
    const float* calm_palette, const float* palette_lch, const float* color_consts,
    float* new_scale, float* new_z_offset, float* new_center, float* new_rgba, float* new_calm, float* position,
    uint8_t* visible, float* chroma, float* bloom, uint8_t* spectrogram, uint8_t* bass_visible, float* bass_rgba,
    float* heights, float* segment_rgb, int B, int n, int bpo, int rotation, int n_segments, float hide_radius,
    int hide_span, void* stream) {
  Args a;
  a.scale = scale;
  a.z_offset = z_offset;
  a.center = center;
  a.rgba = reinterpret_cast<const float4*>(rgba);
  a.calm = calm;
  a.peaks = peaks;
  a.peak_center = peak_center;
  a.peak_size = peak_size;
  a.calmness = calmness;
  a.x_vqt = x_vqt;
  a.scene_calmness = scene_calmness;
  a.dt = dt;
  a.dt_stride = dt_stride;
  a.dropoff_base = dropoff_base;
  a.spec_rgb = spec_rgb;
  a.chroma_index = chroma_index;
  a.chroma_width = chroma_width;
  a.calm_palette = calm_palette;
  a.tables.palette_lch = palette_lch;
  a.tables.color_consts = color_consts;
  a.new_scale = new_scale;
  a.new_z_offset = new_z_offset;
  a.new_center = new_center;
  a.new_rgba = reinterpret_cast<float4*>(new_rgba);
  a.new_calm = new_calm;
  a.position = position;
  a.visible = visible;
  a.chroma = chroma;
  a.bloom = bloom;
  a.spectrogram = reinterpret_cast<uchar4*>(spectrogram);
  a.bass_visible = bass_visible;
  a.bass_rgba = reinterpret_cast<float4*>(bass_rgba);
  a.heights = heights;
  a.segment_rgb = segment_rgb;
  a.n = n;
  a.bpo = bpo;
  a.rotation = rotation;
  a.n_segments = n_segments;
  a.hide_radius = hide_radius;
  a.hide_span = hide_span;
  const int shared = kSharedBytesPerBin * n;
  if (shared > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(viewer_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  viewer_stage_kernel<<<B, kThreads, shared, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
