// Native host runtime for pitchvis_tpu_torch: the ingest side of the
// serving runtime (runtime/server.py) and the training synthesizer's voice
// loop, a copy of the JAX package's native/pitchvis_native.cpp.
//
// The card does the math; this library is the host-side serving runtime
// around it, the C++ counterpart of the reference's audio-thread machinery
// (pitchvis_audio/src/lib.rs RingBuffer + cpal callbacks) scaled to many
// concurrent streams:
//
//  * pv_rb_*   — per-stream single-producer/single-consumer ring buffers
//                with lock-free writes and a batched snapshot that gathers
//                the trailing window of every stream into one contiguous
//                [n_streams, window] host buffer (the host-to-device
//                staging buffer).
//  * pv_rs_*   — per-stream streaming polyphase resamplers (44.1/48 kHz
//                producers to the server rate).
//  * pv_agc_*  — the dagc gain recurrence (dagc_fork/src/lib.rs:76-87) as a
//                tight scalar loop (the serving ingest and the host route of
//                dataset generation, train/dataset.py).
//  * pv_synth_render — additive-harmonic voice mixing with ADSR envelopes
//                (the render hot loop of the training synthesizer,
//                synth/synthesizer.py).
//
// Build: utils/host_build.py (g++ -O3 -march=native -fPIC -std=c++17
// -shared) at first use. Exposed via ctypes (runtime/native.py); every
// entry point is plain C ABI.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Ring buffers
// ---------------------------------------------------------------------------

struct StreamRing {
  std::vector<float> buf;      // capacity samples, circular
  std::atomic<uint64_t> head;  // total samples ever written
  // AGC gain: atomic because the analysis thread's snapshot and the
  // control plane's reset read/write it concurrently with ingest (a plain
  // float would be a formal data race)
  std::atomic<float> gain;
  // delta-ingest read cursor (total samples ever consumed): owned by the
  // single analysis thread, atomic because the control plane's reset and
  // mark_consumed touch it concurrently
  std::atomic<uint64_t> consumed;

  StreamRing() : head(0), gain(1.0f), consumed(0) {}
};

struct RingBank {
  std::vector<std::unique_ptr<StreamRing>> rings;  // atomics are immovable
  int64_t capacity;
};

// Wrap-split bulk copies: the ring is contiguous except at the wrap point,
// so every read/write of n samples is at most two memcpys — per-sample
// `% cap` indexing measured ~5-10x slower on the copies that dominate the
// host side of a serving hop (consume/snapshot at thousands of streams).
static inline void ring_read(const std::vector<float>& buf, int64_t cap,
                             uint64_t from, float* dst, int64_t n) {
  int64_t start = (int64_t)(from % (uint64_t)cap);
  int64_t first = std::min<int64_t>(n, cap - start);
  std::memcpy(dst, buf.data() + start, first * sizeof(float));
  if (n > first) std::memcpy(dst + first, buf.data(), (n - first) * sizeof(float));
}

static inline void ring_write_raw(std::vector<float>& buf, int64_t cap,
                                  uint64_t to, const float* src, int64_t n) {
  int64_t start = (int64_t)(to % (uint64_t)cap);
  int64_t first = std::min<int64_t>(n, cap - start);
  std::memcpy(buf.data() + start, src, first * sizeof(float));
  if (n > first) std::memcpy(buf.data(), src + first, (n - first) * sizeof(float));
}

void* pv_rb_create(int64_t n_streams, int64_t capacity) {
  auto* bank = new RingBank();
  bank->capacity = capacity;
  bank->rings.reserve(n_streams);
  for (int64_t i = 0; i < n_streams; ++i) {
    auto r = std::make_unique<StreamRing>();
    r->buf.assign(capacity, 0.0f);
    bank->rings.push_back(std::move(r));
  }
  return bank;
}

void pv_rb_destroy(void* handle) { delete static_cast<RingBank*>(handle); }

// Producer side (one thread per stream, or any external pacing): appends
// n samples. Non-finite chunks are rejected wholesale (the reference
// rejects on !is_finite(), audio_desktop.rs:102-105). Returns 0 on
// success, -1 on rejection.
int32_t pv_rb_write(void* handle, int64_t stream, const float* samples, int64_t n) {
  auto* bank = static_cast<RingBank*>(handle);
  StreamRing& r = *bank->rings[stream];
  for (int64_t i = 0; i < n; ++i) {
    if (!std::isfinite(samples[i])) return -1;
  }
  uint64_t head = r.head.load(std::memory_order_relaxed);
  const int64_t cap = bank->capacity;
  const float* src = samples;
  uint64_t to = head;
  int64_t m = n;
  if (m > cap) {  // only the last cap samples survive the lap anyway
    src += m - cap;
    to += (uint64_t)(m - cap);
    m = cap;
  }
  ring_write_raw(r.buf, cap, to, src, m);
  r.head.store(head + n, std::memory_order_release);
  return 0;
}

// Same, but applies the AGC recurrence to the chunk before writing and
// updates the stream's gain; freezes on silent chunks (energy < 1e-6).
int32_t pv_rb_write_agc(void* handle, int64_t stream, const float* samples, int64_t n,
                        float desired_rms, float distortion) {
  auto* bank = static_cast<RingBank*>(handle);
  StreamRing& r = *bank->rings[stream];
  double energy = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    if (!std::isfinite(samples[i])) return -1;
    energy += (double)samples[i] * samples[i];
  }
  const bool frozen = energy < 1e-6;
  uint64_t head = r.head.load(std::memory_order_relaxed);
  const int64_t cap = bank->capacity;
  float gain = r.gain.load(std::memory_order_relaxed);
  const float inv = 1.0f / desired_rms;
  // the AGC recurrence is sequential but the store address is not: index
  // once per wrap segment instead of `% cap` per sample (the file-header
  // rule — this is the default path of the batched capacity-scale ingest)
  int64_t i = 0;
  while (i < n) {
    const int64_t idx = (int64_t)((head + (uint64_t)i) % (uint64_t)cap);
    const int64_t seg = std::min<int64_t>(n - i, cap - idx);
    float* dst = r.buf.data() + idx;
    const float* src = samples + i;
    for (int64_t k = 0; k < seg; ++k) {
      float x = src[k] * gain;
      dst[k] = x;
      if (!frozen) {
        float y = x * x * inv;
        float g = 1.0f + distortion * (1.0f - y);
        if (g < distortion) g = distortion;
        gain *= g;
      }
    }
    i += seg;
  }
  r.gain.store(gain, std::memory_order_relaxed);
  r.head.store(head + n, std::memory_order_release);
  return 0;
}

// Batched producer write: appends the rows of one contiguous (rows, n)
// block — row k to stream ids[k] — applying the AGC recurrence per row
// when agc != 0. ONE call per producer tick instead of one per stream:
// at capacity scale (thousands of streams) host ingest is bound by the
// Python call dispatch long before the memcpys matter, and a network
// frontend delivers audio in exactly this batched shape anyway. The
// per-stream single-producer contract applies per ROW (two concurrent
// batch writers must target disjoint id sets). Per-row NaN guard:
// a non-finite row is rejected alone (ok[k]=0; others proceed), matching
// the reference's per-callback rejection (audio_desktop.rs:102-105).
// Returns the number of accepted rows.
int64_t pv_rb_write_batch(void* handle, const int64_t* ids, int64_t rows,
                          const float* samples, int64_t n, uint8_t* ok,
                          int32_t agc, float desired_rms, float distortion) {
  int64_t accepted = 0;
  for (int64_t k = 0; k < rows; ++k) {
    const int32_t ret =
        agc ? pv_rb_write_agc(handle, ids[k], samples + k * n, n,
                              desired_rms, distortion)
            : pv_rb_write(handle, ids[k], samples + k * n, n);
    if (ok) ok[k] = ret == 0 ? 1 : 0;
    if (ret == 0) ++accepted;
  }
  return accepted;
}

// Consumer side: gathers the trailing `window` samples of every stream into
// out[n_streams * window] (zero-padded if a stream has written less than
// `window` samples). Also fills gains[n_streams] when non-null.
void pv_rb_snapshot(void* handle, float* out, float* gains, int64_t window) {
  auto* bank = static_cast<RingBank*>(handle);
  const int64_t cap = bank->capacity;
  const int64_t n_streams = (int64_t)bank->rings.size();
  for (int64_t s = 0; s < n_streams; ++s) {
    StreamRing& r = *bank->rings[s];
    const uint64_t head = r.head.load(std::memory_order_acquire);
    float* dst = out + s * window;
    const int64_t avail = (int64_t)std::min<uint64_t>(head, (uint64_t)window);
    const int64_t pad = window - avail;
    std::memset(dst, 0, pad * sizeof(float));
    ring_read(r.buf, cap, head - (uint64_t)avail, dst + pad, avail);
    if (gains) gains[s] = r.gain.load(std::memory_order_relaxed);
  }
}

// Delta-ingest consumer side (runtime/server.py ingest="delta"): reads the
// next `n` UNCONSUMED samples of every stream, all-or-nothing per stream —
// a stream with fewer than n unread samples is left untouched (its row is
// zeroed and advanced[s]=0), so an underrunning producer freezes its
// device-side window exactly like the snapshot path's stalled trailing
// window. Backlogs beyond `max_lag` samples are skipped (read cursor jumps
// to head - max_lag: realtime skip-ahead, bounded latency). A ring reset
// (head restarting at 0) is detected via head < consumed and rewinds the
// cursor. Returns the number of advanced streams, so a caller draining
// catch-up hops can stop as soon as nothing moved.
int64_t pv_rb_consume(void* handle, float* out, float* gains, uint8_t* advanced,
                      int64_t n, int64_t max_lag) {
  auto* bank = static_cast<RingBank*>(handle);
  const int64_t cap = bank->capacity;
  const int64_t n_streams = (int64_t)bank->rings.size();
  if (max_lag < 0 || max_lag > cap) max_lag = cap;
  int64_t moved = 0;
  for (int64_t s = 0; s < n_streams; ++s) {
    StreamRing& r = *bank->rings[s];
    const uint64_t head = r.head.load(std::memory_order_acquire);
    uint64_t loaded = r.consumed.load(std::memory_order_relaxed);
    uint64_t pos = loaded;
    if (head < pos) pos = 0;  // ring was reset since the last consume
    uint64_t avail = head - pos;
    if (avail > (uint64_t)max_lag) {  // skip-ahead: drop the stale middle
      pos = head - (uint64_t)max_lag;
      avail = (uint64_t)max_lag;
    }
    float* dst = out + s * n;
    if (avail >= (uint64_t)n) {
      ring_read(r.buf, cap, pos, dst, n);
      pos += (uint64_t)n;
      advanced[s] = 1;
      ++moved;
    } else {
      std::memset(dst, 0, n * sizeof(float));  // deterministic, never selected
      advanced[s] = 0;
    }
    // CAS, not a plain store: a pv_rb_reset racing this consume sets
    // consumed=0, and blindly writing the stale cursor back would make the
    // new client's first `loaded` samples silently skippable. On CAS
    // failure the reset's 0 wins (the advanced row's chunk came from the
    // OLD client's audio and that slot's state is being recycled anyway).
    r.consumed.compare_exchange_strong(loaded, pos, std::memory_order_relaxed);
    if (gains) gains[s] = r.gain.load(std::memory_order_relaxed);
  }
  return moved;
}

// Aligns every stream's read cursor with its write head — called right
// after the delta path (re)materializes its device window from a full
// snapshot (init / rebuild / checkpoint restore), so subsequent consumes
// deliver only samples newer than that window.
void pv_rb_mark_consumed(void* handle) {
  auto* bank = static_cast<RingBank*>(handle);
  for (auto& rp : bank->rings) {
    rp->consumed.store(rp->head.load(std::memory_order_acquire),
                       std::memory_order_relaxed);
  }
}

// Window materialization for the delta path: snapshot + mark_consumed fused
// PER STREAM against the SAME head value — two separate calls would splice
// out any samples pushed between them (the gap audio would be in neither
// the materialized window nor any future consume). The cursor is set to
// exactly the head the copy used, so a chunk racing the copy stays
// unconsumed and arrives in the next pv_rb_consume.
void pv_rb_snapshot_consume(void* handle, float* out, float* gains,
                            int64_t window) {
  auto* bank = static_cast<RingBank*>(handle);
  const int64_t cap = bank->capacity;
  const int64_t n_streams = (int64_t)bank->rings.size();
  for (int64_t s = 0; s < n_streams; ++s) {
    StreamRing& r = *bank->rings[s];
    uint64_t loaded = r.consumed.load(std::memory_order_relaxed);
    const uint64_t head = r.head.load(std::memory_order_acquire);
    float* dst = out + s * window;
    const int64_t avail = (int64_t)std::min<uint64_t>(head, (uint64_t)window);
    const int64_t pad = window - avail;
    std::memset(dst, 0, pad * sizeof(float));
    ring_read(r.buf, cap, head - (uint64_t)avail, dst + pad, avail);
    // CAS for the same reset race as pv_rb_consume: a reset's consumed=0
    // must win over this stale head
    r.consumed.compare_exchange_strong(loaded, head, std::memory_order_relaxed);
    if (gains) gains[s] = r.gain.load(std::memory_order_relaxed);
  }
}

// Control plane: recycle one stream slot for a NEW stream (serving churn —
// a client disconnects and another takes its slot). Zeroes the audio, the
// write position, and the AGC gain. Caller contract: the slot's previous
// producer must have stopped (per-stream single-producer rule). A snapshot
// racing this call is memory-safe but may observe AT MOST one glitched
// (partially cleared) window — see the ordering note below.
void pv_rb_reset(void* handle, int64_t stream) {
  auto* bank = static_cast<RingBank*>(handle);
  StreamRing& r = *bank->rings[stream];
  // Zero head FIRST: a snapshot starting after this point sees avail=0 and
  // returns all-zeros regardless of buffer contents. A snapshot already
  // in-flight (old head loaded) may still copy a partially cleared buffer —
  // at most ONE glitched window, documented at the Python binding.
  r.head.store(0, std::memory_order_release);
  std::fill(r.buf.begin(), r.buf.end(), 0.0f);
  r.gain.store(1.0f, std::memory_order_relaxed);
  r.consumed.store(0, std::memory_order_relaxed);
}

double pv_rb_gain(void* handle, int64_t stream) {
  return static_cast<RingBank*>(handle)->rings[stream]->gain.load(std::memory_order_relaxed);
}

uint64_t pv_rb_written(void* handle, int64_t stream) {
  return static_cast<RingBank*>(handle)->rings[stream]->head.load(std::memory_order_acquire);
}

// Checkpoint side: exports the full bank state — per stream the trailing
// min(head, capacity) samples in chronological order (zero-padded at the
// front of the row, same layout as pv_rb_snapshot with window=capacity),
// the total-written head counter, and the AGC gain. Safe against concurrent
// producers in the same sense as snapshot (each row is internally
// consistent up to one in-flight chunk).
void pv_rb_export(void* handle, float* audio_out, uint64_t* heads_out,
                  float* gains_out) {
  auto* bank = static_cast<RingBank*>(handle);
  const int64_t cap = bank->capacity;
  const int64_t n_streams = (int64_t)bank->rings.size();
  for (int64_t s = 0; s < n_streams; ++s) {
    StreamRing& r = *bank->rings[s];
    const uint64_t head = r.head.load(std::memory_order_acquire);
    float* dst = audio_out + s * cap;
    const int64_t avail = (int64_t)std::min<uint64_t>(head, (uint64_t)cap);
    const int64_t pad = cap - avail;
    std::memset(dst, 0, pad * sizeof(float));
    ring_read(r.buf, cap, head - (uint64_t)avail, dst + pad, avail);
    heads_out[s] = head;
    gains_out[s] = r.gain.load(std::memory_order_relaxed);
  }
}

// Restore side: loads a pv_rb_export image into a QUIESCED bank (restart
// path: no producers yet — unlike snapshot/reset this is NOT safe against
// concurrent writes). Head counters resume at their exported values, so
// pv_rb_written continuity and subsequent wraparound behave as if the
// process never died.
void pv_rb_import(void* handle, const float* audio, const uint64_t* heads,
                  const float* gains) {
  auto* bank = static_cast<RingBank*>(handle);
  const int64_t cap = bank->capacity;
  const int64_t n_streams = (int64_t)bank->rings.size();
  for (int64_t s = 0; s < n_streams; ++s) {
    StreamRing& r = *bank->rings[s];
    const uint64_t head = heads[s];
    const float* src = audio + s * cap;
    const int64_t avail = (int64_t)std::min<uint64_t>(head, (uint64_t)cap);
    const int64_t pad = cap - avail;
    std::fill(r.buf.begin(), r.buf.end(), 0.0f);
    ring_write_raw(r.buf, cap, head - (uint64_t)avail, src + pad, avail);
    r.gain.store(gains[s], std::memory_order_relaxed);
    r.head.store(head, std::memory_order_release);
  }
}

// ---------------------------------------------------------------------------
// Streaming polyphase resampler bank (ingest-side 44.1/48 kHz -> 22050)
// ---------------------------------------------------------------------------
//
// The native mirror of ops/resample.py's batched polyphase design (the
// reference resamples WASM mic input with rubato's FftFixedIn,
// pitchvis_audio/src/audio_wasm.rs:176-209). One bank per input rate, one
// history + remainder state per stream; the prototype filter is designed in
// Python (ops/resample.py::_design_prototype) and passed in, so host and
// device paths share EXACTLY the same coefficients. Per-stream
// single-producer contract matches the ring writes it feeds.

struct StreamResampleState {
  std::vector<float> hist;     // last taps-1 consumed input samples
  std::vector<float> pending;  // <M leftover input samples (phase alignment)
};

struct ResamplerBank {
  int64_t l, m, taps;
  std::vector<double> h;  // prototype, length taps * l
  std::vector<StreamResampleState> streams;
};

void* pv_rs_create(int64_t n_streams, int64_t l, int64_t m, int64_t taps,
                   const double* h) {
  auto* bank = new ResamplerBank();
  bank->l = l;
  bank->m = m;
  bank->taps = taps;
  bank->h.assign(h, h + taps * l);
  bank->streams.resize(n_streams);
  for (auto& s : bank->streams) s.hist.assign(taps - 1, 0.0f);
  return bank;
}

void pv_rs_destroy(void* handle) { delete static_cast<ResamplerBank*>(handle); }

void pv_rs_reset(void* handle, int64_t stream) {
  auto& s = static_cast<ResamplerBank*>(handle)->streams[stream];
  std::fill(s.hist.begin(), s.hist.end(), 0.0f);
  s.pending.clear();
}

// Consumes pending + in, emits floor((n_pending + n_in) / m) * l output
// samples into out (caller sizes out via pv_rs_out_bound). Returns the
// number of output samples written, or -1 if out_cap is too small.
int64_t pv_rs_process(void* handle, int64_t stream, const float* in, int64_t n_in,
                      float* out, int64_t out_cap) {
  auto* bank = static_cast<ResamplerBank*>(handle);
  StreamResampleState& s = bank->streams[stream];
  const int64_t l = bank->l, m = bank->m, taps = bank->taps;

  std::vector<float> buf;
  buf.reserve(s.pending.size() + n_in);
  buf.insert(buf.end(), s.pending.begin(), s.pending.end());
  buf.insert(buf.end(), in, in + n_in);

  const int64_t n_blocks = (int64_t)buf.size() / m;
  const int64_t n_proc = n_blocks * m;
  const int64_t n_out = n_blocks * l;
  if (n_out > out_cap) return -1;

  // ext = [hist | processed input]: output j reads ext[taps-1 + m_j - t]
  std::vector<float> ext;
  ext.reserve(taps - 1 + n_proc);
  ext.insert(ext.end(), s.hist.begin(), s.hist.end());
  ext.insert(ext.end(), buf.begin(), buf.begin() + n_proc);

  for (int64_t j = 0; j < n_out; ++j) {
    const int64_t pos = j * m;
    const int64_t m_j = pos / l;
    const int64_t phase = pos % l;
    double acc = 0.0;
    const float* x = ext.data() + (taps - 1) + m_j;
    for (int64_t t = 0; t < taps; ++t) {
      acc += bank->h[phase + t * l] * (double)x[-t];
    }
    out[j] = (float)acc;
  }

  // carry state: last taps-1 samples of [hist | processed] + unconsumed
  // remainder (ext is always >= taps-1 long, so this is exact even when a
  // short chunk consumed fewer than taps-1 new samples)
  std::copy(ext.end() - (taps - 1), ext.end(), s.hist.begin());
  s.pending.assign(buf.begin() + n_proc, buf.end());
  return n_out;
}

// ---------------------------------------------------------------------------
// dagc AGC (standalone)
// ---------------------------------------------------------------------------

// In/out samples, returns the updated gain.
float pv_agc_process(float gain, float* samples, int64_t n, float desired_rms,
                     float distortion, int32_t frozen) {
  const float inv = 1.0f / desired_rms;
  for (int64_t i = 0; i < n; ++i) {
    float x = samples[i] * gain;
    samples[i] = x;
    if (!frozen) {
      float y = x * x * inv;
      float g = 1.0f + distortion * (1.0f - y);
      if (g < distortion) g = distortion;
      gain *= g;
    }
  }
  return gain;
}

// ---------------------------------------------------------------------------
// Synth voice render kernel
// ---------------------------------------------------------------------------

// Renders n samples of `n_voices` additive voices into mix[n] (accumulating)
// and writes each voice's end-of-chunk envelope gain into gains_out.
//
// Per voice inputs (arrays of length n_voices):
//   freq, phase (radians, updated in place), age (seconds, updated),
//   released_at (<0 = not released), amp (velocity * master),
//   attack, decay, sustain, release,
//   harmonics: [n_voices * n_harm] amplitude table.
void pv_synth_render(float* mix, int64_t n, double sample_rate, int64_t n_voices,
                     const double* freq, double* phase, double* age,
                     const double* released_at, const double* amp,
                     const double* attack, const double* decay,
                     const double* sustain, const double* release,
                     const double* harmonics, int64_t n_harm, double* gains_out) {
  const double nyq = sample_rate / 2.0;
  const double dt = 1.0 / sample_rate;
  for (int64_t v = 0; v < n_voices; ++v) {
    const double f = freq[v];
    const double a0 = age[v];
    const double rel = released_at[v];
    double env_last = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      const double t = a0 + i * dt;
      double env;
      if (t < attack[v]) {
        env = t / (attack[v] > 1e-5 ? attack[v] : 1e-5);
      } else if (t < attack[v] + decay[v]) {
        env = 1.0 - (1.0 - sustain[v]) * (t - attack[v]) / (decay[v] > 1e-5 ? decay[v] : 1e-5);
      } else {
        env = sustain[v];
      }
      if (rel >= 0.0 && t > rel) {
        double tr = (t - rel) / (release[v] > 1e-5 ? release[v] : 1e-5);
        env *= tr < 1.0 ? (1.0 - tr) : 0.0;
      }
      double wave = 0.0;
      const double base = phase[v] + 2.0 * M_PI * f * i * dt;
      for (int64_t h = 0; h < n_harm; ++h) {
        const double fh = f * (h + 1);
        if (fh >= nyq) break;
        const double ah = harmonics[v * n_harm + h];
        if (ah == 0.0) continue;
        wave += ah * std::sin(base * (h + 1));
      }
      mix[i] += (float)(amp[v] * env * wave);
      env_last = env;
    }
    phase[v] = std::fmod(phase[v] + 2.0 * M_PI * f * n * dt, 2.0 * M_PI);
    age[v] = a0 + n * dt;
    gains_out[v] = amp[v] * env_last;
  }
}

}  // extern "C"
