// Full SoundFont synthesizer engine of pitchvis_tpu_torch, a copy of the JAX
// package's native/synth_engine.cpp — C++ mirror of the NumPy reference
// implementation in synth/engine.py (behavioral equivalent of
// the reference's vendored rustysynth render path: synthesizer.rs, voice.rs,
// oscillator.rs, volume_envelope.rs, modulation_envelope.rs, lfo.rs,
// bi_quad_filter.rs, reverb.rs, chorus.rs, channel.rs, voice_collection.rs,
// midifile_sequencer.rs).
//
// Build: utils/host_build.py (g++ -O3 -march=native -fPIC -std=c++17
// -shared) at first use, as a library of its own beside pitchvis_native.cpp.
//
// This is the training pipeline's hot loop (train.rs:252-351): MIDI events
// dispatched on the 64-sample block grid, per-voice sample playback through
// resonant low-pass filters with DAHDSR envelopes and LFOs, stereo
// gain-ramped mixing, Freeverb reverb + chorus sends, plus an AGC'd
// chunk-capture loop (pv_train_synthesize) that returns VQT-ready windows
// and active-voice label snapshots in one native call.
//
// Region data arrives as flat tables built by synth/engine_native.py from
// the Python SF2 parser; generator semantics (sum of preset + instrument
// values, SF2 defaults) are baked into those tables' layout, matching
// region_pair.rs:19-21.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int GEN_COUNT = 61;
constexpr double NON_AUDIBLE = 1.0e-3;
constexpr double LOG_NON_AUDIBLE = -6.9077552789821368;  // ln(1e-3)
constexpr double PI = 3.14159265358979323846;
constexpr double HALF_PI = PI / 2.0;

// generator indices used by the voice (see synth/sf2.py for the full map)
enum Gen {
  G_START_OFF = 0, G_END_OFF = 1, G_STARTLOOP_OFF = 2, G_ENDLOOP_OFF = 3,
  G_START_COARSE = 4, G_MOD_LFO_PITCH = 5, G_VIB_LFO_PITCH = 6,
  G_MOD_ENV_PITCH = 7, G_FILTER_FC = 8, G_FILTER_Q = 9,
  G_MOD_LFO_FC = 10, G_MOD_ENV_FC = 11, G_END_COARSE = 12,
  G_MOD_LFO_VOL = 13, G_CHORUS = 15, G_REVERB = 16, G_PAN = 17,
  G_DELAY_MOD_LFO = 21, G_FREQ_MOD_LFO = 22, G_DELAY_VIB_LFO = 23,
  G_FREQ_VIB_LFO = 24, G_DELAY_MOD_ENV = 25, G_ATTACK_MOD_ENV = 26,
  G_HOLD_MOD_ENV = 27, G_DECAY_MOD_ENV = 28, G_SUSTAIN_MOD_ENV = 29,
  G_RELEASE_MOD_ENV = 30, G_KEY_MOD_HOLD = 31, G_KEY_MOD_DECAY = 32,
  G_DELAY_VOL_ENV = 33, G_ATTACK_VOL_ENV = 34, G_HOLD_VOL_ENV = 35,
  G_DECAY_VOL_ENV = 36, G_SUSTAIN_VOL_ENV = 37, G_RELEASE_VOL_ENV = 38,
  G_KEY_VOL_HOLD = 39, G_KEY_VOL_DECAY = 40, G_KEY_RANGE = 43,
  G_VEL_RANGE = 44, G_STARTLOOP_COARSE = 45, G_ATTEN = 48,
  G_ENDLOOP_COARSE = 50, G_COARSE_TUNE = 51, G_FINE_TUNE = 52,
  G_SAMPLE_MODES = 54, G_SCALE_TUNING = 56, G_EXCLUSIVE = 57,
  G_ROOT_KEY = 58,
};

inline double timecents_to_seconds(double x) { return std::pow(2.0, x / 1200.0); }
inline double cents_to_hertz(double x) { return 8.176 * std::pow(2.0, x / 1200.0); }
inline double cents_to_factor(double x) { return std::pow(2.0, x / 1200.0); }
inline double db_to_linear(double x) { return std::pow(10.0, 0.05 * x); }
inline double linear_to_db(double x) { return 20.0 * std::log10(x); }
inline double keynum_factor(int cents, int key) {
  return timecents_to_seconds(static_cast<double>(cents * (60 - key)));
}
inline double exp_cutoff(double x) { return x < LOG_NON_AUDIBLE ? 0.0 : std::exp(x); }
inline double clampd(double v, double lo, double hi) { return v < lo ? lo : (v > hi ? hi : v); }

struct InstRegion {
  int16_t gs[GEN_COUNT];
  int32_t sample_start, sample_end, sample_start_loop, sample_end_loop;
  int32_t sample_rate, original_pitch, pitch_correction;

  bool contains(int key, int vel) const {
    int kr = static_cast<uint16_t>(gs[G_KEY_RANGE]);
    int vr = static_cast<uint16_t>(gs[G_VEL_RANGE]);
    return (kr & 0xFF) <= key && key <= ((kr >> 8) & 0xFF) && (vr & 0xFF) <= vel &&
           vel <= ((vr >> 8) & 0xFF);
  }
  int32_t off(int fine, int coarse) const { return 32768 * gs[coarse] + gs[fine]; }
  int32_t start() const { return sample_start + off(G_START_OFF, G_START_COARSE); }
  int32_t end() const { return sample_end + off(G_END_OFF, G_END_COARSE); }
  int32_t start_loop() const { return sample_start_loop + off(G_STARTLOOP_OFF, G_STARTLOOP_COARSE); }
  int32_t end_loop() const { return sample_end_loop + off(G_ENDLOOP_OFF, G_ENDLOOP_COARSE); }
  int sample_modes() const { return gs[G_SAMPLE_MODES] == 2 ? 0 : gs[G_SAMPLE_MODES]; }
  int root_key() const { return gs[G_ROOT_KEY] != -1 ? gs[G_ROOT_KEY] : original_pitch; }
};

struct PresetRegion {
  int16_t gs[GEN_COUNT];
  int32_t instrument;
  bool contains(int key, int vel) const {
    int kr = static_cast<uint16_t>(gs[G_KEY_RANGE]);
    int vr = static_cast<uint16_t>(gs[G_VEL_RANGE]);
    return (kr & 0xFF) <= key && key <= ((kr >> 8) & 0xFF) && (vr & 0xFF) <= vel &&
           vel <= ((vr >> 8) & 0xFF);
  }
};

struct RegionPair {
  const PresetRegion* p;
  const InstRegion* i;
  int gs(int g) const { return static_cast<int>(p->gs[g]) + static_cast<int>(i->gs[g]); }
};

// --- envelopes (volume_envelope.rs / modulation_envelope.rs) ---------------

struct VolumeEnvelope {
  int sample_rate = 0;
  double attack_slope = 0, decay_slope = 0, release_slope = 0;
  double attack_start = 0, hold_start = 0, decay_start = 0, release_start = 0;
  double sustain_level = 0, release_level = 0;
  int64_t processed = 0;
  int stage = 0;
  double value = 0, priority = 0;

  void start(double delay, double attack, double hold, double decay, double sustain,
             double release) {
    attack_slope = 1.0 / attack;
    decay_slope = -9.226 / decay;
    release_slope = -9.226 / release;
    attack_start = delay;
    hold_start = delay + attack;
    decay_start = delay + attack + hold;
    release_start = 0.0;
    sustain_level = clampd(sustain, 0.0, 1.0);
    release_level = 0.0;
    processed = 0;
    stage = 0;
    value = 0.0;
    process(0);
  }
  void release() {
    stage = 4;
    release_start = static_cast<double>(processed) / sample_rate;
    release_level = value;
  }
  bool process(int n) {
    processed += n;
    double t = static_cast<double>(processed) / sample_rate;
    while (stage <= 2) {
      double end = stage == 0 ? attack_start : (stage == 1 ? hold_start : decay_start);
      if (t < end) break;
      ++stage;
    }
    switch (stage) {
      case 0: value = 0.0; priority = 4.0 + value; return true;
      case 1: value = attack_slope * (t - attack_start); priority = 3.0 + value; return true;
      case 2: value = 1.0; priority = 2.0 + value; return true;
      case 3:
        value = std::max(exp_cutoff(decay_slope * (t - decay_start)), sustain_level);
        priority = 1.0 + value;
        return value > NON_AUDIBLE;
      default:
        value = release_level * exp_cutoff(release_slope * (t - release_start));
        priority = value;
        return value > NON_AUDIBLE;
    }
  }
};

struct ModulationEnvelope {
  int sample_rate = 0;
  double attack_slope = 0, decay_slope = 0, release_slope = 0;
  double attack_start = 0, hold_start = 0, decay_start = 0;
  double decay_end = 0, release_end = 0;
  double sustain_level = 0, release_level = 0;
  int64_t processed = 0;
  int stage = 0;
  double value = 0;

  void start(double delay, double attack, double hold, double decay, double sustain,
             double release) {
    attack_slope = 1.0 / attack;
    decay_slope = 1.0 / decay;
    release_slope = 1.0 / release;
    attack_start = delay;
    hold_start = delay + attack;
    decay_start = delay + attack + hold;
    decay_end = decay_start + decay;
    release_end = release;
    sustain_level = clampd(sustain, 0.0, 1.0);
    release_level = 0.0;
    processed = 0;
    stage = 0;
    value = 0.0;
    process(0);
  }
  void release() {
    stage = 4;
    release_end += static_cast<double>(processed) / sample_rate;
    release_level = value;
  }
  bool process(int n) {
    processed += n;
    double t = static_cast<double>(processed) / sample_rate;
    while (stage <= 2) {
      double end = stage == 0 ? attack_start : (stage == 1 ? hold_start : decay_start);
      if (t < end) break;
      ++stage;
    }
    switch (stage) {
      case 0: value = 0.0; return true;
      case 1: value = attack_slope * (t - attack_start); return true;
      case 2: value = 1.0; return true;
      case 3:
        value = std::max(decay_slope * (decay_end - t), sustain_level);
        return value > NON_AUDIBLE;
      default:
        value = std::max(release_level * release_slope * (release_end - t), 0.0);
        return value > NON_AUDIBLE;
    }
  }
};

struct Lfo {
  int sample_rate = 0, block_size = 0;
  bool active = false;
  double delay = 0, period = 0;
  int64_t processed = 0;
  double value = 0;

  void start(double d, double frequency) {
    if (frequency > 1.0e-3) {
      active = true;
      delay = d;
      period = 1.0 / frequency;
      processed = 0;
      value = 0.0;
    } else {
      active = false;
      value = 0.0;
    }
  }
  void process() {
    if (!active) return;
    processed += block_size;
    double t = static_cast<double>(processed) / sample_rate;
    if (t < delay) {
      value = 0.0;
      return;
    }
    double phase = std::fmod(t - delay, period) / period;
    if (phase < 0.25) value = 4.0 * phase;
    else if (phase < 0.75) value = 4.0 * (0.5 - phase);
    else value = 4.0 * (phase - 1.0);
  }
};

struct BiQuadFilter {
  int sample_rate = 0;
  bool active = false;
  double a0 = 0, a1 = 0, a2 = 0, a3 = 0, a4 = 0;
  double x1 = 0, x2 = 0, y1 = 0, y2 = 0;
  static constexpr double RESONANCE_PEAK_OFFSET = 0.29289321881345254;  // 1 - 1/sqrt(2)

  void clear() { x1 = x2 = y1 = y2 = 0.0; }
  void set_low_pass(double cutoff, double resonance) {
    if (cutoff < 0.499 * sample_rate) {
      active = true;
      double q = resonance - RESONANCE_PEAK_OFFSET / (1.0 + 6.0 * (resonance - 1.0));
      double w = 2.0 * PI * cutoff / sample_rate;
      double cosw = std::cos(w);
      double alpha = std::sin(w) / (2.0 * q);
      double b0 = (1.0 - cosw) / 2.0, b1 = 1.0 - cosw, b2 = (1.0 - cosw) / 2.0;
      double A0 = 1.0 + alpha, A1 = -2.0 * cosw, A2 = 1.0 - alpha;
      a0 = b0 / A0; a1 = b1 / A0; a2 = b2 / A0; a3 = A1 / A0; a4 = A2 / A0;
    } else {
      active = false;
    }
  }
  void process(float* block, int n) {
    if (active) {
      for (int t = 0; t < n; ++t) {
        double in = block[t];
        double out = a0 * in + a1 * x1 + a2 * x2 - a3 * y1 - a4 * y2;
        x2 = x1; x1 = in; y2 = y1; y1 = out;
        block[t] = static_cast<float>(out);
      }
    } else {
      x2 = block[n - 2]; x1 = block[n - 1]; y2 = x2; y1 = x1;
    }
  }
};

struct Oscillator {
  int synth_rate = 0;
  int loop_mode = 0;
  int32_t start_ = 0, end = 0, start_loop = 0, end_loop = 0;
  int root_key = 0;
  double tune = 0, pitch_change_scale = 0, sample_rate_ratio = 0;
  bool looping = false;
  double position = 0;

  void start(int lm, int sr, int32_t s, int32_t e, int32_t sl, int32_t el, int rk, int coarse,
             int fine, int scale) {
    loop_mode = lm;
    start_ = s; end = e; start_loop = sl; end_loop = el; root_key = rk;
    tune = coarse + 0.01 * fine;
    pitch_change_scale = 0.01 * scale;
    sample_rate_ratio = static_cast<double>(sr) / synth_rate;
    looping = lm != 0;  // fork quirk: all LoopMode constants are 0
    // malformed/adversarial SF2 guard: a degenerate loop (length < 1, via
    // loop-offset generators) would divide by zero in process — fall back
    // to one-shot playback. Mirrored in engine.py.
    if (looping && el - sl < 1) looping = false;
    position = static_cast<double>(s);
  }
  bool process(const int16_t* data, int64_t n_data, float* block, int n, double pitch) {
    if (n_data < 2) {
      // empty/degenerate wave data (adversarial SF2 whose smpl chunk is
      // shorter than its sample headers claim): the clamps below would
      // otherwise compute negative upper bounds (clampi(i, n_data - 2)
      // with n_data < 2) and read before the buffer — emit silence and
      // kill the voice instead. Mirrored in engine.py.
      for (int t = 0; t < n; ++t) block[t] = 0.0f;
      return false;
    }
    double pitch_change = pitch_change_scale * (pitch - root_key) + tune;
    double ratio = sample_rate_ratio * std::pow(2.0, pitch_change / 12.0);
    // sample addresses come from untrusted SF2 generators: every index is
    // clamped to the wave data so malformed offsets repeat edge samples
    // instead of reading out of bounds (identical in engine.py)
    auto clampi = [n_data](int64_t i, int64_t hi) {
      return std::min(std::max(i, static_cast<int64_t>(0)), hi);
    };
    if (looping) {
      double loop_len = static_cast<double>(end_loop - start_loop);
      double pos = position;
      for (int t = 0; t < n; ++t) {
        if (pos >= end_loop) pos -= loop_len * std::ceil((pos - end_loop + 1e-12) / loop_len);
        int64_t i1 = static_cast<int64_t>(pos);
        int64_t i2 = i1 + 1;
        if (i2 >= end_loop) i2 -= static_cast<int64_t>(loop_len);
        double frac = pos - static_cast<double>(i1);
        i1 = clampi(i1, n_data - 1);
        i2 = clampi(i2, n_data - 1);
        double x1 = data[i1], x2 = data[i2];
        block[t] = static_cast<float>((x1 + frac * (x2 - x1)) / 32768.0);
        pos += ratio;
      }
      position = pos;
      return true;
    }
    double pos = position;
    const int64_t end_eff = std::min(static_cast<int64_t>(end), n_data);
    if (static_cast<int64_t>(pos) >= end_eff) return false;
    for (int t = 0; t < n; ++t) {
      int64_t i1 = static_cast<int64_t>(pos);
      if (i1 >= end_eff) {
        for (int u = t; u < n; ++u) block[u] = 0.0f;
        position = pos;
        return true;
      }
      int64_t i1c = clampi(i1, n_data - 2);
      double frac = pos - static_cast<double>(i1);
      double x1 = data[i1c], x2 = data[i1c + 1];
      block[t] = static_cast<float>((x1 + frac * (x2 - x1)) / 32768.0);
      pos += ratio;
    }
    position = pos;
    return true;
  }
};

// --- channel (channel.rs) ---------------------------------------------------

struct Channel {
  bool is_percussion = false;
  int bank_number = 0, patch_number = 0;
  int modulation = 0, volume = 0, pan = 0, expression = 0;
  bool hold_pedal = false;
  int reverb_send_ = 0, chorus_send_ = 0;
  int rpn = -1, pitch_bend_range = 0, coarse_tune = 0, fine_tune = 0;
  double pitch_bend_ = 0;

  void reset() {
    bank_number = is_percussion ? 128 : 0;
    patch_number = 0;
    modulation = 0;
    volume = 100 << 7;
    pan = 64 << 7;
    expression = 127 << 7;
    hold_pedal = false;
    reverb_send_ = 40;
    chorus_send_ = 0;
    rpn = -1;
    pitch_bend_range = 2 << 7;
    coarse_tune = 0;
    fine_tune = 8192;
    pitch_bend_ = 0.0;
  }
  void reset_all_controllers() {
    modulation = 0;
    expression = 127 << 7;
    hold_pedal = false;
    rpn = -1;
    pitch_bend_ = 0.0;
  }
  void data_entry_coarse(int v) {
    if (rpn == 0) pitch_bend_range = (pitch_bend_range & 0x7F) | (v << 7);
    else if (rpn == 1) fine_tune = (fine_tune & 0x7F) | (v << 7);
    else if (rpn == 2) coarse_tune = v - 64;
  }
  void data_entry_fine(int v) {
    if (rpn == 0) pitch_bend_range = (pitch_bend_range & 0xFF80) | v;
    else if (rpn == 1) fine_tune = (fine_tune & 0xFF80) | v;
  }
  double get_modulation() const { return (50.0 / 16383.0) * modulation; }
  double get_volume() const { return volume / 16383.0; }
  double get_pan() const { return (100.0 / 16383.0) * pan - 50.0; }
  double get_expression() const { return expression / 16383.0; }
  double get_reverb() const { return reverb_send_ / 127.0; }
  double get_chorus() const { return chorus_send_ / 127.0; }
  double bend_range() const { return (pitch_bend_range >> 7) + 0.01 * (pitch_bend_range & 0x7F); }
  double get_tune() const { return coarse_tune + (1.0 / 8192.0) * (fine_tune - 8192); }
  double get_pitch_bend() const { return bend_range() * pitch_bend_; }
};

// --- voice (voice.rs) -------------------------------------------------------

struct Voice {
  int sample_rate = 0, block_size = 0;
  VolumeEnvelope vol_env;
  ModulationEnvelope mod_env;
  Lfo vib_lfo, mod_lfo;
  Oscillator osc;
  BiQuadFilter filter;
  std::vector<float> block;

  double prev_gain_l = 0, prev_gain_r = 0, cur_gain_l = 0, cur_gain_r = 0;
  double prev_reverb = 0, prev_chorus = 0, cur_reverb = 0, cur_chorus = 0;
  int exclusive_class = 0, channel = 0, key = 0, velocity = 0;
  double note_gain = 0;
  double cutoff = 0, resonance = 0;
  double vib_lfo_to_pitch = 0, mod_lfo_to_pitch = 0, mod_env_to_pitch = 0;
  int mod_lfo_to_cutoff = 0, mod_env_to_cutoff = 0;
  bool dynamic_cutoff = false;
  double mod_lfo_to_volume = 0;
  bool dynamic_volume = false;
  double instrument_pan = 0, instrument_reverb = 0, instrument_chorus = 0;
  double smoothed_cutoff = 0;
  int state = 0;  // 0 playing, 1 release requested, 2 released
  int64_t voice_length = 0;
  int64_t min_voice_length = 0;

  void init(int sr, int bs) {
    sample_rate = sr;
    block_size = bs;
    vol_env.sample_rate = sr;
    mod_env.sample_rate = sr;
    vib_lfo.sample_rate = sr; vib_lfo.block_size = bs;
    mod_lfo.sample_rate = sr; mod_lfo.block_size = bs;
    osc.synth_rate = sr;
    filter.sample_rate = sr;
    block.assign(bs, 0.0f);
    min_voice_length = sr / 500;
  }

  void start(const RegionPair& r, int ch, int k, int vel) {
    exclusive_class = r.i->gs[G_EXCLUSIVE];
    channel = ch;
    key = k;
    velocity = vel;

    if (vel > 0) {
      double sample_atten = 0.4 * (0.1 * r.gs(G_ATTEN));
      double filter_atten = 0.5 * (0.1 * r.gs(G_FILTER_Q));
      double db = 2.0 * linear_to_db(vel / 127.0) - sample_atten - filter_atten;
      note_gain = db_to_linear(db);
    } else {
      note_gain = 0.0;
    }

    cutoff = cents_to_hertz(r.gs(G_FILTER_FC));
    resonance = db_to_linear(0.1 * r.gs(G_FILTER_Q));

    vib_lfo_to_pitch = 0.01 * r.gs(G_VIB_LFO_PITCH);
    mod_lfo_to_pitch = 0.01 * r.gs(G_MOD_LFO_PITCH);
    mod_env_to_pitch = 0.01 * r.gs(G_MOD_ENV_PITCH);
    mod_lfo_to_cutoff = r.gs(G_MOD_LFO_FC);
    mod_env_to_cutoff = r.gs(G_MOD_ENV_FC);
    dynamic_cutoff = mod_lfo_to_cutoff != 0 || mod_env_to_cutoff != 0;
    mod_lfo_to_volume = 0.1 * r.gs(G_MOD_LFO_VOL);
    dynamic_volume = mod_lfo_to_volume > 0.05;
    instrument_pan = clampd(0.1 * r.gs(G_PAN), -50.0, 50.0);
    instrument_reverb = 0.01 * (0.1 * r.gs(G_REVERB));
    instrument_chorus = 0.01 * (0.1 * r.gs(G_CHORUS));

    vol_env.start(
        timecents_to_seconds(r.gs(G_DELAY_VOL_ENV)),
        timecents_to_seconds(r.gs(G_ATTACK_VOL_ENV)),
        timecents_to_seconds(r.gs(G_HOLD_VOL_ENV)) * keynum_factor(r.gs(G_KEY_VOL_HOLD), k),
        timecents_to_seconds(r.gs(G_DECAY_VOL_ENV)) * keynum_factor(r.gs(G_KEY_VOL_DECAY), k),
        db_to_linear(-(0.1 * r.gs(G_SUSTAIN_VOL_ENV))),
        std::max(timecents_to_seconds(r.gs(G_RELEASE_VOL_ENV)), 0.01));
    mod_env.start(
        timecents_to_seconds(r.gs(G_DELAY_MOD_ENV)),
        timecents_to_seconds(r.gs(G_ATTACK_MOD_ENV)) * ((145 - vel) / 144.0),
        timecents_to_seconds(r.gs(G_HOLD_MOD_ENV)) * keynum_factor(r.gs(G_KEY_MOD_HOLD), k),
        timecents_to_seconds(r.gs(G_DECAY_MOD_ENV)) * keynum_factor(r.gs(G_KEY_MOD_DECAY), k),
        1.0 - (0.1 * r.gs(G_SUSTAIN_MOD_ENV)) / 100.0,
        timecents_to_seconds(r.gs(G_RELEASE_MOD_ENV)));
    vib_lfo.start(timecents_to_seconds(r.gs(G_DELAY_VIB_LFO)),
                  cents_to_hertz(r.gs(G_FREQ_VIB_LFO)));
    mod_lfo.start(timecents_to_seconds(r.gs(G_DELAY_MOD_LFO)),
                  cents_to_hertz(r.gs(G_FREQ_MOD_LFO)));
    osc.start(r.i->sample_modes(), r.i->sample_rate, r.i->start(), r.i->end(), r.i->start_loop(),
              r.i->end_loop(), r.i->root_key(), r.gs(G_COARSE_TUNE),
              r.gs(G_FINE_TUNE) + r.i->pitch_correction, r.gs(G_SCALE_TUNING));
    filter.clear();
    filter.set_low_pass(cutoff, resonance);
    smoothed_cutoff = cutoff;

    state = 0;
    voice_length = 0;
    prev_gain_l = prev_gain_r = cur_gain_l = cur_gain_r = 0.0;
    prev_reverb = prev_chorus = cur_reverb = cur_chorus = 0.0;
  }

  void end() {
    if (state == 0) state = 1;
  }
  void kill() { note_gain = 0.0; }

  bool process(const int16_t* data, int64_t n_data, const std::vector<Channel>& channels) {
    if (note_gain < NON_AUDIBLE) return false;
    const Channel& ch = channels[channel];
    if (voice_length >= min_voice_length && state == 1 && !ch.hold_pedal) {
      vol_env.release();
      mod_env.release();
      state = 2;
    }

    if (!vol_env.process(block_size)) return false;
    mod_env.process(block_size);
    vib_lfo.process();
    mod_lfo.process();

    double vib_pitch = (0.01 * ch.get_modulation() + vib_lfo_to_pitch) * vib_lfo.value;
    double mod_pitch = mod_lfo_to_pitch * mod_lfo.value + mod_env_to_pitch * mod_env.value;
    double pitch = key + vib_pitch + mod_pitch + ch.get_tune() + ch.get_pitch_bend();
    if (!osc.process(data, n_data, block.data(), block_size, pitch)) return false;

    if (dynamic_cutoff) {
      double cents = mod_lfo_to_cutoff * mod_lfo.value + mod_env_to_cutoff * mod_env.value;
      double new_cutoff = cents_to_factor(cents) * cutoff;
      smoothed_cutoff = clampd(new_cutoff, 0.5 * smoothed_cutoff, 2.0 * smoothed_cutoff);
      filter.set_low_pass(smoothed_cutoff, resonance);
    }
    filter.process(block.data(), block_size);

    prev_gain_l = cur_gain_l;
    prev_gain_r = cur_gain_r;
    prev_reverb = cur_reverb;
    prev_chorus = cur_chorus;

    double ve = ch.get_volume() * ch.get_expression();
    double channel_gain = ve * ve;
    double mix = note_gain * channel_gain * vol_env.value;
    if (dynamic_volume) mix *= db_to_linear(mod_lfo_to_volume * mod_lfo.value);

    double angle = (PI / 200.0) * (ch.get_pan() + instrument_pan + 50.0);
    if (angle <= 0.0) { cur_gain_l = mix; cur_gain_r = 0.0; }
    else if (angle >= HALF_PI) { cur_gain_l = 0.0; cur_gain_r = mix; }
    else { cur_gain_l = mix * std::cos(angle); cur_gain_r = mix * std::sin(angle); }

    cur_reverb = clampd(ch.get_reverb() + instrument_reverb, 0.0, 1.0);
    cur_chorus = clampd(ch.get_chorus() + instrument_chorus, 0.0, 1.0);

    if (voice_length == 0) {
      prev_gain_l = cur_gain_l;
      prev_gain_r = cur_gain_r;
      prev_reverb = cur_reverb;
      prev_chorus = cur_chorus;
    }
    voice_length += block_size;
    return true;
  }

  double priority() const { return note_gain < NON_AUDIBLE ? 0.0 : vol_env.priority; }
};

// --- effects ----------------------------------------------------------------

struct CombFilter {
  std::vector<float> buffer;
  size_t index = 0;
  float filter_store = 0;

  void mute() { std::fill(buffer.begin(), buffer.end(), 0.0f); filter_store = 0; }
  void process(const float* in, float* out, int n, float feedback, float damp1, float damp2) {
    size_t size = buffer.size();
    int bi = 0;
    while (bi < n) {
      if (index == size) index = 0;
      int rem = static_cast<int>(std::min<size_t>(size - index, n - bi));
      for (int t = 0; t < rem; ++t) {
        float output = buffer[index + t];
        if (std::fabs(output) < 1.0e-6f) output = 0.0f;
        filter_store = output * damp2 + filter_store * damp1;
        if (std::fabs(filter_store) < 1.0e-6f) filter_store = 0.0f;
        buffer[index + t] = in[bi + t] + filter_store * feedback;
        out[bi + t] += output;
      }
      index += rem;
      bi += rem;
    }
  }
};

struct AllPassFilter {
  std::vector<float> buffer;
  size_t index = 0;
  static constexpr float FEEDBACK = 0.5f;

  void mute() { std::fill(buffer.begin(), buffer.end(), 0.0f); }
  void process(float* block, int n) {
    size_t size = buffer.size();
    int bi = 0;
    while (bi < n) {
      if (index == size) index = 0;
      int rem = static_cast<int>(std::min<size_t>(size - index, n - bi));
      for (int t = 0; t < rem; ++t) {
        float input = block[bi + t];
        float bufout = buffer[index + t];
        if (std::fabs(bufout) < 1.0e-6f) bufout = 0.0f;
        block[bi + t] = bufout - input;
        buffer[index + t] = input + bufout * FEEDBACK;
      }
      index += rem;
      bi += rem;
    }
  }
};

struct Reverb {
  static constexpr float FIXED_GAIN = 0.015f;
  CombFilter cf_l[8], cf_r[8];
  AllPassFilter ap_l[4], ap_r[4];
  float feedback, damp1, damp2, gain = FIXED_GAIN;

  void init(int sr) {
    static const int comb[8] = {1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617};
    static const int apf[4] = {556, 441, 341, 225};
    auto scale = [sr](int t) {
      return static_cast<size_t>(std::llround(static_cast<double>(sr) / 44100.0 * t));
    };
    for (int i = 0; i < 8; ++i) {
      cf_l[i].buffer.assign(scale(comb[i]), 0.0f);
      cf_r[i].buffer.assign(scale(comb[i] + 23), 0.0f);
    }
    for (int i = 0; i < 4; ++i) {
      ap_l[i].buffer.assign(scale(apf[i]), 0.0f);
      ap_r[i].buffer.assign(scale(apf[i] + 23), 0.0f);
    }
    feedback = 0.5f * 0.28f + 0.7f;
    damp1 = 0.5f * 0.4f;
    damp2 = 1.0f - damp1;
  }
  void mute() {
    for (auto& f : cf_l) f.mute();
    for (auto& f : cf_r) f.mute();
    for (auto& f : ap_l) f.mute();
    for (auto& f : ap_r) f.mute();
  }
  void process(const float* in, float* out_l, float* out_r, int n) {
    std::fill(out_l, out_l + n, 0.0f);
    std::fill(out_r, out_r + n, 0.0f);
    for (auto& f : cf_l) f.process(in, out_l, n, feedback, damp1, damp2);
    for (auto& f : ap_l) f.process(out_l, n);
    for (auto& f : cf_r) f.process(in, out_r, n, feedback, damp1, damp2);
    for (auto& f : ap_r) f.process(out_r, n);
    // with default wet1=1, wet2=0 the reference skips the cross-mix; so do we
  }
};

struct ChorusChannel {
  std::vector<float> buffer;
  size_t buffer_index = 0, table_index = 0;

  void process(const std::vector<float>& table, const float* in, float* out, int n) {
    size_t buf_len = buffer.size();
    size_t table_len = table.size();
    for (int t = 0; t < n; ++t) {
      double position = static_cast<double>(buffer_index) - table[table_index];
      if (position < 0.0) position += static_cast<double>(buf_len);
      size_t i1 = static_cast<size_t>(position);
      size_t i2 = i1 + 1;
      if (i2 == buf_len) i2 = 0;
      double x1 = buffer[i1], x2 = buffer[i2];
      double a = position - static_cast<double>(i1);
      out[t] = static_cast<float>(x1 + a * (x2 - x1));
      buffer[buffer_index] = in[t];
      if (++buffer_index == buf_len) buffer_index = 0;
      if (++table_index == table_len) table_index = 0;
    }
  }
};

struct Chorus {
  std::vector<float> delay_table;
  ChorusChannel left, right;

  void init(int sr, double delay, double depth, double frequency) {
    size_t buf_len = static_cast<size_t>(sr * (delay + depth)) + 2;
    left.buffer.assign(buf_len, 0.0f);
    right.buffer.assign(buf_len, 0.0f);
    size_t table_len = static_cast<size_t>(std::llround(sr / frequency));
    delay_table.resize(table_len);
    for (size_t t = 0; t < table_len; ++t) {
      double phase = 2.0 * PI * static_cast<double>(t) / static_cast<double>(table_len);
      delay_table[t] = static_cast<float>(sr * (delay + depth * std::sin(phase)));
    }
    left.table_index = 0;
    right.table_index = table_len / 4;
  }
  void mute() {
    std::fill(left.buffer.begin(), left.buffer.end(), 0.0f);
    std::fill(right.buffer.begin(), right.buffer.end(), 0.0f);
  }
  void process(const float* in_l, const float* in_r, float* out_l, float* out_r, int n) {
    left.process(delay_table, in_l, out_l, n);
    right.process(delay_table, in_r, out_r, n);
  }
};

// --- synthesizer --------------------------------------------------------------

struct Preset {
  int32_t preset_id;
  int32_t region_start, region_count;
};

struct Engine {
  std::vector<int16_t> wave;
  std::vector<InstRegion> inst_regions;
  std::vector<std::pair<int32_t, int32_t>> instruments;  // region range
  std::vector<PresetRegion> preset_regions;
  std::vector<Preset> presets;
  int default_preset = 0;

  int sample_rate, block_size, max_polyphony;
  bool effects;
  std::vector<Channel> channels;
  std::vector<Voice> voices;
  int active_voice_count = 0;

  std::vector<float> block_left, block_right;
  int block_read;
  float master_volume = 0.5f;
  Reverb reverb;
  Chorus chorus;
  std::vector<float> ch_in_l, ch_in_r, rv_in, fx_out_l, fx_out_r;

  void init(int sr, int bs, int poly, bool fx) {
    sample_rate = sr;
    block_size = bs;
    max_polyphony = poly;
    effects = fx;
    channels.resize(16);
    for (int i = 0; i < 16; ++i) {
      channels[i].is_percussion = i == 9;
      channels[i].reset();
    }
    voices.resize(poly);
    for (auto& v : voices) v.init(sr, bs);
    block_left.assign(bs, 0.0f);
    block_right.assign(bs, 0.0f);
    block_read = bs;
    if (fx) {
      reverb.init(sr);
      chorus.init(sr, 0.002, 0.0019, 0.4);
      ch_in_l.assign(bs, 0.0f);
      ch_in_r.assign(bs, 0.0f);
      rv_in.assign(bs, 0.0f);
      fx_out_l.assign(bs, 0.0f);
      fx_out_r.assign(bs, 0.0f);
    }
    // default preset = minimum id
    int32_t min_id = INT32_MAX;
    for (size_t i = 0; i < presets.size(); ++i) {
      if (presets[i].preset_id < min_id) {
        min_id = presets[i].preset_id;
        default_preset = static_cast<int>(i);
      }
    }
  }

  const Preset* lookup_preset(int bank, int patch) {
    if (presets.empty()) return nullptr;
    // LAST duplicate (bank, patch) wins, matching the Python reference's
    // dict build (sf2.py preset_lookup) and rustysynth's HashMap inserts
    int32_t id = (bank << 16) | patch;
    const Preset* found = nullptr;
    for (const auto& p : presets)
      if (p.preset_id == id) found = &p;
    if (found) return found;
    int32_t gm = bank < 128 ? patch : (128 << 16);
    for (const auto& p : presets)
      if (p.preset_id == gm) found = &p;
    if (found) return found;
    return &presets[default_preset];
  }

  Voice* request_voice(const InstRegion& region, int channel) {
    int excl = region.gs[G_EXCLUSIVE];
    if (excl != 0) {
      for (int i = 0; i < active_voice_count; ++i) {
        if (voices[i].exclusive_class == excl && voices[i].channel == channel) return &voices[i];
      }
    }
    if (active_voice_count < static_cast<int>(voices.size())) return &voices[active_voice_count++];
    int candidate = 0;
    double lowest = 1e300;
    for (int i = 0; i < active_voice_count; ++i) {
      double p = voices[i].priority();
      if (p < lowest) { lowest = p; candidate = i; }
      else if (p == lowest && voices[i].voice_length > voices[candidate].voice_length) candidate = i;
    }
    return &voices[candidate];
  }

  void note_on(int channel, int key, int velocity) {
    if (velocity == 0) { note_off(channel, key); return; }
    if (channel < 0 || channel >= 16) return;
    const Channel& ch = channels[channel];
    const Preset* preset = lookup_preset(ch.bank_number, ch.patch_number);
    if (!preset) return;
    for (int pr = 0; pr < preset->region_count; ++pr) {
      const PresetRegion& preg = preset_regions[preset->region_start + pr];
      if (!preg.contains(key, velocity)) continue;
      auto [rstart, rcount] = instruments[preg.instrument];
      for (int ir = 0; ir < rcount; ++ir) {
        const InstRegion& ireg = inst_regions[rstart + ir];
        if (!ireg.contains(key, velocity)) continue;
        RegionPair pair{&preg, &ireg};
        Voice* v = request_voice(ireg, channel);
        v->start(pair, channel, key, velocity);
      }
    }
  }

  void note_off(int channel, int key) {
    for (int i = 0; i < active_voice_count; ++i)
      if (voices[i].channel == channel && voices[i].key == key) voices[i].end();
  }
  void note_off_all(bool immediate) {
    if (immediate) active_voice_count = 0;
    else
      for (int i = 0; i < active_voice_count; ++i) voices[i].end();
  }
  void note_off_all_channel(int channel, bool immediate) {
    for (int i = 0; i < active_voice_count; ++i) {
      if (voices[i].channel != channel) continue;
      if (immediate) voices[i].kill();
      else voices[i].end();
    }
  }

  void process_midi(int channel, int command, int d1, int d2) {
    if (channel < 0 || channel >= 16) return;
    Channel& ch = channels[channel];
    switch (command) {
      case 0x80: note_off(channel, d1); break;
      case 0x90: note_on(channel, d1, d2); break;
      case 0xB0:
        switch (d1) {
          case 0x00: ch.bank_number = d2 + (ch.is_percussion ? 128 : 0); break;
          case 0x01: ch.modulation = (ch.modulation & 0x7F) | (d2 << 7); break;
          case 0x21: ch.modulation = (ch.modulation & 0xFF80) | d2; break;
          case 0x06: ch.data_entry_coarse(d2); break;
          case 0x26: ch.data_entry_fine(d2); break;
          case 0x07: ch.volume = (ch.volume & 0x7F) | (d2 << 7); break;
          case 0x27: ch.volume = (ch.volume & 0xFF80) | d2; break;
          case 0x0A: ch.pan = (ch.pan & 0x7F) | (d2 << 7); break;
          case 0x2A: ch.pan = (ch.pan & 0xFF80) | d2; break;
          case 0x0B: ch.expression = (ch.expression & 0x7F) | (d2 << 7); break;
          case 0x2B: ch.expression = (ch.expression & 0xFF80) | d2; break;
          case 0x40: ch.hold_pedal = d2 >= 64; break;
          case 0x5B: ch.reverb_send_ = d2; break;
          case 0x5D: ch.chorus_send_ = d2; break;
          case 0x65: ch.rpn = (ch.rpn & 0x7F) | (d2 << 7); break;
          case 0x64: ch.rpn = (ch.rpn & 0xFF80) | d2; break;
          case 0x78: note_off_all_channel(channel, true); break;
          case 0x79: ch.reset_all_controllers(); break;
          case 0x7B: note_off_all_channel(channel, false); break;
          default: break;
        }
        break;
      case 0xC0: ch.patch_number = d1; break;
      case 0xE0: ch.pitch_bend_ = (1.0 / 8192.0) * ((d1 | (d2 << 7)) - 8192); break;
      default: break;
    }
  }

  void reset() {
    active_voice_count = 0;
    for (auto& ch : channels) ch.reset();
    if (effects) {
      reverb.mute();
      chorus.mute();
    }
    block_read = block_size;
  }

  static void write_block(float prev, float cur, const float* src, float* dst, int n,
                          float inv_n) {
    if (std::max(prev, cur) < static_cast<float>(NON_AUDIBLE)) return;
    if (std::fabs(cur - prev) < 1.0e-3f) {
      for (int t = 0; t < n; ++t) dst[t] += cur * src[t];
    } else {
      float step = inv_n * (cur - prev);
      float g = prev;
      for (int t = 0; t < n; ++t) {
        dst[t] += g * src[t];
        g += step;
      }
    }
  }

  void render_block() {
    // voices.process with swap-remove
    {
      int i = 0;
      while (i < active_voice_count) {
        if (voices[i].process(wave.data(), static_cast<int64_t>(wave.size()), channels)) ++i;
        else std::swap(voices[i], voices[--active_voice_count]);
      }
    }
    int n = block_size;
    float inv_n = 1.0f / n;
    std::fill(block_left.begin(), block_left.end(), 0.0f);
    std::fill(block_right.begin(), block_right.end(), 0.0f);
    float mv = master_volume;
    for (int i = 0; i < active_voice_count; ++i) {
      Voice& v = voices[i];
      write_block(mv * v.prev_gain_l, mv * v.cur_gain_l, v.block.data(), block_left.data(), n, inv_n);
      write_block(mv * v.prev_gain_r, mv * v.cur_gain_r, v.block.data(), block_right.data(), n, inv_n);
    }
    if (!effects) return;

    std::fill(ch_in_l.begin(), ch_in_l.end(), 0.0f);
    std::fill(ch_in_r.begin(), ch_in_r.end(), 0.0f);
    for (int i = 0; i < active_voice_count; ++i) {
      Voice& v = voices[i];
      write_block(v.prev_chorus * v.prev_gain_l, v.cur_chorus * v.cur_gain_l, v.block.data(),
                  ch_in_l.data(), n, inv_n);
      write_block(v.prev_chorus * v.prev_gain_r, v.cur_chorus * v.cur_gain_r, v.block.data(),
                  ch_in_r.data(), n, inv_n);
    }
    chorus.process(ch_in_l.data(), ch_in_r.data(), fx_out_l.data(), fx_out_r.data(), n);
    for (int t = 0; t < n; ++t) {
      block_left[t] += mv * fx_out_l[t];
      block_right[t] += mv * fx_out_r[t];
    }

    std::fill(rv_in.begin(), rv_in.end(), 0.0f);
    float g = reverb.gain;
    for (int i = 0; i < active_voice_count; ++i) {
      Voice& v = voices[i];
      write_block(g * v.prev_reverb * (v.prev_gain_l + v.prev_gain_r),
                  g * v.cur_reverb * (v.cur_gain_l + v.cur_gain_r), v.block.data(), rv_in.data(),
                  n, inv_n);
    }
    reverb.process(rv_in.data(), fx_out_l.data(), fx_out_r.data(), n);
    for (int t = 0; t < n; ++t) {
      block_left[t] += mv * fx_out_l[t];
      block_right[t] += mv * fx_out_r[t];
    }
  }

  void render(float* left, float* right, int64_t n) {
    int64_t wrote = 0;
    while (wrote < n) {
      if (block_read == block_size) {
        render_block();
        block_read = 0;
      }
      int64_t rem = std::min<int64_t>(block_size - block_read, n - wrote);
      std::memcpy(left + wrote, block_left.data() + block_read, rem * sizeof(float));
      std::memcpy(right + wrote, block_right.data() + block_read, rem * sizeof(float));
      block_read += static_cast<int>(rem);
      wrote += rem;
    }
  }
};

struct Sequencer {
  Engine* engine;
  std::vector<double> times;
  std::vector<int32_t> channel, command, data1, data2;
  size_t msg_index = 0;
  int block_wrote = 0;
  double current_time = 0.0;

  void play() {
    block_wrote = engine->block_size;
    current_time = 0.0;
    msg_index = 0;
    engine->reset();
  }
  void process_events() {
    while (msg_index < times.size() && times[msg_index] <= current_time) {
      engine->process_midi(channel[msg_index], command[msg_index], data1[msg_index],
                           data2[msg_index]);
      ++msg_index;
    }
  }
  void render(float* left, float* right, int64_t n) {
    int64_t wrote = 0;
    int bs = engine->block_size;
    while (wrote < n) {
      if (block_wrote == bs) {
        process_events();
        block_wrote = 0;
        current_time += static_cast<double>(bs) / engine->sample_rate;
      }
      int64_t rem = std::min<int64_t>(bs - block_wrote, n - wrote);
      engine->render(left + wrote, right + wrote, rem);
      block_wrote += static_cast<int>(rem);
      wrote += rem;
    }
  }
};

}  // namespace

extern "C" {

void* pv_engine_create(const int16_t* wave, int64_t n_wave, const int16_t* inst_gs,
                       const int32_t* inst_extra, int64_t n_inst_regions,
                       const int32_t* instruments, int64_t n_instruments,
                       const int16_t* preset_gs, const int32_t* preset_inst,
                       int64_t n_preset_regions, const int32_t* presets, int64_t n_presets,
                       int32_t sample_rate, int32_t block_size, int32_t max_polyphony,
                       int32_t enable_effects) {
  // same validated ranges as SynthesizerSettings (synthesizer_settings.rs
  // semantics; mirrored in engine.py): out-of-range values would otherwise
  // read past blocks (block_size < 2 in the biquad), never advance render
  // (block_size == 0), or scale reverb delay lines to zero length
  // (sample_rate < ~100) and hang. Returns nullptr; the ctypes wrapper
  // raises.
  if (sample_rate < 16000 || sample_rate > 192000) return nullptr;
  if (block_size < 8 || block_size > 1024) return nullptr;
  if (max_polyphony < 8 || max_polyphony > 256) return nullptr;
  auto* e = new Engine();
  e->wave.assign(wave, wave + n_wave);
  e->inst_regions.resize(n_inst_regions);
  for (int64_t i = 0; i < n_inst_regions; ++i) {
    std::memcpy(e->inst_regions[i].gs, inst_gs + i * GEN_COUNT, GEN_COUNT * sizeof(int16_t));
    const int32_t* x = inst_extra + i * 7;
    e->inst_regions[i].sample_start = x[0];
    e->inst_regions[i].sample_end = x[1];
    e->inst_regions[i].sample_start_loop = x[2];
    e->inst_regions[i].sample_end_loop = x[3];
    e->inst_regions[i].sample_rate = x[4];
    e->inst_regions[i].original_pitch = x[5];
    e->inst_regions[i].pitch_correction = x[6];
  }
  e->instruments.resize(n_instruments);
  for (int64_t i = 0; i < n_instruments; ++i)
    e->instruments[i] = {instruments[i * 2], instruments[i * 2 + 1]};
  e->preset_regions.resize(n_preset_regions);
  for (int64_t i = 0; i < n_preset_regions; ++i) {
    std::memcpy(e->preset_regions[i].gs, preset_gs + i * GEN_COUNT, GEN_COUNT * sizeof(int16_t));
    e->preset_regions[i].instrument = preset_inst[i];
  }
  e->presets.resize(n_presets);
  for (int64_t i = 0; i < n_presets; ++i)
    e->presets[i] = {presets[i * 3], presets[i * 3 + 1], presets[i * 3 + 2]};
  e->init(sample_rate, block_size, max_polyphony, enable_effects != 0);
  return e;
}

void pv_engine_destroy(void* h) { delete static_cast<Engine*>(h); }
void pv_engine_reset(void* h) { static_cast<Engine*>(h)->reset(); }
void pv_engine_midi(void* h, int32_t ch, int32_t cmd, int32_t d1, int32_t d2) {
  static_cast<Engine*>(h)->process_midi(ch, cmd, d1, d2);
}
void pv_engine_note_on(void* h, int32_t ch, int32_t key, int32_t vel) {
  static_cast<Engine*>(h)->note_on(ch, key, vel);
}
void pv_engine_note_off(void* h, int32_t ch, int32_t key) {
  static_cast<Engine*>(h)->note_off(ch, key);
}
void pv_engine_render(void* h, float* left, float* right, int64_t n) {
  static_cast<Engine*>(h)->render(left, right, n);
}
int32_t pv_engine_active_voices(void* h, int32_t* keys, float* gl, float* gr, int32_t max) {
  Engine* e = static_cast<Engine*>(h);
  int32_t n = std::min<int32_t>(e->active_voice_count, max);
  for (int32_t i = 0; i < n; ++i) {
    keys[i] = e->voices[i].key;
    gl[i] = static_cast<float>(e->voices[i].cur_gain_l);
    gr[i] = static_cast<float>(e->voices[i].cur_gain_r);
  }
  return n;
}

void* pv_seq_create(void* engine, const double* times, const int32_t* channel,
                    const int32_t* command, const int32_t* data1, const int32_t* data2,
                    int64_t n_msgs) {
  auto* s = new Sequencer();
  s->engine = static_cast<Engine*>(engine);
  s->times.assign(times, times + n_msgs);
  s->channel.assign(channel, channel + n_msgs);
  s->command.assign(command, command + n_msgs);
  s->data1.assign(data1, data1 + n_msgs);
  s->data2.assign(data2, data2 + n_msgs);
  s->play();
  return s;
}
void pv_seq_destroy(void* h) { delete static_cast<Sequencer*>(h); }
void pv_seq_render(void* h, float* left, float* right, int64_t n) {
  static_cast<Sequencer*>(h)->render(left, right, n);
}

// The training capture loop (train.rs:252-351) in one native call: render the
// sequence in `chunk`-sample chunks, downmix, AGC each chunk (the dagc
// recurrence over the stream — identical to AGC'ing the ring tail, since the
// tail IS the new chunk), and every `step_chunks`-th chunk snapshot the
// active voices' (key, (l+r)/2 * agc_gain) labels with previous-snapshot
// emission semantics. The AGC'd mono stream is written to `stream_out`
// (capacity ceil(sample_count/chunk)*chunk); the caller slices the trailing
// n_fft capture windows on the device, so only ~1/32nd of the window bytes
// cross the host->device link. Returns the number of captures.
int64_t pv_train_synthesize(void* seq_handle, int64_t sample_count, int64_t chunk,
                            int32_t step_chunks, float agc_desired_rms, float agc_distortion,
                            float* stream_out, int32_t* snap_keys, float* snap_gains,
                            int32_t* snap_counts, int64_t max_captures, int32_t max_voices) {
  Sequencer* seq = static_cast<Sequencer*>(seq_handle);
  Engine* e = seq->engine;
  std::vector<float> right(chunk);
  double gain = 1.0;
  // previous-snapshot labels (the reference emits the PREVIOUS active set
  // with the current window, train.rs:312-345)
  std::vector<int32_t> prev_keys;
  std::vector<float> prev_gains;
  int64_t captures = 0;
  int64_t written = 0;
  int64_t chunk_count = 0;
  while (written < sample_count && captures < max_captures) {
    ++chunk_count;
    float* left = stream_out + written;
    seq->render(left, right.data(), chunk);
    written += chunk;
    double energy = 0.0;
    for (int64_t t = 0; t < chunk; ++t) {
      left[t] = (left[t] + right[t]) / 2.0f;
      energy += static_cast<double>(left[t]) * left[t];
    }
    bool frozen = energy < 1e-6;
    {
      double k = agc_distortion;
      double inv = 1.0 / (agc_desired_rms);
      if (frozen) {
        for (int64_t t = 0; t < chunk; ++t) left[t] = static_cast<float>(left[t] * gain);
      } else {
        for (int64_t t = 0; t < chunk; ++t) {
          double x = left[t] * gain;
          left[t] = static_cast<float>(x);
          gain *= std::max(1.0 + k * (1.0 - x * x * inv), k);
        }
      }
    }
    if (chunk_count % step_chunks != 0) continue;

    // emit previous snapshot's labels for this capture
    int32_t cnt = static_cast<int32_t>(std::min<size_t>(prev_keys.size(), max_voices));
    snap_counts[captures] = cnt;
    for (int32_t i = 0; i < cnt; ++i) {
      snap_keys[captures * max_voices + i] = prev_keys[i];
      snap_gains[captures * max_voices + i] = prev_gains[i];
    }
    ++captures;

    // take the new snapshot (max gain per key)
    prev_keys.clear();
    prev_gains.clear();
    for (int i = 0; i < e->active_voice_count; ++i) {
      const Voice& v = e->voices[i];
      float vg = static_cast<float>((v.cur_gain_l + v.cur_gain_r) / 2.0 * gain);
      bool found = false;
      for (size_t j = 0; j < prev_keys.size(); ++j) {
        if (prev_keys[j] == v.key) {
          if (vg > prev_gains[j]) prev_gains[j] = vg;
          found = true;
          break;
        }
      }
      if (!found) {
        prev_keys.push_back(v.key);
        prev_gains.push_back(vg);
      }
    }
  }
  return captures;
}

}  // extern "C"
