"""Full-fidelity SoundFont synthesizer engine (block-based).

Port of ``pitchvis_tpu/synth/engine.py``, a copy (NumPy and SciPy only).

Behavioral equivalent of the reference's vendored rustysynth render path
(rustysynth_fork/src/synthesizer.rs, voice.rs, oscillator.rs,
volume_envelope.rs, modulation_envelope.rs, lfo.rs, bi_quad_filter.rs,
reverb.rs, chorus.rs, channel.rs, voice_collection.rs,
midifile_sequencer.rs): 64-sample block rendering with per-block envelope /
LFO updates, per-voice resonant low-pass filtering, stereo pan, gain-ramped
mixing, Freeverb-style reverb and dual-tap chorus sends, MIDI channel state
(controllers, RPN pitch-bend range / tuning), priority-based voice stealing,
and sample-accurate-to-the-block event dispatch.

This NumPy implementation is the semantic reference; the C++ engine in
native/ mirrors it for throughput (the training pipeline's hot loop). Within
a block everything is vectorized: the only sequential recurrences are the
biquad (scipy.signal.lfilter) and the reverb comb damping (also lfilter —
the comb/allpass delay lines are longer than a block, so each block's reads
only touch state older than the block).

Deliberate deviations from the Rust fork:
* the oscillator tracks its position in float64 instead of 24.8 fixed point
  (error < 2^-40 per sample, inaudible, and SIMD/vector friendly) — shared
  by both engines;
* in THIS engine only, denormal flushing inside the comb damping recurrence
  is applied per block rather than per sample (lfilter cannot flush inside
  the recurrence); the C++ mirror flushes per sample exactly like the
  reference, so the two engines' reverb tails may diverge at the 1e-6
  audibility floor the reference uses — within the committed golden's and
  the parity tests' tolerances.
"""

from __future__ import annotations

import math

import numpy as np

from .midi import MidiFile
from .sf2 import (
    HALF_PI,
    NON_AUDIBLE,
    InstrumentRegion,
    RegionPair,
    SoundFont,
    cents_to_multiplying_factor,
    decibels_to_linear,
    key_number_to_multiplying_factor,
    linear_to_decibels,
)

LOG_NON_AUDIBLE = math.log(1.0e-3)


def _exp_cutoff(x: float) -> float:
    """exp() that flushes to zero below the audibility floor
    (soundfont_math.rs:56-62)."""
    return 0.0 if x < LOG_NON_AUDIBLE else math.exp(x)


class SynthesizerSettings:
    """Validated settings (synthesizer_settings.rs:14-58)."""

    def __init__(
        self,
        sample_rate: int,
        block_size: int = 64,
        maximum_polyphony: int = 64,
        enable_reverb_and_chorus: bool = True,
    ):
        if not 16_000 <= sample_rate <= 192_000:
            raise ValueError(f"sample rate out of range: {sample_rate}")
        if not 8 <= block_size <= 1024:
            raise ValueError(f"block size out of range: {block_size}")
        if not 8 <= maximum_polyphony <= 256:
            raise ValueError(f"maximum polyphony out of range: {maximum_polyphony}")
        self.sample_rate = int(sample_rate)
        self.block_size = int(block_size)
        self.maximum_polyphony = int(maximum_polyphony)
        self.enable_reverb_and_chorus = bool(enable_reverb_and_chorus)


# -- per-voice components ------------------------------------------------------

_DELAY, _ATTACK, _HOLD, _DECAY, _RELEASE = 0, 1, 2, 3, 4


class VolumeEnvelope:
    """DAHDSR with exponential decay/release (volume_envelope.rs)."""

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self.value = 0.0
        self.priority = 0.0

    def start(self, delay, attack, hold, decay, sustain, release):
        self.attack_slope = 1.0 / attack
        self.decay_slope = -9.226 / decay
        self.release_slope = -9.226 / release
        self.attack_start_time = delay
        self.hold_start_time = delay + attack
        self.decay_start_time = delay + attack + hold
        self.release_start_time = 0.0
        self.sustain_level = min(max(sustain, 0.0), 1.0)
        self.release_level = 0.0
        self.processed_sample_count = 0
        self.stage = _DELAY
        self.value = 0.0
        self.process(0)

    def release(self):
        self.stage = _RELEASE
        self.release_start_time = self.processed_sample_count / self.sample_rate
        self.release_level = self.value

    def process(self, sample_count: int) -> bool:
        self.processed_sample_count += sample_count
        t = self.processed_sample_count / self.sample_rate
        while self.stage <= _HOLD:
            end = (self.attack_start_time, self.hold_start_time, self.decay_start_time)[self.stage]
            if t < end:
                break
            self.stage += 1
        if self.stage == _DELAY:
            self.value = 0.0
            self.priority = 4.0 + self.value
            return True
        if self.stage == _ATTACK:
            self.value = self.attack_slope * (t - self.attack_start_time)
            self.priority = 3.0 + self.value
            return True
        if self.stage == _HOLD:
            self.value = 1.0
            self.priority = 2.0 + self.value
            return True
        if self.stage == _DECAY:
            self.value = max(
                _exp_cutoff(self.decay_slope * (t - self.decay_start_time)), self.sustain_level
            )
            self.priority = 1.0 + self.value
            return self.value > NON_AUDIBLE
        # release
        self.value = self.release_level * _exp_cutoff(
            self.release_slope * (t - self.release_start_time)
        )
        self.priority = self.value
        return self.value > NON_AUDIBLE


class ModulationEnvelope:
    """DAHDSR with *linear* decay/release (modulation_envelope.rs)."""

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self.value = 0.0

    def start(self, delay, attack, hold, decay, sustain, release):
        self.attack_slope = 1.0 / attack
        self.decay_slope = 1.0 / decay
        self.release_slope = 1.0 / release
        self.attack_start_time = delay
        self.hold_start_time = delay + attack
        self.decay_start_time = delay + attack + hold
        self.decay_end_time = self.decay_start_time + decay
        self.release_end_time = release
        self.sustain_level = min(max(sustain, 0.0), 1.0)
        self.release_level = 0.0
        self.processed_sample_count = 0
        self.stage = _DELAY
        self.value = 0.0
        self.process(0)

    def release(self):
        self.stage = _RELEASE
        self.release_end_time += self.processed_sample_count / self.sample_rate
        self.release_level = self.value

    def process(self, sample_count: int) -> bool:
        self.processed_sample_count += sample_count
        t = self.processed_sample_count / self.sample_rate
        while self.stage <= _HOLD:
            end = (self.attack_start_time, self.hold_start_time, self.decay_start_time)[self.stage]
            if t < end:
                break
            self.stage += 1
        if self.stage == _DELAY:
            self.value = 0.0
            return True
        if self.stage == _ATTACK:
            self.value = self.attack_slope * (t - self.attack_start_time)
            return True
        if self.stage == _HOLD:
            self.value = 1.0
            return True
        if self.stage == _DECAY:
            self.value = max(self.decay_slope * (self.decay_end_time - t), self.sustain_level)
            return self.value > NON_AUDIBLE
        self.value = max(
            self.release_level * self.release_slope * (self.release_end_time - t), 0.0
        )
        return self.value > NON_AUDIBLE


class Lfo:
    """Delayed triangle LFO updated once per block (lfo.rs)."""

    def __init__(self, sample_rate: int, block_size: int):
        self.sample_rate = sample_rate
        self.block_size = block_size
        self.active = False
        self.value = 0.0

    def start(self, delay: float, frequency: float):
        if frequency > 1.0e-3:
            self.active = True
            self.delay = delay
            self.period = 1.0 / frequency
            self.processed_sample_count = 0
            self.value = 0.0
        else:
            self.active = False
            self.value = 0.0

    def process(self):
        if not self.active:
            return
        self.processed_sample_count += self.block_size
        t = self.processed_sample_count / self.sample_rate
        if t < self.delay:
            self.value = 0.0
            return
        phase = ((t - self.delay) % self.period) / self.period
        if phase < 0.25:
            self.value = 4.0 * phase
        elif phase < 0.75:
            self.value = 4.0 * (0.5 - phase)
        else:
            self.value = 4.0 * (phase - 1.0)


class BiQuadFilter:
    """Resonant low-pass (bi_quad_filter.rs). The resonance-to-Q relation
    reproduces the reference's peak-height approximation."""

    RESONANCE_PEAK_OFFSET = 1.0 - 1.0 / math.sqrt(2.0)

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self.active = False
        self.a = np.zeros(5, np.float64)  # a0 a1 a2 a3 a4 (normalized b0 b1 b2 a1 a2)
        self.x1 = self.x2 = self.y1 = self.y2 = 0.0

    def clear_buffer(self):
        self.x1 = self.x2 = self.y1 = self.y2 = 0.0

    def set_low_pass_filter(self, cutoff: float, resonance: float):
        if cutoff < 0.499 * self.sample_rate:
            self.active = True
            q = resonance - self.RESONANCE_PEAK_OFFSET / (1.0 + 6.0 * (resonance - 1.0))
            w = 2.0 * math.pi * cutoff / self.sample_rate
            cosw = math.cos(w)
            alpha = math.sin(w) / (2.0 * q)
            b0 = (1.0 - cosw) / 2.0
            b1 = 1.0 - cosw
            b2 = (1.0 - cosw) / 2.0
            a0 = 1.0 + alpha
            a1 = -2.0 * cosw
            a2 = 1.0 - alpha
            self.a = np.array([b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0])
        else:
            self.active = False

    def process(self, block: np.ndarray):
        if self.active:
            from scipy.signal import lfilter

            b = self.a[:3]
            a = np.array([1.0, self.a[3], self.a[4]])
            # direct form I state -> lfilter's direct form II transposed zi
            zi = np.array(
                [
                    self.a[1] * self.x1 + self.a[2] * self.x2 - self.a[3] * self.y1 - self.a[4] * self.y2,
                    self.a[2] * self.x1 - self.a[4] * self.y1,
                ]
            )
            out, _ = lfilter(b, a, block.astype(np.float64), zi=zi)
            self.x2, self.x1 = float(block[-2]), float(block[-1])
            self.y2, self.y1 = float(out[-2]), float(out[-1])
            block[:] = out.astype(np.float32)
        else:
            self.x2, self.x1 = float(block[-2]), float(block[-1])
            self.y2, self.y1 = self.x2, self.x1


class Oscillator:
    """Sample playback with loop handling and pitch modulation
    (oscillator.rs). Position tracked in float64 (see module docstring).
    Mirrors the fork's loop-mode quirk: any non-zero sampleModes value loops
    continuously and note-off does not exit the loop (loop_mode.rs:9-11)."""

    def __init__(self, sample_rate: int):
        self.synthesizer_sample_rate = sample_rate

    def start(self, loop_mode, sample_rate, start, end, start_loop, end_loop, root_key,
              coarse_tune, fine_tune, scale_tuning):
        self.loop_mode = loop_mode
        self.start_ = start
        self.end = end
        self.start_loop = start_loop
        self.end_loop = end_loop
        self.root_key = root_key
        self.tune = coarse_tune + 0.01 * fine_tune
        self.pitch_change_scale = 0.01 * scale_tuning
        self.sample_rate_ratio = sample_rate / self.synthesizer_sample_rate
        self.looping = loop_mode != 0
        # malformed/adversarial SF2 guard: a degenerate loop (length < 1,
        # possible via loop-offset generators) would divide by zero below —
        # fall back to one-shot playback. Mirrored in synth_engine.cpp.
        if self.looping and end_loop - start_loop < 1:
            self.looping = False
        self.position = float(start)

    def release(self):
        # the fork's LoopMode constants are all zero, so LOOP_UNTIL_NOTE_OFF
        # never actually stops looping; mirror that by doing nothing
        pass

    def process(self, data: np.ndarray, block: np.ndarray, pitch: float) -> bool:
        if len(data) < 2:
            # empty/degenerate wave data (adversarial SF2 whose smpl chunk
            # is shorter than its sample headers claim): np.clip(i, 0, -1)
            # would return -1 and either wrap to data[-1] or IndexError on
            # an empty array — emit silence and kill the voice instead.
            # Mirrored in synth_engine.cpp.
            block[:] = 0.0
            return False
        pitch_change = self.pitch_change_scale * (pitch - self.root_key) + self.tune
        pitch_ratio = self.sample_rate_ratio * 2.0 ** (pitch_change / 12.0)
        n = len(block)
        pos = self.position + pitch_ratio * np.arange(n, dtype=np.float64)
        # sample addresses come from untrusted SF2 generators: every index is
        # clamped to the wave data so malformed offsets repeat edge samples
        # instead of reading out of bounds (identical in synth_engine.cpp)
        n_data = len(data)
        if self.looping:
            loop_len = float(self.end_loop - self.start_loop)
            wrapped = np.where(
                pos >= self.end_loop, self.start_loop + np.mod(pos - self.end_loop, loop_len), pos
            )
            i1 = wrapped.astype(np.int64)
            i2 = i1 + 1
            i2 = np.where(i2 >= self.end_loop, i2 - int(loop_len), i2)
            frac = wrapped - i1
            i1 = np.clip(i1, 0, n_data - 1)
            i2 = np.clip(i2, 0, n_data - 1)
            x1 = data[i1].astype(np.float64)
            x2 = data[i2].astype(np.float64)
            block[:] = ((x1 + frac * (x2 - x1)) / 32768.0).astype(np.float32)
            self.position = float(wrapped[-1] + pitch_ratio)
            return True
        # no-loop
        i1 = pos.astype(np.int64)
        alive = i1 < min(self.end, n_data)
        if not alive[0]:
            return False
        i1c = np.clip(i1, 0, n_data - 2)
        frac = pos - i1
        x1 = data[i1c].astype(np.float64)
        x2 = data[i1c + 1].astype(np.float64)
        out = (x1 + frac * (x2 - x1)) / 32768.0
        block[:] = np.where(alive, out, 0.0).astype(np.float32)
        if alive[-1]:
            self.position = float(pos[-1] + pitch_ratio)
        else:
            self.position = float(pos[int(np.argmin(alive))])
        return True


_PLAYING, _RELEASE_REQUESTED, _RELEASED = 0, 1, 2


class Voice:
    """One sounding note (voice.rs). `key` and `current_mix_gain_*` are the
    public introspection surface the training labeler reads
    (voice.rs:38-39, train.rs:318-338)."""

    def __init__(self, settings: SynthesizerSettings):
        self.sample_rate = settings.sample_rate
        self.block_size = settings.block_size
        self.vol_env = VolumeEnvelope(settings.sample_rate)
        self.mod_env = ModulationEnvelope(settings.sample_rate)
        self.vib_lfo = Lfo(settings.sample_rate, settings.block_size)
        self.mod_lfo = Lfo(settings.sample_rate, settings.block_size)
        self.oscillator = Oscillator(settings.sample_rate)
        self.filter = BiQuadFilter(settings.sample_rate)
        self.block = np.zeros(settings.block_size, np.float32)
        self.previous_mix_gain_left = self.previous_mix_gain_right = 0.0
        self.current_mix_gain_left = self.current_mix_gain_right = 0.0
        self.previous_reverb_send = self.previous_chorus_send = 0.0
        self.current_reverb_send = self.current_chorus_send = 0.0
        self.exclusive_class = 0
        self.channel = 0
        self.key = 0
        self.velocity = 0
        self.note_gain = 0.0
        self.voice_state = _PLAYING
        self.voice_length = 0
        self.min_voice_length = settings.sample_rate // 500

    def start(self, region: RegionPair, channel: int, key: int, velocity: int):
        self.exclusive_class = region.instrument.exclusive_class
        self.channel = channel
        self.key = key
        self.velocity = velocity

        if velocity > 0:
            # 40% attenuation scale after Polyphone (voice.rs:138-148)
            sample_attenuation = 0.4 * region.initial_attenuation
            filter_attenuation = 0.5 * region.initial_filter_q
            decibels = (
                2.0 * linear_to_decibels(velocity / 127.0) - sample_attenuation - filter_attenuation
            )
            self.note_gain = decibels_to_linear(decibels)
        else:
            self.note_gain = 0.0

        self.cutoff = region.initial_filter_cutoff_frequency
        self.resonance = decibels_to_linear(region.initial_filter_q)

        self.vib_lfo_to_pitch = 0.01 * region.vib_lfo_to_pitch
        self.mod_lfo_to_pitch = 0.01 * region.mod_lfo_to_pitch
        self.mod_env_to_pitch = 0.01 * region.mod_env_to_pitch

        self.mod_lfo_to_cutoff = region.mod_lfo_to_filter_cutoff
        self.mod_env_to_cutoff = region.mod_env_to_filter_cutoff
        self.dynamic_cutoff = self.mod_lfo_to_cutoff != 0 or self.mod_env_to_cutoff != 0

        self.mod_lfo_to_volume = region.mod_lfo_to_volume
        self.dynamic_volume = self.mod_lfo_to_volume > 0.05

        self.instrument_pan = min(max(region.pan, -50.0), 50.0)
        self.instrument_reverb = 0.01 * region.reverb_effects_send
        self.instrument_chorus = 0.01 * region.chorus_effects_send

        # region_ex.rs start_* conversions
        self.vol_env.start(
            region.delay_vol_env,
            region.attack_vol_env,
            region.hold_vol_env
            * key_number_to_multiplying_factor(region.keynum_to_vol_env_hold, key),
            region.decay_vol_env
            * key_number_to_multiplying_factor(region.keynum_to_vol_env_decay, key),
            decibels_to_linear(-region.sustain_vol_env),
            max(region.release_vol_env, 0.01),
        )
        self.mod_env.start(
            region.delay_mod_env,
            region.attack_mod_env * ((145 - velocity) / 144.0),
            region.hold_mod_env
            * key_number_to_multiplying_factor(region.keynum_to_mod_env_hold, key),
            region.decay_mod_env
            * key_number_to_multiplying_factor(region.keynum_to_mod_env_decay, key),
            1.0 - region.sustain_mod_env / 100.0,
            region.release_mod_env,
        )
        self.vib_lfo.start(region.delay_vib_lfo, region.frequency_vib_lfo)
        self.mod_lfo.start(region.delay_mod_lfo, region.frequency_mod_lfo)
        ir = region.instrument
        self.oscillator.start(
            ir.sample_modes,
            ir.sample.sample_rate,
            ir.sample_start,
            ir.sample_end,
            ir.sample_start_loop,
            ir.sample_end_loop,
            ir.root_key,
            region.coarse_tune,
            region.fine_tune,
            region.scale_tuning,
        )
        self.filter.clear_buffer()
        self.filter.set_low_pass_filter(self.cutoff, self.resonance)
        self.smoothed_cutoff = self.cutoff

        self.voice_state = _PLAYING
        self.voice_length = 0
        self.previous_mix_gain_left = self.previous_mix_gain_right = 0.0
        self.current_mix_gain_left = self.current_mix_gain_right = 0.0
        self.previous_reverb_send = self.previous_chorus_send = 0.0
        self.current_reverb_send = self.current_chorus_send = 0.0

    def end(self):
        if self.voice_state == _PLAYING:
            self.voice_state = _RELEASE_REQUESTED

    def kill(self):
        self.note_gain = 0.0

    def process(self, data: np.ndarray, channels: list["Channel"]) -> bool:
        if self.note_gain < NON_AUDIBLE:
            return False
        channel_info = channels[self.channel]
        self._release_if_necessary(channel_info)

        if not self.vol_env.process(self.block_size):
            return False
        self.mod_env.process(self.block_size)
        self.vib_lfo.process()
        self.mod_lfo.process()

        vib_pitch_change = (
            0.01 * channel_info.modulation + self.vib_lfo_to_pitch
        ) * self.vib_lfo.value
        mod_pitch_change = (
            self.mod_lfo_to_pitch * self.mod_lfo.value + self.mod_env_to_pitch * self.mod_env.value
        )
        pitch = self.key + vib_pitch_change + mod_pitch_change + channel_info.tune + channel_info.pitch_bend
        if not self.oscillator.process(data, self.block, pitch):
            return False

        if self.dynamic_cutoff:
            cents = (
                self.mod_lfo_to_cutoff * self.mod_lfo.value
                + self.mod_env_to_cutoff * self.mod_env.value
            )
            new_cutoff = cents_to_multiplying_factor(cents) * self.cutoff
            # limit change to [x0.5, x2] per block to reduce pop noise
            self.smoothed_cutoff = min(
                max(new_cutoff, 0.5 * self.smoothed_cutoff), 2.0 * self.smoothed_cutoff
            )
            self.filter.set_low_pass_filter(self.smoothed_cutoff, self.resonance)
        self.filter.process(self.block)

        self.previous_mix_gain_left = self.current_mix_gain_left
        self.previous_mix_gain_right = self.current_mix_gain_right
        self.previous_reverb_send = self.current_reverb_send
        self.previous_chorus_send = self.current_chorus_send

        # GM: (volume * expression) squared
        ve = channel_info.volume * channel_info.expression
        channel_gain = ve * ve

        mix_gain = self.note_gain * channel_gain * self.vol_env.value
        if self.dynamic_volume:
            mix_gain *= decibels_to_linear(self.mod_lfo_to_volume * self.mod_lfo.value)

        angle = (math.pi / 200.0) * (channel_info.pan + self.instrument_pan + 50.0)
        if angle <= 0.0:
            self.current_mix_gain_left, self.current_mix_gain_right = mix_gain, 0.0
        elif angle >= HALF_PI:
            self.current_mix_gain_left, self.current_mix_gain_right = 0.0, mix_gain
        else:
            self.current_mix_gain_left = mix_gain * math.cos(angle)
            self.current_mix_gain_right = mix_gain * math.sin(angle)

        self.current_reverb_send = min(
            max(channel_info.reverb_send + self.instrument_reverb, 0.0), 1.0
        )
        self.current_chorus_send = min(
            max(channel_info.chorus_send + self.instrument_chorus, 0.0), 1.0
        )

        if self.voice_length == 0:
            self.previous_mix_gain_left = self.current_mix_gain_left
            self.previous_mix_gain_right = self.current_mix_gain_right
            self.previous_reverb_send = self.current_reverb_send
            self.previous_chorus_send = self.current_chorus_send

        self.voice_length += self.block_size
        return True

    def _release_if_necessary(self, channel_info: "Channel"):
        if self.voice_length < self.min_voice_length:
            return
        if self.voice_state == _RELEASE_REQUESTED and not channel_info.hold_pedal:
            self.vol_env.release()
            self.mod_env.release()
            self.oscillator.release()
            self.voice_state = _RELEASED

    @property
    def priority(self) -> float:
        return 0.0 if self.note_gain < NON_AUDIBLE else self.vol_env.priority


class Channel:
    """MIDI channel state (channel.rs): 14-bit controllers, RPN pitch-bend
    range and tuning, hold pedal, effect sends."""

    def __init__(self, is_percussion_channel: bool):
        self.is_percussion_channel = is_percussion_channel
        self.reset()

    def reset(self):
        self.bank_number = 128 if self.is_percussion_channel else 0
        self.patch_number = 0
        self._modulation = 0
        self._volume = 100 << 7
        self._pan = 64 << 7
        self._expression = 127 << 7
        self.hold_pedal = False
        self._reverb_send = 40
        self._chorus_send = 0
        self._rpn = -1
        self._pitch_bend_range = 2 << 7
        self._coarse_tune = 0
        self._fine_tune = 8192
        self._pitch_bend = 0.0

    def reset_all_controllers(self):
        self._modulation = 0
        self._expression = 127 << 7
        self.hold_pedal = False
        self._rpn = -1
        self._pitch_bend = 0.0

    def set_bank(self, value):
        self.bank_number = value + (128 if self.is_percussion_channel else 0)

    def set_patch(self, value):
        self.patch_number = value

    def set_modulation_coarse(self, v):
        self._modulation = (self._modulation & 0x7F) | (v << 7)

    def set_modulation_fine(self, v):
        self._modulation = (self._modulation & 0xFF80) | v

    def set_volume_coarse(self, v):
        self._volume = (self._volume & 0x7F) | (v << 7)

    def set_volume_fine(self, v):
        self._volume = (self._volume & 0xFF80) | v

    def set_pan_coarse(self, v):
        self._pan = (self._pan & 0x7F) | (v << 7)

    def set_pan_fine(self, v):
        self._pan = (self._pan & 0xFF80) | v

    def set_expression_coarse(self, v):
        self._expression = (self._expression & 0x7F) | (v << 7)

    def set_expression_fine(self, v):
        self._expression = (self._expression & 0xFF80) | v

    def set_hold_pedal(self, v):
        self.hold_pedal = v >= 64

    def set_reverb_send(self, v):
        self._reverb_send = v

    def set_chorus_send(self, v):
        self._chorus_send = v

    def set_rpn_coarse(self, v):
        self._rpn = (self._rpn & 0x7F) | (v << 7)

    def set_rpn_fine(self, v):
        self._rpn = (self._rpn & 0xFF80) | v

    def data_entry_coarse(self, v):
        if self._rpn == 0:
            self._pitch_bend_range = (self._pitch_bend_range & 0x7F) | (v << 7)
        elif self._rpn == 1:
            self._fine_tune = (self._fine_tune & 0x7F) | (v << 7)
        elif self._rpn == 2:
            self._coarse_tune = v - 64

    def data_entry_fine(self, v):
        if self._rpn == 0:
            self._pitch_bend_range = (self._pitch_bend_range & 0xFF80) | v
        elif self._rpn == 1:
            self._fine_tune = (self._fine_tune & 0xFF80) | v

    def set_pitch_bend(self, v1, v2):
        self._pitch_bend = (1.0 / 8192.0) * ((v1 | (v2 << 7)) - 8192)

    @property
    def modulation(self):
        return (50.0 / 16383.0) * self._modulation

    @property
    def volume(self):
        return self._volume / 16383.0

    @property
    def pan(self):
        return (100.0 / 16383.0) * self._pan - 50.0

    @property
    def expression(self):
        return self._expression / 16383.0

    @property
    def reverb_send(self):
        return self._reverb_send / 127.0

    @property
    def chorus_send(self):
        return self._chorus_send / 127.0

    @property
    def pitch_bend_range(self):
        return (self._pitch_bend_range >> 7) + 0.01 * (self._pitch_bend_range & 0x7F)

    @property
    def tune(self):
        return self._coarse_tune + (1.0 / 8192.0) * (self._fine_tune - 8192)

    @property
    def pitch_bend(self):
        return self.pitch_bend_range * self._pitch_bend


# controller-number -> Channel method (synthesizer.rs process_midi_message's
# 0xB0 match arms); module-level so controller-heavy MIDI streams don't
# rebuild a bound-method dict per message
_CC_DISPATCH = {
    0x00: Channel.set_bank,
    0x01: Channel.set_modulation_coarse,
    0x21: Channel.set_modulation_fine,
    0x06: Channel.data_entry_coarse,
    0x26: Channel.data_entry_fine,
    0x07: Channel.set_volume_coarse,
    0x27: Channel.set_volume_fine,
    0x0A: Channel.set_pan_coarse,
    0x2A: Channel.set_pan_fine,
    0x0B: Channel.set_expression_coarse,
    0x2B: Channel.set_expression_fine,
    0x40: Channel.set_hold_pedal,
    0x5B: Channel.set_reverb_send,
    0x5D: Channel.set_chorus_send,
    0x65: Channel.set_rpn_coarse,
    0x64: Channel.set_rpn_fine,
}


class VoiceCollection:
    """Fixed polyphony pool with exclusive-class reuse and lowest-priority
    stealing (voice_collection.rs)."""

    def __init__(self, settings: SynthesizerSettings):
        self.voices = [Voice(settings) for _ in range(settings.maximum_polyphony)]
        self.active_voice_count = 0

    def request_new(self, region: InstrumentRegion, channel: int) -> Voice:
        exclusive_class = region.exclusive_class
        if exclusive_class != 0:
            for i in range(self.active_voice_count):
                v = self.voices[i]
                if v.exclusive_class == exclusive_class and v.channel == channel:
                    return v
        if self.active_voice_count < len(self.voices):
            v = self.voices[self.active_voice_count]
            self.active_voice_count += 1
            return v
        candidate, lowest = 0, float("inf")
        for i in range(self.active_voice_count):
            p = self.voices[i].priority
            if p < lowest:
                lowest, candidate = p, i
            elif p == lowest and self.voices[i].voice_length > self.voices[candidate].voice_length:
                candidate = i
        return self.voices[candidate]

    def process(self, data: np.ndarray, channels: list[Channel]):
        i = 0
        while i < self.active_voice_count:
            if self.voices[i].process(data, channels):
                i += 1
            else:
                self.active_voice_count -= 1
                j = self.active_voice_count
                self.voices[i], self.voices[j] = self.voices[j], self.voices[i]

    def get_active_voices(self) -> list[Voice]:
        return self.voices[: self.active_voice_count]

    def clear(self):
        self.active_voice_count = 0


# -- effects -------------------------------------------------------------------


class Reverb:
    """Freeverb-style reverb (reverb.rs): 8 parallel damped combs + 4 serial
    allpasses per channel, right channel offset by a 23-sample stereo spread.
    All delay lines are longer than a block, so each block is vectorized."""

    FIXED_GAIN = 0.015
    COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
    ALLPASS_TUNINGS = (556, 441, 341, 225)
    STEREO_SPREAD = 23

    def __init__(self, sample_rate: int):
        def scale(t):
            # round half AWAY from zero like Rust f64::round (reverb.rs:150)
            # — Python's round() is half-to-even and differs at e.g. 638.5
            return int(math.floor(sample_rate / 44100.0 * t + 0.5))

        room_size = 0.5 * 0.28 + 0.7
        damp = 0.5 * 0.4
        self.feedback = room_size
        self.damp1 = damp
        self.damp2 = 1.0 - damp
        self.gain = self.FIXED_GAIN
        # with defaults wet1 = 1.0 and wet2 = 0, so the reference skips its
        # final stereo cross-mix stage; we omit it for the same reason
        self.cf_l = [_Comb(scale(t)) for t in self.COMB_TUNINGS]
        self.cf_r = [_Comb(scale(t + self.STEREO_SPREAD)) for t in self.COMB_TUNINGS]
        self.ap_l = [_AllPass(scale(t)) for t in self.ALLPASS_TUNINGS]
        self.ap_r = [_AllPass(scale(t + self.STEREO_SPREAD)) for t in self.ALLPASS_TUNINGS]

    def mute(self):
        for f in self.cf_l + self.cf_r + self.ap_l + self.ap_r:
            f.mute()

    def process(self, input_: np.ndarray, out_l: np.ndarray, out_r: np.ndarray):
        out_l[:] = 0.0
        out_r[:] = 0.0
        for cf in self.cf_l:
            cf.process(input_, out_l, self.feedback, self.damp1, self.damp2)
        for ap in self.ap_l:
            ap.process(out_l)
        for cf in self.cf_r:
            cf.process(input_, out_r, self.feedback, self.damp1, self.damp2)
        for ap in self.ap_r:
            ap.process(out_r)


class _Comb:
    def __init__(self, size: int):
        self.buffer = np.zeros(size, np.float32)
        self.index = 0
        self.filter_store = 0.0

    def mute(self):
        self.buffer[:] = 0.0
        self.filter_store = 0.0

    def process(self, input_block, output_block, feedback, damp1, damp2):
        from scipy.signal import lfilter

        n = len(output_block)
        size = len(self.buffer)
        block_index = 0
        while block_index < n:
            if self.index == size:
                self.index = 0
            rem = min(size - self.index, n - block_index)
            sl = slice(self.index, self.index + rem)
            bl = slice(block_index, block_index + rem)
            out = self.buffer[sl].astype(np.float64)
            out[np.abs(out) < 1e-6] = 0.0
            fs, _ = lfilter([damp2], [1.0, -damp1], out, zi=[damp1 * self.filter_store])
            fs[np.abs(fs) < 1e-6] = 0.0
            self.filter_store = float(fs[-1])
            self.buffer[sl] = (input_block[bl] + fs * feedback).astype(np.float32)
            output_block[bl] += out.astype(np.float32)
            self.index += rem
            block_index += rem


class _AllPass:
    FEEDBACK = 0.5

    def __init__(self, size: int):
        self.buffer = np.zeros(size, np.float32)
        self.index = 0

    def mute(self):
        self.buffer[:] = 0.0

    def process(self, block):
        n = len(block)
        size = len(self.buffer)
        block_index = 0
        while block_index < n:
            if self.index == size:
                self.index = 0
            rem = min(size - self.index, n - block_index)
            sl = slice(self.index, self.index + rem)
            bl = slice(block_index, block_index + rem)
            bufout = self.buffer[sl].copy()
            bufout[np.abs(bufout) < 1e-6] = 0.0
            inp = block[bl].copy()
            block[bl] = bufout - inp
            self.buffer[sl] = inp + bufout * self.FEEDBACK
            self.index += rem
            block_index += rem


class Chorus:
    """Dual-tap modulated delay (chorus.rs): sine delay table, left/right
    taps 90 degrees apart. The delay can be shorter than a block, so reads
    are resolved against a history+input extension (no feedback path)."""

    def __init__(self, sample_rate: int, delay: float, depth: float, frequency: float):
        buf_len = int(sample_rate * (delay + depth)) + 2
        table_len = int(math.floor(sample_rate / frequency + 0.5))  # Rust f64::round
        t = np.arange(table_len, dtype=np.float64)
        phase = 2.0 * np.pi * t / table_len
        self.delay_table = (sample_rate * (delay + depth * np.sin(phase))).astype(np.float32)
        self.hist_l = np.zeros(buf_len, np.float32)
        self.hist_r = np.zeros(buf_len, np.float32)
        self.table_index_l = 0
        self.table_index_r = table_len // 4

    def mute(self):
        self.hist_l[:] = 0.0
        self.hist_r[:] = 0.0

    def _channel(self, hist, input_, output, table_index):
        n = len(input_)
        buf_len = len(hist)
        table_len = len(self.delay_table)
        idx = (table_index + np.arange(n)) % table_len
        delays = self.delay_table[idx].astype(np.float64)
        ext = np.concatenate([hist, input_])
        pos = (buf_len + np.arange(n, dtype=np.float64)) - delays
        i1 = pos.astype(np.int64)
        frac = pos - i1
        x1 = ext[i1].astype(np.float64)
        x2 = ext[np.minimum(i1 + 1, len(ext) - 1)].astype(np.float64)
        output[:] = (x1 + frac * (x2 - x1)).astype(np.float32)
        hist[:] = ext[-buf_len:]
        return (table_index + n) % table_len

    def process(self, in_l, in_r, out_l, out_r):
        self.table_index_l = self._channel(self.hist_l, in_l, out_l, self.table_index_l)
        self.table_index_r = self._channel(self.hist_r, in_r, out_r, self.table_index_r)


# -- synthesizer ----------------------------------------------------------------


class Synthesizer:
    """Block renderer (synthesizer.rs): voice mixing with gain ramps,
    reverb/chorus sends, MIDI message routing."""

    CHANNEL_COUNT = 16
    PERCUSSION_CHANNEL = 9

    def __init__(self, sound_font: SoundFont, settings: SynthesizerSettings | int):
        if isinstance(settings, int):
            settings = SynthesizerSettings(settings)
        self.sound_font = sound_font
        self.sample_rate = settings.sample_rate
        self.block_size = settings.block_size
        self.maximum_polyphony = settings.maximum_polyphony
        self.enable_reverb_and_chorus = settings.enable_reverb_and_chorus
        self.channels = [Channel(i == self.PERCUSSION_CHANNEL) for i in range(self.CHANNEL_COUNT)]
        self.voices = VoiceCollection(settings)
        self.block_left = np.zeros(settings.block_size, np.float32)
        self.block_right = np.zeros(settings.block_size, np.float32)
        self.inverse_block_size = 1.0 / settings.block_size
        self.block_read = settings.block_size
        self.master_volume = 0.5
        if settings.enable_reverb_and_chorus:
            self.reverb = Reverb(settings.sample_rate)
            self.chorus = Chorus(settings.sample_rate, 0.002, 0.0019, 0.4)
            self._fx = [np.zeros(settings.block_size, np.float32) for _ in range(5)]
        else:
            self.reverb = None
            self.chorus = None

    def process_midi_message(self, channel: int, command: int, data1: int, data2: int):
        if not 0 <= channel < len(self.channels):
            return
        ch = self.channels[channel]
        if command == 0x80:
            self.note_off(channel, data1)
        elif command == 0x90:
            self.note_on(channel, data1, data2)
        elif command == 0xB0:
            handler = _CC_DISPATCH.get(data1)
            if handler is not None:
                handler(ch, data2)
            elif data1 == 0x78:
                self.note_off_all_channel(channel, True)
            elif data1 == 0x79:
                ch.reset_all_controllers()
            elif data1 == 0x7B:
                self.note_off_all_channel(channel, False)
        elif command == 0xC0:
            ch.set_patch(data1)
        elif command == 0xE0:
            ch.set_pitch_bend(data1, data2)

    def note_off(self, channel: int, key: int):
        for v in self.voices.get_active_voices():
            if v.channel == channel and v.key == key:
                v.end()

    def note_on(self, channel: int, key: int, velocity: int):
        if velocity == 0:
            self.note_off(channel, key)
            return
        if not 0 <= channel < len(self.channels):
            return
        ch = self.channels[channel]
        preset = self.sound_font.lookup_preset(ch.bank_number, ch.patch_number)
        if preset is None:
            return
        for preset_region in preset.regions:
            if preset_region.contains(key, velocity):
                instrument = self.sound_font.instruments[preset_region.instrument]
                for instrument_region in instrument.regions:
                    if instrument_region.contains(key, velocity):
                        pair = RegionPair(preset_region, instrument_region)
                        voice = self.voices.request_new(instrument_region, channel)
                        voice.start(pair, channel, key, velocity)

    def note_off_all(self, immediate: bool):
        if immediate:
            self.voices.clear()
        else:
            for v in self.voices.get_active_voices():
                v.end()

    def note_off_all_channel(self, channel: int, immediate: bool):
        for v in self.voices.get_active_voices():
            if v.channel == channel:
                v.kill() if immediate else v.end()

    def reset(self):
        self.voices.clear()
        for ch in self.channels:
            ch.reset()
        if self.enable_reverb_and_chorus:
            self.reverb.mute()
            self.chorus.mute()
        self.block_read = self.block_size

    def get_active_voices(self) -> list[Voice]:
        """The fork's introspection hook (synthesizer.rs:525-527)."""
        return self.voices.get_active_voices()

    def render(self, left: np.ndarray, right: np.ndarray):
        assert len(left) == len(right)
        wrote = 0
        n = len(left)
        while wrote < n:
            if self.block_read == self.block_size:
                self._render_block()
                self.block_read = 0
            rem = min(self.block_size - self.block_read, n - wrote)
            left[wrote : wrote + rem] = self.block_left[self.block_read : self.block_read + rem]
            right[wrote : wrote + rem] = self.block_right[self.block_read : self.block_read + rem]
            self.block_read += rem
            wrote += rem

    @staticmethod
    def _write_block(previous_gain, current_gain, source, destination, inverse_block_size):
        if max(previous_gain, current_gain) < NON_AUDIBLE:
            return
        if abs(current_gain - previous_gain) < 1.0e-3:
            destination += np.float32(current_gain) * source
        else:
            step = inverse_block_size * (current_gain - previous_gain)
            gains = np.float32(previous_gain) + np.float32(step) * np.arange(
                len(source), dtype=np.float32
            )
            destination += gains * source

    def _render_block(self):
        self.voices.process(self.sound_font.wave_data, self.channels)
        self.block_left[:] = 0.0
        self.block_right[:] = 0.0
        mv = self.master_volume
        ibs = self.inverse_block_size
        active = self.voices.get_active_voices()
        for v in active:
            self._write_block(mv * v.previous_mix_gain_left, mv * v.current_mix_gain_left,
                              v.block, self.block_left, ibs)
            self._write_block(mv * v.previous_mix_gain_right, mv * v.current_mix_gain_right,
                              v.block, self.block_right, ibs)

        if not self.enable_reverb_and_chorus:
            return
        ch_in_l, ch_in_r, rv_in, out_l, out_r = self._fx
        ch_in_l[:] = 0.0
        ch_in_r[:] = 0.0
        for v in active:
            self._write_block(v.previous_chorus_send * v.previous_mix_gain_left,
                              v.current_chorus_send * v.current_mix_gain_left,
                              v.block, ch_in_l, ibs)
            self._write_block(v.previous_chorus_send * v.previous_mix_gain_right,
                              v.current_chorus_send * v.current_mix_gain_right,
                              v.block, ch_in_r, ibs)
        self.chorus.process(ch_in_l, ch_in_r, out_l, out_r)
        self.block_left += np.float32(mv) * out_l
        self.block_right += np.float32(mv) * out_r

        rv_in[:] = 0.0
        g = self.reverb.gain
        for v in active:
            self._write_block(
                g * v.previous_reverb_send * (v.previous_mix_gain_left + v.previous_mix_gain_right),
                g * v.current_reverb_send * (v.current_mix_gain_left + v.current_mix_gain_right),
                v.block, rv_in, ibs)
        self.reverb.process(rv_in, out_l, out_r)
        self.block_left += np.float32(mv) * out_l
        self.block_right += np.float32(mv) * out_r


class MidiFileSequencer:
    """Plays a MidiFile through a Synthesizer with events dispatched on the
    64-sample block grid (midifile_sequencer.rs:60-111)."""

    def __init__(self, synthesizer: Synthesizer):
        self.synthesizer = synthesizer
        self._midi: MidiFile | None = None
        self._play_loop = False
        self._block_wrote = 0
        self._current_time = 0.0
        self._msg_index = 0

    def play(self, midi: MidiFile, loop: bool = False):
        self._midi = midi
        self._play_loop = loop
        self._block_wrote = self.synthesizer.block_size
        self._current_time = 0.0
        self._msg_index = 0
        self.synthesizer.reset()

    def stop(self):
        self._midi = None
        self.synthesizer.reset()

    def render(self, left: np.ndarray, right: np.ndarray):
        assert len(left) == len(right)
        n = len(left)
        bs = self.synthesizer.block_size
        wrote = 0
        while wrote < n:
            if self._block_wrote == bs:
                self._process_events()
                self._block_wrote = 0
                self._current_time += bs / self.synthesizer.sample_rate
            rem = min(bs - self._block_wrote, n - wrote)
            self.synthesizer.render(left[wrote : wrote + rem], right[wrote : wrote + rem])
            self._block_wrote += rem
            wrote += rem

    def _process_events(self):
        if self._midi is None:
            return
        msgs = self._midi.messages
        while self._msg_index < len(msgs):
            m = msgs[self._msg_index]
            if m.time <= self._current_time:
                self.synthesizer.process_midi_message(m.channel, m.command, m.data1, m.data2)
                self._msg_index += 1
            else:
                break
        if self._msg_index == len(msgs) and self._play_loop:
            self._current_time = 0.0
            self._msg_index = 0
            self.synthesizer.note_off_all(False)
