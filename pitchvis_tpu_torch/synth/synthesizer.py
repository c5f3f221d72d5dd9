"""Additive-harmonic polyphonic synthesizer for training-data generation.

Port of ``pitchvis_tpu/synth/synthesizer.py``. One difference: the render
always runs the native C++ voice loop (``pv_synth_render`` of the port's
native/pitchvis_native.cpp), with no silent fallback; the NumPy loop stays
beside it as :meth:`Synthesizer.render_plain`, the reference the tests hold
the native loop against.

Lightweight companion to the full SoundFont engine (synth/engine.py, the
behavioral equivalent of the reference's vendored rustysynth): when no SF2
file is available, per-program bandlimited additive voices with ADSR
envelopes provide realistic harmonic spectra and the same introspectable
`key` / `current_mix_gain_*` surface the training labeler reads
(rustysynth_fork/src/voice.rs:38-39, train.rs:318-338). Shares the
block-grid `MidiFileSequencer` with the engine, so MIDI events dispatch on
the 64-sample grid (midifile_sequencer.rs:60-76) in both paths.

The render core is the native C++ voice kernel (runtime/native.py); the
NumPy path is the reference implementation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .engine import MidiFileSequencer  # noqa: F401  (re-exported; shared block sequencer)

A4_KEY = 69
A4_FREQ = 440.0
BLOCK_SIZE = 64


def key_to_freq(key: int) -> float:
    return A4_FREQ * 2.0 ** ((key - A4_KEY) / 12.0)


@dataclass
class ProgramTimbre:
    """Harmonic amplitude profile + ADSR (seconds, sustain level)."""

    harmonics: np.ndarray
    attack: float = 0.01
    decay: float = 0.15
    sustain: float = 0.7
    release: float = 0.25


def _harmonics(rolloff: float, n: int = 10) -> np.ndarray:
    h = np.arange(1, n + 1, dtype=np.float64)
    a = 1.0 / h**rolloff
    return (a / np.sqrt((a**2).sum())).astype(np.float64)


# GM family -> timbre (coarse: family = program // 8)
_FAMILY_TIMBRES = {
    0: ProgramTimbre(_harmonics(1.6), 0.005, 0.8, 0.25, 0.2),  # piano
    1: ProgramTimbre(_harmonics(2.2), 0.003, 0.5, 0.3, 0.15),  # chromatic perc
    2: ProgramTimbre(_harmonics(1.4), 0.02, 0.3, 0.8, 0.3),  # organ
    3: ProgramTimbre(_harmonics(1.2), 0.004, 0.4, 0.5, 0.2),  # guitar
    4: ProgramTimbre(_harmonics(1.1), 0.01, 0.3, 0.7, 0.25),  # bass
    5: ProgramTimbre(_harmonics(1.3), 0.06, 0.2, 0.85, 0.35),  # strings
    6: ProgramTimbre(_harmonics(1.5), 0.05, 0.25, 0.8, 0.3),  # ensemble
    7: ProgramTimbre(_harmonics(1.8), 0.03, 0.2, 0.85, 0.2),  # brass
    8: ProgramTimbre(_harmonics(2.0), 0.04, 0.2, 0.8, 0.25),  # reed
    9: ProgramTimbre(_harmonics(2.5), 0.03, 0.2, 0.85, 0.25),  # pipe
}
_DEFAULT_TIMBRE = _FAMILY_TIMBRES[0]


@dataclass
class Voice:
    """One sounding note (voice.rs): public key and current mix gains are
    what the label extractor reads."""

    channel: int
    key: int
    velocity: int
    freq: float
    timbre: ProgramTimbre
    phase: float = 0.0
    age: float = 0.0  # seconds since note-on
    released_at: float | None = None
    current_mix_gain_left: float = 0.0
    current_mix_gain_right: float = 0.0

    def envelope(self, t: np.ndarray) -> np.ndarray:
        """ADSR evaluated at per-sample ages t (vectorized)."""
        tb = self.timbre
        env = np.where(
            t < tb.attack,
            t / max(tb.attack, 1e-5),
            np.where(
                t < tb.attack + tb.decay,
                1.0 - (1.0 - tb.sustain) * (t - tb.attack) / max(tb.decay, 1e-5),
                tb.sustain,
            ),
        )
        if self.released_at is not None:
            tr = t - self.released_at
            env = np.where(tr > 0, env * np.maximum(1.0 - tr / max(tb.release, 1e-5), 0.0), env)
        return env

    def done(self) -> bool:
        return (
            self.released_at is not None
            and self.age > self.released_at + self.timbre.release
        )


class Synthesizer:
    """Real-time polyphonic additive renderer. API-compatible with the full
    SoundFont engine where the sequencer and labeler need it
    (process_midi_message/reset/render/get_active_voices)."""

    MAX_VOICES = 64

    def __init__(self, sample_rate: int = 22050):
        self.sample_rate = sample_rate
        self.block_size = BLOCK_SIZE
        self.voices: list[Voice] = []
        self.programs = [0] * 16
        self.master_gain = 0.18

    def reset(self) -> None:
        self.voices = []
        self.programs = [0] * 16

    def process_midi_message(self, channel: int, command: int, data1: int, data2: int) -> None:
        if command == 0x90 and data2 > 0:
            self.note_on(channel, data1, data2)
        elif command == 0x80 or (command == 0x90 and data2 == 0):
            self.note_off(channel, data1)
        elif command == 0xC0:
            self.process_program_change(channel, data1)
        # controllers/pitch bend: no-op in the additive model

    def process_program_change(self, channel: int, program: int) -> None:
        self.programs[channel] = program

    def note_on(self, channel: int, key: int, velocity: int) -> None:
        if channel == 9:  # percussion channel: no pitched content
            return
        if len(self.voices) >= self.MAX_VOICES:
            self.voices.pop(0)
        timbre = _FAMILY_TIMBRES.get(self.programs[channel] // 8, _DEFAULT_TIMBRE)
        self.voices.append(
            Voice(channel, key, velocity, key_to_freq(key), timbre)
        )

    def note_off(self, channel: int, key: int) -> None:
        for v in self.voices:
            if v.channel == channel and v.key == key and v.released_at is None:
                v.released_at = v.age

    def render_plain(self, left: np.ndarray, right: np.ndarray) -> None:
        """The NumPy reference of :meth:`render`: the same voices, state
        advance and mix gains, in float64 NumPy."""
        n = len(left)
        sr = self.sample_rate
        t_rel = np.arange(n) / sr
        mix = np.zeros(n, np.float64)
        nyq = sr / 2.0

        for v in self.voices:
            ages = v.age + t_rel
            env = v.envelope(ages)
            amp = (v.velocity / 127.0) * self.master_gain
            # bandlimited additive synthesis
            wave = np.zeros(n, np.float64)
            for h, a in enumerate(v.timbre.harmonics, start=1):
                fh = v.freq * h
                if fh >= nyq:
                    break
                wave += a * np.sin(v.phase * h + 2.0 * math.pi * fh * t_rel)
            sig = amp * env * wave
            mix += sig
            # voice state advance
            v.phase = (v.phase + 2.0 * math.pi * v.freq * n / sr) % (2.0 * math.pi)
            v.age += n / sr
            # per-voice mix gain excludes the master volume (rustysynth's
            # current_mix_gain_* is the voice's own velocity/envelope gain,
            # voice.rs:38-39) — label extraction thresholds depend on this
            gain_now = float((v.velocity / 127.0) * env[-1])
            v.current_mix_gain_left = gain_now
            v.current_mix_gain_right = gain_now

        self.voices = [v for v in self.voices if not v.done()]
        left[:] = mix.astype(np.float32)
        right[:] = mix.astype(np.float32)

    def render(self, left: np.ndarray, right: np.ndarray) -> None:
        """Renders len(left) samples into the provided buffers (the
        rustysynth render API shape) with the native C++ voice kernel.
        Raises RuntimeError if the native library cannot be built."""
        from ..runtime import native

        n = len(left)
        vs = self.voices
        if not vs:
            left[:] = 0.0
            right[:] = 0.0
            return
        mix = np.zeros(n, np.float32)
        freq = np.array([v.freq for v in vs], np.float64)
        phase = np.array([v.phase for v in vs], np.float64)
        age = np.array([v.age for v in vs], np.float64)
        released = np.array(
            [v.released_at if v.released_at is not None else -1.0 for v in vs], np.float64
        )
        vel = np.array([v.velocity / 127.0 for v in vs], np.float64)
        amp = vel * self.master_gain
        harm = np.stack([v.timbre.harmonics for v in vs]).astype(np.float64)
        gains = native.synth_render(
            mix, float(self.sample_rate), freq, phase, age, released, amp,
            np.array([v.timbre.attack for v in vs], np.float64),
            np.array([v.timbre.decay for v in vs], np.float64),
            np.array([v.timbre.sustain for v in vs], np.float64),
            np.array([v.timbre.release for v in vs], np.float64),
            harm,
        )
        for v, p, a, g, vl in zip(vs, phase, age, gains, vel):
            v.phase = float(p)
            v.age = float(a)
            env_last = float(g) / max(float(vl) * self.master_gain, 1e-12)
            gain_now = float(vl) * env_last
            v.current_mix_gain_left = gain_now
            v.current_mix_gain_right = gain_now
        self.voices = [v for v in vs if not v.done()]
        left[:] = mix
        right[:] = mix

    def get_active_voices(self) -> list[Voice]:
        """The fork's introspection hook (synthesizer.rs:525-527)."""
        return list(self.voices)


def make_synthesizer(sample_rate: int = 22050, sound_font=None):
    """Factory: the full SoundFont engine when a font is given, the additive
    synthesizer otherwise. Both share MidiFileSequencer."""
    if sound_font is not None:
        from .engine import Synthesizer as EngineSynthesizer, SynthesizerSettings

        return EngineSynthesizer(sound_font, SynthesizerSettings(sample_rate))
    return Synthesizer(sample_rate)
