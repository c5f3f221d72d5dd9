"""ctypes front-end for the native C++ SoundFont engine
(native/synth_engine.cpp) — same semantics as the NumPy reference engine
(synth/engine.py), ~100x faster, used by the training pipeline's render loop
(the reference's rustysynth hot loop, train.rs:252-351).

The Python SF2 parser's object model is flattened into the tables the C ABI
consumes: per-region int16 generator arrays (SF2 defaults already applied),
instrument region ranges, and preset id/region tables.

Port of ``pitchvis_tpu/synth/engine_native.py`` over the port's copy of the
C++ engine, ``pitchvis_tpu_torch/native/synth_engine.cpp``, built as a
library of its own (runtime/native.py::load_synth). A failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .midi import MidiFile
from .sf2 import GEN_COUNT, SoundFont


def _i16ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _i32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f64ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


_FONT_TABLE_CACHE: dict[int, dict[str, np.ndarray]] = {}


def font_tables(font: SoundFont) -> dict[str, np.ndarray]:
    """Flattens a parsed SoundFont into the C engine's region tables.

    Cached per font object: corpus generation constructs one engine PER
    MIDI FILE (engine lifetime = sequencer lifetime), and re-flattening an
    unchanged font 1,500x is pure overhead that scales with the font's
    sample pool. (pv_engine_create still copies the wave table per engine;
    an engine-reuse API would remove that too if GB-scale fonts ever make
    it matter.)"""
    hit = _FONT_TABLE_CACHE.get(id(font))
    # the cache holds a strong reference to the keyed font, so its id()
    # cannot be recycled by a different object while the entry lives
    if hit is not None and hit[0] is font:
        return hit[1]
    tables = _font_tables_uncached(font)
    _FONT_TABLE_CACHE.clear()  # one live corpus font at a time; no leaks
    _FONT_TABLE_CACHE[id(font)] = (font, tables)
    return tables


def _font_tables_uncached(font: SoundFont) -> dict[str, np.ndarray]:
    inst_gs, inst_extra, instruments = [], [], []
    for inst in font.instruments:
        instruments.append([len(inst_gs), len(inst.regions)])
        for r in inst.regions:
            inst_gs.append(r.gs)
            s = r.sample
            inst_extra.append(
                [s.start, s.end, s.start_loop, s.end_loop, s.sample_rate,
                 s.original_pitch, s.pitch_correction]
            )
    preset_gs, preset_inst, presets = [], [], []
    for p in font.presets:
        presets.append([(p.bank_number << 16) | p.patch_number, len(preset_gs), len(p.regions)])
        for r in p.regions:
            preset_gs.append(r.gs)
            preset_inst.append(r.instrument)
    return {
        "wave": np.ascontiguousarray(font.wave_data, np.int16),
        "inst_gs": np.ascontiguousarray(
            np.stack(inst_gs) if inst_gs else np.zeros((0, GEN_COUNT)), np.int16
        ),
        "inst_extra": np.ascontiguousarray(
            np.asarray(inst_extra, np.int32).reshape(-1, 7)
        ),
        "instruments": np.ascontiguousarray(np.asarray(instruments, np.int32).reshape(-1, 2)),
        "preset_gs": np.ascontiguousarray(
            np.stack(preset_gs) if preset_gs else np.zeros((0, GEN_COUNT)), np.int16
        ),
        "preset_inst": np.ascontiguousarray(np.asarray(preset_inst, np.int32).reshape(-1)),
        "presets": np.ascontiguousarray(np.asarray(presets, np.int32).reshape(-1, 3)),
    }


class _NativeVoiceView:
    """Introspection record matching the labeler's voice surface."""

    __slots__ = ("key", "current_mix_gain_left", "current_mix_gain_right")

    def __init__(self, key, gl, gr):
        self.key = int(key)
        self.current_mix_gain_left = float(gl)
        self.current_mix_gain_right = float(gr)


class NativeSynthesizer:
    """Native engine handle with the Synthesizer API surface the sequencer
    and labeler need."""

    def __init__(self, font: SoundFont, sample_rate: int, *, block_size: int = 64,
                 maximum_polyphony: int = 64, enable_reverb_and_chorus: bool = True):
        from ..runtime import native

        lib = native.load_synth()
        self._lib = lib
        # the same validated ranges as the NumPy mirror (SynthesizerSettings)
        # — pv_engine_create also rejects these (returns nullptr) as
        # defense in depth
        from .engine import SynthesizerSettings

        settings = SynthesizerSettings(
            sample_rate, block_size, maximum_polyphony, enable_reverb_and_chorus
        )
        self.sample_rate = settings.sample_rate
        self.block_size = settings.block_size
        self.maximum_polyphony = settings.maximum_polyphony
        t = font_tables(font)
        self._tables = t  # keep alive for the duration of the create call
        self._handle = ctypes.c_void_p(
            lib.pv_engine_create(
                _i16ptr(t["wave"]), len(t["wave"]),
                _i16ptr(t["inst_gs"]), _i32ptr(t["inst_extra"]), len(t["inst_gs"]),
                _i32ptr(t["instruments"]), len(t["instruments"]),
                _i16ptr(t["preset_gs"]), _i32ptr(t["preset_inst"]), len(t["preset_gs"]),
                _i32ptr(t["presets"]), len(t["presets"]),
                self.sample_rate, self.block_size, self.maximum_polyphony,
                int(enable_reverb_and_chorus),
            )
        )
        if not self._handle.value:
            raise ValueError(
                "pv_engine_create rejected the settings (out-of-range "
                f"sample_rate/block_size/polyphony: {self.sample_rate}/"
                f"{self.block_size}/{self.maximum_polyphony})"
            )

    def reset(self) -> None:
        self._lib.pv_engine_reset(self._handle)

    def process_midi_message(self, channel: int, command: int, data1: int, data2: int) -> None:
        self._lib.pv_engine_midi(self._handle, channel, command, data1, data2)

    def note_on(self, channel: int, key: int, velocity: int) -> None:
        self._lib.pv_engine_note_on(self._handle, channel, key, velocity)

    def note_off(self, channel: int, key: int) -> None:
        self._lib.pv_engine_note_off(self._handle, channel, key)

    def render(self, left: np.ndarray, right: np.ndarray) -> None:
        assert left.dtype == np.float32 and right.dtype == np.float32
        self._lib.pv_engine_render(self._handle, _f32ptr(left), _f32ptr(right), len(left))

    def get_active_voices(self) -> list[_NativeVoiceView]:
        n = self.maximum_polyphony
        keys = np.empty(n, np.int32)
        gl = np.empty(n, np.float32)
        gr = np.empty(n, np.float32)
        cnt = self._lib.pv_engine_active_voices(self._handle, _i32ptr(keys), _f32ptr(gl),
                                                _f32ptr(gr), n)
        return [_NativeVoiceView(keys[i], gl[i], gr[i]) for i in range(cnt)]

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.pv_engine_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _message_arrays(midi: MidiFile):
    n = len(midi.messages)
    times = np.array([m.time for m in midi.messages], np.float64)
    ch = np.array([m.channel for m in midi.messages], np.int32)
    cmd = np.array([m.command for m in midi.messages], np.int32)
    d1 = np.array([m.data1 for m in midi.messages], np.int32)
    d2 = np.array([m.data2 for m in midi.messages], np.int32)
    return n, times, ch, cmd, d1, d2


class NativeSequencer:
    """Block-grid MIDI sequencer over a NativeSynthesizer."""

    def __init__(self, synthesizer: NativeSynthesizer):
        self.synthesizer = synthesizer
        self._lib = synthesizer._lib
        self._handle = None

    def play(self, midi: MidiFile, loop: bool = False) -> None:
        del loop  # single-shot rendering, as the training pipeline uses it
        self.stop()
        n, times, ch, cmd, d1, d2 = _message_arrays(midi)
        self._msgs = (times, ch, cmd, d1, d2)  # keep alive
        self._handle = ctypes.c_void_p(
            self._lib.pv_seq_create(
                self.synthesizer._handle, _f64ptr(times), _i32ptr(ch), _i32ptr(cmd),
                _i32ptr(d1), _i32ptr(d2), n,
            )
        )

    def render(self, left: np.ndarray, right: np.ndarray) -> None:
        assert self._handle is not None, "call play() first"
        self._lib.pv_seq_render(self._handle, _f32ptr(left), _f32ptr(right), len(left))

    def stop(self) -> None:
        if self._handle is not None:
            self._lib.pv_seq_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def synthesize_labeled(
    font: SoundFont,
    midi: MidiFile,
    *,
    sample_rate: int,
    chunk: int,
    step_chunks: int,
    max_seconds: float | None = None,
    agc_desired_rms: float = 0.07,
    agc_distortion: float = 0.001,
    max_voices: int = 64,
) -> tuple[np.ndarray, list[dict[int, float]]]:
    """The whole training render→AGC→snapshot loop (train.rs:252-351) in one
    native call. Returns the AGC'd mono stream (chunk-aligned; capture c's
    VQT window is the n_fft samples ending at (c+1)*step_chunks*chunk, zero
    padded on the left — see windows_from_stream) and the per-capture
    {key: gain} label dicts (previous-snapshot semantics)."""
    synth = NativeSynthesizer(font, sample_rate)
    seq = NativeSequencer(synth)
    seq.play(midi)
    length = midi.get_length()
    if max_seconds is not None:
        length = min(length, max_seconds)
    sample_count = int(sample_rate * length)
    n_chunks = -(-sample_count // chunk) if sample_count else 0
    max_captures = n_chunks // step_chunks + 1
    stream = np.zeros(n_chunks * chunk, np.float32)
    keys = np.zeros((max(max_captures, 1), max_voices), np.int32)
    gains = np.zeros((max(max_captures, 1), max_voices), np.float32)
    counts = np.zeros(max(max_captures, 1), np.int32)
    if n_chunks == 0:
        return stream, []
    n = synth._lib.pv_train_synthesize(
        seq._handle, sample_count, chunk, step_chunks,
        agc_desired_rms, agc_distortion,
        _f32ptr(stream), _i32ptr(keys), _f32ptr(gains), _i32ptr(counts),
        max_captures, max_voices,
    )
    labels = []
    for i in range(n):
        d: dict[int, float] = {}
        for j in range(counts[i]):
            k = int(keys[i, j])
            g = float(gains[i, j])
            if g > d.get(k, -1.0):
                d[k] = g
        labels.append(d)
    return stream, labels


def windows_from_stream(stream: np.ndarray, n_captures: int, *, chunk: int,
                        step_chunks: int, n_fft: int) -> np.ndarray:
    """Host-side capture-window extraction (the device path in
    train/dataset.py does the same slicing on-chip): capture c's window is
    the n_fft samples ending at stream position (c+1)*step_chunks*chunk,
    left-padded with the ring buffer's initial zeros."""
    padded = np.concatenate([np.zeros(n_fft, np.float32), stream])
    stride = step_chunks * chunk
    return np.stack([padded[(c + 1) * stride : (c + 1) * stride + n_fft]
                     for c in range(n_captures)])
