"""ctypes bindings for the port's native ingest library
(``pitchvis_tpu_torch/native/pitchvis_native.cpp``).

A port of ``pitchvis_tpu/runtime/native.py`` over the port's own copy of
the C++ source: the ring bank, the resampler bank, the standalone AGC and
the additive synthesizer's voice loop (``pitchvis_native.cpp``), and the
SoundFont engine (``synth_engine.cpp``, a library of its own:
:func:`load_synth`). Each library is built at first use
(utils/host_build.py: g++ under a cross-process lock, into
``build/pitchvis_tpu_torch/``) and its function signatures are bound once,
at load. There is no fallback: if a library cannot be built or loaded,
every constructor here raises, and so does the server or the dataset
generator that stands on them.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops.resample import _design_prototype, make_spec
from ..utils import host_build

_lib = None
_synth_lib = None
_lock = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_void, _i32, _i64, _f32, _f64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float, ctypes.c_double

# name -> (restype, argtypes)
_SIGNATURES = {
    "pv_rb_create": (_void, [_i64, _i64]),
    "pv_rb_destroy": (None, [_void]),
    "pv_rb_write": (_i32, [_void, _i64, _f32p, _i64]),
    "pv_rb_write_agc": (_i32, [_void, _i64, _f32p, _i64, _f32, _f32]),
    "pv_rb_write_batch": (_i64, [_void, _i64p, _i64, _f32p, _i64, _u8p, _i32, _f32, _f32]),
    "pv_rb_snapshot": (None, [_void, _f32p, _f32p, _i64]),
    "pv_rb_consume": (_i64, [_void, _f32p, _f32p, _u8p, _i64, _i64]),
    "pv_rb_mark_consumed": (None, [_void]),
    "pv_rb_snapshot_consume": (None, [_void, _f32p, _f32p, _i64]),
    "pv_rb_gain": (ctypes.c_double, [_void, _i64]),
    "pv_rb_reset": (None, [_void, _i64]),
    "pv_rb_written": (ctypes.c_uint64, [_void, _i64]),
    "pv_rb_export": (None, [_void, _f32p, _u64p, _f32p]),
    "pv_rb_import": (None, [_void, _f32p, _u64p, _f32p]),
    "pv_rs_create": (_void, [_i64, _i64, _i64, _i64, _f64p]),
    "pv_rs_destroy": (None, [_void]),
    "pv_rs_reset": (None, [_void, _i64]),
    "pv_rs_process": (_i64, [_void, _i64, _f32p, _i64, _f32p, _i64]),
    "pv_agc_process": (_f32, [_f32, _f32p, _i64, _f32, _f32, _i32]),
    "pv_synth_render": (None, [_f32p, _i64, _f64, _i64] + [_f64p] * 10 + [_i64, _f64p]),
}

# the SoundFont engine (synth_engine.cpp)
_SYNTH_SIGNATURES = {
    "pv_engine_create": (_void, [_i16p, _i64, _i16p, _i32p, _i64, _i32p, _i64, _i16p, _i32p, _i64,
                                 _i32p, _i64, _i32, _i32, _i32, _i32]),
    "pv_engine_destroy": (None, [_void]),
    "pv_engine_reset": (None, [_void]),
    "pv_engine_midi": (None, [_void] + [_i32] * 4),
    "pv_engine_note_on": (None, [_void] + [_i32] * 3),
    "pv_engine_note_off": (None, [_void] + [_i32] * 2),
    "pv_engine_render": (None, [_void, _f32p, _f32p, _i64]),
    "pv_engine_active_voices": (_i32, [_void, _i32p, _f32p, _f32p, _i32]),
    "pv_seq_create": (_void, [_void, _f64p, _i32p, _i32p, _i32p, _i32p, _i64]),
    "pv_seq_destroy": (None, [_void]),
    "pv_seq_render": (None, [_void, _f32p, _f32p, _i64]),
    "pv_train_synthesize": (_i64, [_void, _i64, _i64, _i32, _f32, _f32, _f32p, _i32p, _f32p, _i32p,
                                   _i64, _i32]),
}


def _load_bound(name: str, signatures: dict) -> ctypes.CDLL:
    path = host_build.library_path(name)
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"cannot load the native library {path}: {e}") from e
    for fn_name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load() -> ctypes.CDLL:
    """The bound ingest library (pitchvis_native.cpp), built at first use.
    Raises RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load_bound("pitchvis_native", _SIGNATURES)
        return _lib


def available() -> bool:
    """True when the ingest library builds and loads (the JAX package's
    ``runtime/native.py::available``); False where it cannot, as on a host
    without g++. Callers that offer a path without the native runtime (the
    CLI's ``--serve``) ask this first, so that no other failure is taken
    for a missing library."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def load_synth() -> ctypes.CDLL:
    """The bound SoundFont engine (synth_engine.cpp), built at first use.
    Raises RuntimeError when it cannot be built or loaded. ctypes releases
    the interpreter lock for the length of each call, so engines on several
    threads render at once (train/dataset.py::_generate_dataset_parallel)."""
    global _synth_lib
    with _lock:
        if _synth_lib is None:
            _synth_lib = _load_bound("synth_engine", _SYNTH_SIGNATURES)
        return _synth_lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _stream_id(stream, n_streams: int) -> int:
    """A stream index checked before it reaches native code, which does not
    check it."""
    stream = int(stream)
    if not 0 <= stream < n_streams:
        raise ValueError(f"stream {stream} out of range for {n_streams} streams")
    return stream


class NativeRingBank:
    """Lock-free per-stream ring buffers with batched snapshot and delta
    consume: the host staging stage feeding the card. The serving-scale
    counterpart of the reference's Arc<Mutex<RingBuffer>>
    (pitchvis_audio/src/lib.rs:17-28)."""

    def __init__(self, n_streams: int, capacity: int):
        self._lib = load()
        self._handle = ctypes.c_void_p(self._lib.pv_rb_create(n_streams, capacity))
        self.n_streams = n_streams
        self.capacity = capacity

    def write(self, stream: int, samples: np.ndarray, *, agc: bool = True,
              desired_rms: float = 0.07, distortion: float = 1e-4) -> bool:
        """Appends a chunk; returns False when rejected (NaN guard)."""
        stream = _stream_id(stream, self.n_streams)
        samples = np.ascontiguousarray(samples, np.float32)
        if agc:
            ret = self._lib.pv_rb_write_agc(
                self._handle, stream, _fptr(samples), len(samples), desired_rms, distortion,
            )
        else:
            ret = self._lib.pv_rb_write(self._handle, stream, _fptr(samples), len(samples))
        return ret == 0

    def write_batch(self, ids: np.ndarray | None, samples: np.ndarray, *,
                    agc: bool = True, desired_rms: float = 0.07,
                    distortion: float = 1e-4) -> np.ndarray:
        """Appends one equal-length chunk to many streams in ONE native
        call: row k of ``samples`` (rows, n) goes to stream ``ids[k]``
        (``None`` = rows 0..rows-1). Per-row NaN guard: returns an ok[rows]
        bool array (rejected rows leave their ring untouched)."""
        samples = np.ascontiguousarray(samples, np.float32)
        if samples.ndim != 2:
            raise ValueError(f"samples must be (rows, n), got {samples.shape}")
        rows = samples.shape[0]
        if ids is None:
            ids = np.arange(rows, dtype=np.int64)
        else:
            ids = np.ascontiguousarray(ids, np.int64)
            if ids.shape != (rows,):
                raise ValueError(f"ids shape {ids.shape} != ({rows},)")
        if rows and (ids.min() < 0 or ids.max() >= self.n_streams):
            raise ValueError("stream id out of range")
        ok = np.empty(rows, np.uint8)
        self._lib.pv_rb_write_batch(
            self._handle, ids.ctypes.data_as(_i64p), rows, _fptr(samples), samples.shape[1],
            ok.ctypes.data_as(_u8p), 1 if agc else 0, desired_rms, distortion,
        )
        return ok.astype(bool)

    def snapshot(self, window: int) -> tuple[np.ndarray, np.ndarray]:
        """Trailing `window` samples of all streams -> ((B, window), gains)."""
        out = np.empty((self.n_streams, window), np.float32)
        gains = np.empty(self.n_streams, np.float32)
        self._lib.pv_rb_snapshot(self._handle, _fptr(out), _fptr(gains), window)
        return out, gains

    def consume(
        self, n: int, max_lag: int = -1, out: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Delta-ingest read: the next `n` unconsumed samples per stream ->
        ((B, n) chunks, gains[B], advanced[B] bool). All-or-nothing per
        stream: a row with fewer than n unread samples stays put (zeros,
        advanced=False) so its window freezes like a stalled snapshot.
        Backlogs beyond `max_lag` samples (-1 = ring capacity) are skipped
        realtime-style.

        ``out`` (a C-contiguous float32 (B, n) view) receives the chunks in
        place: the server stages them straight into pinned host memory."""
        if out is None:
            out = np.empty((self.n_streams, n), np.float32)
        elif out.dtype != np.float32 or out.shape != (self.n_streams, n) or not out.flags["C_CONTIGUOUS"]:
            raise ValueError(f"out must be a C-contiguous float32 ({self.n_streams}, {n}) array")
        gains = np.empty(self.n_streams, np.float32)
        adv = np.empty(self.n_streams, np.uint8)
        self._lib.pv_rb_consume(
            self._handle, _fptr(out), _fptr(gains), adv.ctypes.data_as(_u8p), n, max_lag,
        )
        return out, gains, adv.astype(bool)

    def mark_consumed(self) -> None:
        """Aligns every read cursor with its write head — call right after
        materializing a full-window snapshot so consume() continues from it."""
        self._lib.pv_rb_mark_consumed(self._handle)

    def snapshot_consume(self, window: int) -> tuple[np.ndarray, np.ndarray]:
        """snapshot + mark_consumed fused per stream against ONE head read:
        samples pushed during the copy stay unconsumed. The delta path's
        window (re)materialization primitive."""
        out = np.empty((self.n_streams, window), np.float32)
        gains = np.empty(self.n_streams, np.float32)
        self._lib.pv_rb_snapshot_consume(self._handle, _fptr(out), _fptr(gains), window)
        return out, gains

    def gain(self, stream: int) -> float:
        return float(self._lib.pv_rb_gain(self._handle, _stream_id(stream, self.n_streams)))

    def reset(self, stream: int) -> None:
        """Recycles one slot for a new stream: clears audio, write position,
        read cursor and AGC gain. The slot's previous producer must have
        stopped (per-stream single-producer contract); a concurrent snapshot
        is safe."""
        self._lib.pv_rb_reset(self._handle, _stream_id(stream, self.n_streams))

    def written(self, stream: int) -> int:
        return int(self._lib.pv_rb_written(self._handle, _stream_id(stream, self.n_streams)))

    def export_state(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Checkpoint image: (audio[B, capacity] trailing windows, heads[B]
        total-written counters, gains[B] AGC gains). Snapshot-consistent
        against concurrent producers."""
        audio = np.empty((self.n_streams, self.capacity), np.float32)
        heads = np.empty(self.n_streams, np.uint64)
        gains = np.empty(self.n_streams, np.float32)
        self._lib.pv_rb_export(self._handle, _fptr(audio), heads.ctypes.data_as(_u64p), _fptr(gains))
        return audio, heads, gains

    def import_state(self, audio: np.ndarray, heads: np.ndarray, gains: np.ndarray) -> None:
        """Restores an export_state image. Restart path only: the bank must
        be quiesced (no concurrent producers). Read cursors are left as they
        were; the server's next step re-materializes its window and aligns
        them."""
        audio = np.ascontiguousarray(audio, np.float32)
        heads = np.ascontiguousarray(heads, np.uint64)
        gains = np.ascontiguousarray(gains, np.float32)
        if audio.shape != (self.n_streams, self.capacity):
            raise ValueError(
                f"audio image shape {audio.shape} != ({self.n_streams}, {self.capacity})"
            )
        if heads.shape != (self.n_streams,) or gains.shape != (self.n_streams,):
            raise ValueError(
                f"heads/gains shapes {heads.shape}/{gains.shape} != ({self.n_streams},)"
            )
        self._lib.pv_rb_import(self._handle, _fptr(audio), heads.ctypes.data_as(_u64p), _fptr(gains))

    def close(self) -> None:
        if self._handle:
            self._lib.pv_rb_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


class NativeResamplerBank:
    """Per-stream streaming polyphase resampling at ingest (the reference's
    rubato FftFixedIn stage, pitchvis_audio/src/audio_wasm.rs:176-209). One
    bank per input rate; the prototype filter comes from ops/resample.py."""

    def __init__(self, n_streams: int, sr_in: int, sr_out: int, taps_per_phase: int = 24):
        self._lib = load()
        self.spec = make_spec(sr_in, sr_out, taps_per_phase)
        h = np.ascontiguousarray(
            _design_prototype(self.spec.l, self.spec.m, taps_per_phase), np.float64
        )
        self._handle = ctypes.c_void_p(
            self._lib.pv_rs_create(n_streams, self.spec.l, self.spec.m, taps_per_phase, h.ctypes.data_as(_f64p))
        )
        self.n_streams = n_streams

    def process(self, stream: int, samples: np.ndarray) -> np.ndarray:
        """Feeds one chunk; returns the resampled samples now available
        (input not filling a whole M-block is carried to the next call)."""
        stream = _stream_id(stream, self.n_streams)
        samples = np.ascontiguousarray(samples, np.float32)
        out_cap = (len(samples) + self.spec.m) // self.spec.m * self.spec.l
        out = np.empty(out_cap, np.float32)
        n = self._lib.pv_rs_process(self._handle, stream, _fptr(samples), len(samples), _fptr(out), out_cap)
        if n < 0:
            raise RuntimeError("resampler output buffer undersized (bug)")
        return out[:n]

    def reset(self, stream: int) -> None:
        self._lib.pv_rs_reset(self._handle, _stream_id(stream, self.n_streams))

    def close(self) -> None:
        if self._handle:
            self._lib.pv_rs_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


def agc_process(gain: float, samples: np.ndarray, desired_rms: float,
                distortion: float, frozen: bool) -> float:
    """In-place native dagc recurrence; returns the updated gain."""
    if samples.dtype != np.float32 or not samples.flags.c_contiguous:
        raise ValueError("samples must be a C-contiguous float32 array")
    return float(
        load().pv_agc_process(gain, _fptr(samples), len(samples), desired_rms, distortion, int(frozen))
    )


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_f64p)


def synth_render(mix: np.ndarray, sample_rate: float, freq, phase, age,
                 released_at, amp, attack, decay, sustain, release,
                 harmonics) -> np.ndarray:
    """Native additive-voice render; mutates mix/phase/age in place, returns
    per-voice end-of-chunk gains. mix is float32 and every per-voice array
    float64, all C-contiguous (the native loop writes through them)."""
    n_voices = len(freq)
    gains = np.zeros(n_voices, np.float64)
    if n_voices == 0:
        return gains
    per_voice = (freq, phase, age, released_at, amp, attack, decay, sustain, release)
    if mix.dtype != np.float32 or not mix.flags.c_contiguous:
        raise ValueError("mix must be a C-contiguous float32 array")
    if any(a.dtype != np.float64 or a.shape != (n_voices,) or not a.flags.c_contiguous for a in per_voice):
        raise ValueError(f"per-voice arrays must be C-contiguous float64 ({n_voices},)")
    harmonics = np.ascontiguousarray(harmonics, np.float64)
    if harmonics.ndim != 2 or harmonics.shape[0] != n_voices:
        raise ValueError(f"harmonics must be ({n_voices}, n_harm), got {harmonics.shape}")
    load().pv_synth_render(
        _fptr(mix), len(mix), sample_rate, n_voices, *(_dptr(a) for a in per_voice),
        _dptr(harmonics), harmonics.shape[1], _dptr(gains),
    )
    return gains
