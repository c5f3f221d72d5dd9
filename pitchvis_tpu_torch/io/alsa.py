"""In-process microphone capture via ALSA (ctypes, no build step).

The reference's desktop capture opens the system's input device in-process
through cpal and pushes callback chunks into the ring buffer
(`pitchvis_audio/src/audio_desktop.rs:29-150`); `dump_input_devices`
enumerates the host's devices (audio_desktop.rs:36-48). On a Linux serving
host the native equivalent is ALSA's snd_pcm API, bound here with ctypes —
no compiled extension, gated at runtime on libasound availability (a GPU
server usually ships no sound stack: `available()` is False there and the
pipe/WAV drivers in `io.capture` remain the transport).

The binding surface is deliberately tiny — blocking interleaved float
reads: ``snd_pcm_open / snd_pcm_set_params / snd_pcm_readi /
snd_pcm_recover / snd_pcm_close`` plus the ``snd_device_name_hint`` trio
for listing. Tests exercise the full call discipline (short reads, an
injected overrun, error paths, hint iteration) against a stub libasound
built from the port's ``native/alsa_stub.c`` (:func:`stub_library_path`).

A copy of ``pitchvis_tpu/io/alsa.py``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

# snd_pcm_stream_t / snd_pcm_format_t / snd_pcm_access_t constants
_SND_PCM_STREAM_CAPTURE = 1
_SND_PCM_FORMAT_FLOAT_LE = 14
_SND_PCM_ACCESS_RW_INTERLEAVED = 3

_ENV_LIB = "PITCHVIS_ALSA_LIB"  # test hook: path to a stand-in libasound


def stub_library_path() -> str:
    """The stand-in libasound (``native/alsa_stub.c``) for tests and chip
    runs, built with gcc at first use (utils/host_build.py, under its lock,
    into build/pitchvis_tpu_torch/). Point ``PITCHVIS_ALSA_LIB`` at it, or
    pass it as ``lib_path``."""
    from ..utils import host_build

    return host_build.library_path("alsa_stub", language="c")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.snd_pcm_open.restype = ctypes.c_int
    lib.snd_pcm_open.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.snd_pcm_set_params.restype = ctypes.c_int
    lib.snd_pcm_set_params.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_int, ctypes.c_uint,
    ]
    lib.snd_pcm_readi.restype = ctypes.c_long
    lib.snd_pcm_readi.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong]
    lib.snd_pcm_recover.restype = ctypes.c_int
    lib.snd_pcm_recover.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.snd_pcm_close.restype = ctypes.c_int
    lib.snd_pcm_close.argtypes = [ctypes.c_void_p]
    lib.snd_strerror.restype = ctypes.c_char_p
    lib.snd_strerror.argtypes = [ctypes.c_int]
    lib.snd_device_name_hint.restype = ctypes.c_int
    lib.snd_device_name_hint.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_void_p)),
    ]
    lib.snd_device_name_get_hint.restype = ctypes.c_void_p  # malloc'd char*
    lib.snd_device_name_get_hint.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.snd_device_name_free_hint.restype = ctypes.c_int
    lib.snd_device_name_free_hint.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    return lib


_cache: dict[str, ctypes.CDLL | None] = {}


def _load(lib_path: str | None = None) -> ctypes.CDLL | None:
    path = lib_path or os.environ.get(_ENV_LIB) or "libasound.so.2"
    if path not in _cache:
        try:
            _cache[path] = _bind(ctypes.CDLL(path))
        except (OSError, AttributeError):
            _cache[path] = None
    return _cache[path]


def available(lib_path: str | None = None) -> bool:
    """True when a usable libasound (or the test stub) is loadable."""
    return _load(lib_path) is not None


def _strerror(lib: ctypes.CDLL, err: int) -> str:
    msg = lib.snd_strerror(int(err))
    return msg.decode() if msg else f"ALSA error {err}"


def list_input_devices(lib_path: str | None = None) -> list[dict[str, str]]:
    """Enumerates PCM devices (NAME/DESC/IOID hints), keeping capture-capable
    ones — IOID of None means the device does both directions."""
    lib = _load(lib_path)
    if lib is None:
        return []
    libc = ctypes.CDLL(None)
    hints = ctypes.POINTER(ctypes.c_void_p)()
    if lib.snd_device_name_hint(-1, b"pcm", ctypes.byref(hints)) < 0:
        return []
    out = []
    try:
        i = 0
        while hints[i]:
            hint = hints[i]
            i += 1
            fields = {}
            for key in (b"NAME", b"DESC", b"IOID"):
                ptr = lib.snd_device_name_get_hint(hint, key)
                if ptr:
                    fields[key.decode()] = ctypes.cast(ptr, ctypes.c_char_p).value.decode()
                    libc.free(ctypes.c_void_p(ptr))
            if fields.get("IOID", "Input") != "Input":
                continue  # playback-only
            out.append(fields)
    finally:
        lib.snd_device_name_free_hint(hints)
    return out


class AlsaCaptureDriver:
    """Blocking in-process microphone capture from an ALSA PCM device.

    Drop-in peer of `io.capture.RawPipeDriver` (same `read_chunk` /
    `stream_to` surface): chunks are float32 mono at `sr`, zero-padded at
    stream end never (a live device never EOFs — `read_chunk` returns None
    only on an unrecoverable error). ALSA's `soft_resample` converts
    hardware rates to `sr` device-side, so any mic serves the pipeline's
    22050 Hz directly (the reference requests its rate from cpal the same
    way, audio_desktop.rs:58-73).
    """

    def __init__(
        self,
        device: str = "default",
        sr: int = 22050,
        chunk_size: int = 368,
        latency_us: int = 50_000,
        lib_path: str | None = None,
    ):
        lib = _load(lib_path)
        if lib is None:
            raise RuntimeError(
                "libasound not available — use RawPipeDriver (arecord | demo --serve)"
            )
        self._lib = lib
        self.sr = int(sr)
        self.chunk_size = int(chunk_size)
        pcm = ctypes.c_void_p()
        err = lib.snd_pcm_open(
            ctypes.byref(pcm), device.encode(), _SND_PCM_STREAM_CAPTURE, 0
        )
        if err < 0:
            raise RuntimeError(f"snd_pcm_open({device!r}): {_strerror(lib, err)}")
        self._pcm = pcm
        err = lib.snd_pcm_set_params(
            pcm,
            _SND_PCM_FORMAT_FLOAT_LE,
            _SND_PCM_ACCESS_RW_INTERLEAVED,
            1,  # mono
            self.sr,
            1,  # soft_resample: let ALSA convert the hardware rate
            int(latency_us),
        )
        if err < 0:
            lib.snd_pcm_close(pcm)
            self._pcm = None
            raise RuntimeError(f"snd_pcm_set_params: {_strerror(lib, err)}")

    def read_chunk(self) -> np.ndarray | None:
        """One full chunk, looping over short device reads; overruns (-EPIPE
        after a scheduling stall) are recovered in place and the read
        continues — the lost audio shows up as a gap, exactly as the
        reference's callback misses do. Returns None only when recovery
        fails (device unplugged)."""
        buf = np.empty(self.chunk_size, np.float32)
        filled = 0
        while filled < self.chunk_size:
            view = buf[filled:]
            n = self._lib.snd_pcm_readi(
                self._pcm,
                view.ctypes.data_as(ctypes.c_void_p),
                len(view),
            )
            if n < 0:
                if self._lib.snd_pcm_recover(self._pcm, int(n), 1) < 0:
                    return None
                continue
            filled += int(n)
        return buf

    def stream_to(self, push, stream_idx: int = 0, max_chunks: int | None = None) -> int:
        n = 0
        while max_chunks is None or n < max_chunks:
            chunk = self.read_chunk()
            if chunk is None:
                return n
            push(stream_idx, chunk)
            n += 1
        return n

    def close(self) -> None:
        if getattr(self, "_pcm", None) is not None:
            self._lib.snd_pcm_close(self._pcm)
            self._pcm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
