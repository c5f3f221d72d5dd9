"""WAV loading and saving (stdlib and NumPy only).

A copy of ``pitchvis_tpu/io/wav.py``."""

from __future__ import annotations

import wave

import numpy as np


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Reads a WAV file -> (mono float32 samples in [-1, 1], sample_rate).
    Multi-channel input is downmixed by averaging (like the reference's
    mono downmix, train.rs:296-298).

    Malformed files raise ``ValueError`` — the same typed-rejection contract
    as the SMF/SF2 parsers (corrupted headers, zero channels/rate, torn
    sample data are all ValueError, never wave.Error/EOFError or numpy
    reshape crashes)."""
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(n)
    except (wave.Error, EOFError, RuntimeError) as e:
        # RuntimeError: the stdlib chunk reader raises it bare on corrupt
        # chunk sizes that seek out of bounds (wave.py:158)
        raise ValueError(f"malformed WAV: {e}") from e
    if ch <= 0 or sr <= 0:
        raise ValueError(f"malformed WAV: {ch} channels at {sr} Hz")
    # a truncated data chunk yields a torn final frame: drop it
    frame_bytes = width * ch
    raw = raw[: len(raw) - len(raw) % frame_bytes] if frame_bytes else b""
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def save_wav(path: str, samples: np.ndarray, sr: int) -> None:
    """Writes mono float32 [-1, 1] samples as 16-bit PCM."""
    pcm = np.clip(np.asarray(samples) * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def frames_from_signal(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Slices a signal into overlapping (n_frames, n_fft) analysis frames,
    zero-padded at the start so the first frame ends at sample hop-1
    (matching a ring buffer that starts zeroed)."""
    x = np.asarray(x, np.float32)
    padded = np.concatenate([np.zeros(n_fft, np.float32), x])
    n_frames = max(0, len(x) // hop)
    idx = np.arange(n_fft)[None, :] + (np.arange(n_frames)[:, None] + 1) * hop
    # max index = n_frames*hop + n_fft - 1 <= len(padded) - 1 by construction
    assert n_frames == 0 or idx[-1, -1] < len(padded)
    return padded[idx]
