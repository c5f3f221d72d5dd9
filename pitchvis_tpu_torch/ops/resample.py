"""Batched polyphase resampling.

Port of ``pitchvis_tpu/ops/resample.py``. The reference resamples WASM
microphone input (44.1/48 kHz) to 22050 Hz with rubato's `FftFixedIn`
(pitchvis_audio/src/audio_wasm.rs:176-209). The equivalent here is a
windowed-sinc polyphase resampler expressed as a gather and a short tap sum
per output sample, batched over streams, in plain PyTorch (the JAX package
computes it outside any kernel of its own). The native ingest resamplers
(runtime/native.py::NativeResamplerBank) take their coefficients from the
same prototype, so they equal the JAX package's bit for bit.

For a rational ratio L/M (out/in): y[j] = sum_t h[phase_j + t*L] * x[m_j - t]
with m_j = floor(j*M/L), phase_j = (j*M) mod L, h a lowpass prototype of
length T*L scaled by L. Chunk sizes are constrained to multiples of M so the
phase pattern is fixed per chunk (the streaming state is just the last T-1
input samples).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device


def _design_prototype(l: int, m: int, taps_per_phase: int) -> np.ndarray:
    """Windowed-sinc lowpass prototype for L-fold interpolation followed by
    M-fold decimation; cutoff at min(1/L, 1/M) of the upsampled Nyquist with
    a small rolloff margin, Blackman-Harris windowed."""
    n_taps = taps_per_phase * l
    cutoff = 0.95 * min(1.0 / l, 1.0 / m)  # fraction of upsampled rate /2 pairs
    t = np.arange(n_taps) - (n_taps - 1) / 2.0
    sinc = np.sinc(cutoff * t)
    w = (
        0.35875
        - 0.48829 * np.cos(2 * np.pi * np.arange(n_taps) / (n_taps - 1))
        + 0.14128 * np.cos(4 * np.pi * np.arange(n_taps) / (n_taps - 1))
        - 0.01168 * np.cos(6 * np.pi * np.arange(n_taps) / (n_taps - 1))
    )
    h = sinc * w
    # exact DC normalization (sum over each phase ~ 1). This single rescale
    # subsumes the textbook `h *= cutoff` (lowpass gain) and `h *= l`
    # (zero-stuffing compensation) steps — any prior uniform scaling would
    # be cancelled here, so none is applied.
    h /= np.sum(h) / l
    return h.astype(np.float64)


@dataclass(frozen=True)
class ResamplerSpec:
    sr_in: int
    sr_out: int
    l: int
    m: int
    taps_per_phase: int

    @property
    def history_len(self) -> int:
        """Per-stream streaming history length — what init_state allocates
        and process() carries (the last T-1 input samples)."""
        return self.taps_per_phase - 1


def make_spec(sr_in: int, sr_out: int, taps_per_phase: int = 24) -> ResamplerSpec:
    g = math.gcd(sr_in, sr_out)
    return ResamplerSpec(sr_in, sr_out, l=sr_out // g, m=sr_in // g, taps_per_phase=taps_per_phase)


class PolyphaseResampler:
    """Streaming batched resampler: fixed input chunks (multiple of M) ->
    fixed output chunks of n_in * L / M samples. Its taps and gather indices
    live on ``device``, the card unless ``device="cpu"``."""

    def __init__(self, sr_in: int, sr_out: int, chunk_in: int, taps_per_phase: int = 24, device="cuda"):
        self.device = resolve_device(device)
        self.spec = make_spec(sr_in, sr_out, taps_per_phase)
        l, m, t = self.spec.l, self.spec.m, taps_per_phase
        if chunk_in % m != 0:
            raise ValueError(f"chunk_in must be a multiple of {m} for sr {sr_in}->{sr_out}")
        self.chunk_in = chunk_in
        self.chunk_out = chunk_in * l // m

        # group delay: the prototype peaks at (n_taps-1)/2 upsampled ticks
        self.delay_secs = (t * l - 1) / 2.0 / (l * sr_in)

        # the (n_out, T) tables are built on the device from the (T*L,)
        # float64 prototype: only the prototype crosses from the host (a
        # whole file's tables are hundreds of MB)
        h = torch.from_numpy(_design_prototype(l, m, t)).to(self.device)
        ti = torch.arange(t, dtype=torch.int64, device=self.device)
        pos = torch.arange(self.chunk_out, dtype=torch.int64, device=self.device) * m  # upsampled grid
        m_j = pos // l  # input-sample index of phase start
        phase = pos % l
        # h index for tap t_i: phase + t_i * l ; input index: m_j - t_i
        self._taps = h[phase[:, None] + ti * l].to(torch.float32)  # (n_out, T)
        # gather indices into [history | chunk] of length T-1 + chunk_in:
        # absolute input index (m_j - ti) maps to offset (T-1) + m_j - ti >= 0
        self._idx = (t - 1) + m_j[:, None] - ti  # (n_out, T)

    def init_state(self, n_streams: int) -> torch.Tensor:
        """History: the last T-1 input samples per stream."""
        return torch.zeros((n_streams, self.spec.taps_per_phase - 1), dtype=torch.float32, device=self.device)

    def process(self, history: torch.Tensor, chunk: torch.Tensor):
        """(B, T-1) history + (B, chunk_in) -> (new history, (B, chunk_out)).
        The tap sum is an elementwise product summed over the taps in
        float32 (never a TF32 product on the card)."""
        if chunk.shape[-1] != self.chunk_in:
            raise ValueError(f"chunk has {chunk.shape[-1]} samples, the resampler takes {self.chunk_in}")
        ext = torch.cat([history, chunk], dim=-1)  # (B, T-1+chunk_in)
        windows = ext[:, self._idx]  # (B, n_out, T)
        out = (windows * self._taps).sum(-1)
        new_history = ext[:, -(self.spec.taps_per_phase - 1) :]
        return new_history, out


def resample(x: np.ndarray, sr_in: int, sr_out: int, taps_per_phase: int = 24, device="cuda") -> np.ndarray:
    """Offline convenience: resample (..., n) host audio on ``device`` (the
    card unless ``device="cpu"``), trimming to a multiple of M. Returns host
    audio, (B, n_out) float32."""
    spec = make_spec(sr_in, sr_out, taps_per_phase)
    x = np.atleast_2d(np.asarray(x, np.float32))
    n = (x.shape[-1] // spec.m) * spec.m
    rs = PolyphaseResampler(sr_in, sr_out, n, taps_per_phase, device=device)
    chunk = torch.from_numpy(np.ascontiguousarray(x[..., :n])).to(rs.device)
    _, out = rs.process(rs.init_state(x.shape[0]), chunk)
    return out.cpu().numpy()


class FftChunkResampler:
    """Streaming FFT-domain resampler — the algorithm family of rubato's
    `FftFixedIn` (pitchvis_audio/src/audio_wasm.rs:176-209): fixed-size
    input chunks are windowed, rFFT'd, the spectrum is multiplied by an
    antialiasing rolloff and truncated (or zero-padded) to the output
    length, inverse-transformed at the new rate, and windowed-overlap-added.

    The independent validation oracle for the serving-path
    `PolyphaseResampler` — a from-scratch second implementation of the
    reference's resampling design, agreeing with the polyphase to within the
    filters' passband spec. Host-side f64 NumPy by design (a copy of the JAX
    package's); the serving path stays polyphase.

    Structure: FFT sizes n_in = c*M and n_out = c*L span the SAME wall-clock
    interval at the two rates; 50%-overlapped sqrt-Hann analysis/synthesis
    windows give exact COLA, so apart from the antialiasing filter the
    round trip is an identity on band-limited content.
    """

    def __init__(self, sr_in: int, sr_out: int, c: int = 32, cutoff: float = 0.95):
        g = math.gcd(sr_in, sr_out)
        l, m = sr_out // g, sr_in // g
        while (c * l) % 2 or (c * m) % 2 or c * m < 4096:
            c *= 2
        self.sr_in, self.sr_out = sr_in, sr_out
        self._l, self._m = l, m
        self.n_in, self.n_out = c * m, c * l
        self.h_in, self.h_out = self.n_in // 2, self.n_out // 2

        def sqrt_hann(n: int) -> np.ndarray:
            return np.sqrt(0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n))

        self._w_in = sqrt_hann(self.n_in)
        self._w_out = sqrt_hann(self.n_out)

        # antialiasing rolloff below the tighter Nyquist (rubato's `cutoff`):
        # unity passband, raised-cosine transition from cutoff*nyq to nyq.
        n_bins = min(self.n_in // 2 + 1, self.n_out // 2 + 1)
        f = np.arange(n_bins) * sr_in / self.n_in
        nyq = 0.5 * min(sr_in, sr_out)
        filt = np.ones(n_bins)
        hi = f >= nyq
        trans = (f >= cutoff * nyq) & ~hi
        filt[trans] = 0.5 + 0.5 * np.cos(
            np.pi * (f[trans] - cutoff * nyq) / (nyq - cutoff * nyq)
        )
        filt[hi] = 0.0
        self._filt = filt
        self._n_bins = n_bins

        # streaming state: pending input + synthesis overlap tail
        self._pending = np.zeros(0, np.float64)
        self._ola = np.zeros(self.n_out - self.h_out, np.float64)

    @property
    def delay_secs(self) -> float:
        """Windowed OLA adds no filter delay; the first analysis window is
        centered h_in samples in, so output sample 0 corresponds to input
        sample 0 once the first half-window warmup is discarded."""
        return 0.0

    def process(self, chunk: np.ndarray) -> np.ndarray:
        """Feed input samples; returns whatever output samples completed.
        The first h_out returned samples are the half-window warmup ramp."""
        self._pending = np.concatenate([self._pending, np.asarray(chunk, np.float64)])
        outs = []
        while len(self._pending) >= self.n_in:
            seg = self._pending[: self.n_in]
            self._pending = self._pending[self.h_in :]
            spec = np.fft.rfft(seg * self._w_in)
            out_spec = np.zeros(self.n_out // 2 + 1, np.complex128)
            out_spec[: self._n_bins] = spec[: self._n_bins] * self._filt
            y = np.fft.irfft(out_spec, self.n_out) * (self.n_out / self.n_in)
            y *= self._w_out
            y[: self.n_out - self.h_out] += self._ola
            outs.append(y[: self.h_out])
            self._ola = y[self.h_out :]
        if outs:
            return np.concatenate(outs)
        return np.zeros(0, np.float64)

    def reset(self) -> None:
        """Clears the streaming state (pending input + synthesis tail)."""
        self._pending = np.zeros(0, np.float64)
        self._ola = np.zeros(self.n_out - self.h_out, np.float64)

    def resample(self, x: np.ndarray) -> np.ndarray:
        """Offline: resample a full 1-D signal, time-aligned so y[j]
        estimates x at t = j / sr_out. A half-window zero lead-in completes
        the COLA sum at the signal start; the tail is flushed with zeros.
        Resets the streaming state first, so repeated calls on one instance
        are independent (a leftover pending/OLA tail from a previous signal
        would otherwise shift the window grid and contaminate the start)."""
        self.reset()
        x = np.asarray(x, np.float64)
        pad = np.zeros(self.h_in)
        y = self.process(np.concatenate([pad, x, pad, pad]))
        n_exp = len(x) * self._l // self._m
        return y[self.h_out : self.h_out + n_exp]
