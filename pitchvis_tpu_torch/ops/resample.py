"""Polyphase resampling: the prototype filter and the rate ratio.

A copy of the NumPy part of ``pitchvis_tpu/ops/resample.py``. The native
ingest resamplers (runtime/native.py::NativeResamplerBank) take their
coefficients from here, so they equal the JAX package's bit for bit.

For a rational ratio L/M (out/in): y[j] = sum_t h[phase_j + t*L] * x[m_j - t]
with m_j = floor(j*M/L), phase_j = (j*M) mod L, h a lowpass prototype of
length T*L scaled by L.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


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
        """Per-stream streaming history length (the last T-1 input
        samples)."""
        return self.taps_per_phase - 1


def make_spec(sr_in: int, sr_out: int, taps_per_phase: int = 24) -> ResamplerSpec:
    g = math.gcd(sr_in, sr_out)
    return ResamplerSpec(sr_in, sr_out, l=sr_out // g, m=sr_in // g, taps_per_phase=taps_per_phase)
