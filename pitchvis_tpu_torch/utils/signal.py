"""Synthetic test-signal generation (pitchvis_analysis/src/util.rs:61-79).

A copy of ``pitchvis_tpu/utils/signal.py`` (NumPy only)."""

from __future__ import annotations

import numpy as np

from ..core.config import VqtParameters


def create_sines(params: VqtParameters, freqs, t_diff: float = 0.0) -> np.ndarray:
    """n_fft-sample mixture of sines at `freqs`, each with amplitude 1/12,
    shifted in time by `t_diff` seconds (util.rs:61-79)."""
    i = np.arange(params.n_fft, dtype=np.float64)
    wave = np.zeros(params.n_fft, dtype=np.float64)
    for f in np.atleast_1d(freqs):
        wave += np.sin((i + t_diff * params.sr) * 2.0 * np.pi / params.sr * f) / 12.0
    return wave.astype(np.float32)


def create_sines_batch(params: VqtParameters, freqs_list, t_diff: float = 0.0) -> np.ndarray:
    """Batch of sine mixtures: one row per entry of freqs_list."""
    return np.stack([create_sines(params, fs, t_diff) for fs in freqs_list])
