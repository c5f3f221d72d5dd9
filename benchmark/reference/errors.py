# Frozen copy of pitchvis_tpu_torch/core/errors.py at commit 5c134db8c4ad,
# the plain reference of the benchmark: it imports nothing of the program.
"""Typed construction errors, mirroring the reference's `VqtError`
(pitchvis_analysis/src/vqt.rs:350-366). A copy of
``pitchvis_tpu/core/errors.py``."""

from __future__ import annotations


class VqtError(ValueError):
    """Base class for VQT parameter validation errors."""


class AboveNyquistError(VqtError):
    def __init__(self, highest_frequency: float, nyquist_frequency: float):
        self.highest_frequency = highest_frequency
        self.nyquist_frequency = nyquist_frequency
        super().__init__(
            f"the highest VQT bin frequency ({highest_frequency} Hz) exceeds the "
            f"Nyquist frequency ({nyquist_frequency} Hz); reduce octaves or "
            f"increase the sample rate"
        )


class WindowExceedsNFftError(VqtError):
    def __init__(self, window_length: float, n_fft: int):
        self.window_length = window_length
        self.n_fft = n_fft
        super().__init__(
            f"the longest filter window ({window_length} samples) exceeds n_fft "
            f"({n_fft} samples); increase n_fft or gamma, or decrease quality"
        )
