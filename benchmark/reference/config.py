# Frozen copy of pitchvis_tpu_torch/core/config.py at commit 5c134db8c4ad,
# the plain reference of the benchmark: it imports nothing of the program.
"""Configuration dataclasses for the PyTorch/CUDA port.

A copy of ``pitchvis_tpu/core/config.py`` (the port imports nothing of the
JAX package). They mirror the capability surface of the reference's
parameter structs (`pitchvis_analysis/src/vqt.rs:180-348`,
`analysis.rs:35-98`) as plain frozen dataclasses: hashable, so a parameter
set keys the kernel cache (kernel/builder.py), and a parameter change is the
reference's debounced kernel rebuild
(`pitchvis_viewer/src/app/common.rs:1105-1165`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Defaults (reference: pitchvis_analysis/src/vqt.rs:180-214)
# ---------------------------------------------------------------------------

DEFAULT_SR: int = 22050
DEFAULT_N_FFT: int = 2 * 16384
DEFAULT_MIN_FREQ: float = 55.0
DEFAULT_UPSCALE_FACTOR: int = 1
DEFAULT_BUCKETS_PER_SEMITONE: int = 7 * DEFAULT_UPSCALE_FACTOR
DEFAULT_BUCKETS_PER_OCTAVE: int = 12 * DEFAULT_BUCKETS_PER_SEMITONE
DEFAULT_OCTAVES: int = 7
DEFAULT_SPARSITY_QUANTILE: float = 0.999
DEFAULT_Q: float = 1.6 / DEFAULT_UPSCALE_FACTOR
DEFAULT_GAMMA: float = 4.8 * DEFAULT_Q


@dataclass(frozen=True)
class VqtRange:
    """Frequency range and resolution of the VQT (vqt.rs:238-262)."""

    min_freq: float = DEFAULT_MIN_FREQ
    octaves: int = DEFAULT_OCTAVES
    buckets_per_octave: int = DEFAULT_BUCKETS_PER_OCTAVE

    @property
    def n_buckets(self) -> int:
        return self.buckets_per_octave * self.octaves


@dataclass(frozen=True)
class VqtParameters:
    """Full VQT configuration (vqt.rs:278-348).

    `quality` is librosa's ``filter_scale`` (scales window lengths via
    ``w = quality * sr / (alpha * f + gamma)``), not the effective quality
    factor f/delta-f.
    """

    sr: float = float(DEFAULT_SR)
    n_fft: int = DEFAULT_N_FFT
    range: VqtRange = dataclasses.field(default_factory=VqtRange)
    sparsity_quantile: float = DEFAULT_SPARSITY_QUANTILE
    quality: float = DEFAULT_Q
    gamma: float = DEFAULT_GAMMA

    @property
    def n_buckets(self) -> int:
        return self.range.n_buckets


# Per-binary overrides used by the reference (pitchvis_serial/src/main.rs:17-39,
# pitchvis_train/src/train.rs:30-41).
SERIAL_VQT_PARAMETERS = VqtParameters(
    sr=22050.0,
    n_fft=2 * 16384,
    range=VqtRange(min_freq=55.0, octaves=5, buckets_per_octave=36),
    sparsity_quantile=0.999,
    quality=1.8,
    gamma=4.8 * 1.8,
)

TRAIN_VQT_PARAMETERS = VqtParameters(
    sr=22050.0,
    n_fft=2 * 16384,
    range=VqtRange(min_freq=55.0, octaves=7, buckets_per_octave=36),
    sparsity_quantile=0.999,
    quality=10.0,
    gamma=5.3 * 10.0,
)


@dataclass(frozen=True)
class PeakDetectionParameters:
    """Peak finding thresholds (analysis_modules/peak_detection.rs:9-15)."""

    min_prominence: float = 10.0
    min_height: float = 4.0


@dataclass(frozen=True)
class AnalysisParameters:
    """Analysis-chain configuration (analysis.rs:35-98).

    Durations are seconds (the reference uses ``std::time::Duration``; we keep
    float seconds because they become f32 scalars inside the jitted step).
    """

    # unused, faithfully (analysis.rs:37-39: "currently unused within this
    # crate — the spectrogram display in the viewer keeps its own history
    # buffer"; the headless viewer's SpectrogramState does the same)
    spectrogram_length: int = 400
    peak_config: PeakDetectionParameters = dataclasses.field(
        default_factory=lambda: PeakDetectionParameters(10.0, 4.0)
    )
    bassline_peak_config: PeakDetectionParameters = dataclasses.field(
        default_factory=lambda: PeakDetectionParameters(5.0, 3.5)
    )
    highest_bassnote: int = 12 * 2 + 4
    vqt_smoothing_duration_base: float = 0.070
    vqt_smoothing_calmness_min: float = 0.6
    vqt_smoothing_calmness_max: float = 2.0
    note_calmness_smoothing_duration: float = 3.5
    scene_calmness_smoothing_duration: float = 0.8
    tuning_inaccuracy_smoothing_duration: float = 4.0
    harmonic_threshold: float = 0.3
    # Fixed capacity for the masked peak set (the reference's HashSet<usize>
    # is unbounded). 128 peaks is far beyond any musical spectrum at
    # min_prominence >= 5 dB over <= 588 bins.
    max_peaks: int = 128
    # Jacobi rounds for min-distance peak suppression (ops/peaks.py).
    # None (default) iterates to the exact greedy fixpoint (musical spectra
    # converge in <= 3 rounds). An int runs a fixed number of rounds with no
    # convergence check; adversarial decreasing-priority chains longer than
    # the bound then under-suppress, so the bounded mode is an opt-in speed
    # knob, not the default.
    suppress_iterations: int | None = None


@dataclass(frozen=True)
class AgcParameters:
    """Digital AGC configuration (dagc_fork/src/lib.rs:35-53; instantiated with
    desired_rms=0.07, distortion_factor=1e-4 at audio_desktop.rs:97)."""

    desired_output_rms: float = 0.07
    distortion_factor: float = 1e-4


@dataclass(frozen=True)
class ColorParameters:
    """Color-mapping configuration (pitchvis_colors/src/lib.rs:54-55)."""

    gray_level: float = 60.0
    easing_pow: float = 1.3
