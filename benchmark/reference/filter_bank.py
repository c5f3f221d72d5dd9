# Frozen copy of pitchvis_tpu_torch/kernel/builder.py at commit 5c134db8c4ad,
# the plain reference of the benchmark: it imports nothing of the program.
# Left out of this copy: the dense TPU packings (w_freq, w_time), the disk cache,
# get_kernel and kernel_stats; the filter banks are built as in the program.
"""Host-side VQT kernel construction.

A copy of ``pitchvis_tpu/kernel/builder.py`` (NumPy only; the port imports
nothing of the JAX package) whose disk cache lives in its own subdirectory,
so the two packages never read each other's cache files. The weights it
builds are byte-identical to the JAX package's (tests/test_torch_kernel_builder.py).

Builds the variable-Q filter bank once on the host with NumPy and packs it
into dense matrices for batched matrix products. The construction semantics mirror
the reference implementation (`pitchvis_analysis/src/vqt.rs:517-852`):

* per-bin center frequency ``f_k = min_freq * 2^(k / buckets_per_octave)``
* window length ``w = Q * sr / (alpha * f + gamma)`` with
  ``alpha = (r^2 - 1) / (r^2 + 1)``, ``r = 2^(1/buckets_per_octave)``
* per-bin power-of-two downsampling factor with a 15% anti-Gibbs margin
* Hann-windowed complex exponential filters, L1-normalized in time domain,
  FFT'd, conjugated, sparsified to keep ``sparsity_quantile`` of the L1 mass
* filters grouped by downsampling factor, groups merged by shared input
  window; decimation is performed purely by frequency-domain index remapping
  with the 1/M decimation factor folded into the kernel values
* coefficients beyond the decimated Nyquist are negative-frequency sidelobes
  handled via a conjugate-part matrix using ``X[N-k] = conj(X[k])``
* -3 dB bandwidth-gap validation with warnings (vqt.rs:695-710)

The TPU packings of the program's copy (dense time- and frequency-domain
matrices) and its disk cache are left out of this copy: the reference
applies the complex filter banks to the FFT of each window.

Integer placement decisions (window boundaries, rounded window lengths) are
computed in float32 to match the reference's f32 arithmetic exactly; filter
values themselves are computed in float64 for accuracy and cast to f32.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass

import numpy as np

from .config import VqtParameters
from .errors import AboveNyquistError, WindowExceedsNFftError

log = logging.getLogger(__name__)

GRACE_FACTOR = np.float32(1.15)  # anti-Gibbs margin (vqt.rs:545)


@dataclass(frozen=True)
class FilterParams:
    """Per-filter parameters (vqt.rs:370-384)."""

    freq: float
    window_length: float
    sr_downscaling_factor: int
    minimum_needed_window_size: int


@dataclass
class WindowGroup:
    """A set of filters applied to the FFT of one shared input window
    (vqt.rs:388-404), plus the TPU matmul packings.

    Attributes:
      window: (begin, end) of the input slice relative to an n_fft buffer
        whose last sample is "now".
      row_offset: index of this group's first filter in the global bin order.
      n_filters: number of filters (rows) in this group.
      filter_bank: dense complex128 (n_filters, n_spec) positive-frequency
        kernel over the half spectrum of the window's real FFT.
      negative_filter_bank: dense complex128 (n_filters, n_spec) conjugate
        part (all zeros if no filter has negative-frequency coefficients).
      downscaling_factors: downsampling factor for each filter row.
    """

    window: tuple[int, int]
    row_offset: int
    n_filters: int
    filter_bank: np.ndarray
    negative_filter_bank: np.ndarray
    downscaling_factors: np.ndarray

    @property
    def window_size(self) -> int:
        return self.window[1] - self.window[0]

    @property
    def n_spectrum(self) -> int:
        return self.window_size // 2 + 1

    @property
    def has_negative_part(self) -> bool:
        return bool(np.any(self.negative_filter_bank != 0))

    def nnz(self) -> int:
        return int(np.count_nonzero(self.filter_bank))

    def nnz_negative(self) -> int:
        return int(np.count_nonzero(self.negative_filter_bank))


@dataclass
class VqtKernel:
    """The precomputed VQT kernel (vqt.rs:413-415) plus metadata."""

    params: VqtParameters
    window_groups: list[WindowGroup]
    delay_secs: float
    filter_params: list[FilterParams]
    bandwidths_hz: np.ndarray  # (n_buckets, 2) -3 dB band edges
    coverage_gaps: list[tuple[float, float, float]]  # (freq, band_lo, prev_hi)

    @property
    def n_buckets(self) -> int:
        return self.params.n_buckets


def filter_bank_params(params: VqtParameters) -> list[FilterParams]:
    """Per-filter center frequencies, window lengths, and multi-rate
    constraints (vqt.rs:517-587). Uses f32 arithmetic where the reference's
    integer decisions depend on it."""
    rng = params.range
    n_buckets = rng.n_buckets
    sr = np.float32(params.sr)

    highest_frequency = np.float32(rng.min_freq) * np.float32(2.0) ** (
        np.float32(n_buckets - 1) / np.float32(rng.buckets_per_octave)
    )
    nyquist = sr / np.float32(2.0)
    if highest_frequency > nyquist:
        raise AboveNyquistError(float(highest_frequency), float(nyquist))

    # alpha such that adjacent filters meet at their -3 dB points.
    r = np.float32(2.0) ** (np.float32(1.0) / np.float32(rng.buckets_per_octave))
    alpha = (r * r - np.float32(1.0)) / (r * r + np.float32(1.0))

    filters: list[FilterParams] = []
    for k in range(n_buckets):
        freq = np.float32(rng.min_freq) * np.float32(2.0) ** (
            np.float32(k) / np.float32(rng.buckets_per_octave)
        )
        window_length = np.float32(params.quality) * sr / (alpha * freq + np.float32(params.gamma))

        # Keep the downsampled Nyquist 15% above the theoretically needed one.
        # Top frequencies in (sr/2.3, sr/2] pass the Nyquist check but make
        # the log negative — saturate to no downscaling like the Rust `as`
        # cast (a bare 1 << k_down would raise on the negative shift).
        minimum_scaled_sr = np.ceil(freq * np.float32(2.0) * GRACE_FACTOR)
        k_down = max(0, int(np.floor(np.log2(sr / minimum_scaled_sr))))
        sr_downscaling_factor = 1 << k_down

        # Largest power-of-two reduction of n_fft still containing the window.
        # (Rust `as u32` saturates negative floats to 0; the window-exceeds-
        # n_fft case is caught by the explicit validation below.)
        k_win = max(0, int(np.floor(np.log2(np.float32(params.n_fft) / window_length))))
        minimum_needed_window_size = params.n_fft >> k_win

        filters.append(
            FilterParams(
                freq=float(freq),
                window_length=float(window_length),
                sr_downscaling_factor=sr_downscaling_factor,
                minimum_needed_window_size=minimum_needed_window_size,
            )
        )

    if filters[0].window_length > params.n_fft:
        raise WindowExceedsNFftError(filters[0].window_length, params.n_fft)
    return filters


def _chunk_by(items: list, key) -> list[list]:
    """Group a list into contiguous runs with equal key (Rust `chunk_by`)."""
    out: list[list] = []
    for it in items:
        if out and key(out[-1][-1]) == key(it):
            out[-1].append(it)
        else:
            out.append([it])
    return out


def _hann(n: int) -> np.ndarray:
    """Symmetric Hann window (apodize::hanning_iter semantics: endpoints 0,
    denominator n-1)."""
    if n == 1:
        return np.ones(1)
    i = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))


@dataclass
class _Filter:
    v_frequency_domain: np.ndarray  # complex128, length scaled_n_fft
    bandwidth_3db_in_hz: tuple[float, float]


def _calculate_filter(
    sr: float,
    sparsity_quantile: float,
    sr_scaling: int,
    fp: FilterParams,
    group_window: tuple[int, int],
    window_center: float,
) -> _Filter:
    """One filter of the bank at its rate group's downsampled rate
    (vqt.rs:769-852)."""
    scaled_freq = fp.freq * sr_scaling
    scaled_window_length = np.float32(fp.window_length) / np.float32(sr_scaling)
    # Rust f32::round rounds half away from zero.
    scaled_window_length_rounded = int(np.floor(scaled_window_length + np.float32(0.5)))
    scaled_window_center = (np.float32(window_center) - np.float32(group_window[0])) / np.float32(
        sr_scaling
    )
    scaled_window_center_rounded = int(np.floor(scaled_window_center))
    scaled_n_fft = (group_window[1] - group_window[0]) // sr_scaling

    assert scaled_window_length_rounded <= scaled_n_fft
    filter_begin = scaled_window_center_rounded - scaled_window_length_rounded // 2
    assert filter_begin >= 0, "filter window must fit after the start of its group window"
    assert filter_begin + scaled_window_length_rounded <= scaled_n_fft

    # Hann-windowed complex exponential centered on the common window center.
    n = scaled_window_length_rounded
    i = np.arange(n, dtype=np.float64)
    wavelet = _hann(n) * np.exp(2j * np.pi * i * scaled_freq / sr)

    v = np.zeros(scaled_n_fft, dtype=np.complex128)
    v[filter_begin : filter_begin + n] = wavelet

    # L1 normalization in the time domain.
    v /= np.abs(v).sum()

    # Frequency domain; conjugate for correlation instead of convolution.
    v = np.conj(np.fft.fft(v))

    response = np.abs(v)
    bandwidth = _calculate_bandwidth(response, sr / sr_scaling)

    # Sparsify: zero the smallest coefficients carrying (1 - quantile) of the
    # L1 mass (vqt.rs:822-846). The reference accumulates sorted values until
    # reaching the limit; cumsum reproduces that sequential accumulation.
    sorted_resp = np.sort(response)
    total = sorted_resp.sum()
    limit = (1.0 - sparsity_quantile) * total
    cumsum = np.cumsum(sorted_resp)
    # clamp: pairwise-summed `total` can exceed the sequential cumsum's last
    # entry by an ulp (and quantile<=0 makes limit==total), in which case
    # searchsorted returns len(cumsum) and the +1 would index past the end
    cutoff_idx = (
        0 if limit <= 0.0
        else min(int(np.searchsorted(cumsum, limit, side="left")) + 1, len(sorted_resp))
    )
    cutoff_value = 0.0 if cutoff_idx == 0 else sorted_resp[cutoff_idx - 1]
    v[response < cutoff_value] = 0.0

    return _Filter(v_frequency_domain=v, bandwidth_3db_in_hz=bandwidth)


def _find_3db_points(response: np.ndarray, center: int) -> tuple[int, int]:
    """-3 dB points of a frequency response (vqt.rs:962-978)."""
    threshold = response[center] / math.sqrt(2.0)
    lo = center
    while lo > 0 and response[lo] > threshold:
        lo -= 1
    hi = center
    while hi < len(response) - 1 and response[hi] > threshold:
        hi += 1
    return lo, hi


def _calculate_bandwidth(scaled_response: np.ndarray, scaled_sr: float) -> tuple[float, float]:
    center = int(np.argmax(scaled_response))
    lo, hi = _find_3db_points(scaled_response, center)
    n = len(scaled_response)
    return (lo * scaled_sr / n, hi * scaled_sr / n)


def build_kernel(params: VqtParameters) -> VqtKernel:
    """Builds the full VQT kernel (vqt.rs:599-759) and packs TPU matmul
    weights. Pure host-side NumPy; call once per parameter set (cached via
    :func:`get_kernel`)."""
    filters = filter_bank_params(params)

    max_window_length = np.float32(filters[0].window_length)
    window_center = float(np.float32(params.n_fft) - max_window_length / np.float32(2.0))

    # Rate groups: contiguous runs sharing one downsampling factor.
    rate_groups = _chunk_by(filters, key=lambda f: f.sr_downscaling_factor)

    rg_entries = []  # (factor, window, filters)
    for group in rate_groups:
        window_size = max(fp.minimum_needed_window_size for fp in group)
        half = np.float32(window_size) / np.float32(2.0)
        if float(np.float32(window_center) + half) < params.n_fft:
            window = (
                int(np.float32(window_center) - half),
                int(np.float32(window_center) + half),
            )
        else:
            window = (params.n_fft - window_size, params.n_fft)
        rg_entries.append((group[0].sr_downscaling_factor, window, group))

    kernel_gain = float(np.sqrt(np.float32(params.sr)))

    bandwidths = np.zeros((params.n_buckets, 2))
    coverage_gaps: list[tuple[float, float, float]] = []
    last_upper_bandwidth = 0.0

    # Merge rate groups that share the same window; each merged group shares
    # one FFT (or one time-domain matmul) at runtime.
    window_groups: list[WindowGroup] = []
    row_offset = 0
    bin_idx = 0
    merged = _chunk_by(rg_entries, key=lambda e: e[1])
    for window_chunk in merged:
        window = window_chunk[0][1]
        window_size = window[1] - window[0]
        n_spectrum = window_size // 2 + 1
        n_filters = sum(len(entry[2]) for entry in window_chunk)

        log.debug(
            "window %s (%d samples): %d filters in %d rate group(s)",
            window,
            window_size,
            n_filters,
            len(window_chunk),
        )

        mat = np.zeros((n_filters, n_spectrum), dtype=np.complex128)
        neg_mat = np.zeros((n_filters, n_spectrum), dtype=np.complex128)
        factors = np.zeros(n_filters, dtype=np.int64)
        row = 0
        for m, _win, group_filters in window_chunk:
            scaled_n_fft = window_size // m
            for fp in group_filters:
                filt = _calculate_filter(
                    params.sr, params.sparsity_quantile, m, fp, window, window_center
                )
                bandwidths[bin_idx] = filt.bandwidth_3db_in_hz
                if last_upper_bandwidth > 0.0 and filt.bandwidth_3db_in_hz[0] > last_upper_bandwidth:
                    coverage_gaps.append(
                        (fp.freq, filt.bandwidth_3db_in_hz[0], last_upper_bandwidth)
                    )
                    log.warning(
                        "coverage gap below the filter at %.1f Hz: its -3 dB band "
                        "starts at %.2f Hz but the previous filter's band ends at "
                        "%.2f Hz; decrease quality to close the gap",
                        fp.freq,
                        filt.bandwidth_3db_in_hz[0],
                        last_upper_bandwidth,
                    )
                last_upper_bandwidth = filt.bandwidth_3db_in_hz[1]

                # Remap decimated-spectrum coefficients onto the half spectrum
                # of the *unscaled* window: decimated bin j and full-spectrum
                # bin j have the same frequency, and
                # FFT_decimated[j] = FFT_full[j] / m, so 1/m (together with
                # the 1/scaled_n_fft correlation normalization, i.e.
                # 1/window_size in total) folds into the kernel values.
                # Coefficients beyond the decimated Nyquist index negative
                # frequencies: contribution c * conj(X_half[scaled_n_fft - j])
                # accumulated as conj(conj(c) * X_half[...]) via the
                # conjugate-part matrix (vqt.rs:712-735).
                values = filt.v_frequency_domain * (kernel_gain / window_size)
                nz = np.nonzero(values)[0]
                pos = nz[nz <= scaled_n_fft // 2]
                neg = nz[nz > scaled_n_fft // 2]
                mat[row, pos] = values[pos]
                neg_mat[row, scaled_n_fft - neg] = np.conj(values[neg])

                factors[row] = m
                row += 1
                bin_idx += 1

        log.debug(
            "window %s: kernel nnz %d, conjugate-part nnz %d",
            window,
            np.count_nonzero(mat),
            np.count_nonzero(neg_mat),
        )

        window_groups.append(
            WindowGroup(
                window=window,
                row_offset=row_offset,
                n_filters=n_filters,
                filter_bank=mat,
                negative_filter_bank=neg_mat,
                downscaling_factors=factors,
            )
        )
        row_offset += n_filters

    delay_secs = (params.n_fft - window_center) / params.sr
    log.info("VQT analysis delay: %.1f ms", 1000.0 * delay_secs)

    return VqtKernel(
        params=params,
        window_groups=window_groups,
        delay_secs=delay_secs,
        filter_params=filters,
        bandwidths_hz=bandwidths,
        coverage_gaps=coverage_gaps,
    )
