"""The per-frame analysis chain, batched over streams.

Port of ``pitchvis_tpu/models/analysis.py``: `AnalysisState::preprocess`
(pitchvis_analysis/src/analysis.rs:288-404) and its modules: calmness
(analysis_modules/calmness.rs), afterglow + peak filter
(analysis_modules/afterglow.rs), pitch accuracy / tuning
(analysis_modules/pitch_analysis.rs). Where the JAX package vmaps a
per-frame step, every function here carries the stream axis first: state
tensors are (B, n) per-bin or (B,) per-stream. :func:`analysis_step` is the
per-frame entry point, one stream through the batched step.

The discrete peak masks come finished from the peaks kernel
(ops/peaks_pallas.py::find_peaks_masks), two launches a hop: the smoothed
spectrum with the bassline and the general configuration, the raw spectrum
with the general one. Each equals the JAX package's ``find_peaks_mask`` fed by
``prominences_compact``: that prefilter by ``min_height`` changes no mask,
because prominence is read only at local maxima at or above the
configuration's own ``min_height``. The min-distance suppression runs inside
the kernel, so the step never synchronises with the host.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core.config import AnalysisParameters, VqtRange
from ..core.device import resolve_device
from ..ops.peaks import _shift, enhance_peaks_continuous, promote_bass_peaks
from ..ops.peaks_pallas import find_peaks_masks
from ..utils.ema import ema_update
from ..utils.profiling import annotate
from ..utils.rounding import exact_div, rust_round


@dataclass
class AnalysisState:
    """Carry state of the analysis chain (analysis.rs:119-177), batched:
    per-bin leaves are (B, n) f32, per-stream scalars (B,) f32."""

    x_vqt_smoothed: torch.Tensor
    x_vqt_afterglow: torch.Tensor
    calmness: torch.Tensor
    released_note_calmness: torch.Tensor
    scene_calmness: torch.Tensor
    tuning_inaccuracy: torch.Tensor

    @classmethod
    def init(cls, n_buckets: int, device="cuda") -> "AnalysisState":
        """One stream's fresh state (per-bin leaves (n,), per-stream ()),
        for :func:`analysis_step`."""
        return _row(init_state_batch(1, n_buckets, device=device), 0)


def _row(tree, i: int):
    """Row ``i`` of every leaf of a batched state or outputs dataclass."""
    return type(tree)(**{f.name: getattr(tree, f.name)[i] for f in fields(tree)})


@dataclass
class AnalysisOutputs:
    """Per-frame outputs consumed by display / serial / ML stages."""

    x_vqt_smoothed: torch.Tensor
    x_vqt_peakfiltered: torch.Tensor
    x_vqt_afterglow: torch.Tensor
    peaks: torch.Tensor  # bool mask of discrete peaks
    peak_center: torch.Tensor  # continuous center per peak bin (frac bins)
    peak_size: torch.Tensor  # continuous (bass-promoted) size per peak bin, dB
    calmness: torch.Tensor
    pitch_accuracy: torch.Tensor
    pitch_deviation: torch.Tensor
    scene_calmness: torch.Tensor  # (B,)
    tuning_inaccuracy: torch.Tensor  # (B,), cents


def init_state_batch(n_streams: int, n_buckets: int, device="cuda") -> AnalysisState:
    device = resolve_device(device)
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return AnalysisState(
        x_vqt_smoothed=z(n_streams, n_buckets),
        x_vqt_afterglow=z(n_streams, n_buckets),
        calmness=z(n_streams, n_buckets),
        released_note_calmness=z(n_streams, n_buckets),
        scene_calmness=z(n_streams),
        tuning_inaccuracy=z(n_streams),
    )


def _smoothing_horizons(
    params: AnalysisParameters, rng: VqtRange, scene_calmness: torch.Tensor
) -> torch.Tensor:
    """Per-bin EMA horizons in seconds (analysis.rs:196-208, 291-323):
    base * frequency multiplier (1.5 bass -> 1.0 treble) * calmness
    multiplier (0.6 energetic -> 2.0 calm), truncated to whole ms like the
    reference's Duration::from_millis(duration_ms as u64). base == 0 means
    passthrough (horizon 0). scene_calmness: (B,) -> (B, n)."""
    n = rng.n_buckets
    device = scene_calmness.device
    octave_fraction = exact_div(
        torch.arange(n, dtype=torch.float32, device=device), rng.buckets_per_octave * rng.octaves
    )
    freq_mult = 1.5 - 0.5 * octave_fraction
    calm_mult = params.vqt_smoothing_calmness_min + (
        params.vqt_smoothing_calmness_max - params.vqt_smoothing_calmness_min
    ) * scene_calmness
    base_ms = params.vqt_smoothing_duration_base * 1000.0
    horizon_ms = torch.floor(base_ms * freq_mult * calm_mult[:, None])
    if base_ms > 0.0:
        return exact_div(horizon_ms, 1000.0)
    return torch.zeros_like(horizon_ms)


def _update_calmness(
    params: AnalysisParameters,
    rng: VqtRange,
    x_vqt: torch.Tensor,
    x_smoothed: torch.Tensor,
    dt: torch.Tensor,
    calmness: torch.Tensor,
    released: torch.Tensor,
    scene: torch.Tensor,
    peak_mask: torch.Tensor,
):
    """Per-bin + scene calmness (calmness.rs:23-95): bins within ~+-30 ct of
    an *unsmoothed*-VQT peak (``peak_mask``, general configuration) EMA toward
    1, others toward 0; released-note shadow contributes at 30% weight;
    amplitude(power)-weighted scene average EMA'd; holds in silence.
    dt: (B, 1)."""
    radius = rng.buckets_per_octave // 12 // 3

    # dilate: bin i is "around" a peak p iff i in [p - radius, p + radius),
    # i.e. there is a peak at i + delta for delta in [-radius+1, radius]
    # (calmness.rs:41-47)
    around = peak_mask
    for delta in range(-radius + 1, radius + 1):
        if delta != 0:
            around = around | _shift(peak_mask, delta, False)

    zero = torch.zeros((), dtype=torch.float32, device=x_vqt.device)
    horizon = params.note_calmness_smoothing_duration
    calm_up = ema_update(calmness, 1.0, dt, horizon)
    calm_down = ema_update(calmness, 0.0, dt, horizon)
    new_calm = torch.where(around, calm_up, calm_down)
    # active bins sync the released shadow; inactive bins decay it
    new_released = torch.where(around, calm_up, ema_update(released, 0.0, dt, horizon))

    amp_power = torch.pow(10.0, x_smoothed / 10.0)
    w_active = torch.where(around, amp_power, zero)
    rel_contrib = torch.where(~around & (new_released > 0.01), new_released, zero)
    # the released weight is SELF-weighted — faithful to calmness.rs:79-83,
    # quirk included
    w_released = rel_contrib * 0.3

    weighted = (new_calm * w_active).sum(-1) + (rel_contrib * w_released).sum(-1)
    wsum = w_active.sum(-1) + w_released.sum(-1)

    target = weighted / torch.clamp_min(wsum, 1e-30)
    new_scene = torch.where(
        wsum > 0.0,
        ema_update(scene, target, dt[:, 0], params.scene_calmness_smoothing_duration),
        scene,  # silence: hold (calmness.rs:92-95)
    )
    return new_calm, new_released, new_scene


def _update_afterglow(afterglow: torch.Tensor, x_smoothed: torch.Tensor) -> torch.Tensor:
    """x *= 0.85 - 0.15*(i/n), floored at the smoothed value
    (afterglow.rs:10-21)."""
    n = afterglow.shape[-1]
    decay = 0.85 - 0.15 * (torch.arange(n, dtype=torch.float32, device=afterglow.device) / n)
    return torch.maximum(afterglow * decay, x_smoothed)


def _pitch_accuracy_deviation(
    peak_mask: torch.Tensor, center: torch.Tensor, buckets_per_octave: int
):
    """Per-peak deviation from the nearest semitone, written at the rounded
    center bin (pitch_analysis.rs:12-42)."""
    n = peak_mask.shape[-1]
    idx = torch.arange(n, device=center.device)
    zero = torch.zeros((), dtype=torch.float32, device=center.device)
    c_semi = exact_div(center * 12.0, buckets_per_octave)
    # rust_round: a two-bin plateau's parabola center is exactly i+0.5, where
    # half-to-even would flip the write bin and the deviation sign
    deviation = c_semi - rust_round(c_semi)
    accuracy = torch.clamp_min(1.0 - 2.0 * deviation.abs(), 0.0)

    # the rounded center is within one bin of the peak bin: three shifts
    rel = torch.clamp(rust_round(center).to(torch.int32), 0, n - 1) - idx
    acc_out = torch.zeros_like(center)
    dev_out = torch.zeros_like(center)
    for r in (-1, 0, 1):
        write = peak_mask & (rel == r)
        # target position t receives from source i = t - r
        m = _shift(write, -r, False)
        acc_out = torch.where(m, _shift(torch.where(write, accuracy, zero), -r, 0.0), acc_out)
        dev_out = torch.where(m, _shift(torch.where(write, deviation, zero), -r, 0.0), dev_out)
    return acc_out, dev_out


def _update_tuning_inaccuracy(
    params: AnalysisParameters,
    peak_mask: torch.Tensor,
    center: torch.Tensor,
    size: torch.Tensor,
    buckets_per_octave: int,
    dt: torch.Tensor,
    tuning: torch.Tensor,
) -> torch.Tensor:
    """Power-weighted mean |cents| drift, EMA'd (pitch_analysis.rs:48-75)."""
    zero = torch.zeros((), dtype=torch.float32, device=size.device)
    power = torch.where(peak_mask, torch.pow(10.0, size / 10.0), zero)
    c_semi = exact_div(center * 12.0, buckets_per_octave)
    drift = (c_semi - rust_round(c_semi)).abs()
    power_sum = power.sum(-1)
    avg = torch.where(
        power_sum > 0.0, (drift * power).sum(-1) / torch.clamp_min(power_sum, 1e-30), zero
    )
    return ema_update(tuning, 100.0 * avg, dt[:, 0], params.tuning_inaccuracy_smoothing_duration)


def _analysis_core(
    params: AnalysisParameters,
    rng: VqtRange,
    state: AnalysisState,
    x_vqt: torch.Tensor,
    dt: torch.Tensor,
    x_smoothed: torch.Tensor,
    bass_mask: torch.Tensor,
    gen_mask: torch.Tensor,
    raw_mask: torch.Tensor,
) -> tuple[AnalysisState, AnalysisOutputs]:
    """Steps 2-6 of the analysis chain, given the smoothed spectrum, its peak
    masks under the bassline and the general configuration, and the raw
    spectrum's peak mask under the general one."""
    n = rng.n_buckets
    idx = torch.arange(n, device=x_vqt.device)
    zero = torch.zeros((), dtype=torch.float32, device=x_vqt.device)

    # 2. discrete peaks: bassline config at/below highest_bassnote, general
    # config above (analysis.rs:331-349); highest_bassnote is compared with
    # raw bin indices, faithfully to analysis.rs:338/346
    peaks = (bass_mask & (idx <= params.highest_bassnote)) | (
        gen_mask & (idx > params.highest_bassnote)
    )

    # 3. continuous peak refinement + bass harmonic promotion
    center, size = enhance_peaks_continuous(peaks, x_smoothed, rng)
    size = promote_bass_peaks(
        peaks, center, size, x_smoothed, rng, params.highest_bassnote, params.harmonic_threshold
    )

    # 4. peak filter + afterglow
    x_peakfiltered = torch.where(peaks, x_smoothed, zero)
    afterglow = _update_afterglow(state.x_vqt_afterglow, x_smoothed)

    # 5. calmness (peaks from the *unsmoothed* spectrum)
    calm, released, scene = _update_calmness(
        params, rng, x_vqt, x_smoothed, dt,
        state.calmness, state.released_note_calmness, state.scene_calmness,
        peak_mask=raw_mask,
    )

    # 6. tuning inaccuracy + per-bin pitch accuracy/deviation
    tuning = _update_tuning_inaccuracy(
        params, peaks, center, size, rng.buckets_per_octave, dt, state.tuning_inaccuracy
    )
    accuracy, deviation = _pitch_accuracy_deviation(peaks, center, rng.buckets_per_octave)

    new_state = AnalysisState(
        x_vqt_smoothed=x_smoothed,
        x_vqt_afterglow=afterglow,
        calmness=calm,
        released_note_calmness=released,
        scene_calmness=scene,
        tuning_inaccuracy=tuning,
    )
    outputs = AnalysisOutputs(
        x_vqt_smoothed=x_smoothed,
        x_vqt_peakfiltered=x_peakfiltered,
        x_vqt_afterglow=afterglow,
        peaks=peaks,
        peak_center=torch.where(peaks, center, zero),
        peak_size=torch.where(peaks, size, zero),
        calmness=calm,
        pitch_accuracy=accuracy,
        pitch_deviation=deviation,
        scene_calmness=scene,
        tuning_inaccuracy=tuning,
    )
    return new_state, outputs


def dt_batch(dt, b: int, device) -> torch.Tensor:
    """The frame time as a (B,) float32 tensor on ``device``: ``dt`` is a
    scalar (Python or NumPy), or a (B,) tensor, NumPy array or list,
    broadcast like the JAX package's jnp.broadcast_to. A scalar or a tensor
    on the card costs no host synchronisation."""
    if isinstance(dt, torch.Tensor):
        return dt.to(device=device, dtype=torch.float32).expand(b)
    if np.ndim(dt) == 0:
        # filled on the device: a host scalar copied over would synchronise
        return torch.full((b,), float(dt), dtype=torch.float32, device=device)
    # a per-stream array-like (a NumPy array, a list): one copy
    return torch.as_tensor(np.asarray(dt, np.float32), device=device).expand(b)


def analysis_step_batch(
    params: AnalysisParameters,
    rng: VqtRange,
    state: AnalysisState,
    x_vqt: torch.Tensor,
    dt,
) -> tuple[AnalysisState, AnalysisOutputs]:
    """One frame of the analysis chain (analysis.rs:288-404) for every
    stream: ``x_vqt`` is (B, n_buckets) dB spectra, ``dt`` the frame time in
    seconds, in any form :func:`dt_batch` takes."""
    b, n = x_vqt.shape
    if n != rng.n_buckets:
        raise ValueError(f"x_vqt has {n} bins, the range {rng.n_buckets}")
    with annotate("stage.analysis"):
        dt_col = dt_batch(dt, b, x_vqt.device)[:, None]

        # step 1: calmness- and frequency-adaptive EMA smoothing
        with annotate("analysis.smooth"):
            horizons = _smoothing_horizons(params, rng, state.scene_calmness)
            x_smoothed = ema_update(state.x_vqt_smoothed, x_vqt, dt_col, horizons)

        # discrete peaks of the smoothed spectrum (bassline and general
        # configuration) and of the raw one (calmness uses only the general
        # configuration, calmness.rs:30)
        bpo = rng.buckets_per_octave
        with annotate("analysis.peaks"):
            bass_mask, gen_mask = find_peaks_masks(
                x_smoothed, (params.bassline_peak_config, params.peak_config), bpo, params.suppress_iterations
            )
            (raw_mask,) = find_peaks_masks(x_vqt, (params.peak_config,), bpo, params.suppress_iterations)
        with annotate("analysis.core"):
            return _analysis_core(
                params, rng, state, x_vqt, dt_col, x_smoothed, bass_mask, gen_mask, raw_mask
            )


def analysis_step(
    params: AnalysisParameters,
    rng: VqtRange,
    state: AnalysisState,
    x_vqt: torch.Tensor,
    dt,
) -> tuple[AnalysisState, AnalysisOutputs]:
    """One frame of the analysis chain (analysis.rs:288-404) for one stream:
    ``x_vqt`` is a dB spectrum (n_buckets,), ``state`` a per-frame state
    (:meth:`AnalysisState.init`), ``dt`` the frame time in seconds. Runs
    :func:`analysis_step_batch` on a batch of one, so it launches what a
    batched step does."""
    n = rng.n_buckets
    if tuple(x_vqt.shape) != (n,):
        raise ValueError(f"x_vqt must be ({n},), got {tuple(x_vqt.shape)}")
    batched = type(state)(**{f.name: getattr(state, f.name)[None] for f in fields(state)})
    new_state, outputs = analysis_step_batch(params, rng, batched, x_vqt[None], dt)
    return _row(new_state, 0), _row(outputs, 0)
