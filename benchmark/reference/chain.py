"""The plain reference of a deployment: the chain for S sampled streams.

The VQT runs in float64 (:class:`~.vqt_ref.BatchedVqt`, on any device), the
analysis chain and the output stages in float32 on the CPU, from the copies
in this directory: analysis.py's step and pitchvis_tpu_torch/models/
pipeline.py::derived_stages (at commit 5c134db8c4ad, without the ML stage),
rearranged over many hops in :meth:`Deployment.run`. Nothing here
reads a weight, a table or a state that the program made: the filter bank is
built from the configuration, and the carried state starts fresh.
"""

from __future__ import annotations

import dataclasses

import torch

from .analysis import (
    AnalysisOutputs,
    AnalysisState,
    _pitch_accuracy_deviation,
    _smoothing_horizons,
    _update_afterglow,
    _update_calmness,
    find_peaks_masks,
    init_state_batch,
)
from .ema import ema_update
from .peaks import enhance_peaks_continuous, promote_bass_peaks
from .rounding import exact_div, rust_round
from .config import AnalysisParameters, VqtParameters, VqtRange
from .filter_bank import build_kernel
from .led import led_frame_values
from .viewer import (
    BallOutputs,
    BallState,
    bass_spiral,
    bloom_intensity,
    calmness_histogram,
    chroma_vector,
    spectrogram_row_vqt,
    update_balls,
)
from .vqt_ref import BatchedVqt


def vqt_parameters(config: dict) -> VqtParameters:
    v = config["vqt"]
    return VqtParameters(
        sr=float(v["sr"]),
        n_fft=int(v["n_fft"]),
        range=VqtRange(min_freq=float(v["min_freq"]), octaves=int(v["octaves"]),
                       buckets_per_octave=int(v["buckets_per_octave"])),
        sparsity_quantile=float(v["sparsity_quantile"]),
        quality=float(v["quality"]),
        gamma=float(v["gamma"]),
    )


def _tuning_average(peak_mask, center, size, buckets_per_octave):
    """The power-weighted mean drift that ``_update_tuning_inaccuracy`` of
    analysis.py smooths, for many rows at once (its first half, op for
    op)."""
    zero = torch.zeros((), dtype=torch.float32, device=size.device)
    power = torch.where(peak_mask, torch.pow(10.0, size / 10.0), zero)
    c_semi = exact_div(center * 12.0, buckets_per_octave)
    drift = (c_semi - rust_round(c_semi)).abs()
    power_sum = power.sum(-1)
    return torch.where(power_sum > 0.0, (drift * power).sum(-1) / torch.clamp_min(power_sum, 1e-30), zero)


class Deployment:
    """The reference chain of one configuration for ``n_streams`` streams."""

    def __init__(self, config: dict, n_streams: int, vqt_device="cpu"):
        self.params = vqt_parameters(config)
        self.rng = self.params.range
        self.kernel = build_kernel(self.params)
        self.vqt = BatchedVqt(self.kernel, vqt_device)
        self.analysis_params = AnalysisParameters()
        outputs = config["outputs"]
        self.with_led = bool(outputs["with_led"]) or outputs.get("fetch") == "led"
        self.with_viewer = bool(outputs["with_viewer"])
        n = self.params.n_buckets
        self.state = init_state_batch(n_streams, n, device="cpu")
        self.balls = BallState.init(n_streams, n, device="cpu") if self.with_viewer else None

    @property
    def frame_len(self) -> int:
        """Samples before "now" that the VQT reads (the groups' span)."""
        return self.params.n_fft - self.vqt.begin

    def run(self, x_vqt: torch.Tensor, dt: torch.Tensor, keep) -> dict:
        """H hops of the chain, continuing from the carried state: (H, S,
        n_buckets) float32 dB spectra and (H, S) float32 dt -> the outputs
        of the hops ``keep`` (sorted indices into H) by leaf name, each (K,
        S, ...).

        The order of the work differs from the program's hop by hop, not
        its arithmetic: what carries state from hop to hop (the smoothing
        with its calmness, the afterglow, the tuning's average, the balls)
        runs hop by hop, and what reads only one hop's spectra (the peak
        masks, their refinement, the LED and display outputs) runs for
        many hops at once, row by row as the per-hop step would."""
        h, s, n = x_vqt.shape
        keep = [int(k) for k in keep]
        p, rng = self.analysis_params, self.rng
        bpo = rng.buckets_per_octave
        st = self.state
        rows = lambda x: x.reshape(h * s, *x.shape[2:])  # noqa: E731
        hops = lambda x: x.reshape(h, s, *x.shape[1:])  # noqa: E731

        # the raw spectrum's mask (calmness reads it) for every hop at once
        (raw_mask,) = find_peaks_masks(rows(x_vqt), (p.peak_config,), bpo, p.suppress_iterations)
        raw_mask = hops(raw_mask)
        smoothed, afterglow, calm, released, scene = [], [], [], [], []
        for i in range(h):
            dt_col = dt[i][:, None]
            x_s = ema_update(st.x_vqt_smoothed, x_vqt[i], dt_col, _smoothing_horizons(p, rng, st.scene_calmness))
            c, r, sc = _update_calmness(p, rng, x_vqt[i], x_s, dt_col, st.calmness, st.released_note_calmness,
                                        st.scene_calmness, peak_mask=raw_mask[i])
            a = _update_afterglow(st.x_vqt_afterglow, x_s)
            st = AnalysisState(x_vqt_smoothed=x_s, x_vqt_afterglow=a, calmness=c, released_note_calmness=r,
                               scene_calmness=sc, tuning_inaccuracy=st.tuning_inaccuracy)
            smoothed.append(x_s), afterglow.append(a), calm.append(c), released.append(r), scene.append(sc)
        x_s = torch.stack(smoothed)

        # step 2-4 of the chain for every hop at once
        idx = torch.arange(n)
        bass_mask, gen_mask = find_peaks_masks(rows(x_s), (p.bassline_peak_config, p.peak_config), bpo,
                                               p.suppress_iterations)
        peaks = (bass_mask & (idx <= p.highest_bassnote)) | (gen_mask & (idx > p.highest_bassnote))
        center, size = enhance_peaks_continuous(peaks, rows(x_s), rng)
        size = promote_bass_peaks(peaks, center, size, rows(x_s), rng, p.highest_bassnote, p.harmonic_threshold)
        zero = torch.zeros((), dtype=torch.float32)
        accuracy, deviation = _pitch_accuracy_deviation(peaks, center, bpo)
        avg = _tuning_average(peaks, center, size, bpo)
        tuning = []
        t_state = st.tuning_inaccuracy
        for i in range(h):
            t_state = ema_update(t_state, 100.0 * avg[i * s : (i + 1) * s], dt[i], p.tuning_inaccuracy_smoothing_duration)
            tuning.append(t_state)
        self.state = dataclasses.replace(st, tuning_inaccuracy=t_state)
        peaks, center, size = hops(peaks), hops(center), hops(size)
        outputs = AnalysisOutputs(
            x_vqt_smoothed=x_s,
            x_vqt_peakfiltered=torch.where(peaks, x_s, zero),
            x_vqt_afterglow=torch.stack(afterglow),
            peaks=peaks,
            peak_center=torch.where(peaks, center, zero),
            peak_size=torch.where(peaks, size, zero),
            calmness=torch.stack(calm),
            pitch_accuracy=hops(accuracy),
            pitch_deviation=hops(deviation),
            scene_calmness=torch.stack(scene),
            tuning_inaccuracy=torch.stack(tuning),
        )
        kept = AnalysisOutputs(**{f.name: getattr(outputs, f.name)[keep] for f in dataclasses.fields(outputs)})
        out = {"analysis": kept}
        k = len(keep)
        flat = lambda x: x.reshape(k * s, *x.shape[2:])  # noqa: E731
        back = lambda x: x.reshape(k, s, *x.shape[1:])  # noqa: E731
        if self.with_led:
            out["led"] = back(led_frame_values(rng, flat(kept.peaks), flat(kept.peak_center), flat(kept.peak_size)))
        if self.with_viewer:
            balls_kept = {}
            for i in range(h):
                self.balls, b = update_balls(
                    rng, self.balls, outputs.peaks[i], outputs.peak_center[i], outputs.peak_size[i],
                    outputs.calmness[i], outputs.pitch_accuracy[i], outputs.pitch_deviation[i], dt[i],
                )
                if i in keep:
                    balls_kept[i] = b
            balls = {f.name: torch.stack([getattr(balls_kept[i], f.name) for i in keep])
                     for f in dataclasses.fields(BallOutputs)}
            bass = bass_spiral(rng, flat(kept.peaks), flat(kept.peak_center), flat(kept.peak_size))
            hist = calmness_histogram(flat(kept.calmness))
            out["viewer"] = {
                "balls": balls,
                "chroma": back(chroma_vector(flat(kept.x_vqt_smoothed), rng)),
                "bloom": bloom_intensity(kept.scene_calmness),
                "spectrogram_row": back(spectrogram_row_vqt(rng, flat(kept.x_vqt_smoothed))),
                "bass": {f.name: back(getattr(bass, f.name)) for f in dataclasses.fields(bass)},
                "calmness_histogram": {f.name: back(getattr(hist, f.name)) for f in dataclasses.fields(hist)},
            }
        return out
