# Frozen copy of pitchvis_tpu_torch/ops/vqt_ref.py at commit 5c134db8c4ad,
# the plain reference of the benchmark: it imports nothing of the program.
# Added in this copy: BatchedVqt, vqt_frame_complex_np's products for many frames
# at once in float64 with torch.
"""NumPy reference implementation of the per-frame VQT compute.

Mirrors `Vqt::calculate_vqt_instant_in_db` (pitchvis_analysis/src/vqt.rs:
866-916) and `power_to_db` (vqt.rs:922-954) exactly: per window group, slice
the input, real FFT over the half spectrum, complex kernel mat-vec plus
conjugate-part accumulation, then dB conversion.

A copy of ``pitchvis_tpu/ops/vqt_ref.py``: the float64 oracle that
chip_smoke.py holds the port's f32 VQT kernel against on the card."""

from __future__ import annotations

import numpy as np
import torch

from .filter_bank import VqtKernel

REF_POWER = 0.3 * 0.3
A_MIN = 1e-6 * 1e-6
TOP_DB = 60.0


def power_to_db_np(x_vqt: np.ndarray) -> np.ndarray:
    """dB conversion relative to a fixed reference power, clamped to a 60 dB
    range below the frame maximum and shifted non-negative (vqt.rs:922-954).

    Accepts complex VQT coefficients of shape (..., n_buckets); the frame
    max/min reductions run over the last axis.
    """
    ref_db = 10.0 * np.log10(REF_POWER)
    power = np.abs(x_vqt) ** 2
    log_spec = 10.0 * np.log10(np.maximum(power, A_MIN)) - ref_db

    log_spec_max = log_spec.max(axis=-1, keepdims=True)
    log_spec_min = log_spec.min(axis=-1, keepdims=True)
    floor = log_spec_max - TOP_DB
    log_spec_min = np.maximum(log_spec_min, floor)

    clamped = np.maximum(log_spec, floor)
    return np.where(log_spec_min > 0.0, clamped - log_spec_min, np.maximum(clamped, 0.0))


def vqt_frame_complex_np(kernel: VqtKernel, x: np.ndarray) -> np.ndarray:
    """Complex VQT coefficients of one n_fft frame (before dB)."""
    assert x.shape == (kernel.params.n_fft,), "input must be exactly n_fft samples"
    out = np.zeros(kernel.n_buckets, dtype=np.complex128)
    for g in kernel.window_groups:
        begin, end = g.window
        spectrum = np.fft.rfft(x[begin:end].astype(np.float64))
        y = g.filter_bank @ spectrum
        if g.has_negative_part:
            y = y + np.conj(g.negative_filter_bank @ spectrum)
        out[g.row_offset : g.row_offset + g.n_filters] = y
    return out


def vqt_frame_db_np(kernel: VqtKernel, x: np.ndarray) -> np.ndarray:
    """Per-frame VQT in dB scale (vqt.rs:866-916)."""
    return power_to_db_np(vqt_frame_complex_np(kernel, x)).astype(np.float32)


class BatchedVqt:
    """The products of :func:`vqt_frame_complex_np` for many frames at once,
    in float64 on ``device``: per window group the real FFT of the slice,
    the kernel and the conjugate part, then :func:`power_to_db_np`'s steps.
    Returns float32 dB, the precision the analysis chain takes."""

    def __init__(self, kernel: VqtKernel, device):
        self.kernel = kernel
        self.device = torch.device(device)
        self.groups = [
            (g.window, g.row_offset, g.n_filters,
             torch.from_numpy(g.filter_bank.T.copy()).to(self.device),
             torch.from_numpy(g.negative_filter_bank.T.copy()).to(self.device) if g.has_negative_part else None)
            for g in kernel.window_groups
        ]
        self.begin = min(g.window[0] for g in kernel.window_groups)

    def db(self, frames: torch.Tensor, block: int = 512) -> torch.Tensor:
        """(F, n_fft - begin) samples, the trailing part of each n_fft frame
        that the groups read, -> (F, n_buckets) float32 dB on the CPU."""
        out = []
        for part in torch.split(frames, block):
            x = part.to(self.device, torch.float64)
            y = torch.zeros((x.shape[0], self.kernel.n_buckets), dtype=torch.complex128, device=self.device)
            for (begin, end), row, n, bank, neg in self.groups:
                spectrum = torch.fft.rfft(x[:, begin - self.begin : end - self.begin], dim=-1)
                acc = spectrum @ bank
                if neg is not None:
                    acc = acc + torch.conj(spectrum @ neg)
                y[:, row : row + n] = acc
            power = y.abs() ** 2
            ref_db = 10.0 * np.log10(REF_POWER)
            log_spec = 10.0 * torch.log10(torch.clamp_min(power, A_MIN)) - ref_db
            floor = log_spec.amax(dim=-1, keepdim=True) - TOP_DB
            log_spec_min = torch.maximum(log_spec.amin(dim=-1, keepdim=True), floor)
            clamped = torch.maximum(log_spec, floor)
            db = torch.where(log_spec_min > 0.0, clamped - log_spec_min, torch.clamp_min(clamped, 0.0))
            out.append(db.float().cpu())
        return torch.cat(out) if out else torch.zeros((0, self.kernel.n_buckets))
