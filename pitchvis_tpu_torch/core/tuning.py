"""Live parameter tuning with clamped ranges and debounced kernel rebuild.

The reference viewer lets every analysis/VQT parameter be adjusted at runtime
from the keyboard, clamps each to a safe range, and rebuilds the VQT kernel
2 s after the last change (pitchvis_viewer/src/app/common.rs:847-1165). Here:
a `ParameterTuner` that applies clamped updates to the frozen config
dataclasses and hands out a fresh (cached) kernel once changes settle.

A copy of ``pitchvis_tpu/core/tuning.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from .config import AnalysisParameters, VqtParameters

REBUILD_DEBOUNCE_SECS = 2.0  # common.rs:1105-1165

# clamp ranges from common.rs:916-1102
VQT_CLAMPS: dict[str, tuple[float, float]] = {
    "quality": (0.5, 5.0),
    "gamma": (0.0, 30.0),
    "sparsity_quantile": (0.9, 0.9999),
    "n_fft": (4096, 131072),  # stepped by powers of two (common.rs:975-999)
}

ANALYSIS_CLAMPS: dict[str, tuple[float, float]] = {
    "peak_config.min_prominence": (1.0, 30.0),
    "peak_config.min_height": (1.0, 15.0),
    "bassline_peak_config.min_prominence": (1.0, 20.0),
    "bassline_peak_config.min_height": (1.0, 10.0),
    "harmonic_threshold": (0.05, 0.8),
    "highest_bassnote": (12, 60),
    "vqt_smoothing_calmness_min": (0.1, 2.0),
    "vqt_smoothing_calmness_max": (0.5, 5.0),
    # durations in seconds (the reference clamps milliseconds,
    # common.rs:1033-1102)
    "vqt_smoothing_duration_base": (0.0, 0.5),
    "note_calmness_smoothing_duration": (0.1, 10.0),
    "scene_calmness_smoothing_duration": (0.1, 5.0),
    "tuning_inaccuracy_smoothing_duration": (0.1, 10.0),
    # reference quirk preserved: analysis.rs:37-39 documents this field as
    # "currently unused within this crate (the spectrogram display in the
    # viewer keeps its own history buffer)" — here too (demo/_FrameRenderer
    # sizes its SpectrogramState independently, like the viewer). Tuning it
    # changes nothing else.
    "spectrogram_length": (100, 1000),
}


def _set_nested(obj, dotted: str, value):
    parts = dotted.split(".")
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _set_nested(child, ".".join(parts[1:]), value)})


def _get_nested(obj, dotted: str):
    for p in dotted.split("."):
        obj = getattr(obj, p)
    return obj


class ParameterTuner:
    """Holds the current (vqt, analysis) parameter pair; `adjust` applies a
    clamped delta or absolute set; `pending_rebuild()` reports whether a VQT
    change is waiting out the debounce; `take_rebuilt()` returns the new
    parameter set once settled (analysis-only changes apply immediately)."""

    def __init__(
        self,
        vqt_params: VqtParameters | None = None,
        analysis_params: AnalysisParameters | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.vqt_params = vqt_params or VqtParameters()
        self.analysis_params = analysis_params or AnalysisParameters()
        self._defaults = (self.vqt_params, self.analysis_params)
        self._clock = clock
        self._last_vqt_change: float | None = None
        self._pending_vqt: VqtParameters | None = None

    # -- adjustments ----------------------------------------------------------
    def adjust_vqt(self, field: str, *, delta: float | None = None, value: Any = None):
        lo, hi = VQT_CLAMPS[field]
        cur = _get_nested(self._pending_vqt or self.vqt_params, field)
        new = (cur + delta) if delta is not None else value
        new = min(max(new, lo), hi)
        if isinstance(cur, int):
            new = int(new)
        self._pending_vqt = _set_nested(self._pending_vqt or self.vqt_params, field, new)
        self._last_vqt_change = self._clock()
        return new

    def adjust_analysis(self, field: str, *, delta: float | None = None, value: Any = None):
        lo, hi = ANALYSIS_CLAMPS[field]
        cur = _get_nested(self.analysis_params, field)
        new = (cur + delta) if delta is not None else value
        if isinstance(cur, int):
            new = int(min(max(new, lo), hi))
        else:
            new = min(max(new, lo), hi)
        self.analysis_params = _set_nested(self.analysis_params, field, new)
        return new

    def reset(self) -> None:
        """Reset everything to defaults (the viewer's reset combo). The VQT
        side goes through the rebuild handshake: a caller that rebuilds its
        kernel only when take_rebuilt() returns would otherwise keep serving
        the old tuned kernel while vqt_params claimed defaults."""
        default_vqt, self.analysis_params = self._defaults
        if self.vqt_params != default_vqt or self._pending_vqt is not None:
            self._pending_vqt = default_vqt
            self._last_vqt_change = self._clock()

    # -- rebuild handshake -----------------------------------------------------
    def pending_rebuild(self) -> bool:
        return self._pending_vqt is not None

    def take_rebuilt(self) -> VqtParameters | None:
        """Returns the new VqtParameters once the debounce has elapsed (and
        commits them); None while still debouncing or if nothing changed.
        Invalid parameter combinations RESET to construction defaults with
        the error attached, mirroring the reference's rebuild failure path
        (common.rs:1137-1161: log + reset params to defaults)."""
        if self._pending_vqt is None:
            return None
        if self._clock() - (self._last_vqt_change or 0.0) < REBUILD_DEBOUNCE_SECS:
            return None
        candidate = self._pending_vqt
        self._pending_vqt = None
        # validate through get_kernel so the successful build lands in the
        # lru + disk caches the caller's own get_kernel will hit (build_kernel
        # would validate, throw the kernel away, and pay the ~15 s twice)
        from ..kernel.builder import get_kernel

        try:
            get_kernel(candidate)
        except Exception:
            # Rebuild failure resets to defaults (common.rs:1137-1161) — but
            # through the normal handshake: vqt_params keeps matching the
            # still-served kernel, and the NEXT take_rebuilt() (debounce
            # pre-elapsed) delivers the defaults for the caller to swap in.
            # Committing defaults directly here would leave a caller that
            # only swaps kernels on successful take_rebuilt() serving the old
            # tuned kernel while vqt_params claimed defaults.
            self._pending_vqt = self._defaults[0]
            self._last_vqt_change = self._clock() - REBUILD_DEBOUNCE_SECS
            raise
        self.vqt_params = candidate
        return candidate
