"""Persistent user settings.

Mirrors the viewer's `SettingsState` (pitchvis_viewer/src/app/common.rs:31-43)
persisted via bevy-persistent (TOML/JSON with revert-on-error,
common.rs:1989-2016). Here: a frozen dataclass persisted as JSON with
corrupt-file fallback to defaults.

A copy of ``pitchvis_tpu/core/settings.py``.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from dataclasses import dataclass


class DisplayMode(str, enum.Enum):
    NORMAL = "normal"
    DEBUGGING = "debugging"
    PAUSED = "paused"


class VisualsMode(str, enum.Enum):
    FULL = "full"
    PERFORMANCE = "performance"


class VqtSmoothingMode(str, enum.Enum):
    NONE = "none"
    SHORT = "short"
    DEFAULT = "default"
    LONG = "long"

    def base_duration_secs(self) -> float:
        """Smoothing base per mode (analysis.rs:243-270 semantics: None
        disables the EMA entirely)."""
        return {"none": 0.0, "short": 0.035, "default": 0.070, "long": 0.140}[self.value]


class SpectrogramMode(str, enum.Enum):
    VQT = "vqt"
    PEAKS = "peaks"


@dataclass(frozen=True)
class SettingsState:
    display_mode: DisplayMode = DisplayMode.NORMAL
    visuals_mode: VisualsMode = VisualsMode.FULL
    fps_limit: int | None = 60  # 30 / 60 / None (common.rs:1785-1791)
    vqt_smoothing_mode: VqtSmoothingMode = VqtSmoothingMode.DEFAULT
    spectrogram_mode: SpectrogramMode = SpectrogramMode.VQT
    enable_bloom: bool = True
    enable_analysis_config: bool = False

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps({k: (v.value if isinstance(v, enum.Enum) else v) for k, v in d.items()})

    @classmethod
    def from_json(cls, text: str) -> "SettingsState":
        def _validated_fps(v):
            if v is None:  # None = unlimited, like the reference's FPS limit
                return None
            if isinstance(v, bool) or not isinstance(v, (int, float)) or not (
                0 < v <= 1000
            ):
                raise ValueError(f"invalid fps_limit {v!r}")
            return int(v)

        d = json.loads(text)
        return cls(
            display_mode=DisplayMode(d.get("display_mode", "normal")),
            visuals_mode=VisualsMode(d.get("visuals_mode", "full")),
            # validate like the enum fields: a non-numeric (or absurd)
            # value must trigger load_settings' revert-to-defaults, not
            # surface later as a TypeError in a frame-budget division
            fps_limit=_validated_fps(d.get("fps_limit", 60)),
            vqt_smoothing_mode=VqtSmoothingMode(d.get("vqt_smoothing_mode", "default")),
            spectrogram_mode=SpectrogramMode(d.get("spectrogram_mode", "vqt")),
            enable_bloom=bool(d.get("enable_bloom", True)),
            enable_analysis_config=bool(d.get("enable_analysis_config", False)),
        )


def load_settings(path: str) -> SettingsState:
    """Loads settings; any error reverts to defaults (and rewrites the file),
    matching bevy-persistent's revert-on-error behavior."""
    try:
        with open(path) as f:
            return SettingsState.from_json(f.read())
    except Exception:
        s = SettingsState()
        try:
            save_settings(path, s)
        except OSError:
            pass
        return s


def save_settings(path: str, settings: SettingsState) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(settings.to_json())


def analysis_params_for_mode(
    base_params, mode: VqtSmoothingMode
):
    """Applies a smoothing mode to AnalysisParameters (the reference's
    `update_vqt_smoothing_duration`, analysis.rs:243-270: None disables the
    EMA entirely; Short/Default/Long scale the base horizon)."""
    return dataclasses.replace(
        base_params, vqt_smoothing_duration_base=mode.base_duration_secs()
    )
