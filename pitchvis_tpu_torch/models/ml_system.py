"""ML inference stage: VQT history -> MIDI base-pitch strengths.

Port of ``pitchvis_tpu/models/ml_system.py`` (the viewer's ml_system,
pitchvis_viewer/src/ml_system.rs:24-69): a T-frame history of smoothed VQT
spectra feeds the trained Conv1d + MLP (models/pitch_mlp.py), and its 128
sigmoid outputs are the per-key strengths the viewer gates its display with
(update.rs:247-255). The history is an explicit rolling carry, newest frame
last. Plain PyTorch: the products are ``torch.matmul`` / ``nn.Linear``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from ..core.device import resolve_device
from .pitch_mlp import PitchMLP, apply


@dataclass
class MlState:
    """Rolling history, (T, n_buckets) for one stream or (B, T, n_buckets)
    for a batch (newest last)."""

    history: torch.Tensor

    @classmethod
    def init(cls, t_window: int, n_buckets: int, device="cuda") -> "MlState":
        return cls(history=torch.zeros((t_window, n_buckets), dtype=torch.float32, device=resolve_device(device)))


def init_ml_state_batch(n_streams: int, t_window: int, n_buckets: int, device="cuda") -> MlState:
    return MlState(
        history=torch.zeros((n_streams, t_window, n_buckets), dtype=torch.float32, device=resolve_device(device))
    )


def ml_step(model: PitchMLP, params, state: MlState, x_vqt_smoothed: torch.Tensor) -> tuple[MlState, torch.Tensor]:
    """Pushes the newest frame (n_buckets,) and infers the (128,) MIDI
    strengths. ``params``: a state_dict, or None for the module's own
    weights."""
    history = torch.cat([state.history[1:], x_vqt_smoothed[None, :]], dim=0)
    out = apply(model, params, history.reshape(1, 1, -1))[0]
    return MlState(history=history), out


def ml_step_batch(model: PitchMLP, params, state: MlState, x: torch.Tensor) -> tuple[MlState, torch.Tensor]:
    """Batched over streams: state.history (B, T, n), x (B, n). The flatten
    is frame-major, (B, T, n) -> (B, 1, T*n), as the model was trained."""
    history = torch.cat([state.history[:, 1:], x[:, None, :]], dim=1)
    b = history.shape[0]
    out = apply(model, params, history.reshape(b, 1, -1))
    return MlState(history=history), out


def serving_copy(model: PitchMLP, params, device) -> PitchMLP:
    """The pipeline's and the server's own copy of ``model`` on ``device``: loaded from
    ``params`` (a state_dict, as convert.py returns it), or the module's own
    weights when ``params`` is None; in eval mode, with
    ``requires_grad_(False)``. Training the caller's module afterwards does
    not change what they serve, and no autograd graph is recorded on a
    serving thread (``torch.no_grad()`` is thread-local, so a caller's block
    would not reach a ServeLoop's thread)."""
    served = copy.deepcopy(model)
    served.zero_grad(set_to_none=True)
    if params is not None:
        served.load_state_dict(params)
    return served.to(device).eval().requires_grad_(False)
