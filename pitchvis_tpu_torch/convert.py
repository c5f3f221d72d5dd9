"""Carrying weights and state across from the JAX package, as NumPy arrays.

Nothing here imports JAX: the caller hands over ``np.asarray`` of the JAX
package's arrays (a bf16 array arrives as NumPy's ``bfloat16`` extension
dtype and is reinterpreted bit for bit). With these a test starts both
packages from the same weights and the same mid-stream state, a pipeline's
or a server's, and a PitchMLP's flax parameters (a trained checkpoint)
become the port's state_dict. Like every entry point, these put their
tensors on the card unless given ``device="cpu"``, and raise without CUDA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.device import resolve_device
from .models.analysis import AnalysisState
from .models.ml_system import MlState
from .models.pipeline import PipelineState
from .models.render import DebugInputs
from .models.viewer import BALL_LEAVES, BallOutputs, BallState, BassSpiralOutputs
from .ops.vqt import VqtArrays
from .ops.vqt_pallas import PallasVqtArrays
from .stream.ring import RingState

ANALYSIS_LEAVES = (
    "x_vqt_smoothed",
    "x_vqt_afterglow",
    "calmness",
    "released_note_calmness",
    "scene_calmness",
    "tuning_inaccuracy",
)


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """numpy -> torch on ``device``; bfloat16 arrays keep their bits."""
    device = resolve_device(device)
    a = np.array(a, copy=True, order="C")  # JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy; bfloat16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def vqt_arrays_from_numpy(
    w_time, windows, n_filters, n_fft: int, n_buckets: int, device="cuda", w_freq=()
) -> VqtArrays:
    """The dense paths' weights: ``w_time`` per group (window, 2*nf) and
    ``w_freq`` per group (2*n_spec, 2*nf); either may be empty, as in the JAX
    package's VqtArrays.from_kernel(path=)."""
    device = resolve_device(device)
    return VqtArrays(
        w_freq=tuple(tensor_from_numpy(w, device) for w in w_freq),
        w_time=tuple(tensor_from_numpy(w, device) for w in w_time),
        windows=tuple(tuple(int(v) for v in win) for win in windows),
        n_filters=tuple(int(f) for f in n_filters),
        n_fft=int(n_fft),
        n_buckets=int(n_buckets),
    )


def pallas_vqt_arrays_from_numpy(
    weights, offsets, window_sizes, nf, nf_pad, tail: int, n_fft: int, n_buckets: int,
    device="cuda",
) -> PallasVqtArrays:
    """The fused kernel's padded per-group weights and geometry."""
    device = resolve_device(device)
    return PallasVqtArrays(
        weights=tuple(tensor_from_numpy(w, device) for w in weights),
        offsets=tuple(int(v) for v in offsets),
        window_sizes=tuple(int(v) for v in window_sizes),
        nf=tuple(int(v) for v in nf),
        nf_pad=tuple(int(v) for v in nf_pad),
        tail=int(tail),
        n_fft=int(n_fft),
        n_buckets=int(n_buckets),
    )


def ball_state_from_numpy(arrays: dict, device="cuda") -> BallState:
    """The viewer stage's ball carry from ``arrays``, which holds its leaves
    by the names of BALL_LEAVES with their leading stream axis (a JAX
    pipeline's ``state.balls`` gives them under vmap)."""
    device = resolve_device(device)
    return BallState(**{k: tensor_from_numpy(arrays[k], device).float() for k in BALL_LEAVES})


def ball_state_to_numpy(balls: BallState) -> dict:
    return {k: tensor_to_numpy(getattr(balls, k)) for k in BALL_LEAVES}


def _dataclass_from_numpy(cls, arrays: dict, per_frame: bool, device) -> object:
    """``cls`` from ``arrays`` by its field names, each leaf on ``device``
    with a leading stream axis of one added where ``per_frame``."""
    device = resolve_device(device)
    leaves = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(arrays[f.name])
        leaves[f.name] = tensor_from_numpy(a[None] if per_frame else a, device)
    return cls(**leaves)


def _dataclass_to_numpy(obj) -> dict:
    return {f.name: tensor_to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def ball_outputs_from_numpy(arrays: dict, device="cuda") -> BallOutputs:
    """The viewer's ball outputs (what the rasterizer reads) from ``arrays``
    by the BallOutputs field names: batched ((B, n) leaves, a JAX
    pipeline's ``viewer.balls``) or one frame ((n,) leaves, the JAX
    ``update_balls``), which gains a stream axis of one."""
    return _dataclass_from_numpy(BallOutputs, arrays, np.ndim(arrays["position"]) == 2, device)


def ball_outputs_to_numpy(balls: BallOutputs) -> dict:
    return _dataclass_to_numpy(balls)


def bass_spiral_outputs_from_numpy(arrays: dict, device="cuda") -> BassSpiralOutputs:
    """The bass spiral's outputs from ``arrays`` ("visible", "rgba"):
    batched, or one frame (``rgba`` (4,)), which gains a stream axis of
    one."""
    return _dataclass_from_numpy(BassSpiralOutputs, arrays, np.ndim(arrays["rgba"]) == 1, device)


def bass_spiral_outputs_to_numpy(bass: BassSpiralOutputs) -> dict:
    return _dataclass_to_numpy(bass)


def debug_inputs_from_numpy(arrays: dict, device="cuda") -> DebugInputs:
    """The rasterizer's debug-overlay inputs from ``arrays`` by the
    DebugInputs field names: batched, or one frame (``x_vqt_smoothed``
    (n,), the JAX package's per-frame DebugInputs), which gains a stream
    axis of one."""
    return _dataclass_from_numpy(DebugInputs, arrays, np.ndim(arrays["x_vqt_smoothed"]) == 1, device)


def pitch_mlp_params_from_numpy(tree: dict, device="cuda") -> dict:
    """A flax PitchMLP parameter tree, ``{"params": {"Conv_0": {"kernel",
    "bias"}, "Dense_0": ..., "Dense_<mlp_layers + 1>": ...}}`` with NumPy
    leaves, as the port's state_dict: the conv kernel (5, 1, 16) becomes
    ``conv.weight`` (16, 1, 5), each Dense kernel (in, out) a Linear weight
    (out, in) under ``dense.<i>.weight``."""
    device = resolve_device(device)
    p = tree["params"]
    sd = {
        "conv.weight": tensor_from_numpy(np.transpose(np.asarray(p["Conv_0"]["kernel"]), (2, 1, 0)), device),
        "conv.bias": tensor_from_numpy(p["Conv_0"]["bias"], device),
    }
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    for i in range(n_dense):
        layer = p[f"Dense_{i}"]
        sd[f"dense.{i}.weight"] = tensor_from_numpy(np.asarray(layer["kernel"]).T, device)
        sd[f"dense.{i}.bias"] = tensor_from_numpy(layer["bias"], device)
    return sd


def pitch_mlp_params_to_numpy(state_dict: dict) -> dict:
    """The inverse of pitch_mlp_params_from_numpy: the flax tree with
    NumPy leaves."""
    p = {"Conv_0": {
        "kernel": np.ascontiguousarray(np.transpose(tensor_to_numpy(state_dict["conv.weight"]), (2, 1, 0))),
        "bias": tensor_to_numpy(state_dict["conv.bias"]),
    }}
    n_dense = sum(1 for k in state_dict if k.startswith("dense.") and k.endswith(".weight"))
    for i in range(n_dense):
        p[f"Dense_{i}"] = {
            "kernel": np.ascontiguousarray(tensor_to_numpy(state_dict[f"dense.{i}.weight"]).T),
            "bias": tensor_to_numpy(state_dict[f"dense.{i}.bias"]),
        }
    return {"params": p}


def pipeline_state_from_numpy(arrays: dict, device="cuda") -> PipelineState:
    """``arrays``: "buffer" (B, L), "gain" (B,) and the six analysis leaves
    (ANALYSIS_LEAVES) with their leading stream axis; for a pipeline with
    the ML stage its history (B, T, n_buckets) as "ml_history", and with the
    viewer stage its ball carry as "balls_<leaf>" for each of
    BALL_LEAVES."""
    device = resolve_device(device)
    ml = None
    if "ml_history" in arrays:
        ml = MlState(history=tensor_from_numpy(arrays["ml_history"], device).float())
    balls = None
    if "balls_scale" in arrays:
        balls = ball_state_from_numpy({k: arrays["balls_" + k] for k in BALL_LEAVES}, device)
    return PipelineState(
        ring=RingState(
            buffer=tensor_from_numpy(arrays["buffer"], device).float(),
            gain=tensor_from_numpy(arrays["gain"], device).float(),
        ),
        analysis=AnalysisState(
            **{k: tensor_from_numpy(arrays[k], device).float() for k in ANALYSIS_LEAVES}
        ),
        ml=ml,
        balls=balls,
    )


def pipeline_state_to_numpy(state: PipelineState) -> dict:
    out = {
        "buffer": tensor_to_numpy(state.ring.buffer),
        "gain": tensor_to_numpy(state.ring.gain),
    }
    for k in ANALYSIS_LEAVES:
        out[k] = tensor_to_numpy(getattr(state.analysis, k))
    if state.ml is not None:
        out["ml_history"] = tensor_to_numpy(state.ml.history)
    if state.balls is not None:
        for k, v in ball_state_to_numpy(state.balls).items():
            out["balls_" + k] = v
    return out


def server_state_from_numpy(server, rings, analysis: dict, window=None, balls: dict | None = None,
                            ml_history=None) -> None:
    """Carries a JAX ``StreamServer``'s state into a port ``StreamServer``
    of the same shape, so the port continues it mid-stream.

    ``rings`` is the JAX server's ``NativeRingBank.export_state()`` (audio,
    heads, gains); ``analysis`` holds its analysis carries by the names of
    ANALYSIS_LEAVES; ``window`` is its rolling window on the device (delta
    ingest; a bf16 window becomes f32 exactly). With a window the read
    cursors are set to the write heads, so take the state where the JAX
    server has consumed all the audio it was given (after a step, before
    the next push). Without one, the port's next step re-materializes the
    window from the ring, as after a restore. ``balls`` is the JAX server's
    ball carry (``balls_state``) by the names of BALL_LEAVES, for a server
    with the viewer stage; ``ml_history`` its ML history
    (``ml_state.history``, (B, T, n_buckets)), for a server with the ML
    stage."""
    if (balls is not None) != server.with_viewer:
        raise ValueError("balls must be given exactly when the server has the viewer stage")
    if (ml_history is not None) != (server.ml_model is not None):
        raise ValueError("ml_history must be given exactly when the server has the ML stage")
    audio, heads, gains = rings
    server.rings.import_state(audio, heads, gains)
    state = AnalysisState(
        **{k: tensor_from_numpy(analysis[k], server.device).float() for k in ANALYSIS_LEAVES}
    )
    ball_state = ball_state_from_numpy(balls, server.device) if balls is not None else None
    ml_state = MlState(history=tensor_from_numpy(ml_history, server.device).float()) if ml_history is not None else None
    with server._state_lock:
        server.analysis_state = state
        server.ml_state = ml_state
        server.balls_state = ball_state
        if window is None:
            server._window = None
        else:
            server._window = tensor_from_numpy(window, server.device).float()
            server.rings.mark_consumed()
