"""Serving-state checkpoint and resume.

Port of ``pitchvis_tpu/runtime/checkpoint.py``. A long-running multi-stream
server wants its carried state (ring audio, AGC gains, EMA/calmness
carries, the ML stage's history, the viewer stage's ball-fade carry) to
survive restarts; the parameter set and the output-stage flags are stored
beside it so a restore can rebuild the matching kernel. The JAX package saves its carries
through orbax, which needs JAX; the port saves them with ``np.savez`` and
reads only its own checkpoints (the metadata files and the ring image have
the JAX package's names and keys, the carries do not). Every save is
staged and committed by renames, so a crash mid-save never destroys the
previous checkpoint. A server over a mesh saves its carries gathered to the
host, in the same files as without one, and a restore over a mesh splits
them again: a checkpoint does not depend on the mesh it was saved from.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np

from ..convert import (
    ANALYSIS_LEAVES,
    ball_state_from_numpy,
    ball_state_to_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)
from ..core.config import (
    AgcParameters,
    AnalysisParameters,
    PeakDetectionParameters,
    VqtParameters,
    VqtRange,
)
from ..models.analysis import AnalysisState
from ..models.ml_system import MlState
from ..models.pipeline import PipelineState
from ..models.viewer import BALL_LEAVES
from ..parallel.sharding import gather
from ..stream.ring import RingState


def _stage_dir(path: str) -> str:
    """Fresh staging directory next to ``path`` (same filesystem, so the
    commit renames are atomic); a leftover from a crashed save is cleared."""
    tmp = path + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp


def _commit_dir(tmp: str, path: str) -> None:
    """Crash-safe checkpoint commit: the fully written staging directory
    replaces ``path`` by renames, so at every instant the disk holds the
    complete previous checkpoint, the complete new one, or (between the two
    renames) only ``path.old``, which the loaders fall back to."""
    old = path + ".old"
    if os.path.exists(path):
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(path, old)
    # with ``path`` absent (a prior save crashed between the renames and only
    # ``path.old`` survives) the new generation goes in before ``path.old``
    # is touched: clearing it first would leave no loadable checkpoint
    os.rename(tmp, path)
    if os.path.isdir(old):
        shutil.rmtree(old)


def _resolve_dir(path: str, marker: str) -> str:
    """Where to load from: ``path`` when it holds a complete checkpoint (its
    ``marker`` metadata is written last), else the ``path.old`` generation a
    crash between _commit_dir's renames leaves behind."""
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, marker)) and os.path.exists(
        os.path.join(path + ".old", marker)
    ):
        return path + ".old"
    return path


def _vqt_params_from_dict(d: dict) -> VqtParameters:
    d = dict(d)
    rng = d.pop("range")
    return VqtParameters(range=VqtRange(**rng), **d)


def _analysis_params_from_dict(d: dict) -> AnalysisParameters:
    d = dict(d)
    d["peak_config"] = PeakDetectionParameters(**d["peak_config"])
    d["bassline_peak_config"] = PeakDetectionParameters(**d["bassline_peak_config"])
    return AnalysisParameters(**d)


def _analysis_arrays(state: AnalysisState) -> dict:
    return {k: tensor_to_numpy(getattr(state, k)) for k in ANALYSIS_LEAVES}


def _analysis_state(arrays, device) -> AnalysisState:
    return AnalysisState(**{k: tensor_from_numpy(arrays[k], device) for k in ANALYSIS_LEAVES})


# ---------------------------------------------------------------------------
# StreamingPipeline (device ring + analysis carries)
# ---------------------------------------------------------------------------


def save_pipeline_state(
    path: str,
    state: PipelineState,
    params: VqtParameters,
    analysis_params: AnalysisParameters | None = None,
    agc_params: AgcParameters | None = None,
) -> None:
    """Pass the pipeline's ``analysis_params``/``agc_params`` too when they
    differ from the defaults: the restored carries are only meaningful under
    the time constants and AGC target they were stepped with
    (``load_pipeline_config`` returns them)."""
    path = os.path.abspath(path)
    tmp = _stage_dir(path)
    stages = {}
    if state.ml is not None:
        stages["ml_history"] = tensor_to_numpy(state.ml.history)
    if state.balls is not None:
        stages.update({"balls_" + k: v for k, v in ball_state_to_numpy(state.balls).items()})
    np.savez(
        os.path.join(tmp, "pipeline_state.npz"),
        buffer=tensor_to_numpy(state.ring.buffer),
        gain=tensor_to_numpy(state.ring.gain),
        **_analysis_arrays(state.analysis),
        **stages,
    )
    meta = {
        "params": dataclasses.asdict(params),
        "analysis_params": (
            dataclasses.asdict(analysis_params) if analysis_params is not None else None
        ),
        "agc_params": dataclasses.asdict(agc_params) if agc_params is not None else None,
        "n_streams": int(state.ring.buffer.shape[0]),
        "buffer_len": int(state.ring.buffer.shape[1]),
        "ml_t_window": int(state.ml.history.shape[1]) if state.ml is not None else None,
        "with_viewer": state.balls is not None,
    }
    with open(os.path.join(tmp, "pipeline_meta.json"), "w") as f:
        json.dump(meta, f)
    _commit_dir(tmp, path)


def load_pipeline_config(
    path: str,
) -> tuple[VqtParameters, AnalysisParameters | None, AgcParameters | None]:
    """The full parameter set a checkpointed pipeline ran under (analysis/
    AGC entries are None for checkpoints saved without them)."""
    with open(os.path.join(_resolve_dir(path, "pipeline_meta.json"), "pipeline_meta.json")) as f:
        meta = json.load(f)
    ap = meta.get("analysis_params")
    gp = meta.get("agc_params")
    return (
        _vqt_params_from_dict(meta["params"]),
        _analysis_params_from_dict(ap) if ap is not None else None,
        AgcParameters(**gp) if gp is not None else None,
    )


def load_pipeline_state(path: str, device="cuda") -> tuple[PipelineState, VqtParameters]:
    """The saved state on ``device`` (the card unless ``device="cpu"``) and
    the VQT parameters it ran under."""
    path = _resolve_dir(path, "pipeline_meta.json")
    with open(os.path.join(path, "pipeline_meta.json")) as f:
        meta = json.load(f)
    params = _vqt_params_from_dict(meta["params"])
    with np.load(os.path.join(path, "pipeline_state.npz")) as z:
        ml = balls = None
        if meta.get("ml_t_window"):
            ml = MlState(history=tensor_from_numpy(z["ml_history"], device))
        if meta.get("with_viewer", False):
            balls = ball_state_from_numpy({k: z["balls_" + k] for k in BALL_LEAVES}, device)
        state = PipelineState(
            ring=RingState(buffer=tensor_from_numpy(z["buffer"], device), gain=tensor_from_numpy(z["gain"], device)),
            analysis=_analysis_state(z, device),
            ml=ml,
            balls=balls,
        )
    if tuple(state.ring.buffer.shape) != (meta["n_streams"], meta["buffer_len"]):
        raise ValueError(f"saved ring {tuple(state.ring.buffer.shape)} does not match its metadata")
    return state, params


# ---------------------------------------------------------------------------
# StreamServer (native rings + analysis carries)
# ---------------------------------------------------------------------------


def save_server_state(path: str, server) -> None:
    """Checkpoints a running StreamServer: the native ring bank image (audio
    windows, total-written counters, AGC gains), the per-stream analysis
    carries, the ML history (with the ML stage) and the ball carry (with the
    viewer stage), and the parameter set and serving flags (output stages
    and the ML window included) needed to rebuild the matching server on
    restore. The model itself is code and weights, not serving state: the
    caller passes it again to restore_server.

    The carries are captured first and the ring image after, not as one
    atomic cut: streams that receive audio during the save may be up to one
    hop newer in the ring than in the carries (restore replays that audio).
    The opposite order would be unsafe: carries computed from audio absent
    from the saved ring. Safe to call from the control plane while ingest
    and step() continue."""
    path = os.path.abspath(path)
    tmp = _stage_dir(path)
    with server._state_lock:
        state = server.analysis_state
        ml_state = server.ml_state
        balls = server.balls_state
        vqt_params = server.vqt_params
        analysis_params = server.analysis_params
    # a mesh server's carries, its slices in row order (the identity without one)
    state, ml_state, balls = gather((state, ml_state, balls))
    carries = _analysis_arrays(state)
    audio, heads, gains = server.rings.export_state()
    np.savez_compressed(os.path.join(tmp, "server_rings.npz"), audio=audio, heads=heads, gains=gains)
    np.savez(os.path.join(tmp, "server_analysis_state.npz"), **carries)
    if ml_state is not None:
        np.savez(os.path.join(tmp, "server_ml_state.npz"), history=tensor_to_numpy(ml_state.history))
    if balls is not None:
        np.savez(os.path.join(tmp, "server_balls_state.npz"), **ball_state_to_numpy(balls))
    meta = {
        "vqt_params": dataclasses.asdict(vqt_params),
        "analysis_params": dataclasses.asdict(analysis_params),
        "n_streams": server.n_streams,
        "capacity": server.rings.capacity,
        "path": server.path,
        "fast": server.fast,
        "ingest": server.ingest,
        "hop": server._hop,
        "max_lag": server._max_lag,
        "max_catchup": server._max_catchup,
        "with_led": server.with_led,
        "with_viewer": server.with_viewer,
        "fetch": server.fetch,
        "ml_t_window": server._ml_t,
        "has_ml_state": ml_state is not None,
    }
    with open(os.path.join(tmp, "server_meta.json"), "w") as f:
        json.dump(meta, f)
    _commit_dir(tmp, path)


def restore_server(path: str, ml_model=None, ml_params=None, mesh=None, device="cuda"):
    """Rebuilds a StreamServer from save_server_state on ``device`` (the
    card unless ``device="cpu"``): the same parameters and serving config,
    the ring audio, write positions and AGC gains, and the analysis
    carries, so trajectories continue where the dead process left off. The
    window is re-materialized from the ring on the first step. The output
    stages (``with_led``, ``with_viewer``, ``fetch``) are restored with the
    ball carry. Producers re-attach to their previous slots afterwards.

    ``ml_model``/``ml_params`` re-attach the model a checkpointed ML-serving
    server used (``ml_params`` None: the module's own weights); a checkpoint
    that carries an ML history raises ValueError without ``ml_model``.
    ``mesh`` re-attaches a device mesh (the placement is not part of the
    checkpoint): the restored carries are split over it."""
    from .server import StreamServer

    path = _resolve_dir(path, "server_meta.json")
    with open(os.path.join(path, "server_meta.json")) as f:
        meta = json.load(f)
    vqt_params = _vqt_params_from_dict(meta["vqt_params"])
    analysis_params = _analysis_params_from_dict(meta["analysis_params"])
    if meta.get("has_ml_state") and ml_model is None:
        raise ValueError(
            "checkpoint carries an ML history; pass ml_model (and its ml_params) "
            "to restore_server to continue identical serving"
        )

    server = StreamServer(
        meta["n_streams"],
        vqt_params,
        analysis_params,
        buffer_seconds=meta["capacity"] / vqt_params.sr,
        path=meta["path"],
        fast=meta["fast"],
        ingest=meta.get("ingest", "delta"),
        hop_seconds=meta.get("hop", int(vqt_params.sr / 60.0)) / vqt_params.sr,
        max_lag_seconds=meta.get("max_lag", int(vqt_params.sr * 0.25)) / vqt_params.sr,
        max_catchup_hops=meta.get("max_catchup", 1),
        with_led=meta.get("with_led", False),
        with_viewer=meta.get("with_viewer", False),
        fetch=meta.get("fetch", "full"),
        ml_model=ml_model,
        ml_params=ml_params,
        ml_t_window=meta.get("ml_t_window"),
        mesh=mesh,
        device=device,
    )
    if server.rings.capacity != meta["capacity"]:  # rounding drift
        raise RuntimeError(f"restored capacity {server.rings.capacity} != saved {meta['capacity']}")
    # the exact integers, past the float seconds round trip
    server._hop = int(meta["hop"])
    server._max_lag = int(meta["max_lag"])
    with np.load(os.path.join(path, "server_rings.npz")) as rings:
        server.rings.import_state(rings["audio"], rings["heads"], rings["gains"])
    # without a mesh the carries load straight onto the server's device;
    # over one they load on the host and each slot's rows are copied once
    device = server.device if mesh is None else "cpu"
    with np.load(os.path.join(path, "server_analysis_state.npz")) as z:
        server.analysis_state = server._put_state(_analysis_state(z, device))
    if meta.get("has_ml_state") and server.ml_state is not None:
        with np.load(os.path.join(path, "server_ml_state.npz")) as z:
            server.ml_state = server._put_state(MlState(history=tensor_from_numpy(z["history"], device)))
    if server.with_viewer:
        with np.load(os.path.join(path, "server_balls_state.npz")) as z:
            server.balls_state = server._put_state(ball_state_from_numpy(z, device))
    return server
