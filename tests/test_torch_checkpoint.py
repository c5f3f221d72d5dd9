"""The port's checkpoints (pitchvis_tpu_torch/runtime/checkpoint.py) and
carry-over from the JAX package (convert.py) on the CPU: the server restart
drill, the crash-safe commit, the pipeline's save and load, and a JAX
server's state continued mid-stream by a port server."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from pitchvis_tpu.runtime.server import StreamServer as JaxServer
from pitchvis_tpu_torch import StreamServer, StreamingPipeline
from pitchvis_tpu_torch.convert import ANALYSIS_LEAVES, server_state_from_numpy
from pitchvis_tpu_torch.core.config import AgcParameters, AnalysisParameters
from pitchvis_tpu_torch.runtime.checkpoint import (
    load_pipeline_config,
    load_pipeline_state,
    restore_server,
    save_pipeline_state,
    save_server_state,
)

from conftest import SMALL_PARAMS
from torch_port_helpers import jax_native_lib, streams, to_port  # noqa: F401 (fixture)

HOP = int(SMALL_PARAMS.sr / 60.0)
DT = HOP / SMALL_PARAMS.sr
B = 3


def hops(n, seed):
    a = streams(B, n * HOP, SMALL_PARAMS.sr, seed=seed)
    return [a[:, i * HOP : (i + 1) * HOP] for i in range(n)]


# the JAX package's keys of server_meta.json
SERVER_META_KEYS = {
    "vqt_params", "analysis_params", "n_streams", "capacity", "path", "fast", "ingest", "hop",
    "max_lag", "max_catchup", "with_led", "with_viewer", "fetch", "ml_t_window", "has_ml_state",
}


def warmed_server(path="pallas", ingest="delta"):
    srv = StreamServer(B, to_port(SMALL_PARAMS), buffer_seconds=1.0, path=path, ingest=ingest, device="cpu")
    srv.push_batch(streams(B, int(SMALL_PARAMS.sr * 0.6), SMALL_PARAMS.sr, seed=1))
    srv.step(dt=DT)
    for c in hops(3, seed=2):
        srv.push_batch(c)
        srv.step(dt=DT)
    return srv


@pytest.mark.parametrize("ingest", ["delta", "snapshot"])
def test_server_restart_drill(tmp_path, ingest):
    """save -> close -> restore -> step equals an uninterrupted run on the
    same later audio (the restored window is re-materialized from the ring,
    which holds exactly what the rolled window held)."""
    later = hops(3, seed=4)
    ref = warmed_server(ingest=ingest)
    ref_outs = []
    for c in later:
        ref.push_batch(c)
        ref_outs.append(ref.step(dt=DT))
    ref.close()

    srv = warmed_server(ingest=ingest)
    save_server_state(str(tmp_path / "ckpt"), srv)
    srv.close()  # the process dies
    restored = restore_server(str(tmp_path / "ckpt"), device="cpu")
    assert restored.vqt_params == to_port(SMALL_PARAMS)
    assert restored.path == "pallas" and restored.n_streams == B and restored.ingest == ingest
    for c, (want, want_gains) in zip(later, ref_outs):
        restored.push_batch(c)
        out, gains = restored.step(dt=DT)
        np.testing.assert_array_equal(gains, want_gains)
        for f in dataclasses.fields(out):
            assert torch.equal(getattr(out, f.name), getattr(want, f.name)), f.name
    restored.close()


def test_server_meta_keys(tmp_path):
    """server_meta.json carries the JAX package's keys."""
    srv = warmed_server()
    save_server_state(str(tmp_path / "ckpt"), srv)
    srv.close()
    with open(tmp_path / "ckpt" / "server_meta.json") as f:
        meta = json.load(f)
    assert set(meta) == SERVER_META_KEYS
    with np.load(tmp_path / "ckpt" / "server_rings.npz") as z:
        assert set(z.files) == {"audio", "heads", "gains"}


def test_crash_safe_commit(tmp_path):
    """A stale staging directory does not break the next save; a crash
    between the commit's renames leaves path.old, which restore falls back
    to; with neither, restore raises."""
    path = str(tmp_path / "ckpt")
    srv = StreamServer(2, to_port(SMALL_PARAMS), buffer_seconds=1.0, device="cpu")
    srv.push(0, np.full(512, 0.05, np.float32))
    srv.step(dt=DT)
    save_server_state(path, srv)
    os.makedirs(path + ".tmp/junk")
    srv.step(dt=DT)
    save_server_state(path, srv)
    assert not os.path.exists(path + ".tmp") and not os.path.exists(path + ".old")
    srv.close()
    restore_server(path, device="cpu").close()
    os.rename(path, path + ".old")
    restored = restore_server(path, device="cpu")
    assert restored.n_streams == 2
    restored.close()
    shutil.rmtree(path + ".old")
    with pytest.raises(FileNotFoundError):
        restore_server(path, device="cpu")


def test_restore_without_cuda_raises(tmp_path, monkeypatch):
    srv = warmed_server()
    save_server_state(str(tmp_path / "ckpt"), srv)
    srv.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_server(str(tmp_path / "ckpt"))


def test_pipeline_state_round_trip(tmp_path):
    params = to_port(SMALL_PARAMS)
    ap = dataclasses.replace(AnalysisParameters(), note_calmness_smoothing_duration=7.0)
    gp = AgcParameters(desired_output_rms=0.05)
    pipe = StreamingPipeline(B, params, analysis_params=ap, agc_params=gp, path="pallas", device="cpu")
    chunks = hops(4, seed=5)
    for c in chunks[:3]:
        pipe.step(c, DT)
    save_pipeline_state(str(tmp_path / "p"), pipe.state, params, ap, gp)
    state, got_params = load_pipeline_state(str(tmp_path / "p"), device="cpu")
    assert got_params == params
    assert load_pipeline_config(str(tmp_path / "p")) == (params, ap, gp)
    assert torch.equal(state.ring.buffer, pipe.state.ring.buffer)
    for k in ANALYSIS_LEAVES:
        assert torch.equal(getattr(state.analysis, k), getattr(pipe.state.analysis, k)), k
    resumed = StreamingPipeline(B, params, analysis_params=ap, agc_params=gp, path="pallas", device="cpu")
    resumed.state = state
    assert torch.equal(resumed.step(chunks[3], DT).x_vqt, pipe.step(chunks[3], DT).x_vqt)
    save_pipeline_state(str(tmp_path / "bare"), pipe.state, params)
    assert load_pipeline_config(str(tmp_path / "bare")) == (params, None, None)


@pytest.mark.usefixtures("jax_native_lib")
@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
def test_jax_server_carried_into_port(fast):
    """A JAX server's state (ring image, analysis carries, window) carried
    through convert.server_state_from_numpy into a port server; both then
    step on the same further audio and agree within the pipeline test's
    tolerances (gains equal)."""
    kw = dict(buffer_seconds=1.0, path="pallas", fast=fast)
    jax_srv = JaxServer(B, SMALL_PARAMS, **kw)
    jax_srv.push_batch(streams(B, int(SMALL_PARAMS.sr * 0.6), SMALL_PARAMS.sr, seed=1))
    jax_srv.step(dt=DT)
    for c in hops(4, seed=2):
        jax_srv.push_batch(c)
        jax_srv.step(dt=DT)
    srv = StreamServer(B, to_port(SMALL_PARAMS), device="cpu", **kw)
    server_state_from_numpy(
        srv,
        jax_srv.rings.export_state(),
        {k: np.asarray(getattr(jax_srv.analysis_state, k)) for k in ANALYSIS_LEAVES},
        window=np.asarray(jax_srv._window),
    )
    flips = total = 0
    try:
        for c in hops(6, seed=3):
            jax_srv.push_batch(c)
            srv.push_batch(c)
            jo, jg = jax_srv.step(dt=DT)
            to, tg = srv.step(dt=DT)
            np.testing.assert_array_equal(tg, jg)
            jpk, tpk = np.asarray(jo.peaks), to.peaks.numpy()
            agree = jpk == tpk
            flips += int((~agree).sum())
            total += agree.size
            for name in ("x_vqt_smoothed", "x_vqt_afterglow", "calmness", "peak_size"):
                np.testing.assert_allclose(getattr(to, name).numpy()[agree],
                                           np.asarray(getattr(jo, name))[agree], atol=1e-3, err_msg=name)
            np.testing.assert_allclose(to.scene_calmness.numpy(), np.asarray(jo.scene_calmness), atol=1e-3)
        assert flips <= 2e-4 * total
        assert srv.stats["materializations"] == 0  # the carried window was used
    finally:
        jax_srv.close()
        srv.close()


def ml_model():
    from pitchvis_tpu_torch.models.pitch_mlp import PitchMLP

    return PitchMLP(input_bins=3 * SMALL_PARAMS.n_buckets, mlp_size=32, mlp_layers=2, device="cpu")


def test_server_checkpoint_with_ml_history(tmp_path):
    """A server with the ML stage: its history goes into
    server_ml_state.npz and the meta keys stay the JAX package's, with
    has_ml_state and ml_t_window set; restore_server without a model raises
    ValueError naming ml_model (as the JAX package's does), with it the
    restored server's history and next hops equal the uninterrupted
    server's (torch.equal)."""
    model = ml_model()
    kw = dict(buffer_seconds=1.0, path="pallas", ml_model=model, ml_t_window=3, device="cpu")
    srv = StreamServer(B, to_port(SMALL_PARAMS), **kw)
    srv.push_batch(streams(B, int(SMALL_PARAMS.sr * 0.6), SMALL_PARAMS.sr, seed=1))
    srv.step(dt=DT)
    for c in hops(3, seed=2):
        srv.push_batch(c)
        srv.step(dt=DT)
    path = str(tmp_path / "ckpt")
    save_server_state(path, srv)
    later = hops(3, seed=4)
    want = []
    for c in later:
        srv.push_batch(c)
        want.append(srv.step(dt=DT)[0])
    srv.close()
    with open(os.path.join(path, "server_meta.json")) as f:
        meta = json.load(f)
    assert meta["has_ml_state"] is True and meta["ml_t_window"] == 3
    assert set(meta) == SERVER_META_KEYS
    with np.load(os.path.join(path, "server_ml_state.npz")) as z:
        assert z["history"].shape == (B, 3, SMALL_PARAMS.n_buckets) and np.abs(z["history"]).max() > 0
    with pytest.raises(ValueError, match="ml_model"):
        restore_server(path, device="cpu")
    restored = restore_server(path, ml_model=model, device="cpu")
    try:
        assert restored._ml_t == 3 and restored.ml_model is not model
        for c, w in zip(later, want):
            restored.push_batch(c)
            got, _ = restored.step(dt=DT)
            assert torch.equal(got.ml_midi, w.ml_midi)
            assert torch.equal(got.analysis.x_vqt_smoothed, w.analysis.x_vqt_smoothed)
    finally:
        restored.close()


def test_pipeline_checkpoint_with_ml_history(tmp_path):
    """save_pipeline_state / load_pipeline_state carry the ML history
    (ml_history in the NumPy file, ml_t_window in the meta, as the JAX
    package's key): a pipeline resumed from it gives the same next hop."""
    params = to_port(SMALL_PARAMS)
    model = ml_model()
    pipe = StreamingPipeline(B, params, path="pallas", ml_model=model, ml_t_window=3, device="cpu")
    chunks = hops(4, seed=5)
    for c in chunks[:3]:
        pipe.step(c, DT)
    save_pipeline_state(str(tmp_path / "p"), pipe.state, params)
    with open(tmp_path / "p" / "pipeline_meta.json") as f:
        assert json.load(f)["ml_t_window"] == 3
    state, _ = load_pipeline_state(str(tmp_path / "p"), device="cpu")
    assert torch.equal(state.ml.history, pipe.state.ml.history)
    resumed = StreamingPipeline(B, params, path="pallas", ml_model=model, ml_t_window=3, device="cpu")
    resumed.state = state
    assert torch.equal(resumed.step(chunks[3], DT).ml_midi, pipe.step(chunks[3], DT).ml_midi)
    save_pipeline_state(str(tmp_path / "bare"), StreamingPipeline(B, params, device="cpu").state, params)
    with open(tmp_path / "bare" / "pipeline_meta.json") as f:
        assert json.load(f)["ml_t_window"] is None
    assert load_pipeline_state(str(tmp_path / "bare"), device="cpu")[0].ml is None
