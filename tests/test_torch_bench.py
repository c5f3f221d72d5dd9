"""The port's bench (pitchvis_tpu_torch/bench/) against the JAX package's
(pitchvis_tpu/bench/configs.py, the root bench.py), on the CPU.

- The same work: for each configuration, one unit of the port's work (one
  hop, one step, one batch) on the bench's own seeded inputs equals the unit
  of the JAX functions that the JAX bench times, at small sizes, within the
  tolerances the port's tests state for each function (named at each test).
- The same dicts: the cheap configurations run through both packages at the
  same tiny arguments and return the same keys, metric names and units; the
  others are held to key lists copied from the JAX source.
- The runner: the sweep's "closest to the median, verbatim" rule and the
  ``--check`` gate, on fake configurations, as tests/test_bench_sweep.py and
  tests/test_bench_gate.py test bench.py; the default outputs under build/.
"""

import functools
import json
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pitchvis_tpu.bench import configs as jconfigs
from pitchvis_tpu.core.config import SERIAL_VQT_PARAMETERS, AnalysisParameters, VqtParameters
from pitchvis_tpu.io.led import led_frame_values as jax_led_frame_values
from pitchvis_tpu.kernel.builder import get_kernel as jax_get_kernel
from pitchvis_tpu.models import render as jr
from pitchvis_tpu.models import viewer as jv
from pitchvis_tpu.models.analysis import analysis_step_batch as jax_analysis_step_batch
from pitchvis_tpu.models.analysis import init_state_batch as jax_init_state_batch
from pitchvis_tpu.models.pipeline import StreamingPipeline as JaxPipeline
from pitchvis_tpu.models.pitch_mlp import PitchMLP as JaxPitchMLP
from pitchvis_tpu.ops.vqt import VqtArrays as JaxVqtArrays
from pitchvis_tpu.ops.vqt import vqt_db_batch as jax_vqt_db_batch
from pitchvis_tpu.ops.vqt_pallas import PallasVqtArrays as JaxPallasVqtArrays
from pitchvis_tpu.ops.vqt_pallas import vqt_db_pallas as jax_vqt_db_pallas
from pitchvis_tpu.runtime.server import StreamServer as JaxServer
from pitchvis_tpu.synth.midi import load_midi as j_load_midi
from pitchvis_tpu.synth.sf2 import SoundFont as JSoundFont
from pitchvis_tpu.train import dataset as jds
from pitchvis_tpu.train import device_dataset as jdd
from pitchvis_tpu.ops.vqt import Vqt as JVqt
from pitchvis_tpu_torch import bench as tbench
from pitchvis_tpu_torch.bench import __main__ as runner
from pitchvis_tpu_torch.bench import configs
from pitchvis_tpu_torch.convert import pitch_mlp_params_from_numpy
from pitchvis_tpu_torch.models.pitch_mlp import PitchMLP
from pitchvis_tpu_torch.ops.vqt import Vqt as TVqt
from pitchvis_tpu_torch.synth.midi import load_midi as t_load_midi
from pitchvis_tpu_torch.synth.sf2 import SoundFont as TSoundFont
from pitchvis_tpu_torch.train import dataset as tds
from pitchvis_tpu_torch.train import device_dataset as tdd
from pitchvis_tpu_torch import xtask

from conftest import SMALL_PARAMS
from tests.test_synth import SMALL_TRAIN_PARAMS
from torch_port_helpers import jax_native_lib, to_port, u8_within_one_level  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3
HOP = int(SMALL_PARAMS.sr / 60.0)
DT = HOP / SMALL_PARAMS.sr
P_SMALL = to_port(SMALL_PARAMS)
# tests/test_torch_pipeline.py::test_hop_matches_jax: dB spectra atol 1e-3,
# gains rtol 1e-6, continuous analysis outputs atol 1e-3 where the peaks
# agree, at most 2e-4 of the peak bins flipped
DB_ATOL = 1e-3
GAIN_RTOL = 1e-6
FLIP_SHARE = 2e-4
# tests/test_torch_ml.py: an entry point's ml_midi against the JAX
# package's, atol 1e-4; the model on the same inputs and weights, atol 1e-5
ENTRY_MIDI_ATOL = 1e-4
MODEL_ATOL = 1e-5
# tests/test_torch_led.py: u8 values within one level in at most 1e-5 of them
U8_FLIP_SHARE = 1e-5
# tests/test_torch_dataset.py: the host route's targets and label gains
# equal, spectra within 1e-3 dB where they stand 10 dB over the floor; the
# device route's label gains rtol 1e-5, spectra within 1e-2 dB
HOST_DB_TOL = 1e-3
DEVICE_DB_TOL = 1e-2
LABEL_RTOL = 1e-5


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_analysis_close(to, jo, what):
    """The analysis budget of test_hop_matches_jax on one hop's outputs."""
    jpk, tpk = np.asarray(jo.peaks), _np(to.peaks)
    agree = jpk == tpk
    assert (~agree).sum() <= FLIP_SHARE * agree.size, f"{what}: {(~agree).sum()} peak bins flipped"
    for name in ("x_vqt_smoothed", "x_vqt_afterglow", "calmness", "peak_center", "peak_size",
                 "pitch_accuracy", "pitch_deviation"):
        np.testing.assert_allclose(_np(getattr(to, name))[agree], np.asarray(getattr(jo, name))[agree],
                                   atol=DB_ATOL, err_msg=f"{name} {what}")
    for name in ("scene_calmness", "tuning_inaccuracy"):
        np.testing.assert_allclose(_np(getattr(to, name)), np.asarray(getattr(jo, name)), atol=DB_ATOL,
                                   err_msg=f"{name} {what}")


# ---- the same work -------------------------------------------------------------


@pytest.mark.parametrize("path,fast", [("time", False), ("time", True), ("pallas", False), ("pallas", True)])
def test_offline_unit_matches_jax(path, fast):
    """One offline VQT batch on the bench's frames: dB within 1e-3."""
    unit = configs.offline_vqt_work(batch=B, path=path, fast=fast, params=P_SMALL, device="cpu")
    x = jnp.asarray(configs.offline_inputs(B, SMALL_PARAMS.n_fft))
    kernel = jax_get_kernel(SMALL_PARAMS)
    dtype = jnp.bfloat16 if fast else jnp.float32
    if path == "pallas":
        want = jax_vqt_db_pallas(JaxPallasVqtArrays.from_kernel(kernel, dtype=dtype), x, batch_tile=512)
    else:
        precision = jax.lax.Precision.DEFAULT if fast else jax.lax.Precision.HIGHEST
        want = jax_vqt_db_batch(JaxVqtArrays.from_kernel(kernel, dtype=dtype), x, path=path, precision=precision)
    np.testing.assert_allclose(unit(0).numpy(), np.asarray(want), atol=DB_ATOL)


STREAMING = {
    "streaming": dict(fused=False, path="time", fast=False, with_viewer=False),
    "streaming_pallas_bf16": dict(fused=False, path="pallas", fast=True, with_viewer=False),
    "streaming_fused": dict(fused=True, path="time", fast=False, with_viewer=False),
    "streaming_fused_pallas_bf16": dict(fused=True, path="pallas", fast=True, with_viewer=False),
    "streaming_fused_viewer_pallas_bf16": dict(fused=True, path="pallas", fast=True, with_viewer=True),
}


def _jax_streaming_pipeline(fused, path, fast, with_viewer):
    """The JAX bench's pipeline of a streaming config, at SMALL_PARAMS."""
    if not fused:
        return JaxPipeline(B, SMALL_PARAMS, path=path, fast=fast), None
    t = configs.ML_T_WINDOW
    model = JaxPitchMLP(input_bins=t * SMALL_PARAMS.n_buckets)
    mp = model.init(jax.random.PRNGKey(0), np.zeros((1, 1, t * SMALL_PARAMS.n_buckets), np.float32))
    pipe = JaxPipeline(B, SMALL_PARAMS, ml_model=model, ml_params=mp, ml_t_window=t, with_led=True, path=path,
                       fast=fast, with_viewer=with_viewer)
    return pipe, mp


@pytest.mark.parametrize("name", list(STREAMING))
def test_streaming_unit_matches_jax(name):
    """Two hops of step_multi on the bench's chunks (the port's ML stage
    given the flax model's weights): spectra, gains and the analysis at the
    hop budget, ml_midi atol 1e-4, LED values within one level, the
    viewer's bloom and chroma atol 1e-3 (its inputs' budget)."""
    kw = STREAMING[name]
    jpipe, mp = _jax_streaming_pipeline(**kw)
    sd = None if mp is None else pitch_mlp_params_from_numpy(jax.tree.map(np.asarray, mp), device="cpu")
    pipe = configs.streaming_pipeline(B, params=P_SMALL, ml_params=sd, device="cpu", **kw)
    chunks = configs.streaming_inputs(2, B, HOP)
    got = pipe.step_multi(torch.from_numpy(chunks), DT)
    want = jpipe.step_multi(jnp.asarray(chunks), DT)
    np.testing.assert_allclose(got.x_vqt.numpy(), np.asarray(want.x_vqt), atol=DB_ATOL)
    np.testing.assert_allclose(got.gain.numpy(), np.asarray(want.gain), rtol=GAIN_RTOL)
    _assert_analysis_close(got.analysis, want.analysis, name)
    if kw["fused"]:
        np.testing.assert_allclose(got.ml_midi.numpy(), np.asarray(want.ml_midi), atol=ENTRY_MIDI_ATOL)
        u8_within_one_level(got.led.numpy(), np.asarray(want.led), U8_FLIP_SHARE, "led")
    if kw["with_viewer"]:
        for leaf in ("bloom", "chroma"):
            np.testing.assert_allclose(getattr(got.viewer, leaf).numpy(), np.asarray(getattr(want.viewer, leaf)),
                                       atol=DB_ATOL, err_msg=leaf)


def test_latency_units_match_jax(jax_native_lib):
    """The latency config's pipeline hop and its server's first hop (stream
    0 fed the chunk's first row) against the JAX package's: the hop budget
    of tests/test_torch_pipeline.py and tests/test_torch_server.py."""
    chunk = configs.latency_inputs(B, HOP)
    pipe = configs.streaming_pipeline(B, path="pallas", fast=True, params=P_SMALL, device="cpu")
    jpipe = JaxPipeline(B, SMALL_PARAMS, path="pallas", fast=True)
    got, want = pipe.step(chunk, DT), jpipe.step(chunk, DT)
    np.testing.assert_allclose(got.x_vqt.numpy(), np.asarray(want.x_vqt), atol=DB_ATOL)
    _assert_analysis_close(got.analysis, want.analysis, "pipeline hop")

    srv = configs.latency_server(B, params=P_SMALL, device="cpu")
    jsrv = JaxServer(B, SMALL_PARAMS, buffer_seconds=1.0, path="pallas", fast=True)
    try:
        jsrv.push(0, chunk[0])
        (got, ggains), (want, wgains) = srv.step(dt=DT), jsrv.step(dt=DT)
        np.testing.assert_allclose(ggains, np.asarray(wgains), rtol=GAIN_RTOL)
        _assert_analysis_close(got, want, "server hop")
    finally:
        srv.close()
        jsrv.close()


def _library_that_does_not_build():
    raise RuntimeError("the native ingest library does not build here")


def test_latency_server_skips_only_on_the_cpu(monkeypatch):
    """Without the native ingest library the latency config's server is None
    on the CPU (the JAX bench's skip), and on the card the library's error
    propagates, so that no latency result there lacks its server keys."""
    from pitchvis_tpu_torch.runtime import native

    monkeypatch.setattr(native, "load", _library_that_does_not_build)
    assert configs.latency_server(B, params=P_SMALL, device="cpu") is None
    monkeypatch.setattr(configs, "resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(RuntimeError, match="does not build"):
        configs.latency_server(B, params=P_SMALL)


def test_analysis_unit_matches_jax():
    """Two analysis steps on the bench's spectra, scaled by 1 + 1e-4 i as
    the JAX scan scales them: the analysis budget."""
    state, unit = configs.analysis_work(B, params=P_SMALL, device="cpu")
    jstate = jax_init_state_batch(B, SMALL_PARAMS.n_buckets)
    x = jnp.asarray(configs.analysis_inputs(B, SMALL_PARAMS.n_buckets))
    for i in range(2):
        state, got = unit(state, i)
        jstate, want = jax_analysis_step_batch(AnalysisParameters(), SMALL_PARAMS.range, jstate,
                                               x * (1.0 + 1e-4 * jnp.float32(i)), 1.0 / 60.0)
        _assert_analysis_close(got, want, f"step {i}")


def test_serial_unit_matches_jax():
    """Two LED frames of the bench's peaks (sizes scaled by 1 + 1e-4 i):
    within one level in at most 1e-5 of the values."""
    unit = configs.serial_work(4, device="cpu")
    rng_cfg = SERIAL_VQT_PARAMETERS.range
    mask, center, size = (jnp.asarray(a) for a in configs.serial_inputs(4, rng_cfg.n_buckets))
    batched = jax.vmap(lambda m, c, s: jax_led_frame_values(rng_cfg, m, c, s))
    for i in range(2):
        want = batched(mask, center, size * (1.0 + 1e-4 * jnp.float32(i)))
        u8_within_one_level(unit(i).numpy(), np.asarray(want), U8_FLIP_SHARE, f"frame {i}")


def _labels_close(a, b, rtol):
    assert set(a) == set(b), (a, b)
    for k in a:
        assert (a[k] > 0.5) == (b[k] > 0.5), (k, a[k], b[k])
        assert abs(a[k] - b[k]) <= rtol * max(abs(a[k]), 1e-12), (k, a[k], b[k])


def _spectra_close(a, b, tol):
    strong = a >= 10.0
    if strong.any():
        assert float(np.abs(a[strong] - b[strong]).max()) <= tol


@pytest.mark.parametrize("device_gen", [False, True], ids=["host_route", "device_route"])
def test_train_unit_matches_jax(device_gen, tmp_path, jax_native_lib):
    """The train config's annotation of its own MIDI file (and font, on the
    host route) at SMALL_TRAIN_PARAMS, against the JAX package's: the
    dataset tests' budgets; then the model on the bench's windows with the
    flax model's weights, atol 1e-5."""
    params, t_params = SMALL_TRAIN_PARAMS, to_port(SMALL_TRAIN_PARAMS)
    midi_path, sf_path = configs.train_inputs(str(tmp_path), 2.5, int(params.sr), with_font=not device_gen)
    jv_, tv_ = JVqt(params), TVqt(t_params, device="cpu")
    if device_gen:
        want = jdd.annotate_midi_device(j_load_midi(midi_path), jv_, params, max_seconds=2.5)
        got = tdd.annotate_midi_device(t_load_midi(midi_path), tv_, t_params, max_seconds=2.5)
    else:
        want = jds.annotate_midi(j_load_midi(midi_path), jv_, params, max_seconds=2.5,
                                 sound_font=JSoundFont.from_file(sf_path))
        got = tds.annotate_midi(t_load_midi(midi_path), tv_, t_params, max_seconds=2.5,
                                sound_font=TSoundFont.from_file(sf_path))
    assert len(got) == len(want) > 4
    for (jk, js), (tk, ts) in zip(want, got):
        if device_gen:
            _labels_close(jk, tk, LABEL_RTOL)
        else:
            assert jk == tk
        _spectra_close(js, ts, DEVICE_DB_TOL if device_gen else HOST_DB_TOL)

    windows = configs.train_windows(got)
    jm = JaxPitchMLP(input_bins=5 * params.n_buckets, mlp_size=32)
    mp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 5 * params.n_buckets)))
    tm = PitchMLP(input_bins=5 * params.n_buckets, mlp_size=32, device="cpu").eval()
    tm.load_state_dict(pitch_mlp_params_from_numpy(jax.tree.map(np.asarray, mp), device="cpu"))
    with torch.inference_mode():
        out = tm(torch.from_numpy(windows)[:, None, :]).numpy()
    np.testing.assert_allclose(out, np.asarray(jm.apply(mp, jnp.asarray(windows)[:, None, :])), atol=MODEL_ATOL)


def test_train_corpus_unit_matches_jax(tmp_path, jax_native_lib):
    """generate_dataset over the corpus config's own font and files (2 of
    1 s), on 2 workers: targets equal, spectra within 1e-3 dB."""
    params, t_params = SMALL_TRAIN_PARAMS, to_port(SMALL_TRAIN_PARAMS)
    sf_path, paths = configs.corpus_inputs(str(tmp_path), 2, 1.0, int(params.sr))
    kw = dict(sound_font_path=sf_path, max_seconds_per_file=1.0, n_workers=2)
    row = params.n_buckets + 128
    want = jds.generate_dataset(paths, params, **kw).reshape(-1, row)
    got = tds.generate_dataset(paths, t_params, device="cpu", **kw).reshape(-1, row)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_array_equal(got[:, params.n_buckets :], want[:, params.n_buckets :])
    for a, b in zip(want[:, : params.n_buckets], got[:, : params.n_buckets]):
        _spectra_close(a, b, HOST_DB_TOL)


RENDER_KW = dict(n_streams=2, width=64, height=36, max_balls=4)


def _jax_render_unit(n_streams, width, height, max_balls):
    """The JAX bench's render of its seeded scenes, one frame at time t."""
    rng_cfg = VqtParameters().range
    n = rng_cfg.n_buckets
    cfg = jr.RenderConfig(width=width, height=height, max_balls=max_balls)
    st = jr.make_scene(cfg, rng_cfg)
    a = {k: jnp.asarray(v) for k, v in configs.render_inputs(n_streams, n).items()}
    balls = jax.vmap(lambda p, c, s, cl, ac, d: jv.update_balls(
        rng_cfg, jv.BallState.init(n), p, c, s, cl, ac, d, 1.0 / 60.0)[1])(
        a["peaks"], a["center"], a["size"], a["calm"], a["acc"], a["dev"])
    bass = jax.vmap(lambda p, c, s: jv.bass_spiral(rng_cfg, p, c, s))(a["peaks"], a["center"], a["size"])
    sc = jnp.full((n_streams,), 0.5, jnp.float32)

    @jax.jit
    def frames(t):
        return jax.vmap(lambda ba, bs, c: jr._render_frame_impl(
            cfg, rng_cfg, st.background, st.bass_idx, st.bass_cov, st.text_premul, st.text_a, ba, bs, c, t,
        ))(balls, bass, sc)

    return frames


def test_render_unit_matches_jax():
    """Two frames of the render config's scenes at 64x36, the shader time
    advancing: within one 8-bit step (tests/test_torch_render.py)."""
    unit = configs.render_work(device="cpu", **RENDER_KW)
    frames = _jax_render_unit(**RENDER_KW)
    for i in range(2):
        got = unit(i).numpy()
        want = np.asarray(frames(jnp.float32(i) / 60.0))
        assert got.shape == want.shape == (2, 36, 64, 3) and got.dtype == want.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, f"frame {i}"
    assert got.any(), "the scenes rendered nothing"


# ---- the same dicts --------------------------------------------------------------

# the keys of each JAX config's result beyond metric/value/unit/vs_baseline
# (pitchvis_tpu/bench/configs.py:233-239, :262-263, :279-280, :300-301,
# :498-503, :578-583)
EXTRA_KEYS = {
    "latency": {"p95_ms", "pipelined_hop_ms", "n_streams", "server_pipelined_hop_p50_ms",
                "server_pipelined_hop_p95_ms", "server_multi_hop_ms", "server_multi_k",
                "serve_loop_gap_p50_ms", "serve_loop_gap_p95_ms"},
    "train_corpus": {"speedup_vs_serial", "n_workers"},
    "render": {"raster", "max_balls"},
}
BASE_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.mark.parametrize("name,kw", [
    ("offline_vqt", dict(batch=2, path="time", inner=1)),
    ("analysis", dict(n_streams=2, inner=1)),
    ("serial", dict(n_streams=2, inner=1)),
    ("render", dict(inner=1, **RENDER_KW)),
])
def test_cheap_configs_return_the_jax_dicts(name, kw):
    fn = {"offline_vqt": "bench_offline_vqt", "analysis": "bench_analysis", "serial": "bench_serial",
          "render": "bench_render"}[name]
    want = getattr(jconfigs, fn)(**kw)
    got = getattr(configs, fn)(device="cpu", **kw)
    assert set(got) == set(want) == BASE_KEYS | EXTRA_KEYS.get(name, set())
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    for key in set(got) - {"metric", "unit"}:
        assert type(got[key]) is type(want[key]), key
    if name == "render":
        assert got["raster"] == want["raster"] and got["max_balls"] == want["max_balls"]


# the metric and unit of each JAX config (pitchvis_tpu/bench/configs.py:111-113,
# :180-182, :233-235, :442-444, :498-500)
@pytest.mark.parametrize("name,call,metric,unit", [
    ("offline_vqt_bf16", functools.partial(configs.bench_offline_vqt, batch=2, inner=1, fast=True),
     "vqt_bf16_frames_per_sec_per_chip", "frames/s"),
    ("streaming", functools.partial(configs.bench_streaming, n_streams=2, hops_per_call=1),
     "streaming_realtime_factor_per_chip", "x realtime (aggregate)"),
    ("streaming_fused_viewer_pallas_bf16",
     functools.partial(configs.bench_streaming, n_streams=2, hops_per_call=1, with_viewer=True, path="pallas",
                       fast=True),
     "streaming_fused_viewer_pallas_bf16_realtime_factor_per_chip", "x realtime (aggregate)"),
    ("latency", functools.partial(configs.bench_latency, n_streams=2, iters=3),
     "serving_hop_latency_p50_ms", "ms"),
    ("train", functools.partial(configs.bench_train, seconds=3.0), "train_labeled_frames_per_sec", "frames/s"),
    ("train_corpus", functools.partial(configs.bench_train_corpus, n_files=2, seconds=1.0, n_workers=2),
     "train_corpus_labeled_frames_per_sec", "frames/s"),
])
def test_other_configs_return_the_jax_keys(name, call, metric, unit, jax_native_lib):
    got = call(device="cpu")
    assert set(got) == BASE_KEYS | EXTRA_KEYS.get(name, set()), sorted(got)
    assert got["metric"] == metric and got["unit"] == unit
    assert all(np.isfinite(v) for v in got.values() if isinstance(v, float))


def test_all_configs_are_the_jax_configs():
    assert list(configs.ALL_CONFIGS) == list(jconfigs.ALL_CONFIGS)
    assert configs.REFERENCE_VQT_FPS == jconfigs.REFERENCE_VQT_FPS
    # the same arguments: each entry's keywords are those of the JAX lambda
    p = configs.ALL_CONFIGS
    assert p["streaming_pallas_bf16"].keywords == dict(n_streams=2048, path="pallas", fast=True)
    assert p["streaming_fused_viewer_pallas_bf16"].keywords == dict(with_viewer=True, path="pallas", fast=True)
    assert p["offline_vqt_bf16"].keywords == dict(fast=True)


# ---- the runner ------------------------------------------------------------------


def _fake_configs(monkeypatch, table):
    monkeypatch.setattr(configs, "ALL_CONFIGS", {k: (lambda fn=fn, **kw: fn()) for k, fn in table.items()})


def test_sweep_takes_the_median_run_verbatim(monkeypatch, tmp_path):
    """The entry is the RUN closest to the median, verbatim, with its own
    vs_baseline (a rescale would be wrong for the latency's headroom)."""
    runs = iter([{"metric": "lat_ms", "value": v, "unit": "ms", "vs_baseline": 16.7 / v} for v in (5.0, 20.0, 10.0)])
    _fake_configs(monkeypatch, {"lat": lambda: next(runs)})
    path = tmp_path / "sweep.json"
    runner._run_sweep(3, str(path), device="cpu")
    entry = json.loads(path.read_text())["lat"]
    assert entry["value"] == 10.0 and entry["vs_baseline"] == 16.7 / 10.0
    assert sorted(entry["runs"]) == [5.0, 10.0, 20.0] and entry["config"] == "lat"


@pytest.mark.parametrize("committed,live,lower,rc", [
    ({"a": 100.0}, {"a": 41.0}, (), 0),
    ({"a": 100.0, "b": 10.0}, {"a": 39.0, "b": 10.0}, (), 1),
    ({"lat": 100.0}, {"lat": 240.0}, ("lat",), 0),
    ({"lat": 100.0}, {"lat": 260.0}, ("lat",), 1),
    ({"gone": 5.0, "a": 1.0}, {"a": 1.0}, (), 0),
], ids=["within", "beyond", "lower_within", "lower_beyond", "removed_config"])
def test_check_gate(committed, live, lower, rc, monkeypatch, tmp_path, capsys):
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps({k: {"value": v, "unit": "x"} for k, v in committed.items()}))
    _fake_configs(monkeypatch, {k: (lambda v=v: {"value": v}) for k, v in live.items()})
    monkeypatch.setattr(runner, "_LOWER_IS_BETTER", set(lower))
    assert runner._check(2, str(path), device="cpu") == rc
    if rc:
        assert '"regressed": [' in capsys.readouterr().out


def test_check_without_a_sweep_fails(tmp_path, capsys):
    assert runner._check(2, str(tmp_path / "none.json"), device="cpu") == 1
    assert "no sweep file" in capsys.readouterr().out


def test_default_lines_and_flags(monkeypatch, capsys):
    """The default prints the f32 line, then the bf16 line last; --fast,
    --path/--batch print one line; --config runs one entry; an unknown
    config is refused."""
    calls = []

    def fake(**kw):
        calls.append(kw)
        return {"metric": "fast" if kw.get("fast") else "f32", "value": 1.0}

    monkeypatch.setattr(configs, "bench_offline_vqt", fake)
    assert runner.main(["--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [d["metric"] for d in lines] == ["f32", "fast"]
    assert runner.main(["--device", "cpu", "--path", "time", "--batch", "4"]) == 0
    assert calls[-1] == {"device": torch.device("cpu"), "path": "time", "batch": 4}
    assert runner.main(["--device", "cpu", "--fast"]) == 0
    assert calls[-1]["fast"] is True
    _fake_configs(monkeypatch, {"x": lambda: {"metric": "m", "value": 2.0}})
    capsys.readouterr()
    assert runner.main(["--device", "cpu", "--config", "x"]) == 0
    assert json.loads(capsys.readouterr().out)["value"] == 2.0
    assert runner.main(["--device", "cpu", "--config", "nope"]) == 2


def test_runner_refuses_a_missing_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert runner.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_default_outputs_lie_under_build_and_are_not_tracked():
    build = os.path.join(ROOT, "build")
    outputs = [tbench.SWEEP_PATH, tbench.SOAK_PATH, tbench.LONGHAUL_PATH, os.path.join(ROOT, xtask.GOLDEN_DIR)]
    for path in outputs:
        assert os.path.commonpath([path, build]) == build, path
    # none of the JAX package's measurements or goldens
    for theirs in ("BENCH_SWEEP.json", "artifacts", os.path.join("tests", "golden")):
        assert all(os.path.commonpath([p, os.path.join(ROOT, theirs)]) != os.path.join(ROOT, theirs)
                   for p in outputs)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
    if os.path.isdir(os.path.join(ROOT, ".git")):
        tracked = subprocess.run(["git", "ls-files", "--", *outputs], cwd=ROOT, capture_output=True, text=True)
        assert tracked.returncode == 0 and tracked.stdout == ""
