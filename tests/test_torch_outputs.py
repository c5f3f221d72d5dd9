"""The port's output stages in both entry points: models/pipeline.py::
derived_stages, StreamingPipeline and StreamServer with ``with_led`` /
``with_viewer`` / ``fetch="led"``, against the JAX package's on the same
audio; the committed chain and viewer goldens replayed through the port;
resets, rebuilds, checkpoints and convert.py with the ball carry.

Budgets:
- entry point against entry point (SMALL_PARAMS): tests/test_torch_pipeline.py's, at
  most 2e-4 of the peak bins flipped and continuous outputs within atol
  1e-3 where the peaks agree. The stages are compared on the streams whose
  peaks agreed at every hop so far (a ball carries its history): floats
  within atol 1e-3, booleans exactly, u8 values (LED, spectrogram rows, ball
  colors in levels of 1/255) within one level in at most 1e-3 of the
  values.
- golden replays: tests/test_chain_golden.py::TestIngestServerPath's, peak
  flips <= 2e-4, calmness atol 0.02, scene calmness atol 5e-3, LED within 4
  levels where the peaks agree. The viewer keys, on the frames where every
  peak agrees: ball and bass visibility exactly, u8 values within one level
  in at most 1e-4 of the values, the other floats within atol 1e-3 (the
  port's f32 replay drifted at most 2.7e-5 from the golden on the CPU when
  this was written: an ulp of the spiral angle in sin and cos)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pitchvis_tpu.core.config import SERIAL_VQT_PARAMETERS
from pitchvis_tpu.models import viewer as jv
from pitchvis_tpu.models.analysis import AnalysisOutputs as JaxAnalysisOutputs
from pitchvis_tpu.models.pipeline import StreamingPipeline as JaxPipeline
from pitchvis_tpu.models.pipeline import derived_stages as jax_derived_stages
from pitchvis_tpu.runtime.server import StreamServer as JaxServer
from pitchvis_tpu_torch import CompactOutputs, ServeOutputs, StreamingPipeline, StreamServer
from pitchvis_tpu_torch.convert import (
    ANALYSIS_LEAVES,
    pipeline_state_from_numpy,
    pipeline_state_to_numpy,
    server_state_from_numpy,
)
from pitchvis_tpu_torch.io.led import frame_bytes
from pitchvis_tpu_torch.models.analysis import AnalysisOutputs
from pitchvis_tpu_torch.models.ml_system import init_ml_state_batch
from pitchvis_tpu_torch.models.pitch_mlp import PitchMLP
from pitchvis_tpu_torch.models.pipeline import derived_stages
from pitchvis_tpu_torch.models.viewer import BALL_LEAVES, BallState
from pitchvis_tpu_torch.runtime.checkpoint import (
    load_pipeline_state,
    restore_server,
    save_pipeline_state,
    save_server_state,
)

from conftest import SMALL_PARAMS
from torch_port_helpers import jax_native_lib, seeded_analysis_outputs, streams, to_port, u8_within_one_level  # noqa: F401

B = 3
HOP = int(SMALL_PARAMS.sr / 60.0)
DT = HOP / SMALL_PARAMS.sr
ENTRY_U8_SHARE = 1e-3
GOLDEN_U8_SHARE = 1e-4
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

# viewer leaves by how they are compared
VIEWER_BOOL = ("balls.visible", "bass.visible")
VIEWER_U8 = ("spectrogram_row",)
VIEWER_RGBA = ("balls.rgba", "bass.rgba")
VIEWER_FLOAT = ("balls.position", "balls.scale", "balls.calmness", "balls.pitch_accuracy",
                "balls.pitch_deviation", "chroma", "bloom", "calmness_histogram.heights",
                "calmness_histogram.segment_rgb")


def _leaf(tree, path):
    for part in path.split("."):
        tree = getattr(tree, part)
    return np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)


def assert_stages_close(t_led, j_led, t_view, j_view, rows, u8_share, what=""):
    """The stage outputs of the streams ``rows`` (bool (B,)) within the
    budgets above; a None pair is skipped."""
    if t_led is not None:
        u8_within_one_level(t_led.numpy()[rows], np.asarray(j_led)[rows], u8_share, f"led {what}")
    if t_view is None:
        return
    for path in VIEWER_BOOL:
        np.testing.assert_array_equal(_leaf(t_view, path)[rows], _leaf(j_view, path)[rows], err_msg=f"{path} {what}")
    for path in VIEWER_U8:
        u8_within_one_level(_leaf(t_view, path)[rows], _leaf(j_view, path)[rows], u8_share, f"{path} {what}")
    for path in VIEWER_RGBA:
        got, want = _leaf(t_view, path)[rows], _leaf(j_view, path)[rows]
        u8_within_one_level(np.round(got[..., :3] * 255.0), np.round(want[..., :3] * 255.0), u8_share,
                            f"{path} {what}")
        np.testing.assert_allclose(got[..., 3], want[..., 3], atol=1e-3, err_msg=f"{path} alpha {what}")
    for path in VIEWER_FLOAT:
        np.testing.assert_allclose(_leaf(t_view, path)[rows], _leaf(j_view, path)[rows], atol=1e-3,
                                   err_msg=f"{path} {what}")


# ---------------------------------------------------------------------------
# derived_stages on the same analysis outputs
# ---------------------------------------------------------------------------


def test_derived_stages_match_jax():
    """Three frames of seeded analysis outputs (B=4: one silent stream, one
    with peaks at the minimum distance) through both packages' stages, each
    carrying its own balls: the LED, every viewer leaf and the ball carry
    within tests/test_torch_led.py's and test_torch_viewer.py's tolerances
    (as there: floats 1e-5, positions 1e-4, u8 one level in 1e-5)."""
    rng_cfg = SERIAL_VQT_PARAMETERS.range
    n, b = rng_cfg.n_buckets, 4
    dt = np.array([1 / 60, 1 / 30, 1 / 60, 0.5 / 60], np.float32)
    jb = jax.vmap(lambda _: jv.BallState.init(n))(jnp.arange(b))
    tb = BallState.init(b, n, device="cpu")
    for frame in range(3):
        a = seeded_analysis_outputs(b, n, 20 + frame)
        jn, jm, jl, jb, jview = jax_derived_stages(
            rng_cfg, JaxAnalysisOutputs(**{k: jnp.asarray(v) for k, v in a.items()}), jnp.asarray(dt),
            with_led=True, balls_state=jb, with_viewer=True)
        tn, tm, tl, tb, tview = derived_stages(
            to_port(rng_cfg), AnalysisOutputs(**{k: torch.from_numpy(v.copy()) for k, v in a.items()}),
            torch.from_numpy(dt), with_led=True, balls_state=tb, with_viewer=True)
        assert (tn, tm, jn, jm) == (None, None, None, None)
        rows = np.ones(b, bool)
        u8_within_one_level(tl.numpy(), np.asarray(jl), 1e-5, f"led frame {frame}")
        for path in VIEWER_BOOL:
            np.testing.assert_array_equal(_leaf(tview, path), _leaf(jview, path), err_msg=path)
        for path in VIEWER_U8:
            u8_within_one_level(_leaf(tview, path), _leaf(jview, path), 1e-5, path)
        for path in VIEWER_FLOAT:
            np.testing.assert_allclose(_leaf(tview, path), _leaf(jview, path),
                                       atol=1e-4 if path == "balls.position" else 1e-5, err_msg=path)
        assert_stages_close(None, None, tview, jview, rows, 1e-5, f"frame {frame}")
        for k in BALL_LEAVES:
            if k != "rgba":
                np.testing.assert_allclose(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)), atol=1e-5, err_msg=k)
        assert tuple(tl.shape) == (b, n, 3) and tuple(tview.bass.visible.shape) == (b, n_segments(rng_cfg))


def n_segments(rng_cfg):
    return jv.bass_cylinder_count(rng_cfg.octaves)


@pytest.mark.parametrize("arg", ["ml_model", "ml_params", "ml_state"])
def test_derived_stages_ml_raises(arg):
    """The ML arguments are ported (the name is kept from when they raised):
    as in the JAX package, ml_model with its history runs the stage (its
    outputs against JAX's are tests/test_torch_ml.py's), while ml_params or
    ml_state without a model pass through: no ML outputs, the state
    returned as it was given."""
    n = SMALL_PARAMS.n_buckets
    a = seeded_analysis_outputs(3, n, 0)
    outputs = AnalysisOutputs(**{k: torch.from_numpy(v.copy()) for k, v in a.items()})
    model = PitchMLP(input_bins=2 * n, mlp_size=16, mlp_layers=1, device="cpu")
    state = init_ml_state_batch(3, 2, n, device="cpu")
    kw = {"ml_model": dict(ml_model=model, ml_state=state), "ml_params": dict(ml_params=model.state_dict()),
          "ml_state": dict(ml_state=state)}[arg]
    new_ml, ml_midi, led, balls, viewer = derived_stages(
        to_port(SMALL_PARAMS.range), outputs, torch.full((3,), DT), **kw)
    assert (led, balls, viewer) == (None, None, None)
    if arg == "ml_model":
        assert tuple(ml_midi.shape) == (3, 128) and bool(((ml_midi >= 0) & (ml_midi <= 1)).all())
        assert torch.equal(new_ml.history[:, -1], outputs.x_vqt_smoothed)
    else:
        assert ml_midi is None and new_ml is kw.get("ml_state")


# ---------------------------------------------------------------------------
# both entry points against the JAX package's
# ---------------------------------------------------------------------------


def _audio(hops):
    """B streams of seeded sines + noise; stream 1 carries one NaN chunk
    (hop 5) and stream 2 one silent chunk (hop 7)."""
    sig = streams(B, max(hops, 8) * HOP, SMALL_PARAMS.sr, seed=11)
    sig[1, 5 * HOP + 7] = np.nan
    sig[2, 7 * HOP : 8 * HOP] = 0.0
    return sig[:, : hops * HOP]


class _Agreement:
    """Tracks the streams whose peaks agreed at every hop so far, and the
    peak flips against the pipeline test's budget."""

    def __init__(self):
        self.rows = np.ones(B, bool)
        self.flips = self.total = 0

    def update(self, t_peaks, j_peaks):
        agree = t_peaks.numpy() == np.asarray(j_peaks)
        self.flips += int((~agree).sum())
        self.total += agree.size
        self.rows &= agree.all(axis=1)
        return agree

    def check(self):
        assert self.flips <= 2e-4 * self.total
        assert self.rows.sum() >= B - 1, "too few streams to compare the stages on"


def test_pipeline_with_stages_matches_jax():
    hops = 12
    sig = _audio(hops)
    jp = JaxPipeline(B, SMALL_PARAMS, path="pallas", with_led=True, with_viewer=True)
    tp = StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", with_led=True, with_viewer=True, device="cpu")
    track = _Agreement()
    for h in range(hops):
        chunk = sig[:, h * HOP : (h + 1) * HOP]
        jo = jp.step(chunk, DT)
        to = tp.step(chunk, DT)
        agree = track.update(to.analysis.peaks, jo.analysis.peaks)
        for name in ("calmness", "peak_center", "peak_size"):
            np.testing.assert_allclose(getattr(to.analysis, name).numpy()[agree],
                                       np.asarray(getattr(jo.analysis, name))[agree], atol=1e-3)
        assert_stages_close(to.led, jo.led, to.viewer, jo.viewer, track.rows, ENTRY_U8_SHARE, f"hop {h}")
    track.check()
    assert to.viewer.balls.visible.any() and to.led.any()


def test_pipeline_step_multi_zero_hops_with_stages_matches_jax():
    """Zero hops: led and viewer leaves with a leading axis of 0 and the
    shapes and types of one hop's, as the JAX lax.scan returns them."""
    jp = JaxPipeline(B, SMALL_PARAMS, path="pallas", with_led=True, with_viewer=True)
    tp = StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", with_led=True, with_viewer=True, device="cpu")
    none = np.zeros((0, B, HOP), np.float32)
    jo, to = jp.step_multi(none, DT), tp.step_multi(none, DT)
    paths = ["led"] + [f"viewer.{p}" for p in VIEWER_BOOL + VIEWER_U8 + VIEWER_RGBA + VIEWER_FLOAT]
    for path in paths:
        got, want = _leaf(to, path), _leaf(jo, path)
        assert got.shape == want.shape and got.dtype == want.dtype, path
    multi = tp.step_multi(np.stack([_audio(2)[:, :HOP], _audio(2)[:, HOP:]]), DT)
    assert tuple(multi.led.shape) == (2, B, SMALL_PARAMS.n_buckets, 3)


def _warm(server, sig):
    server.push_batch(sig)
    return server.step(dt=DT)


@pytest.mark.usefixtures("jax_native_lib")
def test_server_with_stages_matches_jax():
    hops = 10
    warm = streams(B, int(SMALL_PARAMS.sr * 0.5), SMALL_PARAMS.sr, seed=12)
    sig = _audio(hops)
    kw = dict(buffer_seconds=1.0, path="pallas", with_led=True, with_viewer=True)
    jax_srv = JaxServer(B, SMALL_PARAMS, **kw)
    srv = StreamServer(B, to_port(SMALL_PARAMS), device="cpu", **kw)
    track = _Agreement()
    try:
        _warm(jax_srv, warm)
        _warm(srv, warm)
        for h in range(hops):
            chunk = sig[:, h * HOP : (h + 1) * HOP]
            jax_srv.push_batch(chunk)
            srv.push_batch(chunk)
            jo, jg = jax_srv.step(dt=DT)
            to, tg = srv.step(dt=DT)
            assert isinstance(to, ServeOutputs) and to.ml_midi is None
            np.testing.assert_array_equal(tg, jg)
            track.update(to.analysis.peaks, jo.analysis.peaks)
            assert_stages_close(to.led, jo.led, to.viewer, jo.viewer, track.rows, ENTRY_U8_SHARE, f"hop {h}")
        track.check()
    finally:
        jax_srv.close()
        srv.close()


@pytest.mark.parametrize("ingest", ["delta", "snapshot"])
def test_fetch_led_equals_the_full_servers_led(ingest):
    """fetch="led" (which implies with_led) returns CompactOutputs whose LED
    block and scalars equal a with_led server's, fed the same pushes; so
    does step_multi(per_hop=True) against the steps."""
    warm = streams(B, int(SMALL_PARAMS.sr * 0.5), SMALL_PARAMS.sr, seed=13)
    sig = _audio(6)
    compact = StreamServer(B, to_port(SMALL_PARAMS), buffer_seconds=1.0, fetch="led", ingest=ingest, device="cpu")
    full = StreamServer(B, to_port(SMALL_PARAMS), buffer_seconds=1.0, with_led=True, ingest=ingest, device="cpu")
    try:
        assert compact.with_led and not compact.with_viewer
        _warm(compact, warm)
        _warm(full, warm)
        for h in range(6):
            chunk = sig[:, h * HOP : (h + 1) * HOP]
            compact.push_batch(chunk)
            full.push_batch(chunk)
            c, _ = compact.step(dt=DT)
            f, _ = full.step(dt=DT)
            assert isinstance(c, CompactOutputs) and isinstance(f, ServeOutputs) and f.viewer is None
            assert torch.equal(c.led, f.led)
            assert torch.equal(c.scene_calmness, f.analysis.scene_calmness)
            assert torch.equal(c.tuning_inaccuracy, f.analysis.tuning_inaccuracy)
        if ingest == "delta":
            k = 3
            chunks = [streams(B, HOP, SMALL_PARAMS.sr, seed=30 + h) for h in range(k)]
            for chunk in chunks:
                compact.push_batch(chunk)
            outs, gains = compact.step_multi(k, per_hop=True)
            assert len(outs) == k and gains.shape == (k, B)
            for chunk, got in zip(chunks, outs):
                full.push_batch(chunk)
                assert torch.equal(got.led, full.step(dt=DT)[0].led)
    finally:
        compact.close()
        full.close()


def test_serve_loop_publishes_stage_outputs():
    """A serve loop over a fetch="led" server publishes CompactOutputs; with
    sync="host" every leaf is a NumPy array."""
    srv = StreamServer(2, to_port(SMALL_PARAMS), buffer_seconds=1.0, fetch="led", device="cpu")
    try:
        srv.push_batch(streams(2, int(SMALL_PARAMS.sr * 0.8), SMALL_PARAMS.sr, seed=14))
        loop = srv.serve(rate_hz=60.0, sync="host")
        got = loop.wait_next(0, timeout=30.0)
        loop.stop()
        assert got is not None and loop.error is None
        _, outputs, _ = got
        assert isinstance(outputs, CompactOutputs) and isinstance(outputs.led, np.ndarray)
        assert outputs.led.shape == (2, SMALL_PARAMS.n_buckets, 3) and outputs.led.dtype == np.uint8
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the committed goldens through the port
# ---------------------------------------------------------------------------


def _replay(golden, names, **kw):
    """The golden signals as streams of one port StreamServer at the serial
    parameters (f32 fused VQT path, delta ingest), a push and a step a hop,
    as TestIngestServerPath drives the JAX server. Returns a list per
    signal of per-hop (ServeOutputs of that stream) dicts of NumPy arrays."""
    params = to_port(SERIAL_VQT_PARAMETERS)
    hop = int(params.sr / 60.0)
    sig = np.stack([golden[f"in_{n}"] for n in names])
    srv = StreamServer(len(names), params, buffer_seconds=2.0, path="pallas", device="cpu", **kw)
    rec = [dict() for _ in names]
    try:
        for i in range(sig.shape[1] // hop):
            srv.push_batch(sig[:, i * hop : (i + 1) * hop])
            out, _ = srv.step(dt=hop / params.sr)
            for b in range(len(names)):
                leaves = {"peaks": out.analysis.peaks, "calmness": out.analysis.calmness,
                          "scene_calmness": out.analysis.scene_calmness, "led": out.led}
                if out.viewer is not None:
                    v = out.viewer
                    leaves.update({
                        "ball_position": v.balls.position, "ball_rgba": v.balls.rgba, "ball_scale": v.balls.scale,
                        "ball_visible": v.balls.visible, "ball_calmness": v.balls.calmness,
                        "ball_pitch_accuracy": v.balls.pitch_accuracy,
                        "ball_pitch_deviation": v.balls.pitch_deviation, "chroma": v.chroma, "bloom": v.bloom,
                        "spectrogram_row": v.spectrogram_row, "bass_visible": v.bass.visible,
                        "bass_rgba": v.bass.rgba, "hist_heights": v.calmness_histogram.heights,
                        "hist_segment_rgb": v.calmness_histogram.segment_rgb,
                    })
                for k, t in leaves.items():
                    rec[b].setdefault(k, []).append(t[b].numpy())
    finally:
        srv.close()
    return [{k: np.stack(v) for k, v in r.items()} for r in rec]


def _check_chain(res, g, name, n):
    flips = res["peaks"] != g[f"{name}_peaks"]
    assert flips.mean() <= 2e-4, f"{name}: peak flips {flips.mean():.2e}"
    np.testing.assert_allclose(res["calmness"], g[f"{name}_calmness"], atol=0.02)
    np.testing.assert_allclose(res["scene_calmness"], g[f"{name}_scene_calmness"], atol=5e-3)
    led_diff = np.abs(res["led"].astype(np.int32) - g[f"{name}_led"].astype(np.int32))
    assert led_diff[~flips].max() <= 4
    # the framed serial byte stream, rebuilt with the port's frame_bytes
    stream = np.frombuffer(b"".join(frame_bytes(f) for f in res["led"]), np.uint8)
    assert stream.shape == g[f"{name}_stream"].shape
    frames = stream.reshape(-1, 3 + 3 * n)
    assert (frames[:, 0] == 0xFF).all() and (frames[:, 1] == n // 256).all() and (frames[:, 2] == n % 256).all()
    assert (frames[:, 3:] <= 0xFE).all()
    return flips


def test_chain_golden_replay():
    """tests/golden/chain_golden.npz, arpeggio and chord, 600 hops at 60 Hz,
    held to the ingest-server budget."""
    with np.load(f"{GOLDEN_DIR}/chain_golden.npz") as z:
        g = {k: z[k] for k in z.files}
    names = ("arpeggio", "chord")
    for name, res in zip(names, _replay(g, names, with_led=True)):
        assert res["peaks"].shape[0] == 600
        _check_chain(res, g, name, SERIAL_VQT_PARAMETERS.n_buckets)


def test_viewer_golden_replay():
    """tests/golden/viewer_golden.npz, arpeggio, 360 hops: the chain keys at
    the ingest-server budget, the viewer keys at the budget stated above."""
    with np.load(f"{GOLDEN_DIR}/viewer_golden.npz") as z:
        g = {k: z[k] for k in z.files}
    (res,) = _replay(g, ("arpeggio",), with_led=True, with_viewer=True)
    flips = _check_chain(res, g, "arpeggio", SERIAL_VQT_PARAMETERS.n_buckets)
    frames = ~flips.any(axis=1)
    assert frames.mean() > 0.99
    for k in ("ball_visible", "bass_visible"):
        np.testing.assert_array_equal(res[k][frames], g[f"arpeggio_{k}"][frames], err_msg=k)
    u8_within_one_level(res["spectrogram_row"][frames], g["arpeggio_spectrogram_row"][frames], GOLDEN_U8_SHARE,
                        "spectrogram_row")
    for k in ("ball_rgba", "bass_rgba"):
        got, want = res[k][frames], g[f"arpeggio_{k}"][frames]
        u8_within_one_level(np.round(got[..., :3] * 255.0), np.round(want[..., :3] * 255.0), GOLDEN_U8_SHARE, k)
        np.testing.assert_allclose(got[..., 3], want[..., 3], atol=1e-3, err_msg=k)
    for k in ("ball_position", "ball_scale", "ball_calmness", "ball_pitch_accuracy", "ball_pitch_deviation",
              "chroma", "bloom", "hist_heights", "hist_segment_rgb"):
        np.testing.assert_allclose(res[k][frames], g[f"arpeggio_{k}"][frames], atol=1e-3, err_msg=k)
    assert res["ball_visible"].any() and res["bass_visible"].any()


# ---------------------------------------------------------------------------
# resets, rebuilds, checkpoints and convert with the ball carry
# ---------------------------------------------------------------------------


def _fresh_balls(n, rows=1):
    return BallState.init(rows, n, device="cpu")


def _balls_equal(a, b, row_a=None, row_b=None):
    return all(torch.equal(getattr(a, k) if row_a is None else getattr(a, k)[row_a],
                           getattr(b, k) if row_b is None else getattr(b, k)[row_b]) for k in BALL_LEAVES)


def test_pipeline_reset_and_rebuild_with_balls():
    n = SMALL_PARAMS.n_buckets
    tp = StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", with_viewer=True, device="cpu")
    sig = _audio(4)
    for h in range(3):
        tp.step(sig[:, h * HOP : (h + 1) * HOP], DT)
    before = tp.state.balls
    row = int(before.scale.abs().sum(dim=1).argmax())
    assert float(before.scale[row].abs().max()) > 0.0
    tp.reset_stream(row)
    assert _balls_equal(tp.state.balls, _fresh_balls(n), row, 0)
    for other in set(range(B)) - {row}:
        assert _balls_equal(tp.state.balls, before, other, other)
    assert float(before.scale[row].abs().max()) > 0.0, "the state captured before the reset changed"
    # same layout: the carry persists; another layout: fresh carries of its width
    carried = tp.state.balls
    tp.rebuild(dataclasses.replace(to_port(SMALL_PARAMS), quality=SMALL_PARAMS.quality * 1.1))
    assert tp.state.balls is carried
    wide = dataclasses.replace(to_port(SMALL_PARAMS), range=dataclasses.replace(
        to_port(SMALL_PARAMS.range), octaves=3))
    tp.rebuild(wide)
    assert _balls_equal(tp.state.balls, _fresh_balls(wide.n_buckets, B))
    out = tp.step(sig[:, 3 * HOP : 4 * HOP], DT)
    assert tuple(out.viewer.balls.position.shape) == (B, wide.n_buckets, 3)


@pytest.mark.parametrize("mid_flight", [False, True], ids=["between_hops", "mid_flight"])
def test_server_reset_clears_the_ball_row(mid_flight):
    """reset_stream clears the stream's ball row, also when it lands while a
    hop is in flight (after its capture, before its write-back: the row is
    re-applied); the other rows keep their carries. A layout-changing
    rebuild re-initializes the carry."""
    n = SMALL_PARAMS.n_buckets
    srv = StreamServer(B, to_port(SMALL_PARAMS), buffer_seconds=1.0, with_viewer=True, device="cpu")
    try:
        _warm(srv, streams(B, int(SMALL_PARAMS.sr * 0.5), SMALL_PARAMS.sr, seed=15))
        for h in range(2):
            srv.push_batch(_audio(2)[:, h * HOP : (h + 1) * HOP])
            srv.step(dt=DT)
        assert float(srv.balls_state.scale[1].abs().max()) > 0.0
        if mid_flight:
            real = srv.rings.consume

            def racing(*args, **kw):
                srv.rings.consume = real
                srv.reset_stream(1)
                return real(*args, **kw)

            srv.rings.consume = racing
            srv.push_batch(_audio(3)[:, 2 * HOP :])
            srv.step(dt=DT)
        else:
            kept = srv.balls_state
            srv.reset_stream(1)
            assert _balls_equal(srv.balls_state, kept, 0, 0)
        assert _balls_equal(srv.balls_state, _fresh_balls(n), 1, 0)
        assert float(srv.balls_state.scale[0].abs().max()) > 0.0
        wide = dataclasses.replace(to_port(SMALL_PARAMS), range=dataclasses.replace(
            to_port(SMALL_PARAMS.range), octaves=3))
        srv.rebuild(wide)
        assert _balls_equal(srv.balls_state, _fresh_balls(wide.n_buckets, B))
    finally:
        srv.close()


def test_pipeline_checkpoint_round_trip_with_balls(tmp_path):
    params = to_port(SMALL_PARAMS)
    pipe = StreamingPipeline(B, params, path="pallas", with_led=True, with_viewer=True, device="cpu")
    sig = _audio(4)
    for h in range(3):
        pipe.step(sig[:, h * HOP : (h + 1) * HOP], DT)
    save_pipeline_state(str(tmp_path / "p"), pipe.state, params)
    state, _ = load_pipeline_state(str(tmp_path / "p"), device="cpu")
    assert _balls_equal(state.balls, pipe.state.balls)
    resumed = StreamingPipeline(B, params, path="pallas", with_led=True, with_viewer=True, device="cpu")
    resumed.state = state
    chunk = sig[:, 3 * HOP :]
    a, b = resumed.step(chunk, DT), pipe.step(chunk, DT)
    assert torch.equal(a.led, b.led) and torch.equal(a.viewer.balls.rgba, b.viewer.balls.rgba)
    bare = StreamingPipeline(B, params, path="pallas", device="cpu")
    save_pipeline_state(str(tmp_path / "bare"), bare.state, params)
    assert load_pipeline_state(str(tmp_path / "bare"), device="cpu")[0].balls is None


def test_server_checkpoint_round_trip_with_stages(tmp_path):
    """A with_led + with_viewer server saved and restored continues exactly
    like the server that was not stopped (flags and ball carry restored)."""
    kw = dict(buffer_seconds=1.0, path="pallas", with_led=True, with_viewer=True, device="cpu")
    warm = streams(B, int(SMALL_PARAMS.sr * 0.5), SMALL_PARAMS.sr, seed=16)
    sig = _audio(5)
    ref, srv = (StreamServer(B, to_port(SMALL_PARAMS), **kw) for _ in range(2))
    try:
        for s in (ref, srv):
            _warm(s, warm)
            for h in range(2):
                s.push_batch(sig[:, h * HOP : (h + 1) * HOP])
                s.step(dt=DT)
        save_server_state(str(tmp_path / "ckpt"), srv)
        srv.close()
        restored = restore_server(str(tmp_path / "ckpt"), device="cpu")
        assert (restored.with_led, restored.with_viewer, restored.fetch) == (True, True, "full")
        assert _balls_equal(restored.balls_state, ref.balls_state)
        for h in range(2, 5):
            chunk = sig[:, h * HOP : (h + 1) * HOP]
            ref.push_batch(chunk)
            restored.push_batch(chunk)
            want, _ = ref.step(dt=DT)
            got, _ = restored.step(dt=DT)
            assert torch.equal(got.led, want.led)
            assert torch.equal(got.viewer.balls.position, want.viewer.balls.position)
            assert torch.equal(got.viewer.spectrogram_row, want.viewer.spectrogram_row)
        restored.close()
    finally:
        ref.close()
        srv.close()


def _jax_pipeline_arrays(jp):
    s = jp.state
    out = {"buffer": np.asarray(s.ring.buffer), "gain": np.asarray(s.ring.gain)}
    out.update({k: np.asarray(getattr(s.analysis, k)) for k in ANALYSIS_LEAVES})
    out.update({"balls_" + k: np.asarray(getattr(s.balls, k)) for k in BALL_LEAVES})
    return out


def test_jax_pipeline_balls_carried_into_port():
    """A mid-stream JAX pipeline with the viewer stage, its balls included,
    carried across (convert.py) and back unchanged; both then continue
    alike within the entry-point budget."""
    sig = _audio(8)
    jp = JaxPipeline(B, SMALL_PARAMS, path="pallas", with_led=True, with_viewer=True)
    for h in range(4):
        jp.step(sig[:, h * HOP : (h + 1) * HOP], DT)
    snap = _jax_pipeline_arrays(jp)
    tp = StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", with_led=True, with_viewer=True, device="cpu")
    tp.state = pipeline_state_from_numpy(snap, device="cpu")
    for k, v in pipeline_state_to_numpy(tp.state).items():
        np.testing.assert_array_equal(v, snap[k], err_msg=k)
    track = _Agreement()
    for h in range(4, 8):
        chunk = sig[:, h * HOP : (h + 1) * HOP]
        jo, to = jp.step(chunk, DT), tp.step(chunk, DT)
        track.update(to.analysis.peaks, jo.analysis.peaks)
        assert_stages_close(to.led, jo.led, to.viewer, jo.viewer, track.rows, ENTRY_U8_SHARE, f"hop {h}")
    track.check()


@pytest.mark.usefixtures("jax_native_lib")
def test_jax_server_balls_carried_into_port():
    """A JAX server's state with its ball carry carried into a port server
    (convert.server_state_from_numpy); both continue alike within the
    entry-point budget. Balls for a server without the viewer stage raise."""
    kw = dict(buffer_seconds=1.0, path="pallas", with_led=True, with_viewer=True)
    jax_srv = JaxServer(B, SMALL_PARAMS, **kw)
    srv = StreamServer(B, to_port(SMALL_PARAMS), device="cpu", **kw)
    plain = StreamServer(B, to_port(SMALL_PARAMS), buffer_seconds=1.0, device="cpu")
    sig = _audio(8)
    try:
        _warm(jax_srv, streams(B, int(SMALL_PARAMS.sr * 0.5), SMALL_PARAMS.sr, seed=17))
        for h in range(3):
            jax_srv.push_batch(sig[:, h * HOP : (h + 1) * HOP])
            jax_srv.step(dt=DT)
        balls = {k: np.asarray(getattr(jax_srv.balls_state, k)) for k in BALL_LEAVES}
        analysis = {k: np.asarray(getattr(jax_srv.analysis_state, k)) for k in ANALYSIS_LEAVES}
        with pytest.raises(ValueError, match="viewer"):
            server_state_from_numpy(plain, jax_srv.rings.export_state(), analysis, balls=balls)
        server_state_from_numpy(srv, jax_srv.rings.export_state(), analysis,
                                window=np.asarray(jax_srv._window), balls=balls)
        for k in BALL_LEAVES:
            np.testing.assert_array_equal(getattr(srv.balls_state, k).numpy(), balls[k], err_msg=k)
        track = _Agreement()
        for h in range(3, 8):
            chunk = sig[:, h * HOP : (h + 1) * HOP]
            jax_srv.push_batch(chunk)
            srv.push_batch(chunk)
            jo, _ = jax_srv.step(dt=DT)
            to, _ = srv.step(dt=DT)
            track.update(to.analysis.peaks, jo.analysis.peaks)
            assert_stages_close(to.led, jo.led, to.viewer, jo.viewer, track.rows, ENTRY_U8_SHARE, f"hop {h}")
        track.check()
    finally:
        jax_srv.close()
        srv.close()
        plain.close()
