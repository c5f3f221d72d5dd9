"""The port's rasterizer (pitchvis_tpu_torch/models/render.py, batched, with
its composite in ops/composite.py) against the JAX package's
(pitchvis_tpu/models/render.py, one frame, or under jax.vmap) on the same
inputs, at the golden's size (160x90, padded to 160x96, SERIAL_VQT_PARAMETERS).

Tolerances, each measured on the CPU (CHANGES.md has the values):
* the shader functions within atol 2e-6 (measured at most 9e-7: torch's
  and XLA's sin, atan2 and sqrt differ in the last ulp);
* the scene's static layers: bass_idx equal; background, bass coverage and
  the pitch-name layer within atol 1e-5 (3.1e-6: the spiral points come
  from torch's cos, sin and pow);
* bloom within 1e-5 of the image's largest value (2e-7), tonemap atol 1e-6
  (4.8e-7);
* frames within one 8-bit step, the JAX golden test's own budget
  (tests/test_render_golden.py), and the count of values that moved
  reported;
* the composite's plain version bit for bit against a NumPy float32 loop of
  the JAX scan.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pitchvis_tpu.core.config import SERIAL_VQT_PARAMETERS, VqtParameters
from pitchvis_tpu.io.golden import render_scene_inputs as jax_scene_inputs
from pitchvis_tpu.models import render as jr
from pitchvis_tpu.models import viewer as jv
from pitchvis_tpu_torch import convert
from pitchvis_tpu_torch.io.golden import render_scene_inputs
from pitchvis_tpu_torch.models import render as tr
from pitchvis_tpu_torch.models import viewer as tv
from pitchvis_tpu_torch.ops import composite
from pitchvis_tpu_torch.ops.composite import composite_patches_plain

from torch_port_helpers import seeded_analysis_outputs, to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "render_golden.npz")
PARAMS = SERIAL_VQT_PARAMETERS
RNG = to_port(PARAMS.range)
SHADER_ATOL = 2e-6
STATICS_ATOL = 1e-5
BLOOM_REL = 1e-5
TONEMAP_ATOL = 1e-6
CFG_KW = dict(width=160, height=90, ball_patch=48, max_balls=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _port_cfg(cfg) -> tr.RenderConfig:
    return tr.RenderConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def assert_frames_close(got, want, what):
    """At most one 8-bit step apart; the message counts the values that
    moved."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, (what, got.shape, want.shape)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, f"{what}: max step {d.max()}, {(d > 0).sum()} of {d.size} values differ"


# ---- shader math ------------------------------------------------------------


def test_shader_functions_match_jax():
    r = np.random.default_rng(0)
    uvx = r.uniform(-1.1, 1.1, (5, 1, 64)).astype(np.float32)
    uvy = r.uniform(-1.1, 1.1, (5, 64, 1)).astype(np.float32)
    rr = np.sqrt(uvx * uvx + uvy * uvy)
    x, y, z = (r.uniform(0.0, 4.3, (5, 64, 64)).astype(np.float32) for _ in range(3))
    acc = r.uniform(0.5, 1.0, (5, 1, 1)).astype(np.float32)
    dev = r.uniform(-0.4, 0.4, (5, 1, 1)).astype(np.float32)
    calm = r.uniform(0.0, 1.0, (5, 1, 1)).astype(np.float32)
    rgb = r.uniform(0.0, 1.0, (5, 1, 1, 3)).astype(np.float32)
    a = r.uniform(0.0, 1.0, (5, 1, 1)).astype(np.float32)
    for time in (0.0, 1.25, 37.7):
        t32 = np.float32(time)
        pairs = {
            "simplex_noise3": (jr.simplex_noise3(x, y, z), tr.simplex_noise3(_t(x), _t(y), _t(z))),
            "ring_profile": (jr.ring_profile(rr), tr.ring_profile(_t(rr))),
            "center_dot": (jr.pitch_indicator_center_dot(rr, acc, t32),
                           tr.pitch_indicator_center_dot(_t(rr), _t(acc), time)),
            "tuning": (jr.tuning_indicator(uvx, uvy, rr, dev, t32),
                       tr.tuning_indicator(_t(uvx), _t(uvy), _t(rr), _t(dev), time)),
        }
        j_rgb, j_a = jr.ball_fragment(uvx, uvy, rgb, a, calm, t32, acc, dev)
        t_rgb, t_a = tr.ball_fragment(_t(uvx), _t(uvy), _t(rgb), _t(a), _t(calm), time, _t(acc), _t(dev))
        pairs["fragment rgb"] = (j_rgb, t_rgb)
        pairs["fragment alpha"] = (j_a, t_a)
        c = r.uniform(-0.1, 1.2, 500).astype(np.float32)
        pairs["srgb_to_linear"] = (jr.srgb_to_linear(c), tr.srgb_to_linear(_t(c)))
        pairs["linear_to_srgb"] = (jr.linear_to_srgb(c), tr.linear_to_srgb(_t(c)))
        for name, (want, got) in pairs.items():
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SHADER_ATOL, rtol=0,
                                       err_msg=f"{name} t={time}")


# ---- scene statics, bloom, tonemap ---------------------------------------------


@pytest.mark.parametrize("mode", ["full", "galaxy", "zen"])
@pytest.mark.parametrize("params", [SERIAL_VQT_PARAMETERS, VqtParameters()], ids=["serial", "default"])
def test_scene_statics_match_jax(mode, params):
    j_cfg = jr.RenderConfig.for_mode(mode, **CFG_KW)
    t_cfg = tr.RenderConfig.for_mode(mode, **CFG_KW)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert (t_cfg.padded_width, t_cfg.padded_height, t_cfg.pixel_size) == (
        j_cfg.padded_width, j_cfg.padded_height, j_cfg.pixel_size)
    js = jr.make_scene(j_cfg, params.range)
    ts = tr.make_scene(t_cfg, to_port(params.range), device="cpu")
    assert ts.n_cylinders == js.n_cylinders
    np.testing.assert_array_equal(ts.bass_idx.numpy(), np.asarray(js.bass_idx))
    for name in ("background", "bass_cov", "text_premul", "text_a"):
        want, got = getattr(js, name), getattr(ts, name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=STATICS_ATOL, rtol=0, err_msg=name)
    assert (ts.text_premul is not None) == (mode == "full")


def test_make_scene_is_built_once_a_device():
    cfg = tr.RenderConfig(**CFG_KW)
    assert tr.make_scene(cfg, RNG, "cpu") is tr.make_scene(cfg, RNG, torch.device("cpu"))


def test_bloom_and_tonemap_match_jax():
    r = np.random.default_rng(3)
    img = r.uniform(0.0, 1.5, (2, 90, 160, 3)).astype(np.float32)
    intensity = np.array([0.3, 1.0], np.float32)
    want = np.stack([np.asarray(jr._bloom(jnp.asarray(img[i]), intensity[i], 160, 90)) for i in range(2)])
    got = tr._bloom(_t(img).permute(0, 3, 1, 2).contiguous(), _t(intensity), 160, 90).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=BLOOM_REL * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(tr._tonemap(_t(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
                               np.asarray(jr._tonemap(jnp.asarray(img))), atol=TONEMAP_ATOL, rtol=0)
    assert tr._bloom_mip_sizes(640, 360) == jr._bloom_mip_sizes(640, 360)
    for mip in range(jr.BLOOM_MIP_COUNT):
        assert tr._bloom_blend_factor(0.4, float(mip), 7.0) == jr._bloom_blend_factor(0.4, float(mip), 7.0)


def test_bloom_products_run_in_full_f32_whatever_the_caller_set():
    """Inside the bloom the card's float32 products are IEEE (the JAX
    package asks for Precision.HIGHEST), and the caller's setting, made by
    the legacy, the generic or the new API, comes back as it was."""
    matmul = torch.backends.cuda.matmul
    generic_before, before = torch.get_float32_matmul_precision(), matmul.fp32_precision
    try:
        for set_tf32 in (lambda: setattr(matmul, "allow_tf32", True),
                         lambda: torch.set_float32_matmul_precision("high"),
                         lambda: setattr(matmul, "fp32_precision", "tf32")):
            set_tf32()
            with tr._full_f32_matmul(torch.device("cuda")):
                assert matmul.fp32_precision == "ieee"
            assert matmul.fp32_precision == "tf32" and matmul.allow_tf32
            assert torch.get_float32_matmul_precision() == "high"
            with tr._full_f32_matmul(torch.device("cpu")):  # nothing to set for a CPU render
                assert matmul.fp32_precision == "tf32"
    finally:  # the generic setting first, then the new one: the process's state as it was
        torch.set_float32_matmul_precision(generic_before)
        matmul.fp32_precision = before


# ---- the composite -----------------------------------------------------------


def _numpy_scan(img, rgb, a, si, sj):
    """The JAX scan body in NumPy float32: slice, blend, update, in order."""
    out = img.copy()
    p = a.shape[-1]
    for b in range(img.shape[0]):
        for k in range(a.shape[1]):
            r0, c0 = sj[b, k], si[b, k]
            patch = out[b, r0 : r0 + p, c0 : c0 + p]
            ak = a[b, k][..., None]
            out[b, r0 : r0 + p, c0 : c0 + p] = rgb[b, k] * ak + patch * (np.float32(1.0) - ak)
    return out


@pytest.mark.parametrize("case", ["overlapping", "edges", "one", "disks", "empty", "no_patches"])
def test_composite_plain_equals_the_numpy_scan(case):
    r = np.random.default_rng(7)
    b, k, p, hp, wp = {"overlapping": (3, 12, 24, 96, 160), "edges": (2, 8, 16, 40, 56), "one": (1, 1, 96, 96, 96),
                       "disks": (2, 16, 7, 96, 160), "empty": (0, 4, 8, 24, 32),
                       "no_patches": (2, 0, 8, 24, 32)}[case]
    img = r.uniform(0.0, 1.0, (b, hp, wp, 3)).astype(np.float32)
    a = r.uniform(0.0, 1.0, (b, k, p, p)).astype(np.float32)
    a[..., : p // 3, :] = 0.0
    if case == "disks":  # one colour a disk, broadcast over the patch
        rgb_small = r.uniform(0.0, 1.0, (b, k, 1, 1, 3)).astype(np.float32)
        rgb = np.broadcast_to(rgb_small, (b, k, p, p, 3))
        rgb_t = _t(rgb_small).expand(b, k, p, p, 3)
    else:
        rgb = r.uniform(0.0, 1.0, (b, k, p, p, 3)).astype(np.float32)
        rgb_t = _t(rgb)
    if case == "overlapping":  # all in one corner region, so every pixel there sees several
        si = r.integers(0, 30, (b, k))
        sj = r.integers(0, 20, (b, k))
    else:  # origins at both edges of the raster
        si = r.choice([0, wp - p], (b, k))
        sj = r.choice([0, hp - p], (b, k))
    want = _numpy_scan(img, rgb, a, si, sj)
    before = composite.launches
    got = composite.composite_patches(_t(img), rgb_t, _t(a), _t(si.astype(np.int32)), _t(sj.astype(np.int32)))
    assert composite.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == img.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "overlapping":  # the order matters here: reversed, the result differs
        rev = composite_patches_plain(_t(img), rgb_t.flip(1), _t(a).flip(1), _t(si).flip(1), _t(sj).flip(1))
        assert not torch.equal(rev, got)


def test_composite_rejects_what_the_kernel_does_not_take():
    img = torch.zeros(1, 8, 8, 3)
    a = torch.zeros(1, 2, 4, 4)
    o = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="rgb"):
        composite.composite_patches(img, torch.zeros(1, 2, 4, 4), a, o, o)
    with pytest.raises(TypeError, match="float32"):
        composite.composite_patches(img.double(), torch.zeros(1, 2, 4, 4, 3), a, o, o)
    with pytest.raises(TypeError, match="integer"):
        composite.composite_patches(img, torch.zeros(1, 2, 4, 4, 3), a, o.float(), o)
    with pytest.raises(ValueError, match="does not fit"):
        composite.composite_patches(img, torch.zeros(1, 2, 9, 9, 3), torch.zeros(1, 2, 9, 9), o, o)


# ---- frames against the JAX package and the golden -------------------------------


@pytest.fixture(scope="module")
def golden_frames():
    with np.load(GOLDEN) as z:
        return z["plain"], z["overlay"]


@pytest.fixture(scope="module")
def jax_scene():
    cfg, rng_cfg, balls, bass, debug, sc, t = jax_scene_inputs()
    plain = np.asarray(jr.render_frame(cfg, rng_cfg, balls, bass, sc, t))
    overlay = np.asarray(jr.render_frame(cfg, rng_cfg, balls, bass, sc, t, debug=debug))
    return (cfg, rng_cfg, balls, bass, debug, sc, t), (plain, overlay)


def test_golden_scene_matches_jax(jax_scene):
    """io/golden.py::render_scene_inputs (what the card replays) builds the
    JAX package's scene: the same draws through the port's display math."""
    (j_cfg, j_rng, j_balls, j_bass, j_debug, j_sc, j_t), _ = jax_scene
    cfg, rng_cfg, balls, bass, debug, sc, t = render_scene_inputs(device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_port_cfg(j_cfg)) and rng_cfg == to_port(j_rng)
    assert (sc, t) == (j_sc, j_t)
    for got, want in ((balls, j_balls), (bass, j_bass), (debug, j_debug)):
        for name, w in _leaves(want).items():
            g = getattr(got, name).numpy()[0]
            if w.dtype in (np.bool_, np.uint8, np.int32):
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:  # the viewer's own budget (tests/test_torch_viewer.py): positions 1e-4, other floats 1e-5
                np.testing.assert_allclose(g, w, atol=1e-4 if name == "position" else 1e-5, rtol=0, err_msg=name)


def test_render_frame_matches_golden_and_jax(jax_scene, golden_frames):
    (cfg, rng_cfg, balls, bass, debug, sc, t), jax_frames = jax_scene
    t_balls = convert.ball_outputs_from_numpy(_leaves(balls), "cpu")
    t_bass = convert.bass_spiral_outputs_from_numpy(_leaves(bass), "cpu")
    t_debug = convert.debug_inputs_from_numpy(_leaves(debug), "cpu")
    port_cfg, port_rng = _port_cfg(cfg), to_port(rng_cfg)
    before = composite.launches
    plain = tr.render_frame(port_cfg, port_rng, t_balls, t_bass, sc, t).numpy()
    overlay = tr.render_frame(port_cfg, port_rng, t_balls, t_bass, sc, t, debug=t_debug).numpy()
    assert composite.launches == before
    for got, want_golden, want_jax, name in zip((plain, overlay), golden_frames, jax_frames, ("plain", "overlay")):
        assert_frames_close(got, want_golden, f"{name} vs render_golden.npz")
        assert_frames_close(got, want_jax, f"{name} vs the JAX render_frame")
    # the port's own scene (io/golden.py) gives the same frames
    p_cfg, p_rng, p_balls, p_bass, p_debug, p_sc, p_t = render_scene_inputs(device="cpu")
    assert_frames_close(tr.render_frame(p_cfg, p_rng, p_balls, p_bass, p_sc, p_t).numpy(), golden_frames[0], "scene")
    two = type(t_balls)(**{k: v.expand(2, *v.shape[1:]) for k, v in vars(t_balls).items()})
    with pytest.raises(ValueError, match="one stream"):
        tr.render_frame(port_cfg, port_rng, two, None, sc, t)


def _balls_for(n_streams, rng_cfg, seed):
    """Ball and bass outputs of ``n_streams`` streams through the port's
    display math on seeded analysis outputs (NumPy leaves, stream axis
    first), and their scene calmness."""
    a = seeded_analysis_outputs(n_streams, rng_cfg.n_buckets, seed)
    port_rng = to_port(rng_cfg)
    state = tv.BallState.init(n_streams, rng_cfg.n_buckets, device="cpu")
    args = [_t(a[k]) for k in ("peaks", "peak_center", "peak_size", "calmness", "pitch_accuracy", "pitch_deviation")]
    for _ in range(3):  # fading trails behind the live balls
        state, balls = tv.update_balls(port_rng, state, *args, 1.0 / 60.0)
    bass = tv.bass_spiral(port_rng, *args[:3])
    return convert.ball_outputs_to_numpy(balls), convert.bass_spiral_outputs_to_numpy(bass), a


def test_render_batch_matches_jax_and_per_stream_frames():
    n_streams = 3
    balls, bass, a = _balls_for(n_streams, PARAMS.range, seed=5)
    sc = a["scene_calmness"]
    cfg = tr.RenderConfig(**CFG_KW)
    t_balls = convert.ball_outputs_from_numpy(balls, "cpu")
    t_bass = convert.bass_spiral_outputs_from_numpy(bass, "cpu")
    dbg = {"x_vqt_smoothed": a["x_vqt_smoothed"], "peaks": a["peaks"], "peak_center": a["peak_center"],
           "peak_size": a["peak_size"], "calmness": a["calmness"],
           "graph_values": np.random.default_rng(1).uniform(0, 1, (n_streams, 300)).astype(np.float32),
           "spectrogram": np.random.default_rng(2).integers(0, 256, (n_streams, 60, PARAMS.n_buckets, 4), np.uint8),
           "spectrogram_write_index": np.array([0, 17, 59], np.int32),
           "chroma": np.random.default_rng(3).uniform(0, 1, (n_streams, 12)).astype(np.float32)}
    t_debug = convert.debug_inputs_from_numpy(dbg, "cpu")
    j_cfg = jr.RenderConfig(**CFG_KW)
    for debug in (None, t_debug):
        got = tr.render_batch(cfg, RNG, t_balls, t_bass, _t(sc), 2.5, debug=debug)
        assert got.shape == (n_streams, 90, 160, 3) and got.dtype == torch.uint8
        j_debug = None if debug is None else jr.DebugInputs(**{k: jnp.asarray(v) for k, v in dbg.items()})
        want = jr.render_batch(j_cfg, PARAMS.range, jv.BallOutputs(**{k: jnp.asarray(v) for k, v in balls.items()}),
                               jv.BassSpiralOutputs(**{k: jnp.asarray(v) for k, v in bass.items()}), sc,
                               np.float32(2.5), debug=j_debug)
        assert_frames_close(got.numpy(), want, f"render_batch vs JAX, debug={debug is not None}")
        for s in range(n_streams):
            one = lambda obj: type(obj)(**{k: v[s : s + 1] for k, v in vars(obj).items()})  # noqa: E731
            frame = tr.render_frame(cfg, RNG, one(t_balls), one(t_bass), float(sc[s]), 2.5,
                                    debug=None if debug is None else one(debug))
            assert torch.equal(frame, got[s]), f"stream {s}, debug={debug is not None}"


def test_render_streams_takes_the_rows():
    balls, bass, a = _balls_for(5, PARAMS.range, seed=9)
    viewer = type("Viewer", (), {})()
    viewer.balls = convert.ball_outputs_from_numpy(balls, "cpu")
    viewer.bass = convert.bass_spiral_outputs_from_numpy(bass, "cpu")
    sc = _t(a["scene_calmness"])
    cfg = tr.RenderConfig(**CFG_KW)
    want = tr.render_batch(cfg, RNG, viewer.balls, viewer.bass, sc, 0.5)
    for streams in (range(1, 4), [4, 0], torch.tensor([2])):
        got = tr.render_streams(cfg, RNG, viewer, sc, 0.5, streams=streams)
        assert torch.equal(got, want[torch.as_tensor(list(streams))]), streams
    assert torch.equal(tr.render_streams(cfg, RNG, viewer, sc, 0.5), want[:1])


def test_equal_z_balls_draw_in_jax_order():
    """Two overlapping balls of equal z: JAX's stable argsort draws the
    higher bin first and the lower one on top; so does the port."""
    n = PARAMS.range.n_buckets
    balls = {"position": np.zeros((1, n, 3), np.float32), "rgba": np.zeros((1, n, 4), np.float32),
             "scale": np.zeros((1, n), np.float32), "visible": np.zeros((1, n), bool),
             "calmness": np.ones((1, n), np.float32), "pitch_accuracy": np.zeros((1, n), np.float32),
             "pitch_deviation": np.zeros((1, n), np.float32)}
    for b, x, rgb in ((40, 0.0, (1.0, 0.0, 0.0)), (90, 0.3, (0.0, 0.0, 1.0))):
        balls["position"][0, b] = (x, 0.5, -3.0)  # equal z
        balls["rgba"][0, b] = (*rgb, 1.0)
        balls["scale"][0, b] = 0.06
        balls["visible"][0, b] = True
    cfg = tr.RenderConfig(**CFG_KW, with_bloom=False)
    j_cfg = jr.RenderConfig(**CFG_KW, with_bloom=False)
    t_balls = convert.ball_outputs_from_numpy(balls, "cpu")
    got = tr.render_frame(cfg, RNG, t_balls, None, 0.0, 0.0).numpy()
    j_balls = jv.BallOutputs(**{k: jnp.asarray(v[0]) for k, v in balls.items()})
    want = np.asarray(jr.render_frame(j_cfg, PARAMS.range, j_balls, None, 0.0, 0.0))
    assert_frames_close(got, want, "equal-z balls")
    # the overlap's center pixel shows the ball of the lower bin (red) on top
    col = int(round(0.15 / cfg.pixel_size + (cfg.width - 1) / 2.0))
    row = int(round((cfg.height - 1) / 2.0 - 0.5 / cfg.pixel_size))
    assert got[row, col, 0] > got[row, col, 2] + 50, got[row, col]


def test_output_conversions_round_trip():
    balls, bass, _ = _balls_for(3, PARAMS.range, seed=11)
    for arrays, to_t, to_np in ((balls, convert.ball_outputs_from_numpy, convert.ball_outputs_to_numpy),
                                (bass, convert.bass_spiral_outputs_from_numpy, convert.bass_spiral_outputs_to_numpy)):
        back = to_np(to_t(arrays, "cpu"))
        assert back.keys() == arrays.keys()
        for k in arrays:
            np.testing.assert_array_equal(back[k], arrays[k])
        one = to_np(to_t({k: v[1] for k, v in arrays.items()}, "cpu"))  # one frame gains a stream axis
        for k in arrays:
            np.testing.assert_array_equal(one[k], arrays[k][1:2])


def test_atlas_copy_is_byte_equal():
    with open(os.path.join(ROOT, "pitchvis_tpu", "models", "assets", "pitch_name_atlas.npz"), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "pitchvis_tpu_torch", "models", "assets", "pitch_name_atlas.npz"), "rb") as f:
        assert f.read() == want
    from pitchvis_tpu_torch.models.glyph_atlas import ATLAS_FONT_PX, REFERENCE_FONT_PX, load_atlas

    from pitchvis_tpu.models import glyph_atlas as jga

    assert (ATLAS_FONT_PX, REFERENCE_FONT_PX) == (jga.ATLAS_FONT_PX, jga.REFERENCE_FONT_PX)
    for (tb, tc), (jb, jc) in zip(load_atlas(), jga.load_atlas()):
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tc, jc)


def test_galaxy_and_zen_frames_match_jax(jax_scene):
    (cfg, rng_cfg, balls, bass, _, sc, t), _ = jax_scene
    t_balls = convert.ball_outputs_from_numpy(_leaves(balls), "cpu")
    t_bass = convert.bass_spiral_outputs_from_numpy(_leaves(bass), "cpu")
    for mode in ("galaxy", "zen"):
        j_cfg = jr.RenderConfig.for_mode(mode, **CFG_KW)
        want = np.asarray(jr.render_frame(j_cfg, rng_cfg, balls, bass, sc, t))
        got = tr.render_frame(tr.RenderConfig.for_mode(mode, **CFG_KW), RNG, t_balls, t_bass, sc, t).numpy()
        assert_frames_close(got, want, mode)
