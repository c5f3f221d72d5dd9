"""The port's display outputs (pitchvis_tpu_torch/models/viewer.py, batched)
against the JAX package's (pitchvis_tpu/models/viewer.py, one stream under
jax.vmap) on the same seeded analysis outputs: B = 4 streams, stream 1
silent, stream 2 with peaks at the 2-bin minimum distance, a dt a stream.

Tolerances: float outputs within atol 1e-5 (pow, cos, sin and exp round in
another ulp in PyTorch than in XLA), ball positions within atol 1e-4 (the
spiral angle reaches some 50 rad, where an ulp is 3.8e-6: XLA's and
PyTorch's sin and cos differ by about that much there, times a radius up to
10); colors and u8 rows within one level in at most 1e-5 of the values
(tests/test_torch_colors.py); booleans exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pitchvis_tpu.core.config import SERIAL_VQT_PARAMETERS, VqtParameters
from pitchvis_tpu.models import viewer as jv
from pitchvis_tpu_torch.models import viewer as tv

from torch_port_helpers import seeded_analysis_outputs, to_port, u8_within_one_level

B = 4
U8_FLIP_SHARE = 1e-5
RANGES = {"serial": SERIAL_VQT_PARAMETERS.range, "default": VqtParameters().range}
DT = np.array([1 / 60, 0.5 / 60, 2 / 60, 1 / 30], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _assert_close(got, want, what, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol, err_msg=what)


def _assert_rgba(got, want, what):
    """RGB channels in levels of 1/255 (jitted XLA may divide by 255 through
    the reciprocal, an ulp from a level) within one level; alpha within
    atol."""
    got, want = np.asarray(got), np.asarray(want)
    u8_within_one_level(np.round(got[..., :3] * 255.0), np.round(want[..., :3] * 255.0), U8_FLIP_SHARE, what)
    _assert_close(got[..., 3], want[..., 3], what + " alpha")


def test_static_geometry_matches_jax():
    for octaves, bpo in ((5, 36), (7, 84), (4, 24)):
        assert tv.bass_cylinder_count(octaves) == jv.bass_cylinder_count(octaves)
        assert tv.pitch_color_rotation(bpo) == jv.pitch_color_rotation(bpo)
        _assert_close(tv.spiral_points(octaves, bpo), jv.spiral_points(octaves, bpo), "spiral", rtol=1e-6)
    x = np.random.default_rng(0).uniform(0, 180, (3, 50)).astype(np.float32)
    for got, want in zip(tv.bin_to_spiral(36, _t(x)), jv.bin_to_spiral(36, _j(x))):
        _assert_close(got, want, "bin_to_spiral", rtol=1e-6)
    sc = np.array([0.0, 0.3, 0.77, 1.0], np.float32)
    _assert_close(tv.bloom_intensity(_t(sc)), jv.bloom_intensity(_j(sc)), "bloom", atol=0.0)


@pytest.mark.parametrize("name", sorted(RANGES))
def test_chroma_matches_jax(name):
    rng_cfg = RANGES[name]
    x = seeded_analysis_outputs(B, rng_cfg.n_buckets, 1)["x_vqt_smoothed"]
    want = jax.vmap(lambda xs: jv.chroma_vector(xs, rng_cfg))(_j(x))
    got = tv.chroma_vector(_t(x), to_port(rng_cfg))
    assert tuple(got.shape) == (B, 12)
    _assert_close(got, want, "chroma")


@pytest.mark.parametrize(
    "shader_params,ball_scale_factor",
    [(True, 1.0), (False, 1.0), (True, 0.7)],
    ids=["normal", "no_shader_params", "performance_scale"],
)
@pytest.mark.parametrize("name", sorted(RANGES))
def test_update_balls_over_hops_matches_jax(name, shader_params, ball_scale_factor):
    """Six hops, each package carrying its own ball state, a dt a stream."""
    rng_cfg = RANGES[name]
    n = rng_cfg.n_buckets
    kw = dict(shader_params=shader_params, ball_scale_factor=ball_scale_factor)
    js = jax.vmap(lambda _: jv.BallState.init(n))(jnp.arange(B))
    ts = tv.BallState.init(B, n, device="cpu")
    for hop in range(6):
        a = seeded_analysis_outputs(B, n, 10 + hop)
        if hop == 3:  # a hop without peaks: every ball fades
            a["peaks"][:] = False
            a["peak_center"][:] = 0.0
            a["peak_size"][:] = 0.0
        args = [a[k] for k in ("peaks", "peak_center", "peak_size", "calmness", "pitch_accuracy", "pitch_deviation")]
        js, jo = jax.vmap(lambda s, p, c, z, cal, acc, dev, d: jv.update_balls(
            rng_cfg, s, p, c, z, cal, acc, dev, d, **kw))(js, *map(_j, args), _j(DT))
        ts, to = tv.update_balls(to_port(rng_cfg), ts, *map(_t, args), _t(DT), **kw)
        what = f"hop {hop}"
        np.testing.assert_array_equal(to.visible.numpy(), np.asarray(jo.visible), err_msg=what)
        _assert_close(to.position, jo.position, what + " position", atol=1e-4)
        _assert_rgba(to.rgba, jo.rgba, what + " rgba")
        for k in ("scale", "calmness", "pitch_accuracy", "pitch_deviation"):
            _assert_close(getattr(to, k), getattr(jo, k), f"{what} {k}")
        for k in ("scale", "z_offset", "center", "calm"):
            _assert_close(getattr(ts, k), getattr(js, k), f"{what} state {k}")
        _assert_rgba(ts.rgba, js.rgba, what + " state rgba")
    assert to.visible.any()


@pytest.mark.parametrize("name", sorted(RANGES))
def test_spectrogram_rows_match_jax(name):
    rng_cfg = RANGES[name]
    a = seeded_analysis_outputs(B, rng_cfg.n_buckets, 2)
    want = jax.vmap(lambda xs: jv.spectrogram_row_vqt(rng_cfg, xs))(_j(a["x_vqt_smoothed"]))
    got = tv.spectrogram_row_vqt(to_port(rng_cfg), _t(a["x_vqt_smoothed"]))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, rng_cfg.n_buckets, 4)
    u8_within_one_level(got.numpy(), want, U8_FLIP_SHARE, "vqt row")
    m, c, s = (a[k] for k in ("peaks", "peak_center", "peak_size"))
    want = jax.vmap(lambda m, c, s: jv.spectrogram_row_peaks(rng_cfg, m, c, s))(_j(m), _j(c), _j(s))
    got = tv.spectrogram_row_peaks(to_port(rng_cfg), _t(m), _t(c), _t(s))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, rng_cfg.n_buckets, 4)
    u8_within_one_level(got.numpy(), want, U8_FLIP_SHARE, "peaks row")
    assert (got[1] == 0).all()


@pytest.mark.parametrize("name", sorted(RANGES))
@pytest.mark.parametrize("seed", [3, 4])
def test_bass_spiral_matches_jax(name, seed):
    rng_cfg = RANGES[name]
    a = seeded_analysis_outputs(B, rng_cfg.n_buckets, seed)
    m, c, s = (a[k] for k in ("peaks", "peak_center", "peak_size"))
    # stream 0's lowest peak six semitones up: 36 segments lit; stream 3's
    # beyond the cylinder range: nothing lit
    low = rng_cfg.buckets_per_octave // 2
    m[0, :low] = False
    m[0, low] = True
    c[0, low], s[0, low] = low + 0.25, 12.0
    m[3, : rng_cfg.n_buckets // 2] = False
    want = jax.vmap(lambda m, c, s: jv.bass_spiral(rng_cfg, m, c, s))(_j(m), _j(c), _j(s))
    got = tv.bass_spiral(to_port(rng_cfg), _t(m), _t(c), _t(s))
    np.testing.assert_array_equal(got.visible.numpy(), np.asarray(want.visible))
    _assert_rgba(got.rgba, want.rgba, "bass rgba")
    assert int(got.visible[0].sum()) == 36 and not got.visible[1].any() and not got.visible[3].any()


def test_calmness_colors_and_histogram_match_jax():
    c = np.random.default_rng(5).uniform(0, 1, (B, 60)).astype(np.float32)
    c[0, :4] = [0.3, 0.7, np.nan, 0.7000001]
    np.testing.assert_array_equal(tv.calmness_to_color(_t(c)).numpy(), np.asarray(jv.calmness_to_color(_j(c))))
    want = jax.vmap(jv.calmness_histogram)(_j(c))
    got = tv.calmness_histogram(_t(c))
    np.testing.assert_array_equal(got.heights.numpy(), np.asarray(want.heights))
    np.testing.assert_array_equal(got.segment_rgb.numpy(), np.asarray(want.segment_rgb))


def test_calmness_graph_wraps_like_jax():
    """17 pushes into rings of 7, each stream its own values: the ordered
    trace and its colors after every push."""
    cap = 7
    js = jax.vmap(lambda _: jv.CalmnessGraphState.init(cap))(jnp.arange(B))
    ts = tv.CalmnessGraphState.init(B, cap, device="cpu")
    r = np.random.default_rng(6)
    for _ in range(17):
        v = r.uniform(0, 1, B).astype(np.float32)
        js = jax.vmap(lambda s, x: s.push(x))(js, _j(v))
        ts = ts.push(_t(v))
        jo, jc = jax.vmap(lambda s: s.trace())(js)
        to, tc = ts.trace()
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.write_index.numpy(), np.asarray(js.write_index))


def test_spectrogram_state_wraps_like_jax():
    h, n = 5, 12
    js = jax.vmap(lambda _: jv.SpectrogramState.init(h, n))(jnp.arange(B))
    ts = tv.SpectrogramState.init(B, h, n, device="cpu")
    r = np.random.default_rng(7)
    for _ in range(12):
        row = r.integers(1, 256, (B, n, 4)).astype(np.uint8)
        js = jax.vmap(lambda s, x: s.push(x))(js, _j(row))
        ts = ts.push(_t(row))
        np.testing.assert_array_equal(ts.image.numpy(), np.asarray(js.image))
        np.testing.assert_array_equal(ts.write_index.numpy(), np.asarray(js.write_index))


def test_rows_are_independent():
    """Every max is a stream's own: scaling one stream's peak sizes changes
    no other stream's balls, peaks-mode spectrogram row or bass spiral."""
    rng_cfg = to_port(SERIAL_VQT_PARAMETERS.range)
    a = seeded_analysis_outputs(5, rng_cfg.n_buckets, 8)
    louder = a["peak_size"].copy()
    louder[0] *= 10.0

    def run(size):
        args = [_t(a[k]) for k in ("peaks", "peak_center")] + [_t(size)] + [
            _t(a[k]) for k in ("calmness", "pitch_accuracy", "pitch_deviation")]
        _, balls = tv.update_balls(rng_cfg, tv.BallState.init(5, rng_cfg.n_buckets, device="cpu"), *args, 1 / 60)
        return (balls, tv.spectrogram_row_peaks(rng_cfg, *args[:3]), tv.bass_spiral(rng_cfg, *args[:3]))

    for base, scaled in zip(run(a["peak_size"]), run(louder)):
        leaves = [base] if isinstance(base, torch.Tensor) else [getattr(base, f.name) for f in dataclasses.fields(base)]
        scaled_leaves = [scaled] if isinstance(scaled, torch.Tensor) else [
            getattr(scaled, f.name) for f in dataclasses.fields(scaled)]
        for x, y in zip(leaves, scaled_leaves):
            assert torch.equal(x[1:], y[1:])
