"""The port's LED stage (pitchvis_tpu_torch/io/led.py) against the JAX
package's (pitchvis_tpu/io/led.py, one stream under jax.vmap) on the same
seeded analysis outputs, B >= 3 streams: one silent, one with peaks at the
2-bin minimum distance.

Tolerances: splatted sizes within atol 1e-5 (pow(fract, 1.9) rounds in
another ulp in PyTorch than in XLA); u8 LED values within one level in at
most 1e-5 of the values (tests/test_torch_colors.py); the frame header
exactly."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pitchvis_tpu.core.config import SERIAL_VQT_PARAMETERS, VqtParameters
from pitchvis_tpu.io import led as jled
from pitchvis_tpu_torch.io import led as tled

from torch_port_helpers import seeded_analysis_outputs, to_port, u8_within_one_level

U8_FLIP_SHARE = 1e-5
RANGES = {"serial": SERIAL_VQT_PARAMETERS.range, "default": VqtParameters().range}


def _inputs(rng_cfg, b=4, seed=0):
    out = seeded_analysis_outputs(b, rng_cfg.n_buckets, seed)
    return out["peaks"], out["peak_center"], out["peak_size"]


def _jax_led(rng_cfg, m, c, s):
    return np.array(jax.vmap(lambda m, c, s: jled.led_frame_values(rng_cfg, m, c, s))(
        jnp.asarray(m), jnp.asarray(c), jnp.asarray(s)))


def _port_led(rng_cfg, m, c, s):
    return tled.led_frame_values(to_port(rng_cfg), torch.from_numpy(m), torch.from_numpy(c), torch.from_numpy(s))


@pytest.mark.parametrize("name", sorted(RANGES))
def test_splat_peaks_matches_jax(name):
    rng_cfg = RANGES[name]
    n = rng_cfg.n_buckets
    m, c, s = _inputs(rng_cfg)
    want = np.asarray(jax.vmap(lambda m, c, s: jled.splat_peaks(m, c, s, n))(
        jnp.asarray(m), jnp.asarray(c), jnp.asarray(s)))
    got = tled.splat_peaks(torch.from_numpy(m), torch.from_numpy(c), torch.from_numpy(s), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert (got[1] == 0).all()


@pytest.mark.parametrize("name", sorted(RANGES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_led_frame_values_match_jax(name, seed):
    rng_cfg = RANGES[name]
    m, c, s = _inputs(rng_cfg, seed=seed)
    want = _jax_led(rng_cfg, m, c, s)
    got = _port_led(rng_cfg, m, c, s)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (4, rng_cfg.n_buckets, 3)
    got = got.numpy()
    u8_within_one_level(got, want, U8_FLIP_SHARE, "led")
    assert got.max() <= 0xFE
    assert (got[1] == 0).all(), "the silent stream's frame is all zeros"


def test_led_table_matches_jax():
    """The static (n, 3) RGB table is calculate_color of the rotated bins,
    as the JAX package computes it each frame."""
    from pitchvis_tpu.ops.colors import calculate_color

    rng_cfg = SERIAL_VQT_PARAMETERS.range
    n, bpo = rng_cfg.n_buckets, rng_cfg.buckets_per_octave
    bucket = ((np.arange(n) + (bpo - 3 * (bpo // 12))) % bpo).astype(np.float32)
    want = np.asarray(calculate_color(bpo, jnp.asarray(bucket), jled.SERIAL_COLORS, jled.SERIAL_GRAY_LEVEL,
                                      jled.SERIAL_EASING_POW))
    got = tled._led_rgb(to_port(rng_cfg)).numpy()
    u8_within_one_level(got * 255.0, want * 255.0, U8_FLIP_SHARE, "led table")


def test_rows_are_independent():
    """The max that scales each stream's colors is that stream's own: scaling
    one stream's peak sizes changes no other stream's LED frame."""
    rng_cfg = SERIAL_VQT_PARAMETERS.range
    m, c, s = _inputs(rng_cfg, b=5, seed=3)
    base = _port_led(rng_cfg, m, c, s)
    louder = s.copy()
    louder[0] *= 10.0
    scaled = _port_led(rng_cfg, m, c, louder)
    assert torch.equal(scaled[1:], base[1:])
    u8_within_one_level(scaled[0].numpy(), base[0].numpy(), 0.01, "the scaled stream")


def test_frame_bytes_and_led_frame_match_jax():
    rng_cfg = SERIAL_VQT_PARAMETERS.range
    n = rng_cfg.n_buckets
    m, c, s = _inputs(rng_cfg, seed=4)
    values = _jax_led(rng_cfg, m, c, s)
    assert tled.frame_bytes(values[0]) == jled.frame_bytes(values[0])
    assert tled.frame_bytes(torch.from_numpy(values[0])) == jled.frame_bytes(values[0])
    got = tled.led_frame(to_port(rng_cfg), torch.from_numpy(m[0]), torch.from_numpy(c[0]), torch.from_numpy(s[0]))
    want = jled.led_frame(rng_cfg, jnp.asarray(m[0]), jnp.asarray(c[0]), jnp.asarray(s[0]))
    assert len(got) == 3 + 3 * n and got[:3] == bytes([0xFF, n // 256, n % 256]) == want[:3]
    u8_within_one_level(np.frombuffer(got, np.uint8), np.frombuffer(want, np.uint8), U8_FLIP_SHARE, "frame")


def test_serial_writer_to_a_file_and_a_stream(tmp_path):
    frame = tled.frame_bytes(np.arange(12, dtype=np.uint8).reshape(4, 3))
    path = tmp_path / "leds.bin"
    w = tled.SerialWriter(str(path))
    w.write_frame(frame)
    w.write_frame(frame)
    w.close()
    assert path.read_bytes() == frame * 2

    class Sink:
        def __init__(self):
            self.data = b""

        def write(self, b):
            self.data += b

        def flush(self):
            pass

    sink = Sink()
    w = tled.SerialWriter(sink)
    w.write_frame(frame)
    w.close()
    assert sink.data == frame
