"""The port's color math (pitchvis_tpu_torch/ops/colors.py) against the JAX
package's (pitchvis_tpu/ops/colors.py) on the same seeded inputs.

Tolerances: PyTorch has no cbrt (the port takes pow(t, 1/3)), and PyTorch
and XLA round pow, atan2, cos and sin differently in the last ulp. Lab
values (a 0-100 scale) agree within atol 1e-4, LCh and Lab from LCh within
atol 1e-5; u8 levels within one level, in at most 1e-5 of the values (a
level flips only where a value lands within an ulp of a rounding edge: one
of 3e5 at bpo 24 when this was written, none at bpo 84 or 36)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pitchvis_tpu.ops import colors as jc
from pitchvis_tpu_torch.ops import colors as tc
from pitchvis_tpu_torch.utils.rounding import exact_div

U8_FLIP_SHARE = 1e-5


def _u8_within_one_level(got, want, share=U8_FLIP_SHARE):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= 1.0, f"a u8 level moved by {d.max()}"
    assert (d > 0).mean() <= share, f"{(d > 0).sum()} of {d.size} levels flipped"


def test_constants_equal_jax():
    np.testing.assert_array_equal(tc.COLORS, jc.COLORS)
    np.testing.assert_array_equal(tc.SERIAL_COLORS, jc.SERIAL_COLORS)
    assert tc.PITCH_NAMES == jc.PITCH_NAMES
    assert (tc.GRAY_LEVEL, tc.EASING_POW) == (jc.GRAY_LEVEL, jc.EASING_POW)
    np.testing.assert_array_equal(tc._XYZ2RGB, jc._XYZ2RGB)
    assert (tc._EPS, tc._KAPPA) == (jc._EPS, jc._KAPPA)


@pytest.mark.parametrize(
    "bpo,palette,gray,ease",
    [(84, "COLORS", 60.0, 1.3), (36, "SERIAL_COLORS", 5.0, 2.3), (24, "COLORS", 60.0, 1.3)],
    ids=["default_bpo84", "serial_bpo36", "half_semitones_bpo24"],
)
def test_calculate_color_matches_jax(bpo, palette, gray, ease):
    """Every integer bucket of seven octaves (at bpo 24 every odd one is an
    exact half-semitone) and 1e5 seeded fractional ones: RGB in levels of
    1/255, within one level in the stated share."""
    rng = np.random.default_rng(bpo)
    b = rng.uniform(0, bpo * 7, 100_000).astype(np.float32)
    b[: bpo * 7] = np.arange(bpo * 7)
    colors = getattr(jc, palette)
    want = np.asarray(jc.calculate_color(bpo, jnp.asarray(b), colors, gray, ease))
    got = tc.calculate_color(bpo, torch.from_numpy(b), colors, gray, ease).numpy()
    assert got.shape == (b.size, 3) and got.dtype == np.float32
    # the outputs are levels / 255 in both packages
    _u8_within_one_level(got * 255.0, want * 255.0)
    np.testing.assert_allclose(got * 255.0, np.round(got * 255.0), atol=1e-3)


def test_calculate_color_batched_shape():
    """(B, n) buckets give (B, n, 3) colors, each row as computed alone."""
    b = np.random.default_rng(0).uniform(0, 84, (3, 40)).astype(np.float32)
    got = tc.calculate_color(84, torch.from_numpy(b))
    assert got.shape == (3, 40, 3)
    for row in range(3):
        assert torch.equal(got[row], tc.calculate_color(84, torch.from_numpy(b[row])))


def test_lab_chain_matches_jax():
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (20_000, 3)).astype(np.float32)
    u8[:12] = np.floor(jc.COLORS * 255.0)
    lab_j = np.asarray(jc.srgb_u8_to_lab(jnp.asarray(u8)))
    lab_t = tc.srgb_u8_to_lab(torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(lab_t, lab_j, atol=1e-4)
    # from here on, the same Lab inputs to both
    lch_j = np.asarray(jc.lab_to_lch(jnp.asarray(lab_j)))
    lch_t = tc.lab_to_lch(torch.from_numpy(lab_j.copy())).numpy()
    np.testing.assert_allclose(lch_t, lch_j, atol=1e-5)
    back_j = np.asarray(jc.lch_to_lab(jnp.asarray(lch_j)))
    back_t = tc.lch_to_lab(torch.from_numpy(lch_j.copy())).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=1e-5)


def test_lab_to_srgb_u8_matches_jax():
    rng = np.random.default_rng(2)
    n = 200_000
    lab = np.stack(
        [rng.uniform(0, 100, n), rng.uniform(-80, 80, n), rng.uniform(-80, 80, n)], -1
    ).astype(np.float32)
    want = np.asarray(jc.lab_to_srgb_u8(jnp.asarray(lab)))
    got = tc.lab_to_srgb_u8(torch.from_numpy(lab)).numpy()
    assert got.min() >= 0.0 and got.max() <= 255.0
    _u8_within_one_level(got, want)


def test_exact_div_is_correctly_rounded():
    """exact_div equals float32 division (NumPy's, correctly rounded), also
    for divisors whose reciprocal is inexact."""
    x = np.random.default_rng(3).uniform(-1e3, 1e3, 10_000).astype(np.float32)
    for d in (255.0, 12.92, 1.055, 116.0, 84, 7.0):
        got = exact_div(torch.from_numpy(x), d).numpy()
        np.testing.assert_array_equal(got, x / np.float32(d))
