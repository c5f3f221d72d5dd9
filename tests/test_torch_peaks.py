"""The port's peak primitives against the JAX package: local maxima and
prominences bit for bit (they take only compares, min, max and one
subtraction), the peaks kernel's plain version against the JAX Pallas peaks
kernel (interpret mode), and peak masks from full prominences equal to the
JAX hot path's pair-compacted ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from pitchvis_tpu.core.config import AnalysisParameters, VqtRange
from pitchvis_tpu.ops import peaks as jpeaks
from pitchvis_tpu.ops.peaks_pallas import local_maxima_and_prominences_pallas
from pitchvis_tpu_torch.ops import peaks as tpeaks
from pitchvis_tpu_torch.ops.peaks_pallas import (
    local_maxima_and_prominences,
    local_maxima_and_prominences_plain,
)

from torch_port_helpers import to_port


def walks(seed, b=6, n=588, quantize=None):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((b, n)), axis=1).astype(np.float32)
    x = x - x.min(axis=1, keepdims=True)
    if quantize:
        x = np.round(x * quantize) / quantize
    return x.astype(np.float32)


TIE_FIXTURES = [
    [0, 5, 0, 5, 0],
    [0, 5, 0, 5, 0, 5, 0],
    [0, 1, 5, 5, 5, 1, 0],
    [5, 1, 0, 1, 6],
    [0, 3, 3, 1, 3, 3, 0, 2, 2, 2, 2, 0],
]


@pytest.mark.parametrize("case", ["walk", "plateaus", "n65", "n96"] + [f"tie{i}" for i in range(len(TIE_FIXTURES))])
def test_local_maxima_and_prominences_bitwise(case):
    if case == "walk":
        x = walks(0)
    elif case == "plateaus":
        x = walks(1, quantize=1.0)
    elif case == "n65":
        x = walks(2, n=65, quantize=2.0)
    elif case == "n96":
        x = walks(3, n=96)
    else:
        x = np.asarray([TIE_FIXTURES[int(case[3:])]], np.float32)
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(tpeaks.local_maxima(tx).numpy(), np.asarray(jax.vmap(jpeaks.local_maxima)(jx)))
    np.testing.assert_array_equal(tpeaks.prominences(tx).numpy(), np.asarray(jax.vmap(jpeaks.prominences)(jx)))


@pytest.mark.parametrize("seed", range(3))
def test_kernel_plain_matches_jax_pallas_kernel(seed):
    x = walks(seed, b=5, n=128, quantize=1.0 if seed == 1 else None)
    jm, jp = local_maxima_and_prominences_pallas(jnp.asarray(x), batch_tile=4)
    tm, tp = local_maxima_and_prominences_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # the dispatching wrapper takes the plain version for CPU tensors
    wm, wp = local_maxima_and_prominences(torch.from_numpy(x))
    assert torch.equal(wm, tm) and torch.equal(wp, tp)


@pytest.mark.parametrize("seed", range(4))
def test_prominences_compact_matches_jax(seed):
    x = walks(seed, b=3, n=[96, 250, 588, 65][seed], quantize=2.0 if seed == 0 else None)
    jx = jnp.asarray(x)
    jl = jax.vmap(jpeaks.local_maxima)(jx)
    want = np.asarray(jax.vmap(lambda a, b: jpeaks.prominences_compact(a, b, 2.0))(jx, jl))
    tx = torch.from_numpy(x)
    got = tpeaks.prominences_compact(tx, tpeaks.local_maxima(tx), 2.0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_find_peaks_mask_full_prominences_equals_jax_compact(seed):
    """The port feeds find_peaks_mask full prominences with the min_height
    prefilter applied as a mask; the JAX hot path feeds pair-compacted ones.
    The peak masks must be identical."""
    ap = AnalysisParameters()
    bpo = 24
    x = walks(seed, b=4, n=96, quantize=2.0 if seed % 2 else None) * 2.0
    jx = jnp.asarray(x)
    for cfg in (ap.peak_config, ap.bassline_peak_config):
        min_h = min(ap.peak_config.min_height, ap.bassline_peak_config.min_height)

        def jax_mask(xi, cfg=cfg):
            lm = jpeaks.local_maxima(xi)
            return jpeaks.find_peaks_mask(xi, cfg, bpo, precomputed=(lm, jpeaks.prominences_compact(xi, lm, min_h)))

        want = np.asarray(jax.vmap(jax_mask)(jx))
        tx = torch.from_numpy(x)
        lm, prom = local_maxima_and_prominences(tx)
        prom = torch.where(lm & (tx >= min_h), prom, torch.tensor(tpeaks._NEG))
        got = tpeaks.find_peaks_mask(tx, to_port(cfg), bpo, precomputed=(lm, prom)).numpy()
        np.testing.assert_array_equal(got, want)
        assert want.any()


class TestSuppression:
    @staticmethod
    def _chain(length, step=-0.5, start=50.0):
        x = np.zeros(2 * length + 20, np.float32)
        x[np.arange(length) * 2 + 3] = start + np.arange(length) * step
        return x

    @pytest.mark.parametrize("length", [5, 20, 40])
    @pytest.mark.parametrize("step", [-0.5, 0.5])
    def test_exact_mode_matches_scipy_on_chains(self, length, step):
        x = torch.from_numpy(self._chain(length, step))[None]
        kept = tpeaks._suppress_by_distance(tpeaks.local_maxima(x), x, 3, None)[0]
        want, _ = scipy.signal.find_peaks(x[0].numpy(), distance=3)
        np.testing.assert_array_equal(np.where(kept.numpy())[0], want)

    def test_batched_chains_converge_together(self):
        xs = np.stack([self._chain(20), self._chain(20, -0.1), self._chain(20, 0.3)])
        tx = torch.from_numpy(xs)
        kept = tpeaks._suppress_by_distance(tpeaks.local_maxima(tx), tx, 3, None).numpy()
        for i in range(xs.shape[0]):
            want, _ = scipy.signal.find_peaks(xs[i], distance=3)
            np.testing.assert_array_equal(np.where(kept[i])[0], want)

    def test_exact_tie_fixture(self):
        for fx, want in (([0, 5, 0, 5, 0], [3]), ([0, 5, 0, 5, 0, 5, 0], [1, 5])):
            x = torch.tensor([fx], dtype=torch.float32)
            kept = tpeaks._suppress_by_distance(tpeaks.local_maxima(x), x, 3)[0]
            np.testing.assert_array_equal(np.where(kept.numpy())[0], want)

    @pytest.mark.parametrize("seed", range(3))
    def test_tie_heavy_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        x = (np.round(rng.uniform(0.0, 4.0, (3, 120)) * 2.0) / 2.0).astype(np.float32)
        jx = jnp.asarray(x)
        cand = jax.vmap(jpeaks.local_maxima)(jx)
        tx = torch.from_numpy(x)
        for d in (2, 3, 5):
            want = np.asarray(jax.vmap(lambda c, h: jpeaks._suppress_by_distance(c, h, d))(cand, jx))
            got = tpeaks._suppress_by_distance(tpeaks.local_maxima(tx), tx, d).numpy()
            np.testing.assert_array_equal(got, want)


def test_continuous_and_bass_promotion_match_jax():
    """Sub-bin refinement and bass promotion: elementwise float math whose
    rounding XLA may fuse differently (FMA contraction), so atol 1e-4 dB /
    1e-5 bins."""
    rng_cfg = VqtRange(min_freq=110.0, octaves=4, buckets_per_octave=24)
    x = walks(5, b=3, n=rng_cfg.n_buckets) + 3.0
    jx = jnp.asarray(x)
    jmask = jax.vmap(jpeaks.local_maxima)(jx)
    jc, js = jax.vmap(lambda m, xi: jpeaks.enhance_peaks_continuous(m, xi, rng_cfg))(jmask, jx)
    jsize = jax.vmap(lambda m, c, s, xi: jpeaks.promote_bass_peaks(m, c, s, xi, rng_cfg, 28, 0.3))(jmask, jc, js, jx)
    tx = torch.from_numpy(x)
    tmask = tpeaks.local_maxima(tx)
    tc, ts = tpeaks.enhance_peaks_continuous(tmask, tx, to_port(rng_cfg))
    tsize = tpeaks.promote_bass_peaks(tmask, tc, ts, tx, to_port(rng_cfg), 28, 0.3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tsize.numpy(), np.asarray(jsize), atol=1e-4)
