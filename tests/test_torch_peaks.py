"""The port's peak primitives against the JAX package: local maxima and
prominences bit for bit (they take only compares, min, max and one
subtraction), the peaks kernel's plain version against the JAX Pallas peaks
kernel (interpret mode), peak masks from full prominences equal to the
JAX hot path's pair-compacted ones, the plain version of the kernel's peak
selection identical to the JAX hot path's masks, and a NumPy emulation of the
kernel's own per-row algorithm identical to that plain version."""

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
    find_peaks_masks,
    find_peaks_masks_plain,
    local_maxima_and_prominences,
    local_maxima_and_prominences_plain,
)
from pitchvis_tpu_torch.ops.vqt import Vqt

from torch_port_helpers import default_params, peaks_kernel_emulation, streams, to_port


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


def _chains(n, rng):
    """Rows of candidates two bins apart: heights falling, rising, equal, in
    short equal runs and random from a few levels. Jacobi rounds on them
    converge slowly (a falling chain of k peaks needs about k/2 rounds), so a
    bounded number of rounds leaves a state that is not the fixpoint."""
    k = (n - 4) // 2
    steps = [
        20.0 - 0.25 * np.arange(k),
        4.0 + 0.25 * np.arange(k),
        np.full(k, 7.0),
        20.0 - np.repeat(np.arange((k + 2) // 3), 3)[:k],
        rng.integers(3, 9, k).astype(np.float64),
        rng.integers(3, 6, k) + 0.5,
    ]
    x = np.zeros((len(steps), n), np.float32)
    for row, h in zip(x, steps):
        row[2 + 2 * np.arange(k)] = h
    # plateaus of two and three bins between singles, and peaks at the ends
    x[4, 1] = x[4, 2]
    x[5, n - 2] = 9.0
    x[5, n - 3] = 9.0
    return x


_VQT_SPECTRA = {}


def _vqt_spectra():
    """dB spectra of the port's own fused VQT (its plain version, on the CPU)
    at the default parameters, 588 bins at 84 an octave: four frames of six
    seeded sines each plus noise."""
    if not _VQT_SPECTRA:
        params = default_params()
        sig = streams(12, params.n_fft, params.sr, seed=11).reshape(4, 3, -1).sum(axis=1)
        vqt = Vqt(to_port(params), path="pallas", device="cpu")
        _VQT_SPECTRA["x"] = vqt.calculate_vqt_batch_in_db(sig.astype(np.float32)).numpy()
    return _VQT_SPECTRA["x"]


def _selection_inputs(kind, n=588):
    rng = np.random.default_rng({"walk": 21, "rounded": 22, "chains": 23, "vqt": 24}[kind])
    if kind == "walk":
        return walks(21, b=4, n=n) + 1.0
    if kind == "rounded":
        # about n/6 local maxima a row, many of equal height, plateaus
        return walks(22, b=4, n=n, quantize=1.0) + 2.0
    if kind == "chains":
        return _chains(n, rng)
    assert n == 588
    return _vqt_spectra()


SUPPRESS_ITERATIONS = [None, 0, 1, 2, 3]
SELECTION_KINDS = ["walk", "rounded", "chains", "vqt"]


def _jax_masks(x, configs, bpo, suppress_iterations):
    """The JAX hot path's masks: find_peaks_mask fed by prominences_compact
    under the smallest min_height of the configurations, as
    pitchvis_tpu/models/analysis.py::analysis_step feeds it."""
    min_h = min(c.min_height for c in configs)

    def one(xi, cfg):
        lm = jpeaks.local_maxima(xi)
        pre = (lm, jpeaks.prominences_compact(xi, lm, min_h))
        return jpeaks.find_peaks_mask(xi, cfg, bpo, precomputed=pre, suppress_iterations=suppress_iterations)

    jx = jnp.asarray(x)
    return [np.asarray(jax.vmap(lambda xi, cfg=cfg: one(xi, cfg))(jx)) for cfg in configs]


@pytest.mark.parametrize("suppress_iterations", SUPPRESS_ITERATIONS)
@pytest.mark.parametrize("kind", SELECTION_KINDS)
def test_find_peaks_masks_plain_identical_to_jax(kind, suppress_iterations):
    """Both configurations in one call, and the general one alone (as the
    analysis step calls it on the raw spectrum), identical to the JAX masks;
    the bounded rounds too, converged or not."""
    ap = AnalysisParameters()
    bpo = 84  # min separation 3 bins, first allowed bin 4
    x = _selection_inputs(kind)
    tx = torch.from_numpy(x)
    both = (ap.bassline_peak_config, ap.peak_config)
    want = _jax_masks(x, both, bpo, suppress_iterations)
    got = find_peaks_masks_plain(tx, [to_port(c) for c in both], bpo, suppress_iterations)
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want[0].any()
    (alone,) = find_peaks_masks(tx, (to_port(ap.peak_config),), bpo, suppress_iterations)
    np.testing.assert_array_equal(alone.numpy(), _jax_masks(x, (ap.peak_config,), bpo, suppress_iterations)[0])


def test_bounded_rounds_differ_from_the_fixpoint_on_chains():
    """The chains really leave the bounded mode unconverged, so the cases
    above and below hold the rounds themselves and not only their end."""
    ap = to_port(AnalysisParameters())
    tx = torch.from_numpy(_selection_inputs("chains"))
    exact = find_peaks_masks_plain(tx, (ap.bassline_peak_config,), 84, None)[0]
    for k in (0, 1, 2, 3):
        assert not torch.equal(find_peaks_masks_plain(tx, (ap.bassline_peak_config,), 84, k)[0], exact)


@pytest.mark.parametrize("suppress_iterations", SUPPRESS_ITERATIONS)
@pytest.mark.parametrize("n", [65, 96, 588, 1100])
@pytest.mark.parametrize("kind", ["walk", "rounded", "chains"])
def test_kernel_emulation_identical_to_plain(kind, n, suppress_iterations):
    ap = to_port(AnalysisParameters())
    x = _selection_inputs(kind, n)[:3 if kind != "chains" else None]
    rounds = -1 if suppress_iterations is None else suppress_iterations
    for bpo, configs in ((84, (ap.bassline_peak_config, ap.peak_config)), (120, (ap.peak_config,)), (24, (ap.peak_config,))):
        want = find_peaks_masks_plain(torch.from_numpy(x), configs, bpo, suppress_iterations)
        got = peaks_kernel_emulation(
            x, [(c.min_height, c.min_prominence) for c in configs],
            tpeaks.min_separation_bins(bpo), rounds, tpeaks.first_allowed_bin(bpo),
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"bpo {bpo}")


@pytest.mark.parametrize("suppress_iterations", [None, 1])
def test_kernel_emulation_identical_to_plain_on_vqt_spectra(suppress_iterations):
    ap = to_port(AnalysisParameters())
    x = _vqt_spectra()
    configs = (ap.bassline_peak_config, ap.peak_config)
    want = find_peaks_masks_plain(torch.from_numpy(x), configs, 84, suppress_iterations)
    got = peaks_kernel_emulation(
        x, [(c.min_height, c.min_prominence) for c in configs], 3,
        -1 if suppress_iterations is None else suppress_iterations, 4,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert want[1].any()


def test_find_peaks_masks_arguments_and_empty_batch():
    ap = to_port(AnalysisParameters())
    x = torch.from_numpy(walks(0, b=2, n=96))
    with pytest.raises(ValueError):
        find_peaks_masks(x, (), 84)
    with pytest.raises(ValueError):
        find_peaks_masks(x, (ap.peak_config,) * 3, 84)
    with pytest.raises(ValueError):
        find_peaks_masks(x, (ap.peak_config,), 84, suppress_iterations=-1)
    empty = find_peaks_masks(x[:0], (ap.bassline_peak_config, ap.peak_config), 84)
    assert [tuple(m.shape) for m in empty] == [(0, 96), (0, 96)] and empty[0].dtype == torch.bool


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_top_k_peaks_matches_jax(seed, k):
    """ops/peaks.py::top_k_peaks against the JAX package's on peak masks
    with many equal sizes and equal centers: ties go to the lower bin, as
    lax.top_k breaks them, and equal centers keep their order, as the
    stable jnp.argsort does; k beyond the peaks pads with +inf / 0 /
    invalid."""
    r = np.random.default_rng(seed)
    n = 180
    mask = r.random((4, n)) < 0.08
    size = np.round(r.uniform(0.0, 3.0, (4, n))).astype(np.float32)  # few levels: ties
    center = (np.arange(n) + np.round(r.uniform(-2, 2, (4, n)))).astype(np.float32)  # equal centers
    mask[3] = False
    for b in range(4):
        want = jpeaks.top_k_peaks(jnp.asarray(mask[b]), jnp.asarray(center[b]), jnp.asarray(size[b]), k)
        got = tpeaks.top_k_peaks(torch.from_numpy(mask[b]), torch.from_numpy(center[b]),
                                 torch.from_numpy(size[b]), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    batched = tpeaks.top_k_peaks(torch.from_numpy(mask), torch.from_numpy(center), torch.from_numpy(size), k)
    for b in range(4):
        one = tpeaks.top_k_peaks(torch.from_numpy(mask[b]), torch.from_numpy(center[b]),
                                 torch.from_numpy(size[b]), k)
        for g, w in zip(batched, one):
            torch.testing.assert_close(g[b], w, rtol=0, atol=0)
