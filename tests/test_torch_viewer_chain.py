"""The viewer deployment's chain over many hops, the port against the JAX
package on the CPU: the analysis and every display output, with the ball
carry that keeps a ball fading for many hops after its peak is gone.

Both packages get the same dB spectra (the port's own VQT of seeded notes
at the viewer's VqtParameters(): 588 bins, a 367-sample hop) and run their
analysis step and output stages from their own carried state, hop after
hop. The port's outputs are those of ``StreamingPipeline.step_multi`` with
``with_viewer=True``, the path the viewer deployment serves.

Budgets: the peaks exactly (both sides threshold the same f32 values, so a
flip would be a departure, and the ball carry would keep it for many hops);
booleans exactly; u8 values, and colors in levels of 1/255, within one
level in at most 1e-5 of them over all hops (tests/test_torch_viewer.py's:
XLA may divide by 255 through the reciprocal, an ulp from a level); every
other float within atol 1e-4: bin centres reach 588, where an f32 ulp is
6.1e-5, and the tuning average, a sum over the peaks in another order,
drifted at most 8.2e-5 over 128 hops when this was written.

The smoothed spectrum and its afterglow are held so in all but 1e-3 of
their values, and within 0.05 dB in those. The smoothing horizon is floored
to whole ms; where a bin's product lands on a whole ms, the JAX package's
compiled program (a product with the reciprocals of 588 and of 1000) floors
it one ms apart from its own written f32 arithmetic, which the port follows
bit for bit (:func:`test_smoothing_horizons_follow_the_written_arithmetic`),
and the EMA carries that gap for some hops: 0-29 of 301,056 values, at most
0.030 dB, over three seeds when this was written."""

import jax
import numpy as np
import torch

import jax.numpy as jnp

from pitchvis_tpu.core.config import AnalysisParameters as JaxAnalysisParameters
from pitchvis_tpu.core.config import VqtParameters as JaxVqtParameters
from pitchvis_tpu.models import viewer as jv
from pitchvis_tpu.models.analysis import _smoothing_horizons as jax_smoothing_horizons
from pitchvis_tpu.models.analysis import analysis_step_batch as jax_analysis_step_batch
from pitchvis_tpu.models.analysis import init_state_batch as jax_init_state_batch
from pitchvis_tpu.models.pipeline import derived_stages as jax_derived_stages
from pitchvis_tpu_torch import StreamingPipeline
from pitchvis_tpu_torch.models.analysis import _smoothing_horizons
from pitchvis_tpu_torch.models.viewer import BALL_LEAVES

from torch_port_helpers import to_port, u8_within_one_level

B = 4
HOPS = 128
FLOAT_ATOL = 1e-4
U8_SHARE = 1e-5
SMOOTHED = ("x_vqt_smoothed", "x_vqt_afterglow")
SMOOTHED_SHARE = 1e-3  # of their values past FLOAT_ATOL, where a horizon floors one ms apart
SMOOTHED_DB = 0.05
ANALYSIS_FLOATS = ("calmness", "peak_center", "peak_size", "pitch_accuracy", "pitch_deviation", "scene_calmness",
                   "tuning_inaccuracy")
VIEWER_BOOL = ("balls.visible", "bass.visible")
VIEWER_U8 = ("spectrogram_row",)
VIEWER_RGBA = ("balls.rgba", "bass.rgba")
VIEWER_FLOAT = ("balls.position", "balls.scale", "balls.calmness", "balls.pitch_accuracy", "balls.pitch_deviation",
                "chroma", "bloom", "calmness_histogram.heights", "calmness_histogram.segment_rgb")


def _notes(n_samples: int, sr: float, seed: int) -> np.ndarray:
    """(B, n_samples) float32: per stream a run of notes of 0.1-0.4 s (three
    harmonics, a 10-ms attack, an exponential decay, 30 dB of levels), a
    fifth of them rests, over a little noise; stream 1 silent but for the
    noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / sr
    sig = np.zeros((B, n_samples))
    for s in range(B):
        pos = 0
        while pos < n_samples:
            length = int(rng.uniform(0.1, 0.4) * sr)
            if s != 1 and rng.uniform() < 0.8:
                f0 = 55.0 * 2.0 ** ((rng.integers(1, 72) + rng.uniform(-0.2, 0.2)) / 12.0)
                since = t[pos : pos + length] - t[pos]
                env = np.minimum(since / 0.01, 1.0) * np.exp(-since / rng.uniform(0.2, 1.0))
                amp = 0.3 * 10.0 ** (rng.uniform(-30.0, 0.0) / 20.0)
                for h in range(1, 4):
                    if f0 * h < 0.45 * sr:
                        sig[s, pos : pos + length] += amp * env * np.sin(2 * np.pi * f0 * h * since) / h
            pos += length
    sig += 1e-3 * rng.standard_normal(sig.shape)
    return sig.astype(np.float32)


def _leaf(tree, path):
    for part in path.split("."):
        tree = getattr(tree, part)
    return np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)


def test_smoothing_horizons_follow_the_written_arithmetic():
    """The port's per-bin horizons, floored to whole ms, equal bit for bit
    what the JAX package's function computes op by op, at 588 bins over the
    whole range of scene calmness."""
    jax_params = JaxVqtParameters()
    calm = np.linspace(0.0, 1.0, 101).astype(np.float32)
    got = _smoothing_horizons(to_port(JaxAnalysisParameters()), to_port(jax_params.range), torch.from_numpy(calm))
    with jax.disable_jit():
        want = np.stack([np.asarray(jax_smoothing_horizons(JaxAnalysisParameters(), jax_params.range, jnp.float32(c)))
                         for c in calm])
    np.testing.assert_array_equal(got.numpy(), want)


def test_viewer_chain_over_many_hops_matches_jax():
    jax_params = JaxVqtParameters()
    params = to_port(jax_params)
    rng_cfg = jax_params.range
    n = rng_cfg.n_buckets
    hop = int(params.sr / 60.0)
    dt = hop / params.sr
    sig = _notes(HOPS * hop, params.sr, seed=23)
    chunks = torch.from_numpy(sig.reshape(B, HOPS, hop).transpose(1, 0, 2).copy())
    pipe = StreamingPipeline(B, params, path="pallas", with_viewer=True, device="cpu")
    out = pipe.step_multi(chunks, dt)

    analysis = jax.jit(lambda s, x, d: jax_analysis_step_batch(JaxAnalysisParameters(), rng_cfg, s, x, d))
    stages = jax.jit(lambda o, d, b: jax_derived_stages(rng_cfg, o, d, with_viewer=True, balls_state=b))
    state = jax_init_state_batch(B, n)
    balls = jax.vmap(lambda _: jv.BallState.init(n))(jnp.arange(B))
    dt_b = jnp.full((B,), dt, jnp.float32)
    fading = 0
    smoothed_off = {name: [] for name in SMOOTHED}
    levels = {path: ([], []) for path in (*VIEWER_U8, *VIEWER_RGBA)}  # (port, JAX) in 8-bit levels
    for h in range(HOPS):
        state, want = analysis(state, jnp.asarray(out.x_vqt[h].numpy()), dt_b)
        _, _, _, balls, view = stages(want, dt_b, balls)
        what = f"hop {h}"
        np.testing.assert_array_equal(out.analysis.peaks[h].numpy(), np.asarray(want.peaks), err_msg=what)
        for name in SMOOTHED:
            gap = np.abs(getattr(out.analysis, name)[h].numpy() - np.asarray(getattr(want, name)))
            assert gap.max() <= SMOOTHED_DB, f"{what} {name}: {gap.max()} dB"
            smoothed_off[name].append(gap > FLOAT_ATOL)
        for name in ANALYSIS_FLOATS:
            np.testing.assert_allclose(getattr(out.analysis, name)[h].numpy(), np.asarray(getattr(want, name)),
                                       atol=FLOAT_ATOL, rtol=0, err_msg=f"{what} {name}")
        for path in VIEWER_BOOL:
            np.testing.assert_array_equal(_leaf(out.viewer, path)[h], _leaf(view, path), err_msg=f"{what} {path}")
        for path in VIEWER_U8:
            levels[path][0].append(_leaf(out.viewer, path)[h])
            levels[path][1].append(_leaf(view, path))
        for path in VIEWER_RGBA:
            got, want_rgba = _leaf(out.viewer, path)[h], _leaf(view, path)
            levels[path][0].append(np.round(got[..., :3] * 255.0))
            levels[path][1].append(np.round(want_rgba[..., :3] * 255.0))
            np.testing.assert_allclose(got[..., 3], want_rgba[..., 3], atol=FLOAT_ATOL, rtol=0,
                                       err_msg=f"{what} {path} alpha")
        for path in VIEWER_FLOAT:
            np.testing.assert_allclose(_leaf(out.viewer, path)[h], _leaf(view, path), atol=FLOAT_ATOL, rtol=0,
                                       err_msg=f"{what} {path}")
        fading += int((out.viewer.balls.visible[h] & ~out.analysis.peaks[h]).sum())
    for name, off in smoothed_off.items():
        assert np.mean(off) <= SMOOTHED_SHARE, f"{name}: {np.sum(off)} values past {FLOAT_ATOL}"
    for path, (got, want_levels) in levels.items():
        u8_within_one_level(np.stack(got), np.stack(want_levels), U8_SHARE, path)
    for k in BALL_LEAVES:
        np.testing.assert_allclose(getattr(pipe.state.balls, k).numpy(), np.asarray(getattr(balls, k)),
                                   atol=FLOAT_ATOL, rtol=0, err_msg=f"ball carry {k}")
    # the carry is exercised: peaks come and go, and balls outlive them
    assert int(out.analysis.peaks.sum()) > HOPS and fading > HOPS
