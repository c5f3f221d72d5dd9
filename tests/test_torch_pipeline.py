"""The port's streaming hop (ring + AGC -> fused VQT -> analysis) against
the JAX package's StreamingPipeline(path="pallas") on the same audio, and
the committed streaming golden replayed by the port alone."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pitchvis_tpu.core.config import AnalysisParameters
from pitchvis_tpu.models.analysis import analysis_step_batch as jax_analysis_step_batch
from pitchvis_tpu.models.pipeline import StreamingPipeline as JaxPipeline
from pitchvis_tpu_torch import StreamingPipeline, convert, get_kernel, init_pipeline_state, init_state_batch
from pitchvis_tpu_torch.ops.vqt import VqtArrays
from pitchvis_tpu_torch.ops.vqt_pallas import PallasVqtArrays
from pitchvis_tpu_torch.stream.ring import RingState
from pitchvis_tpu_torch.convert import ANALYSIS_LEAVES, pipeline_state_from_numpy, pipeline_state_to_numpy
from pitchvis_tpu_torch.models.analysis import analysis_step_batch
from pitchvis_tpu_torch.models.ml_system import MlState, init_ml_state_batch
from pitchvis_tpu_torch.models.pitch_mlp import PitchMLP
from pitchvis_tpu_torch.models.viewer import BallState, CalmnessGraphState, SpectrogramState
from pitchvis_tpu_torch.train.train import TrainConfig, make_model

from conftest import SMALL_PARAMS
from torch_port_helpers import default_params, streams, to_port

B = 3
HOPS = 30
HOP = 367
DT = HOP / SMALL_PARAMS.sr
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "streaming_golden.npz")


def _audio():
    """B streams of seeded sines + noise; stream 1 carries one NaN chunk
    (hop 5) and stream 2 one silent chunk (hop 10)."""
    sig = streams(B, HOPS * HOP, SMALL_PARAMS.sr, seed=0)
    sig[1, 5 * HOP + 7] = np.nan
    sig[2, 10 * HOP : 11 * HOP] = 0.0
    return sig


def _jax_state(pipe):
    s = pipe.state
    out = {"buffer": np.asarray(s.ring.buffer), "gain": np.asarray(s.ring.gain)}
    for k in ANALYSIS_LEAVES:
        out[k] = np.asarray(getattr(s.analysis, k))
    return out


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
def test_hop_matches_jax(fast):
    """Gains rtol 1e-6 (the AGC is bit-exact; the bound allows nothing
    more); x_vqt atol 1e-3 dB (f32/bf16 sums in another order); at most 2e-4
    of the peak bins may flip (a flip needs a bin within ~1e-4 dB of a
    threshold); continuous outputs atol 1e-3 where the peaks agree."""
    sig = _audio()
    jp = JaxPipeline(B, SMALL_PARAMS, path="pallas", fast=fast)
    tp = StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", fast=fast, device="cpu")
    flips = total = 0
    for h in range(HOPS):
        chunk = sig[:, h * HOP : (h + 1) * HOP]
        jo = jp.step(chunk, DT)
        to = tp.step(chunk, DT)
        np.testing.assert_allclose(to.gain.numpy(), np.asarray(jo.gain), rtol=1e-6)
        np.testing.assert_allclose(to.x_vqt.numpy(), np.asarray(jo.x_vqt), atol=1e-3)
        jpk = np.asarray(jo.analysis.peaks)
        tpk = to.analysis.peaks.numpy()
        flips += int((jpk != tpk).sum())
        total += jpk.size
        agree = jpk == tpk
        for name in ("x_vqt_smoothed", "x_vqt_afterglow", "calmness", "peak_center", "peak_size",
                     "pitch_accuracy", "pitch_deviation"):
            got = getattr(to.analysis, name).numpy()
            want = np.asarray(getattr(jo.analysis, name))
            np.testing.assert_allclose(got[agree], want[agree], atol=1e-3, err_msg=f"{name}, hop {h}")
        for name in ("scene_calmness", "tuning_inaccuracy"):
            np.testing.assert_allclose(
                getattr(to.analysis, name).numpy(), np.asarray(getattr(jo.analysis, name)), atol=1e-3)
    assert flips <= 2e-4 * total
    # the NaN chunk was rejected: nothing non-finite entered the ring
    assert np.isfinite(tp.state.ring.buffer.numpy()).all()
    assert (to.analysis.peaks.numpy().sum(axis=1) > 0).any()


def test_analysis_on_jax_spectra_gives_identical_peaks():
    """Given the JAX package's dB spectra and state, the port's analysis
    step finds the same peaks; state leaves within atol 1e-5 (elementwise
    float math fused differently by XLA)."""
    sig = _audio()
    ap = AnalysisParameters()
    rng_cfg = SMALL_PARAMS.range
    jp = JaxPipeline(B, SMALL_PARAMS, path="pallas")
    for h in range(12):
        before = _jax_state(jp)
        jo = jp.step(sig[:, h * HOP : (h + 1) * HOP], DT)
        state = pipeline_state_from_numpy(before, device="cpu").analysis
        ts, to = analysis_step_batch(to_port(ap), to_port(rng_cfg), state, torch.from_numpy(np.array(jo.x_vqt)), DT)
        js, _ = jax_analysis_step_batch(
            ap, rng_cfg, jp.state.analysis.replace(**{k: jnp.asarray(before[k]) for k in ANALYSIS_LEAVES}),
            jo.x_vqt, DT)
        np.testing.assert_array_equal(to.peaks.numpy(), np.asarray(jo.analysis.peaks), err_msg=f"hop {h}")
        for k in ANALYSIS_LEAVES:
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), atol=1e-5, err_msg=k)


def test_step_multi_equals_steps_and_reset_matches_jax():
    sig = _audio()
    k = 4
    chunks = np.stack([sig[:, h * HOP : (h + 1) * HOP] for h in range(2 * k)])
    a = StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", device="cpu")
    b = StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", device="cpu")
    j = JaxPipeline(B, SMALL_PARAMS, path="pallas")
    multi = a.step_multi(chunks[:k], DT)
    singles = [b.step(c, DT) for c in chunks[:k]]
    for h in range(k):
        assert torch.equal(multi.x_vqt[h], singles[h].x_vqt)
        assert torch.equal(multi.analysis.peaks[h], singles[h].analysis.peaks)
    assert torch.equal(a.state.ring.buffer, b.state.ring.buffer)
    j.step_multi(chunks[:k], DT)

    before = a.state.ring.buffer.clone()
    a.reset_stream(1)
    j.reset_stream(1)
    assert float(a.state.ring.buffer[1].abs().max()) == 0.0 and float(a.state.ring.gain[1]) == 1.0
    assert torch.equal(a.state.ring.buffer[0], before[0])
    assert float(a.state.analysis.x_vqt_smoothed[1].abs().max()) == 0.0
    for c in chunks[k:]:
        to = a.step(c, DT)
        jo = j.step(c, DT)
    np.testing.assert_allclose(to.gain.numpy(), np.asarray(jo.gain), rtol=1e-6)
    np.testing.assert_allclose(to.x_vqt.numpy(), np.asarray(jo.x_vqt), atol=1e-3)


def test_state_round_trip_resumes_like_jax():
    """A mid-stream JAX state carried across (convert.py) and back is
    unchanged, and both packages continue from it alike."""
    sig = _audio()
    jp = JaxPipeline(B, SMALL_PARAMS, path="pallas")
    for h in range(6):
        jp.step(sig[:, h * HOP : (h + 1) * HOP], DT)
    snap = _jax_state(jp)
    tp = StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", device="cpu")
    tp.state = pipeline_state_from_numpy(snap, device="cpu")
    for k, v in pipeline_state_to_numpy(tp.state).items():
        np.testing.assert_array_equal(v, snap[k], err_msg=k)
    for h in range(6, 10):
        chunk = sig[:, h * HOP : (h + 1) * HOP]
        jo = jp.step(chunk, DT)
        to = tp.step(chunk, DT)
    np.testing.assert_allclose(to.gain.numpy(), np.asarray(jo.gain), rtol=1e-6)
    np.testing.assert_allclose(to.x_vqt.numpy(), np.asarray(jo.x_vqt), atol=1e-3)
    np.testing.assert_array_equal(to.analysis.peaks.numpy(), np.asarray(jo.analysis.peaks))


def test_rebuild_keeps_audio():
    tp = StreamingPipeline(2, to_port(SMALL_PARAMS), path="pallas", device="cpu")
    tp.step(streams(2, HOP, SMALL_PARAMS.sr, seed=3), DT)
    ring = tp.state.ring.buffer.clone()
    new = dataclasses.replace(to_port(SMALL_PARAMS), quality=SMALL_PARAMS.quality * 1.1)
    tp.rebuild(new)
    assert torch.equal(tp.state.ring.buffer, ring)
    assert tp.vqt_params == new
    with pytest.raises(ValueError):
        tp.rebuild(dataclasses.replace(new, sr=44100.0))


def test_streaming_golden_replay():
    """tests/golden/streaming_golden.npz through the port alone at default
    parameters: spectra atol 1e-3 dB, gains rtol 1e-4 (tests/test_golden.py's
    tolerances for the JAX package)."""
    params = default_params()
    with np.load(GOLDEN) as z:
        sig, hop, want_spectra, want_gains = z["signal"], int(z["hop"]), z["spectra"], z["gains"]
    pipe = StreamingPipeline(1, to_port(params), path="pallas", device="cpu")
    spectra, gains = [], []
    for i in range(len(sig) // hop):
        out = pipe.step(sig[None, i * hop : (i + 1) * hop], hop / params.sr)
        spectra.append(out.x_vqt[0].numpy())
        gains.append(float(out.gain[0]))
    np.testing.assert_allclose(np.stack(spectra), want_spectra, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gains), want_gains, rtol=1e-4)


def _small_kernel():
    return get_kernel(to_port(SMALL_PARAMS))


def _state_arrays():
    state = init_pipeline_state(1, to_port(SMALL_PARAMS), device="cpu")
    return pipeline_state_to_numpy(state)


# every exported constructor that places tensors: called with its default
# device, and with device="cpu"
CONSTRUCTORS = {
    "init_pipeline_state": lambda **kw: init_pipeline_state(2, to_port(SMALL_PARAMS), **kw),
    "init_state_batch": lambda **kw: init_state_batch(2, SMALL_PARAMS.n_buckets, **kw),
    "RingState.init": lambda **kw: RingState.init(2, 64, **kw),
    "VqtArrays.from_kernel": lambda **kw: VqtArrays.from_kernel(_small_kernel(), **kw),
    "PallasVqtArrays.from_kernel": lambda **kw: PallasVqtArrays.from_kernel(_small_kernel(), **kw),
    "convert.tensor_from_numpy": lambda **kw: convert.tensor_from_numpy(np.zeros(3, np.float32), **kw),
    "convert.vqt_arrays_from_numpy": lambda **kw: convert.vqt_arrays_from_numpy(
        [np.zeros((4, 2), np.float32)], [(0, 4)], [1], 4, 1, **kw),
    "convert.pallas_vqt_arrays_from_numpy": lambda **kw: convert.pallas_vqt_arrays_from_numpy(
        [np.zeros((4, 256), np.float32)], [0], [4], [1], [128], 4, 4, 1, **kw),
    "convert.pipeline_state_from_numpy": lambda **kw: pipeline_state_from_numpy(_state_arrays(), **kw),
    "init_pipeline_state(with_viewer=True)": lambda **kw: init_pipeline_state(
        2, to_port(SMALL_PARAMS), with_viewer=True, **kw),
    "BallState.init": lambda **kw: BallState.init(2, 8, **kw),
    "CalmnessGraphState.init": lambda **kw: CalmnessGraphState.init(2, 5, **kw),
    "SpectrogramState.init": lambda **kw: SpectrogramState.init(2, 3, 8, **kw),
    "convert.ball_state_from_numpy": lambda **kw: convert.ball_state_from_numpy(
        convert.ball_state_to_numpy(BallState.init(2, 8, device="cpu")), **kw),
    "init_pipeline_state(ml_t_window=3)": lambda **kw: init_pipeline_state(
        2, to_port(SMALL_PARAMS), ml_t_window=3, **kw),
    "MlState.init": lambda **kw: MlState.init(3, 8, **kw),
    "init_ml_state_batch": lambda **kw: init_ml_state_batch(2, 3, 8, **kw),
    "PitchMLP": lambda **kw: list(PitchMLP(input_bins=40, mlp_size=8, mlp_layers=1, **kw).parameters()),
    "train.make_model": lambda **kw: list(make_model(TrainConfig(n_buckets=8, mlp_size=8), **kw).parameters()),
    "convert.pitch_mlp_params_from_numpy": lambda **kw: list(convert.pitch_mlp_params_from_numpy(
        convert.pitch_mlp_params_to_numpy(
            PitchMLP(input_bins=40, mlp_size=8, mlp_layers=1, device="cpu").state_dict()), **kw).values()),
}


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [leaf for item in obj for leaf in _leaves(item)]
    if dataclasses.is_dataclass(obj):
        return [leaf for f in dataclasses.fields(obj) for leaf in _leaves(getattr(obj, f.name))]
    return []


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_the_card(name):
    """Entry points run on the card unless asked for the CPU: on a host
    without CUDA the default device raises instead of placing the tensors on
    the CPU unasked; with device="cpu" every tensor lies there. (On a host
    with a card the default places them on it.)"""
    make = CONSTRUCTORS[name]
    if torch.cuda.is_available():
        assert all(leaf.device.type == "cuda" for leaf in _leaves(make()))
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    leaves = _leaves(make(device="cpu"))
    assert leaves and all(leaf.device.type == "cpu" for leaf in leaves)


DT_FORMS = {
    "float": lambda: DT,
    "numpy_scalar": lambda: np.float32(DT),
    "numpy_array": lambda: np.array([DT, 0.5 * DT, 2.0 * DT], np.float32),
    "list": lambda: [DT, 0.5 * DT, 2.0 * DT],
    "tensor": lambda: torch.tensor([DT, 0.5 * DT, 2.0 * DT]),
}


@pytest.mark.parametrize("form", sorted(DT_FORMS))
def test_dt_forms_match_jax(form):
    """dt as a float, a NumPy scalar, a per-stream NumPy array, a list and a
    tensor: the port's step broadcasts each as the JAX package's does
    (jnp.broadcast_to), within test_hop_matches_jax's tolerances."""
    sig = _audio()
    jp = JaxPipeline(B, SMALL_PARAMS, path="pallas")
    tp = StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", device="cpu")
    for h in range(4):
        chunk = sig[:, h * HOP : (h + 1) * HOP]
        dt = DT_FORMS[form]()
        jo = jp.step(chunk, dt.numpy() if isinstance(dt, torch.Tensor) else dt)
        to = tp.step(chunk, dt)
    np.testing.assert_array_equal(to.analysis.peaks.numpy(), np.asarray(jo.analysis.peaks))
    for k in ANALYSIS_LEAVES:
        np.testing.assert_allclose(getattr(tp.state.analysis, k).numpy(), np.asarray(getattr(jp.state.analysis, k)),
                                   atol=1e-3, err_msg=k)


def test_step_multi_zero_hops_matches_jax():
    """Zero hops: outputs with a leading axis of 0 and the shapes and types
    of one hop's, as the JAX lax.scan returns them; the state as it was."""
    sig = _audio()
    jp = JaxPipeline(B, SMALL_PARAMS, path="pallas")
    tp = StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", device="cpu")
    jp.step(sig[:, :HOP], DT)
    tp.step(sig[:, :HOP], DT)
    before = pipeline_state_to_numpy(tp.state)
    jax_before = _jax_state(jp)
    none = np.zeros((0, B, HOP), np.float32)
    jo = jp.step_multi(none, DT)
    to = tp.step_multi(none, DT)
    pairs = [(to.x_vqt, jo.x_vqt), (to.gain, jo.gain)] + [
        (getattr(to.analysis, f.name), getattr(jo.analysis, f.name)) for f in dataclasses.fields(to.analysis)]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(np.asarray(want).shape)
        assert got.numpy().dtype == np.asarray(want).dtype
    assert to.x_vqt.shape == (0, B, SMALL_PARAMS.n_buckets)
    for k, v in pipeline_state_to_numpy(tp.state).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    for k, v in _jax_state(jp).items():
        np.testing.assert_array_equal(v, jax_before[k], err_msg=k)


@pytest.mark.parametrize("scene", [0.0, 0.25, 0.731], ids=["silent_scene", "quarter", "calm"])
def test_smoothing_horizons_equal_jax(scene):
    """The smoothing horizons are floors of products that are whole numbers
    of ms at some bins (bin 420 at scene calmness 0 and default parameters):
    their bits decide the floor, so the port's equal the JAX package's bit
    for bit. On the card the quotients behind them are divided exactly
    (utils/rounding.py::exact_div); chip_smoke.py holds a card server
    against a CPU server on the same audio."""
    from pitchvis_tpu.models.analysis import _smoothing_horizons as jax_horizons
    from pitchvis_tpu_torch.models.analysis import _smoothing_horizons

    params = default_params()
    ap = AnalysisParameters()
    want = np.asarray(jax_horizons(ap, params.range, jnp.float32(scene)))
    got = _smoothing_horizons(to_port(ap), to_port(params.range), torch.full((1,), scene))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_per_frame_analysis_step_matches_jax():
    """The per-frame models/analysis.py::analysis_step (exported from the
    package as in the JAX package) on one stream of the JAX package's dB
    spectra, its state carried for 10 frames: the same peaks, state leaves
    within atol 1e-5 as the batched step is held; and it equals row 0 of
    the port's batched step."""
    from pitchvis_tpu.models.analysis import AnalysisState as JState
    from pitchvis_tpu.models.analysis import analysis_step as jax_analysis_step
    from pitchvis_tpu_torch import analysis_step
    from pitchvis_tpu_torch.models.analysis import AnalysisState

    sig = _audio()
    ap, rng_cfg = AnalysisParameters(), SMALL_PARAMS.range
    jp = JaxPipeline(B, SMALL_PARAMS, path="pallas")
    n = SMALL_PARAMS.n_buckets
    js, ts, tb = JState.init(n), AnalysisState.init(n, device="cpu"), init_state_batch(1, n, device="cpu")
    assert ts.x_vqt_smoothed.shape == (n,) and ts.scene_calmness.shape == ()
    for h in range(10):
        x = np.array(jp.step(sig[:, h * HOP : (h + 1) * HOP], DT).x_vqt)[0]
        js, jo = jax_analysis_step(ap, rng_cfg, js, jnp.asarray(x), DT)
        ts, to = analysis_step(to_port(ap), to_port(rng_cfg), ts, torch.from_numpy(x), DT)
        tb, tob = analysis_step_batch(to_port(ap), to_port(rng_cfg), tb, torch.from_numpy(x[None]), DT)
        np.testing.assert_array_equal(to.peaks.numpy(), np.asarray(jo.peaks), err_msg=f"frame {h}")
        for k in ANALYSIS_LEAVES:
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), atol=1e-5, err_msg=k)
            torch.testing.assert_close(getattr(ts, k), getattr(tb, k)[0], rtol=0, atol=0)
        torch.testing.assert_close(to.peak_size, tob.peak_size[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match=f"x_vqt must be \\({n},\\)"):
        analysis_step(to_port(ap), to_port(rng_cfg), ts, torch.zeros(1, n), DT)


def test_ema_update_with_alpha_matches_jax():
    from pitchvis_tpu.utils.ema import ema_update_with_alpha as jax_ema
    from pitchvis_tpu_torch.utils.ema import ema_update_with_alpha

    r = np.random.default_rng(4)
    y, x = (r.standard_normal((3, 40)).astype(np.float32) for _ in range(2))
    for alpha in (0.0, 0.37, 1.0, r.uniform(0, 1, 40).astype(np.float32)):
        got = ema_update_with_alpha(torch.from_numpy(y), torch.from_numpy(x),
                                    torch.from_numpy(alpha) if isinstance(alpha, np.ndarray) else alpha)
        want = np.asarray(jax_ema(jnp.asarray(y), jnp.asarray(x), alpha))
        np.testing.assert_array_equal(got.numpy(), want)
