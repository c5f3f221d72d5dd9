"""The viewer stage in one call (pitchvis_tpu_torch/ops/viewer_stage.py):
on the CPU, its checks, its outputs' sharing of the carry and its launch
counter; on the card (marked ``card``, skipped without one), the kernel
``csrc/viewer.cu`` against the plain version, ``viewer_stage_plain``, over
128 hops with a carried state.

On the card every leaf must be torch.equal but the chroma vector: the
kernel adds each pitch class's bins in the order of its class table, and
PyTorch's reduction in an order of its own, so each normalized class sum
may differ by the rounding of a sum of up to 49 float32 terms and of the
maximum it is divided by: within rtol CHROMA_RTOL (49 * 2**-24 = 2.9e-6 on
each, with room).

Nothing here imports JAX, so on a machine with a card the file runs alone:
``python3 -m pytest --noconftest -m card tests/test_torch_viewer_stage.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from pitchvis_tpu_torch.core.config import VqtParameters, VqtRange
from pitchvis_tpu_torch.models.analysis import AnalysisOutputs
from pitchvis_tpu_torch.models.viewer import BallState
from pitchvis_tpu_torch.ops import viewer_stage as vs

CHROMA_RTOL = 1e-5
GEOMETRIES = {
    "viewer_588": VqtParameters().range,  # 7 octaves x 84
    "serial_180": VqtRange(min_freq=55.0, octaves=5, buckets_per_octave=36),
    "coarse_96": VqtRange(min_freq=110.0, octaves=4, buckets_per_octave=24),
}


def hop_inputs(rng_cfg: VqtRange, b: int, hop: int, seed: int, device="cpu") -> tuple[AnalysisOutputs, object]:
    """One hop of analysis outputs for ``b`` streams and its frame time,
    seeded: peaks at least two bins apart with centers within one bin
    of them (exact half-bin offsets among them), sizes and the smoothed
    spectrum in dB. Row 0 has no peak and a silent spectrum; row 1 peaks at
    bins 0 and n - 1; row 2 pairs of peaks two bins apart whose centers key
    the bin between them; row 3 a negative spectrum (below 4 streams, the
    last ``b`` of these rows). The frame time is a float, a (B,) tensor or a
    0-d tensor, by hop."""
    n = rng_cfg.n_buckets
    r = np.random.default_rng([seed, hop])
    kept = b
    b = max(b, 4)
    peaks = np.zeros((b, n), bool)
    offset = r.uniform(-1.0, 1.0, (b, n))
    offset[r.random((b, n)) < 0.1] = 0.5
    for s in range(4, b):
        i = int(r.integers(0, 3))
        while i < n:
            if r.random() < 0.12 + 0.1 * (hop % 3):
                peaks[s, i] = True
                i += 2
            else:
                i += 1
    peaks[1, [0, n - 1]] = True
    for i in range(2, n - 3, 9):  # peaks i and i + 2 both keyed to bin i + 1
        peaks[2, [i, i + 2]] = True
        offset[2, i], offset[2, i + 2] = 1.0 + 0.5 * r.random(), -0.5 * r.random()
    center = np.where(peaks, np.clip(np.arange(n) + offset, 0.0, n - 1.0), 0.0).astype(np.float32)
    size = np.where(peaks, r.uniform(0.5, 30.0, (b, n)), 0.0).astype(np.float32)
    smoothed = r.uniform(0.0, 40.0, (b, n)).astype(np.float32)
    smoothed[0] = 0.0
    smoothed[3] = -smoothed[3]
    calmness = r.uniform(0.0, 1.0, (b, n)).astype(np.float32)
    calmness[:, ::7] = np.float32(0.3)
    calmness[:, 3::11] = np.float32(0.7)
    rows = {
        "x_vqt_smoothed": smoothed,
        "x_vqt_peakfiltered": np.where(peaks, smoothed, 0.0).astype(np.float32),
        "x_vqt_afterglow": smoothed,
        "peaks": peaks,
        "peak_center": center,
        "peak_size": size,
        "calmness": calmness,
        "pitch_accuracy": np.where(peaks, r.uniform(0.0, 1.0, (b, n)), 0.0).astype(np.float32),
        "pitch_deviation": np.where(peaks, r.uniform(-0.5, 0.5, (b, n)), 0.0).astype(np.float32),
        "scene_calmness": r.uniform(0.0, 1.0, b).astype(np.float32),
        "tuning_inaccuracy": r.uniform(0.0, 30.0, b).astype(np.float32),
    }
    outputs = AnalysisOutputs(**{k: torch.from_numpy(v[b - kept :]).to(device) for k, v in rows.items()})
    dt = 367 / 22050 * (1.0 + 0.25 * (hop % 4))
    if hop % 3 == 1:
        dt = torch.from_numpy(r.uniform(0.5, 2.0, kept).astype(np.float32) * np.float32(dt)).to(device)
    elif hop % 3 == 2:
        dt = torch.tensor(dt, dtype=torch.float32, device=device)
    return outputs, dt


def leaves(tree, prefix="") -> dict:
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for f in dataclasses.fields(tree):
        out.update(leaves(getattr(tree, f.name), f"{prefix}.{f.name}"))
    return out


def assert_same(got: dict, want: dict, what: str, chroma_rtol: float = 0.0) -> None:
    assert got.keys() == want.keys(), what
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {name} {g.dtype} {tuple(g.shape)}"
        if chroma_rtol and name == "viewer.chroma":
            assert torch.allclose(g, w, rtol=chroma_rtol, atol=0.0), \
                f"{what}: {name} off by {float(((g - w).abs() / w.abs().clamp_min(1e-30)).max()):.3e} (relative)"
        else:
            bad = int((g != w).sum())
            assert bad == 0, f"{what}: {name} differs in {bad} of {w.numel()} values"


def run_hops(rng_cfg, b, hops, device, stage, seed=11):
    """``hops`` hops of ``stage`` (``viewer_stage`` or
    ``viewer_stage_plain``) from a fresh carry: each hop's outputs and new
    carry as leaves."""
    state = BallState.init(b, rng_cfg.n_buckets, device=device)
    out = []
    for hop in range(hops):
        outputs, dt = hop_inputs(rng_cfg, b, hop, seed, device)
        state, view = stage(rng_cfg, state, outputs, dt)
        out.append({**leaves(view, "viewer"), **leaves(state, "state")})
    return out


# ---- the CPU --------------------------------------------------------------------


def test_outputs_share_the_carry_and_pass_the_shader_params_through():
    rng_cfg = GEOMETRIES["coarse_96"]
    outputs, dt = hop_inputs(rng_cfg, 5, 0, 3)
    state, view = vs.viewer_stage(rng_cfg, BallState.init(5, rng_cfg.n_buckets, device="cpu"), outputs, dt)
    assert view.balls.rgba is state.rgba and view.balls.scale is state.scale and view.balls.calmness is state.calm
    assert view.balls.pitch_accuracy is outputs.pitch_accuracy
    assert view.balls.pitch_deviation is outputs.pitch_deviation


def test_cpu_path_counts_no_launch():
    rng_cfg = GEOMETRIES["serial_180"]
    before = vs.launches
    run_hops(rng_cfg, 4, 2, "cpu", vs.viewer_stage)
    assert vs.launches == before


def _faulty(fault):
    """A hop's inputs with one fault, and the error it must raise."""
    rng_cfg = GEOMETRIES["coarse_96"]
    b, n = 5, rng_cfg.n_buckets
    outputs, dt = hop_inputs(rng_cfg, b, 0, 5)
    state = BallState.init(b, n, device="cpu")
    if fault == "peaks_dtype":
        outputs = dataclasses.replace(outputs, peaks=outputs.peaks.to(torch.uint8))
    elif fault == "row_dtype":
        outputs = dataclasses.replace(outputs, peak_size=outputs.peak_size.double())
    elif fault == "carry_dtype":
        state = dataclasses.replace(state, scale=state.scale.half())
    elif fault == "bins":
        outputs = dataclasses.replace(outputs, calmness=torch.zeros(b, n + 1))
    elif fault == "layout":
        rng_cfg = GEOMETRIES["serial_180"]
    elif fault == "rgba_shape":
        state = dataclasses.replace(state, rgba=torch.zeros(b, n, 3))
    elif fault == "streams":
        outputs = dataclasses.replace(outputs, scene_calmness=torch.zeros(b + 1))
    elif fault == "dt_shape":
        dt = torch.zeros(b + 1)
    elif fault == "non_contiguous_row":
        outputs = dataclasses.replace(outputs, x_vqt_smoothed=torch.zeros(n, b).t())
    elif fault == "non_contiguous_carry":
        state = dataclasses.replace(state, rgba=torch.zeros(b, 4, n).transpose(1, 2))
    elif fault == "device_mix":
        outputs = dataclasses.replace(outputs, peak_center=torch.empty(b, n, device="meta"))
    errors = {"peaks_dtype": TypeError, "row_dtype": TypeError, "carry_dtype": TypeError}
    return rng_cfg, state, outputs, dt, errors.get(fault, ValueError)


FAULTS = ("peaks_dtype", "row_dtype", "carry_dtype", "bins", "layout", "rgba_shape", "streams", "dt_shape",
          "non_contiguous_row", "non_contiguous_carry", "device_mix")


@pytest.mark.parametrize("fault", FAULTS)
def test_check_raises(fault):
    rng_cfg, state, outputs, dt, error = _faulty(fault)
    dt_b = dt if isinstance(dt, torch.Tensor) else torch.full((outputs.peaks.shape[0],), dt)
    with pytest.raises(error):
        vs._check(rng_cfg, state, outputs, dt_b)
    # a frame time of the wrong length fails to broadcast before the check
    with pytest.raises(RuntimeError if fault == "dt_shape" else error):
        vs.viewer_stage(rng_cfg, state, outputs, dt)


def test_check_takes_what_the_pipeline_hands_it():
    """A broadcast frame time and pitch rows that are views pass: the
    kernel reads the frame time by its stride and never reads the pitch
    rows."""
    rng_cfg = GEOMETRIES["coarse_96"]
    b, n = 5, rng_cfg.n_buckets
    outputs, _ = hop_inputs(rng_cfg, b, 0, 7)
    outputs = dataclasses.replace(outputs, pitch_accuracy=torch.zeros(n, b).t())
    vs._check(rng_cfg, BallState.init(b, n, device="cpu"), outputs, torch.tensor(0.01).expand(b))


# ---- the card ---------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the viewer kernel runs on it")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_kernel_equals_the_plain_version_on_the_card(card, geometry):
    """128 hops of 37 streams (no multiple of anything the kernel tiles
    by) with the carry of each path fed back to it."""
    rng_cfg = GEOMETRIES[geometry]
    before = vs.launches
    got = run_hops(rng_cfg, 37, 128, card, vs.viewer_stage)
    assert vs.launches == before + 128
    want = run_hops(rng_cfg, 37, 128, card, vs.viewer_stage_plain)
    for hop, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"{geometry}, hop {hop}", chroma_rtol=CHROMA_RTOL)


@pytest.mark.card
def test_kernel_takes_one_stream_and_none(card):
    rng_cfg = GEOMETRIES["viewer_588"]
    got = run_hops(rng_cfg, 1, 3, card, vs.viewer_stage)
    want = run_hops(rng_cfg, 1, 3, card, vs.viewer_stage_plain)
    for hop, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"B=1, hop {hop}", chroma_rtol=CHROMA_RTOL)
    before = vs.launches
    (view,) = run_hops(rng_cfg, 0, 1, card, vs.viewer_stage)
    assert vs.launches == before and view["viewer.balls.position"].shape == (0, rng_cfg.n_buckets, 3)
