"""The port's ``freq`` VQT path (batched rFFT + one product per window
group, ops/vqt.py) against the JAX package's ``freq`` path, the float64
oracle and the committed goldens, and ``Vqt(precision=)``, on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pitchvis_tpu.io.golden import GOLDEN_PARAMS, load
from pitchvis_tpu.kernel.builder import get_kernel as jax_get_kernel
from pitchvis_tpu.models.pipeline import StreamingPipeline as JPipeline
from pitchvis_tpu.ops.vqt import Vqt as JVqt
from pitchvis_tpu.ops.vqt import VqtArrays as JVqtArrays
from pitchvis_tpu.ops.vqt_ref import vqt_frame_db_np
from pitchvis_tpu_torch import StreamServer, StreamingPipeline, convert
from pitchvis_tpu_torch.kernel.builder import get_kernel
from pitchvis_tpu_torch.ops import vqt as tvqt

from conftest import SMALL_PARAMS
from torch_port_helpers import default_params, streams, to_port

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GEOMETRIES = {"small": SMALL_PARAMS, "default": default_params()}


def _frames(params, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(params.n_fft) / params.sr
    f = 110.0 * 2.0 ** rng.uniform(0.0, 3.5, (n, 1))
    x = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal((n, params.n_fft))
    return x.astype(np.float32)


@pytest.mark.parametrize("geometry", ["small", "default"])
@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
def test_power_and_db_match_jax_freq(geometry, fast):
    """The same frames through both ``freq`` paths: power within the
    tolerances tests/test_torch_vqt.py states for the fused path (f32: rtol
    1e-5; bf16, both sides rounding the packed spectrum and the weights to
    bf16: rtol 1e-3; each plus 1e-6 of the frame's peak power), dB within
    2e-3 as the dense path is held to the JAX package's there."""
    params = GEOMETRIES[geometry]
    x = _frames(params, 4, 0)
    j = JVqt(params, path="freq", fast=fast)
    t = tvqt.Vqt(to_port(params), path="freq", fast=fast, device="cpu")
    assert t.precision == ("default" if fast else "highest")
    want = np.asarray(j.calculate_vqt_batch_power(jnp.asarray(x)))
    got = t.calculate_vqt_batch_power(x).numpy()
    scale = want.max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= (1e-3 if fast else 1e-5) * np.abs(want) + 1e-6 * scale)
    np.testing.assert_allclose(
        t.calculate_vqt_batch_in_db(x).numpy(), np.asarray(j.calculate_vqt_batch_in_db(jnp.asarray(x))), atol=2e-3
    )


@pytest.mark.parametrize("geometry", ["small", "default"])
def test_f32_db_within_3e4_of_oracle(geometry):
    """The f32 ``freq`` path within 3e-4 dB of the float64 oracle, the JAX
    package's contract for its f32 paths."""
    params = GEOMETRIES[geometry]
    jk = jax_get_kernel(params)
    x = _frames(params, 4, 3)
    want = np.stack([vqt_frame_db_np(jk, xi) for xi in x])
    got = tvqt.Vqt(to_port(params), path="freq", device="cpu").calculate_vqt_batch_in_db(x).numpy()
    assert np.abs(got - want).max() <= 3e-4


def test_reduced_goldens():
    """tests/golden/vqt_golden.npz through the ``freq`` path, <5e-4 dB as
    the other paths are held."""
    g = load(os.path.join(GOLDEN_DIR, "vqt_golden.npz"))
    names = sorted(g)
    x = np.stack([g[n][0] for n in names])
    want = np.stack([g[n][1] for n in names])
    got = tvqt.Vqt(to_port(GOLDEN_PARAMS), path="freq", device="cpu").calculate_vqt_batch_in_db(x)
    assert np.abs(got.numpy() - want).max() < 5e-4


def test_arrays_upload_only_the_paths_weights():
    """VqtArrays.from_kernel(path=) as in the JAX package: one weight set for
    a fixed path, both for None; the weights are the JAX package's bit for
    bit, and a set that was not uploaded is refused."""
    kernel = get_kernel(to_port(SMALL_PARAMS))
    ja = JVqtArrays.from_kernel(jax_get_kernel(SMALL_PARAMS), path="freq")
    ta = tvqt.make_vqt_arrays(kernel, path="freq", device="cpu")
    assert ta.w_time == () and len(ta.w_freq) == len(ja.w_freq) == len(ta.windows)
    for tw, jw in zip(ta.w_freq, ja.w_freq):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    both = tvqt.VqtArrays.from_kernel(kernel, device="cpu")
    assert len(both.w_time) == len(both.w_freq) == len(both.windows)
    x = torch.from_numpy(_frames(SMALL_PARAMS, 2, 5))
    torch.testing.assert_close(
        tvqt.vqt_power_batch(both, x, path="freq"), tvqt.vqt_power_batch(ta, x, path="freq"), rtol=0, atol=0
    )
    with pytest.raises(ValueError, match="no weights for path 'time'"):
        tvqt.vqt_power_batch(ta, x, path="time")
    with pytest.raises(ValueError, match="unknown VQT path"):
        tvqt.vqt_power_batch(both, x, path="nope")
    with pytest.raises(ValueError, match="unknown VQT path"):
        tvqt.make_vqt_arrays(kernel, path="nope", device="cpu")
    # the checkpoint converter carries both sets
    conv = convert.vqt_arrays_from_numpy(
        [np.asarray(w) for w in JVqtArrays.from_kernel(jax_get_kernel(SMALL_PARAMS)).w_time], ta.windows,
        ta.n_filters, ta.n_fft, ta.n_buckets, device="cpu", w_freq=[np.asarray(w) for w in ja.w_freq],
    )
    torch.testing.assert_close(tvqt.vqt_db_auto(conv, x, path="freq"), tvqt.vqt_db_auto(ta, x, path="freq"))


def test_precision_argument():
    """None, "highest" and "default" (any case) on the dense paths; any
    precision on ``path="pallas"`` raises, as the JAX package's Vqt does."""
    params = to_port(SMALL_PARAMS)
    x = _frames(SMALL_PARAMS, 2, 6)
    base = tvqt.Vqt(params, path="freq", device="cpu").calculate_vqt_batch_in_db(x)
    for p in ("highest", "HIGHEST", "default"):
        v = tvqt.Vqt(params, path="freq", precision=p, device="cpu")
        assert v.precision == p.lower()
        torch.testing.assert_close(v.calculate_vqt_batch_in_db(x), base, rtol=0, atol=0)
    assert tvqt.Vqt(params, path="time", fast=True, device="cpu").precision == "default"
    with pytest.raises(ValueError, match="pallas"):
        tvqt.Vqt(params, path="pallas", precision="highest", device="cpu")
    with pytest.raises(ValueError, match="pallas"):
        tvqt.Vqt(params, path="pallas", fast=True, precision="default", device="cpu")
    with pytest.raises(ValueError, match="precision must be"):
        tvqt.Vqt(params, path="freq", precision="fastest", device="cpu")
    assert tvqt.Vqt(params, path="pallas", device="cpu").precision == "highest"


def test_pipeline_and_server_serve_the_freq_path():
    """StreamingPipeline(path="freq") hop by hop against the JAX package's
    (spectra within 2e-3 dB, peaks equal), and a StreamServer on the
    ``freq`` path against the port's pipeline on the ``time`` path."""
    params = SMALL_PARAMS
    hop = 367
    audio = streams(2, 6 * hop, params.sr, seed=11)
    j = JPipeline(2, params, path="freq")
    t = StreamingPipeline(2, to_port(params), path="freq", device="cpu")
    for h in range(6):
        chunk = audio[:, h * hop : (h + 1) * hop]
        jo = j.step(chunk, hop / params.sr)
        to = t.step(chunk, hop / params.sr)
        np.testing.assert_allclose(to.x_vqt.numpy(), np.asarray(jo.x_vqt), atol=2e-3)
        np.testing.assert_array_equal(to.analysis.peaks.numpy(), np.asarray(jo.analysis.peaks))
    srv = StreamServer(2, to_port(params), buffer_seconds=1.0, path="freq", ingest="snapshot", device="cpu")
    try:
        srv.push_batch(audio[:, : 4 * hop])
        out, _ = srv.step(dt=hop / params.sr)
        assert out.x_vqt_smoothed.shape == (2, params.n_buckets)
        assert torch.isfinite(out.x_vqt_smoothed).all()
        assert srv.arrays.w_time == () and len(srv.arrays.w_freq) == len(srv.arrays.windows)
    finally:
        srv.close()
