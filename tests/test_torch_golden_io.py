"""The port's golden-file tooling (io/golden.py) against the JAX package's:
the signal generators bit for bit, the frame-golden loader on every
committed golden, the chain replay at the chain budget, and the writers,
which write where they are told (a temporary directory here)."""

import glob
import os

import numpy as np
import pytest

import pitchvis_tpu.io.golden as jgolden
import pitchvis_tpu_torch.io.golden as tgolden
from pitchvis_tpu.core.config import SERIAL_VQT_PARAMETERS, VqtParameters

from conftest import SMALL_PARAMS
from torch_port_helpers import to_port

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _equal_dicts(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("params", [SMALL_PARAMS, VqtParameters()], ids=["small", "default"])
def test_golden_and_streaming_signals_equal(params):
    _equal_dicts(tgolden.golden_signals(to_port(params)), jgolden.golden_signals(params))
    for seconds in (1.5, 0.2):
        np.testing.assert_array_equal(
            tgolden.streaming_signal(to_port(params), seconds), jgolden.streaming_signal(params, seconds)
        )


def test_chain_signals_equal():
    """Arpeggio, chirp, chord and the f64 synth clip (the port's copy of the
    SoundFont engine), 2 s at the serial parameters and 1.5 s at 44100 Hz."""
    _equal_dicts(tgolden.chain_signals(to_port(SERIAL_VQT_PARAMETERS), 2.0),
                 jgolden.chain_signals(SERIAL_VQT_PARAMETERS, 2.0))
    p44 = VqtParameters(sr=44100.0)
    want = jgolden.chain_signals(p44, 1.5)
    _equal_dicts(tgolden.chain_signals(to_port(p44), 1.5), want)
    del want["synth"]
    _equal_dicts(tgolden.chain_signals(to_port(p44), 1.5, with_synth=False), want)


def test_load_every_committed_golden():
    """Frame goldens load to the same pairs; the goldens of other layouts
    raise ValueError in both packages."""
    paths = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.npz")))
    assert len(paths) >= 6
    frame = 0
    for path in paths:
        try:
            want = jgolden.load(path)
        except ValueError:
            with pytest.raises(ValueError, match="no in_/out_ frame pairs"):
                tgolden.load(path)
            continue
        got = tgolden.load(path)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k][0], want[k][0])
            np.testing.assert_array_equal(got[k][1], want[k][1])
        frame += 1
    assert frame == 2  # vqt_golden.npz and vqt_golden_default.npz


def test_frame_generator_reproduces_committed_golden(tmp_path):
    """generate() at the reduced parameters writes the committed
    vqt_golden.npz's pairs (the float64 oracle, the same code), into the
    directory it is given."""
    path = tgolden.generate(str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path)
    got, want = tgolden.load(path), jgolden.load(os.path.join(GOLDEN_DIR, "vqt_golden.npz"))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1], want[k][1])


def _check_chain(res, want, n):
    """tests/test_torch_outputs.py::_check_chain's budget: peak flips in at
    most 2e-4 of the bins, calmness within 0.02, scene calmness within
    5e-3, LED values within 4 where no peak flips, and the same framing."""
    flips = res["peaks"] != want["peaks"]
    assert flips.mean() <= 2e-4, flips.mean()
    np.testing.assert_allclose(res["calmness"], want["calmness"], atol=0.02)
    np.testing.assert_allclose(res["scene_calmness"], want["scene_calmness"], atol=5e-3)
    led_diff = np.abs(res["led"].astype(np.int32) - want["led"].astype(np.int32))
    assert led_diff[~flips].max() <= 4
    assert res["stream"].shape == want["stream"].shape and int(res["hop"]) == int(want["hop"])
    frames = res["stream"].reshape(-1, 3 + 3 * n)
    assert (frames[:, 0] == 0xFF).all() and (frames[:, 3:] <= 0xFE).all()


@pytest.mark.parametrize("path", ["time", "pallas"])
def test_run_chain_matches_jax(path):
    """One second of the chain's arpeggio through run_chain in both
    packages (the port's on the CPU), in blocks of 25 hops."""
    params = SERIAL_VQT_PARAMETERS
    sig = jgolden.chain_signals(params, 1.0)["arpeggio"]
    want = jgolden.run_chain(params, sig, path=path, block=25)
    got = tgolden.run_chain(to_port(params), sig, path=path, block=25, device="cpu")
    assert sorted(got) == sorted(want) and got["peaks"].shape == (60, params.n_buckets)
    _check_chain(got, want, params.n_buckets)
    np.testing.assert_allclose(got["x_vqt"], want["x_vqt"], atol=2e-3)


def test_run_chain_with_viewer_records_the_viewer_keys():
    params = to_port(SERIAL_VQT_PARAMETERS)
    sig = tgolden.streaming_signal(params, 0.25)
    res = tgolden.run_chain(params, sig, with_viewer=True, block=4, device="cpu")
    n_hops = len(sig) // int(params.sr / 60.0)
    assert set(tgolden.VIEWER_KEYS) <= set(res)
    assert all(res[k].shape[0] == n_hops for k in tgolden.CHAIN_KEYS + tgolden.VIEWER_KEYS)


def test_streaming_writer_writes_where_told(tmp_path):
    """generate_streaming into a temporary directory, 0.3 s: the layout of
    tests/golden/streaming_golden.npz, spectra within the 1e-3 dB the port's
    replay of that golden is held to."""
    path = tgolden.generate_streaming(str(tmp_path), seconds=0.3, device="cpu")
    assert os.path.dirname(path) == str(tmp_path)
    with np.load(path) as got, np.load(os.path.join(GOLDEN_DIR, "streaming_golden.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        n = got["spectra"].shape[0]
        assert int(got["hop"]) == int(want["hop"]) and n == len(got["signal"]) // int(got["hop"])
        np.testing.assert_allclose(got["spectra"], want["spectra"][:n], atol=1e-3)
