"""The port's polyphase resampler (ops/resample.py) against the JAX
package's on the same seeded [-1, 1] signals, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pitchvis_tpu.ops.resample as jrs
import pitchvis_tpu_torch.ops.resample as trs

RATES = [(44100, 22050), (48000, 22050), (16000, 22050)]


def _signal(n_streams: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n_streams, n)).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_process_matches_jax(sr_in, sr_out):
    """One chunk of three streams, with a seeded history: the same taps and
    gather indices, the 24 products summed in another order (XLA's einsum
    against a float32 sum over the taps): within 1e-6 absolute."""
    m = trs.make_spec(sr_in, sr_out).m
    chunk_in = m * max(1, 4410 // m)
    t = trs.PolyphaseResampler(sr_in, sr_out, chunk_in, device="cpu")
    j = jrs.PolyphaseResampler(sr_in, sr_out, chunk_in)
    assert (t.chunk_out, t.delay_secs) == (j.chunk_out, j.delay_secs)
    np.testing.assert_array_equal(t._taps.numpy(), np.asarray(j._taps))
    np.testing.assert_array_equal(t._idx.numpy(), np.asarray(j._idx))
    hist = _signal(3, t.spec.history_len, 1)
    x = _signal(3, chunk_in, 2)
    th, ty = t.process(torch.from_numpy(hist), torch.from_numpy(x))
    jh, jy = j.process(jnp.asarray(hist), jnp.asarray(x))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert ty.shape == (3, t.chunk_out) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_streaming_in_chunks_equals_one_shot(sr_in, sr_out):
    """Ten chunks carried through the history equal one call over the whole
    signal (the same products and sums for every output sample)."""
    m = trs.make_spec(sr_in, sr_out).m
    chunk_in = 4 * m
    x = torch.from_numpy(_signal(2, 10 * chunk_in, 3))
    whole = trs.PolyphaseResampler(sr_in, sr_out, 10 * chunk_in, device="cpu")
    _, want = whole.process(whole.init_state(2), x)
    rs = trs.PolyphaseResampler(sr_in, sr_out, chunk_in, device="cpu")
    hist, outs = rs.init_state(2), []
    for c in range(10):
        hist, y = rs.process(hist, x[:, c * chunk_in : (c + 1) * chunk_in])
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), want, rtol=0, atol=0)


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_resample_matches_jax(sr_in, sr_out):
    """Host audio in, host audio out, trimmed to a multiple of M, within
    1e-6 absolute of the JAX package's."""
    x = _signal(2, sr_in // 3 + 17, 4)
    got = trs.resample(x, sr_in, sr_out, device="cpu")
    want = np.asarray(jrs.resample(x, sr_in, sr_out))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    mono = trs.resample(x[0], sr_in, sr_out, device="cpu")
    np.testing.assert_array_equal(mono[0], got[0])


def test_chunk_not_multiple_of_m_raises():
    with pytest.raises(ValueError, match="multiple of 320"):
        trs.PolyphaseResampler(48000, 22050, 1000, device="cpu")
    rs = trs.PolyphaseResampler(44100, 22050, 2, device="cpu")
    with pytest.raises(ValueError, match="takes 2"):
        rs.process(rs.init_state(1), torch.zeros(1, 4))


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_fft_chunk_resampler_equals_jax(sr_in, sr_out):
    """The NumPy oracle, the same code in both packages: bit for bit,
    streaming and offline."""
    x = _signal(1, 3 * sr_in // 4, 5)[0]
    t, j = trs.FftChunkResampler(sr_in, sr_out), jrs.FftChunkResampler(sr_in, sr_out)
    np.testing.assert_array_equal(t.resample(x), j.resample(x))
    for part in np.array_split(x, 7):
        np.testing.assert_array_equal(t.process(part), j.process(part))


@pytest.mark.parametrize("sr_in", [44100, 48000])
def test_polyphase_agrees_with_its_oracle(sr_in):
    """The port's polyphase resampler against its FFT oracle on a two-tone
    signal, with the polyphase's group delay removed by an exact fractional
    shift: above 70 dB SNR, tests/test_stream.py's bound for the JAX
    package's pair."""
    sr_out = 22050
    t = np.arange(sr_in) / sr_in
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.25 * np.sin(2 * np.pi * 1320.0 * t)).astype(np.float32)
    y = trs.FftChunkResampler(sr_in, sr_out).resample(x)
    yp = trs.resample(x, sr_in, sr_out, device="cpu")[0]
    n = min(len(y), len(yp))
    spec = trs.make_spec(sr_in, sr_out)
    delay = (spec.taps_per_phase * spec.l - 1) / 2.0 / (spec.l * sr_in) * sr_out
    f = np.fft.rfftfreq(n)
    ypa = np.fft.irfft(np.fft.rfft(yp[:n].astype(np.float64)) * np.exp(2j * np.pi * f * delay), n)
    sl = slice(2000, n - 2000)
    snr = 10 * np.log10(np.mean(y[sl] ** 2) / np.mean((ypa[sl] - y[sl]) ** 2))
    assert snr > 70.0, snr
