"""The port's host I/O and control modules against the JAX package's on the
same seeded inputs: WAV loading (typed rejection included), the test-signal
helpers, settings persistence, live tuning, the capture drivers, the ALSA
binding against the port's own stub libasound, and the stage timer."""

import dataclasses
import io
import random
import time
import wave

import numpy as np
import pytest

import pitchvis_tpu.core.settings as jsettings
import pitchvis_tpu.io.capture as jcapture
import pitchvis_tpu.io.wav as jwav
import pitchvis_tpu.utils.profiling as jprof
import pitchvis_tpu.utils.signal as jsignal
import pitchvis_tpu_torch.core.settings as tsettings
import pitchvis_tpu_torch.io.capture as tcapture
import pitchvis_tpu_torch.io.wav as twav
import pitchvis_tpu_torch.utils.profiling as tprof
import pitchvis_tpu_torch.utils.signal as tsignal
from pitchvis_tpu.core.tuning import ParameterTuner as JTuner
from pitchvis_tpu.io.keytune import COMBOS as JCOMBOS
from pitchvis_tpu.io.keytune import KeyTuner as JKeyTuner
from pitchvis_tpu_torch.core.tuning import ParameterTuner as TTuner
from pitchvis_tpu_torch.io import alsa
from pitchvis_tpu_torch.io.keytune import COMBOS, KeyTuner as TKeyTuner
from pitchvis_tpu_torch.io.png import read_png, write_png

from conftest import SMALL_PARAMS
from torch_port_helpers import to_port


def _write_pcm(path, data: np.ndarray, width: int, channels: int, sr: int) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def _pcm(width: int, channels: int, n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    x = (0.6 * np.sin(2 * np.pi * r.uniform(100, 2000) * np.arange(n * channels) / 48000)).reshape(n, channels)
    x += 0.05 * r.standard_normal((n, channels))
    if width == 1:
        return np.clip(128 + 127 * x, 0, 255).astype(np.uint8)
    if width == 2:
        return np.clip(32767 * x, -32768, 32767).astype(np.int16)
    return np.clip(2147483647 * x, -2147483648, 2147483647).astype(np.int32)


class TestWav:
    @pytest.mark.parametrize("width", [1, 2, 4])
    @pytest.mark.parametrize("channels", [1, 2])
    def test_load_equals_jax(self, tmp_path, width, channels):
        path = str(tmp_path / "x.wav")
        _write_pcm(path, _pcm(width, channels, 4801, width * 10 + channels), width, channels, 48000)
        got, sr = twav.load_wav(path)
        want, jsr = jwav.load_wav(path)
        assert sr == jsr == 48000 and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)

    def test_fuzzed_files_parse_or_raise_like_jax(self, tmp_path):
        """tests/test_io.py's malformed-asset fuzz (truncation at every
        offset, 2000 random corruptions, the torn final frame): each file
        loads to the same samples in both packages or raises ValueError in
        both."""
        sr = 22050
        x = (0.3 * np.sin(2 * np.pi * 440.0 * np.arange(200) / sr)).astype(np.float32)
        path = str(tmp_path / "f.wav")
        twav.save_wav(path, x, sr)
        base = open(path, "rb").read()
        cpath = str(tmp_path / "c.wav")

        def outcome(load):
            try:
                y, s = load(cpath)
            except ValueError:
                return "ValueError"
            assert np.isfinite(y).all()
            return y, s

        def check(data: bytes):
            open(cpath, "wb").write(data)
            got, want = outcome(twav.load_wav), outcome(jwav.load_wav)
            if isinstance(want, str):
                assert got == want
            else:
                assert not isinstance(got, str) and got[1] == want[1]
                np.testing.assert_array_equal(got[0], want[0])

        for cut in range(len(base)):
            check(base[:cut])
        rng = random.Random(0)
        for _ in range(2000):
            data = bytearray(base)
            for _ in range(rng.randint(1, 6)):
                data[rng.randrange(len(data))] = rng.randrange(256)
            check(bytes(data))
        check(base[:-1])
        assert len(twav.load_wav(path)[0]) == len(x)

    def test_save_equals_jax(self, tmp_path):
        x = np.random.default_rng(3).uniform(-1.2, 1.2, 999).astype(np.float32)
        twav.save_wav(str(tmp_path / "t.wav"), x, 44100)
        jwav.save_wav(str(tmp_path / "j.wav"), x, 44100)
        assert open(tmp_path / "t.wav", "rb").read() == open(tmp_path / "j.wav", "rb").read()

    @pytest.mark.parametrize("n_fft,hop", [(256, 100), (64, 100), (8192, 367)])
    def test_frames_from_signal_equal(self, n_fft, hop):
        x = np.random.default_rng(n_fft).standard_normal(3001).astype(np.float32)
        np.testing.assert_array_equal(
            twav.frames_from_signal(x, n_fft, hop), jwav.frames_from_signal(x, n_fft, hop)
        )


def test_create_sines_equal():
    params = SMALL_PARAMS
    for freqs, t_diff in (([440.0], 0.0), ([110.0, 220.5, 1001.0], 0.013)):
        np.testing.assert_array_equal(
            tsignal.create_sines(to_port(params), freqs, t_diff), jsignal.create_sines(params, freqs, t_diff)
        )
    fl = [[110.0], [220.0, 330.0]]
    np.testing.assert_array_equal(
        tsignal.create_sines_batch(to_port(params), fl, 0.5), jsignal.create_sines_batch(params, fl, 0.5)
    )


class TestSettings:
    def test_to_json_equals_jax(self):
        def both(**kw):
            return (
                tsettings.SettingsState(**{k: getattr(tsettings, c)(v) if c else v for k, (c, v) in kw.items()}),
                jsettings.SettingsState(**{k: getattr(jsettings, c)(v) if c else v for k, (c, v) in kw.items()}),
            )

        for t, j in (both(), both(display_mode=("DisplayMode", "debugging"), fps_limit=(None, None),
                                  vqt_smoothing_mode=("VqtSmoothingMode", "long"), enable_bloom=(None, False),
                                  spectrogram_mode=("SpectrogramMode", "peaks"))):
            assert t.to_json() == j.to_json()
            assert tsettings.SettingsState.from_json(j.to_json()) == t

    def test_corrupt_file_reverts_like_jax(self, tmp_path):
        for mod, name in ((tsettings, "t.json"), (jsettings, "j.json")):
            path = str(tmp_path / name)
            open(path, "w").write("{not json")
            assert mod.load_settings(path) == mod.SettingsState()
        assert open(tmp_path / "t.json").read() == open(tmp_path / "j.json").read()

    @pytest.mark.parametrize("bad", ['"60"', "0", "-5", "1e9", "true"])
    def test_bad_fps_limit_reverts_like_jax(self, tmp_path, bad):
        good = tsettings.SettingsState().to_json()
        for mod, name in ((tsettings, "t.json"), (jsettings, "j.json")):
            path = str(tmp_path / name)
            open(path, "w").write(good.replace('"fps_limit": 60', f'"fps_limit": {bad}'))
            assert mod.load_settings(path) == mod.SettingsState()
        assert open(tmp_path / "t.json").read() == open(tmp_path / "j.json").read()

    def test_smoothing_mode_applies_like_jax(self):
        from pitchvis_tpu.core.config import AnalysisParameters as JAP
        from pitchvis_tpu_torch.core.config import AnalysisParameters as TAP

        for mode in tsettings.VqtSmoothingMode:
            got = tsettings.analysis_params_for_mode(TAP(), mode)
            want = jsettings.analysis_params_for_mode(JAP(), jsettings.VqtSmoothingMode(mode.value))
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class TestKeyTuner:
    KEYS = "12-+ 3+x4/9+ 0 1 4++ 8+ 23+=+ 89+ r s 5+6- 7-"

    def _tuners(self):
        clocks = _Clock(), _Clock()
        t = TKeyTuner(TTuner(to_port(SMALL_PARAMS), clock=clocks[0]), clock=clocks[0])
        j = JKeyTuner(JTuner(SMALL_PARAMS, clock=clocks[1]), clock=clocks[1])
        return t, j, clocks

    def test_same_keystrokes_same_status_and_parameters(self):
        """The same keystroke string through both KeyTuners: the same status
        lines, then, after the 2 s debounce, the same analysis parameters and
        the same rebuilt VQT parameters (a quality step, at the small test
        geometry)."""
        t, j, clocks = self._tuners()
        assert COMBOS == JCOMBOS
        for ch in self.KEYS.replace(" ", ""):
            assert t.feed(ch) == j.feed(ch), ch
            assert dataclasses.asdict(t.tuner.analysis_params) == dataclasses.asdict(j.tuner.analysis_params)
        for ch in "14++":
            assert t.feed(ch) == j.feed(ch)
        assert t.take_retuned_analysis() is None and j.take_retuned_analysis() is None
        assert t.tuner.take_rebuilt() is None and j.tuner.take_rebuilt() is None
        for c in clocks:
            c.t += 2.1
        ta, ja = t.take_retuned_analysis(), j.take_retuned_analysis()
        assert ta is not None and dataclasses.asdict(ta) == dataclasses.asdict(ja)
        tv, jv = t.tuner.take_rebuilt(), j.tuner.take_rebuilt()
        assert tv is not None and dataclasses.asdict(tv) == dataclasses.asdict(jv)
        assert tv.quality == pytest.approx(SMALL_PARAMS.quality + 0.5)
        assert t.spectrogram_mode == j.spectrogram_mode == "peaks"
        assert t.feed("q") == j.feed("q") == "quit" and t.quit

    def test_invalid_rebuild_resets_through_handshake_like_jax(self):
        t, j, clocks = self._tuners()
        for kt in (t, j):
            kt.tuner.adjust_vqt("quality", value=2.0)
            # an unbuildable combination (a window longer than n_fft), as
            # tests/test_tuning.py injects it
            kt.tuner._pending_vqt = dataclasses.replace(kt.tuner._pending_vqt, quality=5.0, gamma=0.01, n_fft=2048)
        for c in clocks:
            c.t += 2.1
        errors = []
        for kt in (t, j):
            with pytest.raises(Exception) as e:
                kt.tuner.take_rebuilt()
            errors.append(type(e.value).__name__)
        assert errors[0] == errors[1] == "WindowExceedsNFftError"
        assert dataclasses.asdict(t.tuner.take_rebuilt()) == dataclasses.asdict(j.tuner.take_rebuilt())
        assert dataclasses.asdict(t.tuner.vqt_params) == dataclasses.asdict(SMALL_PARAMS)

    def test_run_reader_over_a_pipe(self):
        import os

        from pitchvis_tpu_torch.io.keytune import run_reader

        r, w = os.pipe()
        os.write(w, b"14+q+")
        os.close(w)
        kt = self._tuners()[0]
        seen = []
        run_reader(r, kt, on_status=seen.append)
        os.close(r)
        assert seen[-1] == "quit" and len(seen) == 4 and kt.tuner.pending_rebuild()


class _Trickle(io.RawIOBase):
    """A pipe that returns at most ``step`` bytes a read (a producer that
    hands over partial sample frames mid-stream)."""

    def __init__(self, data: bytes, step: int):
        self._data, self._pos, self._step = data, 0, step

    def read(self, n=-1):
        n = self._step if n < 0 else min(n, self._step)
        out = self._data[self._pos : self._pos + n]
        self._pos += len(out)
        return out


class TestCapture:
    def test_wav_stream_driver_chunks_equal_jax(self, tmp_path):
        sr = 22050
        x = (0.3 * np.sin(2 * np.pi * 330.0 * np.arange(int(sr * 0.4)) / sr)).astype(np.float32)
        path = str(tmp_path / "in.wav")
        twav.save_wav(path, x, sr)
        got = list(tcapture.WavStreamDriver(path, sr, 735, device="cpu").chunks())
        want = list(jcapture.WavStreamDriver(path, sr, 735).chunks())
        assert len(got) == len(want) == -(-len(x) // 735)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        pushed = []
        assert tcapture.WavStreamDriver(path, sr, 735, device="cpu").stream_to(
            lambda i, c: pushed.append((i, c)), stream_idx=3) == len(got)
        assert all(i == 3 for i, _ in pushed)

    def test_wav_stream_driver_resamples_like_jax(self, tmp_path):
        """A 44.1 kHz file resampled to 22050 Hz on the CPU: the resampler's
        1e-6 absolute bound (tests/test_torch_resample.py)."""
        x = (0.3 * np.sin(2 * np.pi * 330.0 * np.arange(17640) / 44100)).astype(np.float32)
        path = str(tmp_path / "in44.wav")
        twav.save_wav(path, x, 44100)
        got = np.concatenate(list(tcapture.WavStreamDriver(path, 22050, 735, device="cpu").chunks()))
        want = np.concatenate(list(jcapture.WavStreamDriver(path, 22050, 735).chunks()))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("step", [1, 3, 7, 4096])
    def test_raw_pipe_short_reads_equal_jax(self, step):
        x = np.random.default_rng(step).standard_normal(1000).astype(np.float32)
        data = x.tobytes() + b"\x01\x02"  # a torn final sample
        out = []
        for mod in (tcapture, jcapture):
            drv = mod.RawPipeDriver(_Trickle(data, step), 22050, 368)
            chunks = []
            while (c := drv.read_chunk()) is not None:
                chunks.append(c)
            out.append(chunks)
        assert len(out[0]) == len(out[1]) == 3
        for g, w in zip(*out):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.concatenate(out[0])[:1000], x)

    def test_dump_input_devices_lists_the_drivers(self, monkeypatch):
        monkeypatch.setenv("PITCHVIS_ALSA_LIB", "/nonexistent/libasound.so")
        buf = io.StringIO()
        tcapture.dump_input_devices(file=buf)
        text = buf.getvalue()
        assert "WavStreamDriver" in text and "RawPipeDriver" in text and "unavailable" in text


class TestAlsaCapture:
    """io/alsa.py against the port's stub libasound (native/alsa_stub.c,
    built by utils/host_build.py): the call discipline of
    tests/test_io.py::TestAlsaCapture."""

    def test_unavailable_without_lib(self):
        assert not alsa.available("/nonexistent/libasound.so")
        assert alsa.list_input_devices("/nonexistent/libasound.so") == []
        with pytest.raises(RuntimeError, match="libasound"):
            alsa.AlsaCaptureDriver(lib_path="/nonexistent/libasound.so")

    def test_capture_tone_with_overrun_recovery(self):
        so = alsa.stub_library_path()
        assert alsa.available(so)
        sr, chunk = 22050, 368
        with alsa.AlsaCaptureDriver(sr=sr, chunk_size=chunk, lib_path=so) as drv:
            chunks = [drv.read_chunk() for _ in range(4)]
        assert all(c is not None and c.shape == (chunk,) for c in chunks)
        joined = np.concatenate(chunks)
        t = np.arange(len(joined)) / sr
        np.testing.assert_allclose(joined, 0.2 * np.sin(2 * np.pi * 440.0 * t), atol=1e-5)

    def test_set_params_rejection_closes_pcm(self):
        so = alsa.stub_library_path()
        with pytest.raises(RuntimeError, match="set_params"):
            alsa.AlsaCaptureDriver(sr=1, chunk_size=64, lib_path=so)
        with pytest.raises(RuntimeError, match="snd_pcm_open"):
            alsa.AlsaCaptureDriver(device="missing", lib_path=so)

    def test_device_listing_filters_playback_only(self):
        devices = alsa.list_input_devices(alsa.stub_library_path())
        assert [d["NAME"] for d in devices] == ["default", "hw:0,0"]
        assert devices[1]["DESC"] == "Stub microphone"

    def test_env_hook_and_stream_to_feeds_server_rings(self, monkeypatch):
        """PITCHVIS_ALSA_LIB selects the stub; AlsaCaptureDriver ->
        StreamServer.push, the in-process mic path, on the CPU."""
        from pitchvis_tpu_torch import StreamServer, VqtParameters

        monkeypatch.setenv("PITCHVIS_ALSA_LIB", alsa.stub_library_path())
        assert alsa.available()
        server = StreamServer(1, VqtParameters(), device="cpu")
        try:
            with alsa.AlsaCaptureDriver() as drv:
                assert drv.stream_to(server.push, 0, max_chunks=8) == 8
            windows, _gains = server.rings.snapshot(2048)
            assert np.abs(windows[0, -512:]).max() > 0
        finally:
            server.close()


class _FakePerfCounter:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def test_stage_timer_equals_jax(monkeypatch):
    """The same observations on a fake clock: the same EMA, rate and
    report in both packages."""
    clock = _FakePerfCounter()
    monkeypatch.setattr(time, "perf_counter", clock)
    timers = tprof.StageTimer(horizon=1.0), jprof.StageTimer(horizon=1.0)
    rng = np.random.default_rng(0)
    for _ in range(40):
        dt = float(rng.uniform(0.001, 0.004))
        clock.t += 1.0 / 60.0
        for timer in timers:
            timer.observe("hop", dt)
    for timer in timers:
        with timer.stage("render"):
            clock.t += 0.002
    t, j = timers
    assert t.report() == j.report()
    assert t.ema("hop") == j.ema("hop") and t.fps("hop") == j.fps("hop") and t.max_fps("hop") == j.max_fps("hop")
    assert t.fps("hop") == pytest.approx(60.0, rel=1e-6)
    assert t.last("render") == pytest.approx(0.002) and t.report()["render"]["count"] == 1


def test_trace_annotate_and_debug_report(tmp_path):
    from pitchvis_tpu_torch import StreamingPipeline

    pipe = StreamingPipeline(1, to_port(SMALL_PARAMS), device="cpu")
    timer = tprof.StageTimer()
    with tprof.trace(str(tmp_path / "prof")) as prof:
        with tprof.annotate("hop"), timer.stage("hop"):
            pipe.step(np.zeros((1, 367), np.float32), 367 / 22050)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any(e.key == "hop" for e in prof.key_averages())
    report = tprof.debug_report(pipe, timer)
    assert report["backend"] == "cpu" and report["devices"] == ["cpu"]
    assert report["n_buckets"] == SMALL_PARAMS.n_buckets and report["stages"]["hop"]["count"] == 1
    assert report["vqt_delay_ms"] == round(1000.0 * pipe.delay_secs, 2)


def test_png_round_trip_and_pillow(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (37, 53, 3), np.uint8)
    path = str(tmp_path / "f.png")
    write_png(path, rgb)
    np.testing.assert_array_equal(read_png(path), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), rgb)
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "not.png"))
