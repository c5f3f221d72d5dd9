"""The port's command line (``python -m pitchvis_tpu_torch.demo``) against
the JAX package's, both in process on the same inputs: the summary lines
and the pitchvis_serial LED stream on every VQT path (the kernels' plain
versions on the CPU) at the chain budget, and a 44100 Hz WAV through the
resampler."""

import pytest

from pitchvis_tpu_torch.io.golden import chain_signals
from pitchvis_tpu_torch.io.wav import save_wav
from pitchvis_tpu_torch.core.config import VqtParameters

from pitchvis_tpu.core.config import SERIAL_VQT_PARAMETERS

from torch_demo_helpers import check_offline_against_jax, led_frames, run_main


@pytest.mark.parametrize("path", ["time", "freq", "pallas"])
def test_tone_led_matches_jax(path, tmp_path, capsys, monkeypatch):
    """--tone 440 --seconds 1 --led: 30 hops at the serial parameters."""
    n = SERIAL_VQT_PARAMETERS.n_buckets
    led = {w: str(tmp_path / f"{w}.bin") for w in ("port", "jax")}
    lines, errs = {}, {}
    for which in ("port", "jax"):
        lines[which], errs[which] = run_main(
            which, ["--tone", "440", "--seconds", "1", "--led", led[which], "--path", path], capsys, monkeypatch
        )
        assert "wrote 30 LED frames" in errs[which]
    assert "offline: 30 hops on cpu, 1.000 s of audio" in errs["port"]
    flips = check_offline_against_jax(lines["port"], lines["jax"], led["port"], led["jax"], n)
    assert len(flips) == 30
    assert all("A4+0ct" in line for line in lines["port"][10:])
    assert led_frames(led["port"], n).any()


def test_wav_44100_through_the_resampler_matches_jax(tmp_path, capsys, monkeypatch):
    """One second of the chain's chord, written at 44100 Hz by the port's
    save_wav: both CLIs resample it to 22050 Hz (the port's on the CPU)
    and print and write the same at the chain budget."""
    sig = chain_signals(VqtParameters(sr=44100.0), 1.0)["chord"]
    wav = str(tmp_path / "chord44.wav")
    save_wav(wav, sig, 44100)
    n = SERIAL_VQT_PARAMETERS.n_buckets
    led = {w: str(tmp_path / f"{w}.bin") for w in ("port", "jax")}
    lines = {w: run_main(w, [wav, "--led", led[w], "--path", "pallas"], capsys, monkeypatch)[0]
             for w in ("port", "jax")}
    check_offline_against_jax(lines["port"], lines["jax"], led["port"], led["jax"], n)
    assert len(lines["port"]) == 30
    assert any("A2" in line for line in lines["port"])
