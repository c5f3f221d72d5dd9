"""The port's command line, live: ``--serve`` from a pipe (the native
ingest resampler, pipelined with its tail flushed), ``--serve --loop``
(cadenced), ``--tune`` without a terminal, in-process ALSA capture and
``--list-devices`` against the port's stub libasound, the device-ring
fallback where the native runtime is missing, and the refusal to run
without CUDA unless asked for the CPU."""

import io
import sys
import types

import numpy as np

import pitchvis_tpu_torch.demo as tdemo
from pitchvis_tpu_torch.core.config import SERIAL_VQT_PARAMETERS
from pitchvis_tpu_torch.io import alsa
from pitchvis_tpu_torch.runtime import native

from torch_demo_helpers import led_frames, port_cli


def _tone(sr: int, seconds: float) -> bytes:
    t = np.arange(int(sr * seconds)) / sr
    return (0.2 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32).tobytes()


def test_serve_pipe_at_44100_pipelined_with_led(tmp_path):
    """One second at 44100 Hz on stdin, resampled in the native ingest
    path: one summary line and one LED frame per hop (30), the pipelined
    tail included, and the tone found."""
    led = str(tmp_path / "live.bin")
    proc = port_cli(["--serve", "--device", "cpu", "--input-sr", "44100", "--pipelined", "--led", led],
                    input=_tone(44100, 1.0))
    err = proc.stderr.decode()
    assert proc.returncode == 0, err[-2000:]
    lines = proc.stdout.decode().splitlines()
    assert len(lines) == 30 and "A4" in lines[-1]
    assert "serving stdin: 44100 Hz in -> 22050 Hz, hop 1470 (30 fps), pipelined on cpu" in err
    assert led_frames(led, SERIAL_VQT_PARAMETERS.n_buckets).shape[0] == 30


def test_serve_loop_cadenced():
    proc = port_cli(["--serve", "--loop", "--hops-per-dispatch", "4", "--fps", "30", "--device", "cpu"],
                    input=_tone(22050, 1.0))
    err = proc.stderr.decode()
    assert proc.returncode == 0, err[-2000:]
    assert "A4" in proc.stdout.decode() and "loop stats" in err


def test_serve_tune_without_tty_degrades_gracefully():
    """--tune with no controlling terminal disables tuning with a notice and
    serves normally (tests/test_io.py's contract for the JAX CLI)."""
    proc = port_cli(["--serve", "--loop", "--tune", "--fps", "30", "--device", "cpu"],
                    input=_tone(22050, 1.0), start_new_session=True)
    err = proc.stderr.decode()
    assert proc.returncode == 0, err[-2000:]
    assert "tuning disabled" in err and "A4" in proc.stdout.decode()


def test_serve_alsa_and_list_devices_against_the_stub():
    env = {"PITCHVIS_ALSA_LIB": alsa.stub_library_path()}
    proc = port_cli(["--list-devices"], env=env)
    assert proc.returncode == 0
    out = proc.stdout.decode()
    assert "hw:0,0: Stub microphone" in out and "Stub speakers" not in out
    proc = port_cli(["--serve", "--alsa", "--seconds", "1", "--fps", "30", "--device", "cpu"], env=env)
    err = proc.stderr.decode()
    assert proc.returncode == 0, err[-2000:]
    assert "serving alsa:default" in err and "A4" in proc.stdout.decode()


def test_without_cuda_the_cli_refuses():
    """Without --device cpu the CLI asks for the card and, where there is
    none, exits non-zero with resolve_device's message; offline and live."""
    for args in (["--tone", "440", "--seconds", "1"], ["--serve"]):
        proc = port_cli(args, env={"CUDA_VISIBLE_DEVICES": ""}, input=b"")
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr.decode()
        assert proc.stdout.decode() == ""


def test_fallback_without_the_native_runtime(monkeypatch, capsys):
    """Where the native library cannot be built, --serve runs the
    device-ring pipeline on the same device; the options that need the
    native runtime are refused."""
    monkeypatch.setattr(native, "available", lambda: False)
    stdin = types.SimpleNamespace(buffer=io.BytesIO(_tone(22050, 0.5)))
    monkeypatch.setattr(sys, "stdin", stdin)
    assert tdemo.main(["--serve", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "device ring pipeline on cpu" in out.err
    assert len(out.out.splitlines()) == 15 and "A4" in out.out
    for extra, msg in ((["--loop"], "--loop needs"), (["--input-sr", "44100"], "--input-sr needs"),
                       (["--render", "x"], "--render with --serve needs")):
        assert tdemo.main(["--serve", "--device", "cpu", *extra]) == 2
        assert msg in capsys.readouterr().err
