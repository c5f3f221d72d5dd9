"""Shared helpers of the tests that hold the port's command line
(pitchvis_tpu_torch/demo.py) against the JAX package's: running either
``main`` in process, and the chain budget for what the two print and write
(tests/test_torch_outputs.py::_check_chain's LED bound, the peaks compared
through the printed notes)."""

from __future__ import annotations

import os
import sys

import numpy as np

import pitchvis_tpu.demo as jdemo
import pitchvis_tpu.utils.compile_cache as jcompile_cache
import pitchvis_tpu_torch.demo as tdemo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_main(which: str, argv, capsys, monkeypatch) -> tuple[list[str], str]:
    """Runs ``demo.main(argv)`` of one package in this process ("jax" or
    "port", the port's with ``--device cpu``); returns its stdout lines and
    its stderr. The JAX CLI's persistent XLA cache is left off, so the
    worker's JAX state is what the other tests see."""
    capsys.readouterr()
    if which == "jax":
        monkeypatch.setattr(jcompile_cache, "enable_compilation_cache", lambda *a, **k: None)
        rc = jdemo.main(argv)
    else:
        rc = tdemo.main([*argv, "--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return out.out.splitlines(), out.err


def notes_of(line: str) -> list[tuple[str, float]]:
    """The (note, size dB) pairs of an offline summary line
    ``t=... tune=...ct  A4+0ct(37.3dB), ...``."""
    tail = line.split("ct  ", 1)[1]
    if not tail:
        return []
    out = []
    for tok in tail.split(", "):
        name, size = tok[:-3].split("(")
        out.append((name, float(size)))
    return out


def led_frames(path: str, n: int) -> np.ndarray:
    """A pitchvis_serial byte stream -> (frames, n, 3) uint8, its framing
    checked (0xFF, the u16 count, values below 0xFF)."""
    data = np.frombuffer(open(path, "rb").read(), np.uint8)
    frames = data.reshape(-1, 3 + 3 * n)
    assert (frames[:, 0] == 0xFF).all() and (frames[:, 1] == n // 256).all() and (frames[:, 2] == n % 256).all()
    assert (frames[:, 3:] <= 0xFE).all()
    return frames[:, 3:].reshape(-1, n, 3)


def check_offline_against_jax(port_lines, jax_lines, port_led=None, jax_led=None, n=None):
    """The summary lines are equal in count; where the two print the same
    notes (no peak flipped), sizes agree within 0.15 dB, the AGC gain is the
    same string and the calmness within 0.02; at most one line in 30 may
    differ in its notes (the chain budget's 2e-4 of the bins flipping, at
    180 bins). The LED frames, where given, are within 4 on every line
    without a flip."""
    assert len(port_lines) == len(jax_lines) > 0
    flips = []
    for p, j in zip(port_lines, jax_lines):
        pn, jn = notes_of(p), notes_of(j)
        flipped = [a for a, _ in pn] != [a for a, _ in jn]
        flips.append(flipped)
        if flipped:
            continue
        for (_, ps), (_, js) in zip(pn, jn):
            assert abs(ps - js) <= 0.15, (p, j)
        assert p.split(" calm=")[0] == j.split(" calm=")[0], (p, j)  # t= and gain=
        assert abs(float(p.split("calm=")[1][:4]) - float(j.split("calm=")[1][:4])) <= 0.02, (p, j)
    assert sum(flips) <= max(1, len(flips) // 30), f"{sum(flips)} of {len(flips)} lines differ in their notes"
    if port_led is not None:
        pl, jl = led_frames(port_led, n), led_frames(jax_led, n)
        assert pl.shape == jl.shape and pl.shape[0] == len(port_lines)
        keep = ~np.asarray(flips)
        assert np.abs(pl[keep].astype(np.int32) - jl[keep].astype(np.int32)).max() <= 4
    return flips


def port_cli(args, **kwargs):
    """``python -m pitchvis_tpu_torch.demo args`` in a subprocess from the
    root of the checkout, with this process's torch thread count (a test
    worker's share of the cores, conftest.py)."""
    import subprocess

    import torch

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=str(torch.get_num_threads()), **kwargs.pop("env", {}))
    return subprocess.run([sys.executable, "-m", "pitchvis_tpu_torch.demo", *args], capture_output=True,
                          cwd=ROOT, env=env, timeout=kwargs.pop("timeout", 300), **kwargs)

