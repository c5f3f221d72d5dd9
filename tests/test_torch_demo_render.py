"""The port's command line with ``--render`` against the JAX package's, both
in process on the same tone: the frames of a PNG directory (plain and with
the debug overlay) within one 8-bit step, and the GIF output with its cap."""

import glob
import os

import numpy as np
import pytest
from PIL import Image

from pitchvis_tpu_torch.io.png import read_png

from torch_demo_helpers import run_main


@pytest.mark.parametrize("overlay", [False, True], ids=["plain", "debug_overlay"])
def test_render_frames_match_jax(overlay, tmp_path, capsys, monkeypatch):
    """--render DIR --render-size 160x90 on a 0.2-second tone (6 frames):
    the port's PNGs (its own writer) against the JAX CLI's (Pillow), within
    one 8-bit step, the render golden's budget."""
    dirs = {w: str(tmp_path / w) for w in ("port", "jax")}
    for w in ("port", "jax"):
        argv = ["--tone", "440", "--seconds", "0.2", "--render", dirs[w], "--render-size", "160x90",
                "--path", "pallas"] + (["--debug-overlay"] if overlay else [])
        _, err = run_main(w, argv, capsys, monkeypatch)
        assert f"wrote 6 PNGs to {dirs[w]}" in err
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(dirs["port"], "*.png")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(os.path.join(dirs["jax"], "*.png")))
    assert len(names) == 6
    for name in names:
        got = read_png(os.path.join(dirs["port"], name))
        want = np.asarray(Image.open(os.path.join(dirs["jax"], name)).convert("RGB"))
        assert got.shape == want.shape == (90, 160, 3)
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, f"{name}: max step {d.max()}, {(d > 0).sum()} of {d.size} values differ"
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 10


def test_gif_output_and_cap(tmp_path, capsys, monkeypatch):
    """--render OUT.gif keeps its frames in memory, capped by
    --render-max-frames, and writes one animated GIF."""
    out = str(tmp_path / "t.gif")
    _, err = run_main("port", ["--tone", "440", "--seconds", "0.2", "--render", out, "--render-size", "64x36",
                               "--render-max-frames", "4"], capsys, monkeypatch)
    assert "GIF capped at 4 frames" in err and "wrote 4-frame GIF" in err
    im = Image.open(out)
    assert im.size == (64, 36) and im.n_frames == 4
