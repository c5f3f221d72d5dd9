"""The deterministic scene of the rasterizer's golden frames.

Port of ``pitchvis_tpu/io/golden.py::render_scene_inputs``: the scene that
``tests/golden/render_golden.npz`` holds rendered, plain and with the
Debugging overlay, built from the same seeded draws through the port's own
display math, so the golden replays where the JAX package is absent (on the
card). The rest of that module (the golden generators and loaders) is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SERIAL_VQT_PARAMETERS, VqtParameters
from ..core.device import resolve_device
from ..models.render import DebugInputs, RenderConfig
from ..models.viewer import BallState, bass_spiral, update_balls


def render_scene_inputs(params: VqtParameters | None = None, device="cuda"):
    """The raster golden's scene: a seeded 3-peak frame pushed through the
    display math (update_balls, bass_spiral) plus seeded Debugging-overlay
    panel data, one stream, on ``device`` (the card unless
    ``device="cpu"``). Returns (cfg, rng_cfg, balls, bass, debug,
    scene_calmness, time), each per-stream leaf with a stream axis of one."""
    device = resolve_device(device)
    params = params or SERIAL_VQT_PARAMETERS
    rng_cfg = params.range
    n = rng_cfg.n_buckets
    cfg = RenderConfig(width=160, height=90, ball_patch=48, max_balls=16)

    r = np.random.default_rng(42)
    peaks = np.zeros(n, bool)
    center = np.arange(n, dtype=np.float32)
    size = np.zeros(n, np.float32)
    for b in (20, 61, 118):
        peaks[b] = True
        center[b] = b + float(r.uniform(-0.4, 0.4))
        size[b] = float(r.uniform(10.0, 25.0))
    calmness = r.uniform(0.0, 1.0, n).astype(np.float32)
    accuracy = r.uniform(0.5, 1.0, n).astype(np.float32)
    deviation = r.uniform(-0.4, 0.4, n).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.asarray(a)[None]).to(device)

    _, balls = update_balls(
        rng_cfg, BallState.init(1, n, device=device), t(peaks), t(center), t(size), t(calmness), t(accuracy),
        t(deviation), 1.0 / 60.0,
    )
    bass = bass_spiral(rng_cfg, t(peaks), t(center), t(size))
    debug = DebugInputs(
        x_vqt_smoothed=t(r.uniform(0, 30, n).astype(np.float32)),
        peaks=t(peaks),
        peak_center=t(center),
        peak_size=t(size),
        calmness=t(calmness),
        graph_values=t(r.uniform(0, 1, 300).astype(np.float32)),
        spectrogram=t(r.integers(0, 256, (200, n, 4), np.uint8)),
        spectrogram_write_index=t(np.int32(37)),
        chroma=t(r.uniform(0, 1, 12).astype(np.float32)),
    )
    return cfg, rng_cfg, balls, bass, debug, np.float32(0.6), np.float32(1.25)
