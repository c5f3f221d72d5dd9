"""Shared helpers of the tests that hold pitchvis_tpu_torch against
pitchvis_tpu: parameter conversion between the two packages' (identical)
config dataclasses and seeded input signals, made with NumPy so both
packages see the same bits."""

from __future__ import annotations

import dataclasses

import numpy as np

import pitchvis_tpu.core.config as jcfg
import pitchvis_tpu_torch.core.config as tcfg


def to_port(obj):
    """A pitchvis_tpu config dataclass -> the equal pitchvis_tpu_torch one."""
    cls = getattr(tcfg, type(obj).__name__)
    kwargs = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kwargs[f.name] = to_port(v) if dataclasses.is_dataclass(v) else v
    return cls(**kwargs)


def default_params():
    return jcfg.VqtParameters()


def streams(n_streams: int, n_samples: int, sr: float, seed: int) -> np.ndarray:
    """(B, T) float32: per stream two seeded sines plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / sr
    f = 110.0 * 2.0 ** rng.uniform(0.0, 3.5, (n_streams, 2, 1))
    a = rng.uniform(0.05, 0.4, (n_streams, 2, 1))
    sig = (a * np.sin(2 * np.pi * f * t)).sum(axis=1)
    sig += 0.01 * rng.standard_normal((n_streams, n_samples))
    return sig.astype(np.float32)
