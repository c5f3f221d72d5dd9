# Frozen copy of pitchvis_tpu_torch/utils/ema.py at commit 5c134db8c4ad,
# the plain reference of the benchmark: it imports nothing of the program.
"""Frame-rate-independent exponential moving average.

Mirrors `EmaMeasurement` (pitchvis_analysis/src/util.rs:90-137): the decay is
``alpha = 1 - exp(-2 * dt / horizon)``, the exact continuous-time form, so
updating n times with dt/n equals one update with dt (toward a constant
target). A horizon of 0 (the reference's ``None``) means passthrough.

Port of ``pitchvis_tpu/utils/ema.py``: pure functions over float32 tensors;
the EMA state lives in the analysis state (models/analysis.py)."""

from __future__ import annotations

import torch


def ema_alpha(dt, horizon):
    """alpha = 1 - exp(-2 dt / horizon); passthrough (alpha=1) when horizon<=0.

    `dt` is a scalar or a tensor broadcastable against `horizon`; `horizon`
    may be a Python float or a per-bin tensor (seconds).
    """
    dt = torch.as_tensor(dt, dtype=torch.float32)
    if not isinstance(horizon, torch.Tensor):
        # filled on dt's device: a host scalar copied to the card would
        # synchronise with the host
        horizon = torch.full((), float(horizon), dtype=torch.float32, device=dt.device)
    positive = horizon > 0.0
    safe = torch.where(positive, horizon, torch.ones_like(horizon))
    alpha = 1.0 - torch.exp(-2.0 * dt / safe)
    return torch.where(positive, alpha, torch.ones_like(alpha))


def ema_update(y, x, dt, horizon):
    """One EMA step toward x over timestep dt (util.rs:106-125)."""
    return y + ema_alpha(dt, horizon) * (x - y)


def ema_update_with_alpha(y, x, alpha):
    """One EMA step toward x with a given decay ``alpha``."""
    return y + alpha * (x - y)
