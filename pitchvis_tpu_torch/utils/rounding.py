"""Half-away-from-zero rounding (Rust ``f32::round``) for non-negative
operands.

``torch.round`` is IEEE half-to-even and differs from the reference's
``.round()`` at exact ``.5`` fractions — which the analysis chain produces
for real: a two-bin plateau's parabola center is exactly ``i + 0.5``, and
coarse layouts make every odd bin an exact half-semitone (``12*b/24``).
``floor(x + 0.5)`` replicates Rust for the non-negative quantities the
analysis chain rounds (bucket indices, semitone counts). Port of
``pitchvis_tpu/utils/rounding.py``.
"""

from __future__ import annotations

import torch


def rust_round(x: torch.Tensor) -> torch.Tensor:
    """Rust ``f32::round`` semantics for non-negative ``x``."""
    return torch.floor(x + 0.5)
