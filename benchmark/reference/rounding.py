# Frozen copy of pitchvis_tpu_torch/utils/rounding.py at commit 5c134db8c4ad,
# the plain reference of the benchmark: it imports nothing of the program.
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


def exact_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device. On the card PyTorch turns
    a division by a Python scalar into a product with its rounded reciprocal,
    which can land one ulp off the quotient; where a quotient is then floored
    or rounded (a smoothing horizon, a nearest semitone, a u8 color level),
    that ulp flips the result against the CPU and the JAX package. So the
    divisor goes in as a 0-d tensor filled on x's device (a fill, no host
    copy)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)
