"""Pitch-class color mapping.

Port of ``pitchvis_tpu/ops/colors.py`` (itself a vectorized port of
`pitchvis_colors`, pitchvis_colors/src/lib.rs): the 12-tone palettes, and
`calculate_color` (lib.rs:93-117), which maps a fractional pitch bucket to
RGB by converting the nearest pitch-class base color to LCh, scaling chroma
by a saturation easing of the distance to the pitch-class center, and
blending lightness toward a gray level. Base colors are truncated to u8
before RGB->LCh, and the final LCh->RGB result is rounded and clamped to u8,
as the reference's ``lab`` crate does (lib.rs:102,115).

Color math: sRGB (D65) <-> CIE Lab with the standard epsilon/kappa
constants, matching the ``lab`` crate's formulas.

Against the JAX package: PyTorch has no ``cbrt`` (``pow(t, 1/3)`` stands in
for it), and PyTorch and XLA round ``pow``, ``atan2``, ``cos``, ``sin`` and
``exp`` differently in the last ulp, on the CPU as on the card. So a u8
level can flip by one where a value lands within an ulp of a rounding edge:
the colors agree within one level in a small share of elements
(tests/test_torch_colors.py states it), not bit for bit. Every division that
feeds the u8 rounding is exact (utils/rounding.py::exact_div): on the card a
division by a Python scalar would be a product with its rounded reciprocal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.rounding import exact_div, rust_round

# pitchvis_colors/src/lib.rs:19-34
COLORS = np.array(
    [
        [0.85, 0.36, 0.36],  # C
        [0.01, 0.52, 0.71],  # C#
        [0.97, 0.76, 0.05],  # D
        [0.45, 0.34, 0.63],  # Eb
        [0.47, 0.77, 0.22],  # E
        [0.78, 0.32, 0.52],  # F
        [0.00, 0.64, 0.56],  # F#
        [0.95, 0.54, 0.23],  # G
        [0.30, 0.37, 0.64],  # Ab
        [1.00, 0.96, 0.03],  # A
        [0.57, 0.30, 0.55],  # Bb
        [0.12, 0.71, 0.34],  # B
    ],
    dtype=np.float32,
)

# pitchvis_serial/src/main.rs:44-57
SERIAL_COLORS = np.array(
    [
        [0.95, 0.10, 0.10],
        [0.01, 0.52, 0.71],
        [0.97, 0.79, 0.00],
        [0.45, 0.34, 0.63],
        [0.47, 0.99, 0.02],
        [0.88, 0.02, 0.52],
        [0.00, 0.80, 0.55],
        [0.99, 0.54, 0.03],
        [0.25, 0.30, 0.64],
        [0.95, 0.99, 0.00],
        [0.52, 0.00, 0.60],
        [0.05, 0.80, 0.15],
    ],
    dtype=np.float32,
)

PITCH_NAMES = ["C", "C♯", "D", "E♭", "E", "F", "F♯", "G", "A♭", "A", "B♭", "B"]

GRAY_LEVEL = 60.0  # lib.rs:54
EASING_POW = 1.3  # lib.rs:55

# D65 white point and sRGB matrices (lab crate constants)
_WHITE = np.array([0.95047, 1.0, 1.08883])
_RGB2XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ]
)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)
_EPS = 216.0 / 24389.0
_KAPPA = 24389.0 / 27.0


def _mat3(v: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """Explicit 3x3 color-matrix transform as elementwise f32 mul-adds (a
    matmul could run in TF32 on the card)."""
    cols = [
        v[..., 0] * float(m[i][0]) + v[..., 1] * float(m[i][1]) + v[..., 2] * float(m[i][2])
        for i in range(3)
    ]
    return torch.stack(cols, dim=-1)


def _per_channel(v: torch.Tensor, values: np.ndarray) -> torch.Tensor:
    """``v / values`` over the last axis of size 3, each quotient exact."""
    return torch.stack([exact_div(v[..., i], float(values[i])) for i in range(3)], dim=-1)


def srgb_u8_to_lab(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8-valued sRGB -> CIE Lab (D65)."""
    c = exact_div(rgb_u8.to(torch.float32), 255.0)
    lin = torch.where(
        c > 0.04045, torch.pow(exact_div(c + 0.055, 1.055), 2.4), exact_div(c, 12.92)
    )
    xyz = _mat3(lin, _RGB2XYZ)
    t = _per_channel(xyz, _WHITE.astype(np.float32))
    # no torch.cbrt: t > _EPS > 0 on that branch, where pow(t, 1/3) is the
    # real cube root within an ulp or so
    f = torch.where(t > _EPS, torch.pow(t, 1.0 / 3.0), exact_div(_KAPPA * t + 16.0, 116.0))
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([l, a, b], dim=-1)


def lab_to_srgb_u8(lab: torch.Tensor) -> torch.Tensor:
    """CIE Lab -> sRGB with the lab crate's round+clamp u8 quantization
    (float32 values in [0, 255])."""
    l, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = exact_div(l + 16.0, 116.0)
    fx = fy + exact_div(a, 500.0)
    fz = fy - exact_div(b, 200.0)

    def finv(f):
        f3 = f**3
        return torch.where(f3 > _EPS, f3, exact_div(116.0 * f - 16.0, _KAPPA))

    # lab crate: y uses the L > kappa*eps branch
    y = torch.where(l > _KAPPA * _EPS, fy**3, exact_div(l, _KAPPA))
    # times the white point channel by channel: a Python scalar needs no
    # host-to-device copy
    white = _WHITE.astype(np.float32)
    xyz = torch.stack(
        [finv(fx) * float(white[0]), y * float(white[1]), finv(fz) * float(white[2])], dim=-1
    )
    lin = _mat3(xyz, _XYZ2RGB)
    c = torch.where(lin > 0.0031308, 1.055 * torch.pow(lin, 1.0 / 2.4) - 0.055, 12.92 * lin)
    # floor(x + 0.5): Rust f32::round (half away from zero, the lab crate's
    # quantization); torch.round is half-to-even and differs at exact .5
    return torch.clamp(torch.floor(c * 255.0 + 0.5), 0.0, 255.0)


def lab_to_lch(lab: torch.Tensor) -> torch.Tensor:
    l, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    c = torch.sqrt(a * a + b * b)
    h = torch.atan2(b, a)
    return torch.stack([l, c, h], dim=-1)


def lch_to_lab(lch: torch.Tensor) -> torch.Tensor:
    l, c, h = lch[..., 0], lch[..., 1], lch[..., 2]
    return torch.stack([l, c * torch.cos(h), c * torch.sin(h)], dim=-1)


def static_table(build, *key, device: torch.device) -> torch.Tensor:
    """``build(*key)``, a table that depends only on its hashable ``key`` (a
    palette, a bin layout), on ``device``. Built once in float32 on the host
    by the same ops a per-frame computation would run, and copied once a
    device: the card's table is then the CPU's bit for bit (the card's pow,
    atan2, cos and sin round in other ulps, which would flip a u8 level of a
    whole column of streams), and a hop after the first launches nothing for
    it. The first call on a device copies to it, which synchronises."""
    return _table_on(build, key, torch.device(device))


# never evicted: a CUDA graph captured over a table reads it by address
# (models/pipeline.py::StreamingPipeline.step_multi); one entry a table,
# bin layout and device
@functools.cache
def _table_on(build, key: tuple, device: torch.device) -> torch.Tensor:
    host = _table_on(build, key, torch.device("cpu")) if device.type != "cpu" else build(*key)
    return host.to(device)


def _palette_lch_host(palette: bytes) -> torch.Tensor:
    """The 12-color palette (float32 RGB bytes) as a (12, 3) LCh table, its
    colors truncated to u8 first (lib.rs:102)."""
    colors = torch.from_numpy(np.frombuffer(palette, np.float32).reshape(12, 3).copy())
    return lab_to_lch(srgb_u8_to_lab(torch.floor(colors * 255.0)))


def calculate_color(
    buckets_per_octave: int,
    bucket: torch.Tensor,
    colors: np.ndarray = COLORS,
    gray_level: float = GRAY_LEVEL,
    easing_pow: float = EASING_POW,
) -> torch.Tensor:
    """Vectorized `calculate_color` (pitchvis_colors/src/lib.rs:93-117).

    bucket: (...,) fractional pitch buckets. Returns (..., 3) RGB in [0, 1]
    on bucket's device."""
    pitch_continuous = exact_div(12.0 * bucket, buckets_per_octave)
    # f32::round (half away from zero, lib.rs:102-103): at bpo=24 every odd
    # bin is an exact half-semitone, where half-to-even picks the wrong
    # pitch class (and saturation)
    nearest = rust_round(pitch_continuous)
    cls = torch.remainder(nearest.to(torch.int64), 12)

    # the palette's 12 colors in LCh, picked per element by an exact gather
    palette = np.ascontiguousarray(colors, np.float32).tobytes()
    lch = static_table(_palette_lch_host, palette, device=bucket.device)[cls]

    inaccuracy = torch.abs(pitch_continuous - nearest)
    saturation = 1.0 - torch.pow(2.0 * inaccuracy, easing_pow)

    l = saturation * lch[..., 0] + (1.0 - saturation) * gray_level
    c = lch[..., 1] * saturation
    out_u8 = lab_to_srgb_u8(lch_to_lab(torch.stack([l, c, lch[..., 2]], dim=-1)))
    return exact_div(out_u8, 255.0)
