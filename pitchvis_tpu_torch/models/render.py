"""Rasterizer for the PitchVis scene, batched over streams.

Port of ``pitchvis_tpu/models/render.py``. The reference presents its
analysis through a Bevy/wgpu app (pitchvis_viewer/src/display_system/): an
orthographic 2D camera over a log-spiral of "pitch balls" shaded by
``noisy_color_rings_2d.wgsl``, a spider net, a bass spiral, pitch names and
HDR bloom. This module computes that image from the viewer's outputs
(models/viewer.py) as uint8 sRGB frames, with no windowing stack: the
display-rate consumer path for the streams somebody is watching
(:func:`render_streams`).

Faithful pieces (exact formulas, cited):
* scene layout: camera ``FixedVertical { viewport_height: 38*0.41421357 }``
  (setup.rs:359-363), clear color srgb(0.23, 0.23, 0.25) (mod.rs:18-19),
  20x20 ball quads on the spiral (setup.rs:110), spider net rays of radius
  octaves*2.2 + the visual spiral polyline, thickness 0.05, srgb(0.3, 0.3,
  0.3) (setup.rs:174-223), bass cylinders 0.05 wide (setup.rs:127-172),
  back-to-front alpha blending in z order (ball z =
  (size/max-1.01)*12.5, update.rs:232-234).
* the ball fragment shader (noisy_color_rings_2d.wgsl, active options):
  Gustavson simplex noise (lines 6-75), ``ring(uv) = sin(r*sqrt(r)*pi)^2``
  (116-120), the pitch-accuracy center dot (126-141), the spiral-star
  tuning indicator (231-260), the fragment composition with
  ``ring_strength = clamp(1-calmness*1.65)^3`` and the smooth circle
  boundary (395-429); shading in LINEAR color space, sRGB encode at the end.
* post-processing: Bevy's mip-chain bloom (13-tap downsample pyramid at the
  512-high internal resolution, soft-threshold prefilter 0.17/0.82, 3x3
  tent upsampling, per-mip blend weights for the reference's Additive
  settings, setup.rs:367-377) as separable products, and
  ``Tonemapping::SomewhatBoringDisplayTransform`` (setup.rs:358).
* the pitch-name Text2d ring (setup.rs:386-416) from the committed glyph
  atlas (models/glyph_atlas.py), composited as a static layer.

Layout: every per-frame tensor carries the stream axis first. The raster is
(B, Hp, Wp, 3) float32 up to the crop, then channel-first (B, 3, H, W)
through bloom and tonemap, so each separable bloom product is one batched
product without a transpose. The scene's static layers and the bloom's
operator matrices are NumPy on the host, built once for each (config, range,
device) and copied once to the device (:func:`make_scene`,
``_bloom_tables``): a frame after the first copies nothing and does not
synchronise with the host. ``time`` is a host scalar; the scalar-only
expressions of the shader (``time * 0.8``, the pulses) are evaluated in
float32 on the host.

The back-to-front composite of the K ball patches, and of the debug
overlay's peak disks, is the hand-written kernel ``csrc/composite.cu``
(ops/composite.py); everything else is plain PyTorch. The bloom's products
run in IEEE float32 on the card whatever the caller's TF32 setting (the JAX
package asks for ``Precision.HIGHEST``): ``_full_f32_matmul``.

Over a mesh (parallel/sharding.py) the inputs are ``Sharded`` by streams:
each slice renders on its own device with that device's static layers and
bloom tables, one composite launch a slice, and the frames come back
``Sharded`` the same way. No frame depends on another stream, so nothing
crosses devices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import warnings

import numpy as np
import torch

from ..core.config import VqtRange
from ..core.device import resolve_device
from ..ops.colors import COLORS, GRAY_LEVEL, calculate_color, static_table
from ..ops.composite import composite_patches
from ..parallel.sharding import Sharded, map_shards, select_rows
from ..utils.rounding import exact_div, rust_round
from .viewer import (
    SPIRAL_SEGMENTS_PER_SEMITONE,
    BallOutputs,
    BassSpiralOutputs,
    _calmness_palette,
    bass_cylinder_count,
    bin_to_spiral,
    bloom_intensity,
    pitch_color_rotation,
)

# setup.rs:359-363: FixedVertical viewport height in world units
VIEWPORT_HEIGHT = 38.0 * 0.414_213_57
# mod.rs:18-21: clear colors (sRGB)
CLEAR_COLOR = (0.23, 0.23, 0.25)  # CLEAR_COLOR_NEUTRAL
CLEAR_COLOR_GALAXY = (0.05, 0.0, 0.05)
BALL_HALF_EXTENT = 10.0  # setup.rs:110: Rectangle::new(20, 20) half size
NET_COLOR = (0.3, 0.3, 0.3)  # setup.rs:200/220
NET_THICKNESS = 0.05  # setup.rs:197/215
BASS_WIDTH = 0.05  # setup.rs:159: Rectangle::new(0.05, h + 0.01)
BASS_END_EXTENSION = 0.005  # the h + 0.01 overhang, half per end
# setup.rs:367-377: the reference's Bloom component settings
BLOOM_THRESHOLD = 0.17  # prefilter.threshold
BLOOM_SOFTNESS = 0.82  # prefilter.threshold_softness
BLOOM_LF_BOOST = 1.0  # low_frequency_boost
BLOOM_LF_CURVATURE = 1.0  # low_frequency_boost_curvature
BLOOM_HIGH_PASS = 0.52  # high_pass_frequency
# bevy_core_pipeline bloom internals: the pyramid runs at a fixed internal
# resolution capped at 512 px high (MAX_MIP_DIMENSION), mip count
# ilog2(512).max(2) - 1 = 8
BLOOM_MAX_MIP_DIMENSION = 512
BLOOM_MIP_COUNT = 8


def _f32(x) -> float:
    """A host scalar rounded to float32, as a Python float."""
    return float(np.float32(x))


def _pulse(time: float, base: float, depth: float) -> float:
    """``base + depth * sin(time * 3)`` in float32 on the host (the shader's
    pulses)."""
    t = np.float32(time) * np.float32(3.0)
    return float(np.float32(base) + np.float32(depth) * np.sin(t, dtype=np.float32))


def srgb_to_linear(c) -> torch.Tensor:
    """IEC 61966-2-1 decode (what Bevy's Color::srgb -> LinearRgba does)."""
    c = torch.as_tensor(c, dtype=torch.float32)
    return torch.where(c <= 0.04045, exact_div(c, 12.92), torch.pow(exact_div(c + 0.055, 1.055), 2.4))


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp_min(torch.as_tensor(c, dtype=torch.float32), 0.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def _smoothstep(e0: float, e1: float, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(exact_div(x - e0, e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _step(edge, x) -> torch.Tensor:
    return torch.where(x >= edge, 1.0, 0.0)


# noisy_color_rings_2d.wgsl:6-75 constants, float32 as the shader has them
_C_X = np.float32(1.0 / 6.0)
_C_Y = np.float32(1.0 / 3.0)
_NS_X = float(np.float32(2.0 / 7.0 - 0.0))  # n_*D.w - D.x with n_=1/7, D=(0,.5,1,2)
_NS_Y = float(np.float32(1.0 / 7.0 * 0.5 - 1.0))  # n_*D.y - D.z
_NS_Z = float(np.float32(1.0 / 7.0 * 1.0 - 0.0))  # n_*D.z - D.x


def simplex_noise3(x, y, z) -> torch.Tensor:
    """Gustavson/McEwan 3D simplex noise, an exact float32 port of
    ``simplexNoise3`` in noisy_color_rings_2d.wgsl:6-75 (component-wise;
    the vec3/vec4 lanes of the WGSL are unrolled). Arguments broadcast; a
    Python float takes part as a float32 scalar."""
    c_x, c_y = float(_C_X), float(_C_Y)
    c_x2, c_x3 = float(2.0 * _C_X), float(3.0 * _C_X)

    def permute4(v):
        return torch.remainder((v * 34.0 + 1.0) * v, 289.0)

    s = (x + y + z) * c_y
    ix, iy, iz = torch.floor(x + s), torch.floor(y + s), torch.floor(z + s)
    t = (ix + iy + iz) * c_x
    x0x, x0y, x0z = x - ix + t, y - iy + t, z - iz + t

    # g = step(x0.yzx, x0.xyz); l = 1 - g
    gx, gy, gz = _step(x0y, x0x), _step(x0z, x0y), _step(x0x, x0z)
    lx, ly, lz = 1.0 - gx, 1.0 - gy, 1.0 - gz
    # i1 = min(g.xyz, l.zxy); i2 = max(g.xyz, l.zxy)
    i1x, i1y, i1z = torch.minimum(gx, lz), torch.minimum(gy, lx), torch.minimum(gz, ly)
    i2x, i2y, i2z = torch.maximum(gx, lz), torch.maximum(gy, lx), torch.maximum(gz, ly)

    x1x, x1y, x1z = x0x - i1x + c_x, x0y - i1y + c_x, x0z - i1z + c_x
    x2x, x2y, x2z = x0x - i2x + c_x2, x0y - i2y + c_x2, x0z - i2z + c_x2
    x3x, x3y, x3z = x0x - 1.0 + c_x3, x0y - 1.0 + c_x3, x0z - 1.0 + c_x3

    ix, iy, iz = torch.remainder(ix, 289.0), torch.remainder(iy, 289.0), torch.remainder(iz, 289.0)
    # p = permute4(permute4(permute4(iz + [0,i1z,i2z,1]) + iy + [...]) + ix + [...])
    adds = [(0.0, 0.0, 0.0), (i1z, i1y, i1x), (i2z, i2y, i2x), (1.0, 1.0, 1.0)]
    inner = [permute4(iz + a[0]) for a in adds]
    mid = [permute4(inner[k] + iy + adds[k][1]) for k in range(4)]
    p = [permute4(mid[k] + ix + adds[k][2]) for k in range(4)]

    xs = [(x0x, x0y, x0z), (x1x, x1y, x1z), (x2x, x2y, x2z), (x3x, x3y, x3z)]
    total = 0.0
    for k in range(4):
        j = p[k] - 49.0 * torch.floor(p[k] * _NS_Z * _NS_Z)
        x_ = torch.floor(j * _NS_Z)
        y_ = torch.floor(j - 7.0 * x_)
        xg = x_ * _NS_X + _NS_Y
        yg = y_ * _NS_X + _NS_Y
        hg = 1.0 - torch.abs(xg) - torch.abs(yg)
        # b0/b1 + s0/s1 + sh reshuffle, unrolled per lane
        sx = torch.floor(xg) * 2.0 + 1.0
        sy = torch.floor(yg) * 2.0 + 1.0
        sh = -_step(hg, 0.0)
        px, py, pz = xg + sx * sh, yg + sy * sh, hg
        norm = 1.79284291400159 - 0.85373472095314 * (px * px + py * py + pz * pz)
        px, py, pz = px * norm, py * norm, pz * norm
        cx, cy, cz = xs[k]
        m = torch.clamp_min(0.6 - (cx * cx + cy * cy + cz * cz), 0.0)
        m = m * m
        total = total + m * m * (px * cx + py * cy + pz * cz)
    return 42.0 * total


def ring_profile(r: torch.Tensor) -> torch.Tensor:
    """noisy_color_rings_2d.wgsl:116-120: sin(r*sqrt(r)*pi)^2."""
    f = torch.sin(r * torch.sqrt(torch.clamp_min(r, 0.0)) * math.pi)
    return f * f


def pitch_indicator_center_dot(r: torch.Tensor, pitch_accuracy: torch.Tensor, time: float) -> torch.Tensor:
    """Active option 1 (wgsl:126-141): white center dot above accuracy 0.85,
    pulsing at 3 rad/s."""
    threshold = 0.85
    accuracy_factor = exact_div(pitch_accuracy - threshold, 1.0 - threshold)
    dot_falloff = _smoothstep(0.08, 0.0, r)
    lit = torch.where(pitch_accuracy < threshold, 0.0, accuracy_factor)
    return dot_falloff * lit * _pulse(time, 0.85, 0.15)


def tuning_indicator(uv_x, uv_y, r, pitch_deviation, time: float) -> torch.Tensor:
    """Active option 1 (wgsl:231-260): 6-pointed spiral star; sharp spirals
    clockwise, flat counterclockwise."""
    angle = torch.atan2(uv_y, uv_x)
    star_angle = angle * 6.0
    spiral_angle = star_angle + r * (pitch_deviation * 4.0) * math.pi * 4.0
    star_intensity = torch.clamp_min(torch.cos(spiral_angle), 0.0) * (1.0 - _smoothstep(0.15, 0.25, r))
    accuracy = 1.0 - torch.abs(pitch_deviation) * 2.0
    brightness = (0.3 + (1.0 - 0.3) * accuracy) * _pulse(time, 0.7, 0.3)  # mix(0.3, 1.0, accuracy)
    out = star_intensity * brightness
    return torch.where((r > 0.25) | (r < 0.01), 0.0, out)


def ball_fragment(uv_x, uv_y, mat_rgb_linear, mat_a, calmness, time: float, pitch_accuracy, pitch_deviation):
    """The full fragment (wgsl:395-429) at shader-local uv in [-1,1]^2.
    ``mat_rgb_linear`` is the material color in LINEAR space (Bevy converts
    the sRGB uniform before upload), with a trailing rgb axis; returns
    (rgb_linear, alpha)."""
    mesh_u = (uv_x + 1.0) * 0.5
    mesh_v = (uv_y + 1.0) * 0.5
    r = torch.sqrt(uv_x * uv_x + uv_y * uv_y)

    f_noise_raw = simplex_noise3(mesh_u * 4.3, mesh_v * 4.3, float(np.float32(time) * np.float32(0.8)))
    f_noise = torch.clamp(f_noise_raw - 0.15, 0.0, 1.0)
    f_ring = ring_profile(r)

    mix_t = (f_noise * calmness * f_ring)[..., None]
    ring_rgb = mat_rgb_linear * (1.0 - mix_t) + 1.0 * mix_t
    ring_a = mat_a * f_ring

    acc = pitch_indicator_center_dot(r, pitch_accuracy, time)
    tun = tuning_indicator(uv_x, uv_y, r, pitch_deviation, time)
    final_rgb = ring_rgb + ((acc + tun) * 0.4)[..., None]

    c = torch.clamp(1.0 - calmness * 1.65, 0.0, 1.0)
    ring_strength = c * c * c
    rs_rgb = ring_strength[..., None]  # broadcast vs the rgb axis
    out_rgb = mat_rgb_linear * (1.0 - rs_rgb) + final_rgb * rs_rgb
    out_a = mat_a * (1.0 - ring_strength) + ring_a * ring_strength

    edge = _smoothstep(0.96, 1.0, r)
    return out_rgb, out_a * (1.0 - edge)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Frozen raster parameters. ``ball_patch`` is the square pixel tile
    each ball renders into; balls whose on-screen radius exceeds patch/2 are
    clipped at the tile edge (at the default 360p a ball needs scale > ~0.19
    to clip, beyond anything the serving chain produces). ``max_balls``
    bounds how many balls shade per frame: the K frontmost visible ones;
    overflow drops the backmost (smallest)."""

    width: int = 640
    height: int = 360
    viewport_height: float = VIEWPORT_HEIGHT
    ball_patch: int = 96
    max_balls: int = 64
    with_bloom: bool = True
    with_net: bool = True
    with_bass: bool = True
    with_pitch_names: bool = True
    clear_color: tuple = CLEAR_COLOR

    @classmethod
    def for_mode(cls, visuals_mode: str = "full", **kw) -> "RenderConfig":
        """Config for a SettingsState.visuals_mode: Galaxy uses the galaxy
        clear color (update.rs:908-916) and hides the bass spiral
        (update.rs:374-376); zen/full/performance use the neutral clear
        color. Pitch names show in Full and Performance only
        (update.rs:871-885). (Performance also shrinks balls 0.7x; that
        lives in viewer.update_balls(ball_scale_factor=0.7), not here.)"""
        mode = str(getattr(visuals_mode, "value", visuals_mode)).lower()
        if mode == "galaxy":
            kw.setdefault("clear_color", CLEAR_COLOR_GALAXY)
            kw.setdefault("with_bass", False)
        if mode not in ("full", "performance"):
            kw.setdefault("with_pitch_names", False)
        return cls(**kw)

    @property
    def pixel_size(self) -> float:
        return self.viewport_height / self.height

    # The raster is computed at multiple-of-8 dimensions and cropped before
    # the bloom, as the JAX package does: the two packages then composite
    # on the same raster.
    @property
    def padded_width(self) -> int:
        return (self.width + 7) // 8 * 8

    @property
    def padded_height(self) -> int:
        return (self.height + 7) // 8 * 8


def _pixel_grid(cfg: RenderConfig):
    """World coordinates of pixel centers over the PADDED raster; x right,
    y up, origin at the center of the visible (unpadded) image. Padding
    rows/cols extend the grid beyond the right/bottom edge and are cropped
    after rendering."""
    s = cfg.pixel_size
    xs = (np.arange(cfg.padded_width) - (cfg.width - 1) / 2.0) * s
    ys = ((cfg.height - 1) / 2.0 - np.arange(cfg.padded_height)) * s
    return xs.astype(np.float32), ys.astype(np.float32)


def _segment_coverage(xs, ys, p0, p1, half_width, aa):
    """Antialiased coverage of a thick segment over the pixel grid (NumPy,
    precompute only)."""
    px = xs[None, :] - p0[0]
    py = ys[:, None] - p0[1]
    dx, dy = p1[0] - p0[0], p1[1] - p0[1]
    seg_len2 = max(dx * dx + dy * dy, 1e-12)
    t = np.clip((px * dx + py * dy) / seg_len2, 0.0, 1.0)
    qx = px - t * dx
    qy = py - t * dy
    d = np.sqrt(qx * qx + qy * qy)
    return np.clip((half_width + 0.5 * aa - d) / aa, 0.0, 1.0)


def _scale_bitmap(cov_u8: np.ndarray, s: float):
    """Downscale a u8 coverage bitmap by factor ``s`` (< 1): 2x box
    reductions while the remaining factor is below 0.5, then one bilinear
    resample to the exact target size. Returns ``(coverage [0,1], a, b)``
    where original pixel coordinate p maps to output coordinate ``a*p + b``
    (needed to place the glyph center)."""
    cov = cov_u8.astype(np.float32) / 255.0
    a, b = 1.0, 0.0
    while s < 0.5:
        h2, w2 = cov.shape[0] // 2 * 2, cov.shape[1] // 2 * 2
        cov = cov[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))
        a, b = a / 2.0, (b - 0.5) / 2.0  # box reduce: p' = (p - 0.5) / 2
        s *= 2.0
    h_out = max(int(round(cov.shape[0] * s)), 1)
    w_out = max(int(round(cov.shape[1] * s)), 1)
    yi = (np.arange(h_out) + 0.5) / s - 0.5
    xi = (np.arange(w_out) + 0.5) / s - 0.5
    y0 = np.clip(np.floor(yi).astype(np.int64), 0, cov.shape[0] - 1)
    y1 = np.clip(y0 + 1, 0, cov.shape[0] - 1)
    x0 = np.clip(np.floor(xi).astype(np.int64), 0, cov.shape[1] - 1)
    x1 = np.clip(x0 + 1, 0, cov.shape[1] - 1)
    fy = np.clip(yi - y0, 0.0, 1.0)[:, None].astype(np.float32)
    fx = np.clip(xi - x0, 0.0, 1.0)[None, :].astype(np.float32)
    out = (
        cov[y0][:, x0] * (1 - fy) * (1 - fx)
        + cov[y0][:, x1] * (1 - fy) * fx
        + cov[y1][:, x0] * fy * (1 - fx)
        + cov[y1][:, x1] * fy * fx
    )
    # bilinear stage: p'' = (p' + 0.5) * s - 0.5
    return out, a * s, (b + 0.5) * s - 0.5


def _stamp_bitmap(premul, alpha, cov, rgb_linear, row0: float, col0: float):
    """Alpha-composites a coverage bitmap (top-left at float raster coords
    (row0, col0)) into the premultiplied layer arrays in place, with
    bilinear subpixel placement and edge clipping."""
    ri, rf = int(np.floor(row0)), row0 - np.floor(row0)
    ci, cf = int(np.floor(col0)), col0 - np.floor(col0)
    pad = np.pad(cov, ((1, 1), (1, 1)))
    shifted = (
        pad[1:, 1:] * (1 - rf) * (1 - cf)
        + pad[1:, :-1] * (1 - rf) * cf
        + pad[:-1, 1:] * rf * (1 - cf)
        + pad[:-1, :-1] * rf * cf
    )[: cov.shape[0] + 1, : cov.shape[1] + 1]
    h, w = shifted.shape
    hp, wp = alpha.shape[0], alpha.shape[1]
    r0, c0 = max(ri, 0), max(ci, 0)
    r1, c1 = min(ri + h, hp), min(ci + w, wp)
    if r1 <= r0 or c1 <= c0:
        return
    sub = shifted[r0 - ri : r1 - ri, c0 - ci : c1 - ci, None]
    premul[r0:r1, c0:c1] = rgb_linear * sub + premul[r0:r1, c0:c1] * (1.0 - sub)
    alpha[r0:r1, c0:c1] = sub + alpha[r0:r1, c0:c1] * (1.0 - sub)


def _srgb_to_linear_np(rgb) -> np.ndarray:
    return srgb_to_linear(torch.as_tensor(np.asarray(rgb, np.float32))).numpy()


class SceneStatics:
    """Per-(config, range, device) raster data: the linear-space background
    (clear color + spider net), the bass-spiral segment index map (nearest
    cylinder per pixel, -1 where none) + coverage, and the static pitch-name
    overlay layer. Built with NumPy on the host and copied to ``device``
    once."""

    def __init__(self, cfg: RenderConfig, rng: VqtRange, device: torch.device):
        xs, ys = _pixel_grid(cfg)
        aa = cfg.pixel_size
        clear = _srgb_to_linear_np(cfg.clear_color)
        hp, wp = cfg.padded_height, cfg.padded_width
        background = np.broadcast_to(clear, (hp, wp, 3)).astype(np.float32).copy()

        # visual spiral points: 72 per octave (setup.rs:47-48)
        n_vis = rng.octaves * 12 * SPIRAL_SEGMENTS_PER_SEMITONE
        vx, vy = bin_to_spiral(12 * SPIRAL_SEGMENTS_PER_SEMITONE, np.arange(n_vis, dtype=np.float32))
        vx, vy = vx.numpy(), vy.numpy()

        if cfg.with_net:
            cov = np.zeros((hp, wp), np.float32)
            radius = rng.octaves * 2.2  # setup.rs:184
            for i in range(12):
                a = i / 12.0 * 2.0 * math.pi
                p1 = (radius * math.cos(a), radius * math.sin(a))
                cov = np.maximum(cov, _segment_coverage(xs, ys, (0.0, 0.0), p1, NET_THICKNESS / 2, aa))
            for i in range(n_vis - 1):
                cov = np.maximum(
                    cov,
                    _segment_coverage(xs, ys, (vx[i], vy[i]), (vx[i + 1], vy[i + 1]), NET_THICKNESS / 2, aa),
                )
            net = _srgb_to_linear_np(NET_COLOR)
            background = background * (1.0 - cov[..., None]) + net * cov[..., None]

        n_cyl = bass_cylinder_count(rng.octaves)
        bass_idx = np.full((hp, wp), -1, np.int32)
        bass_cov = np.zeros((hp, wp), np.float32)
        if cfg.with_bass:
            for i in range(n_cyl):
                p0 = np.array([vx[i], vy[i]])
                p1 = np.array([vx[i + 1], vy[i + 1]])
                d = p1 - p0
                nrm = d / max(np.hypot(*d), 1e-9)
                # the cylinder rect is (h + 0.01) long: extend half per end
                c = _segment_coverage(
                    xs, ys, tuple(p0 - nrm * BASS_END_EXTENSION), tuple(p1 + nrm * BASS_END_EXTENSION),
                    BASS_WIDTH / 2, aa,
                )
                take = c > bass_cov
                bass_idx[take] = i
                bass_cov[take] = c[take]

        # pitch-name ring (setup.rs:386-416): 12 static Text2d entities,
        # DejaVuSans 40px scaled 0.02, centered on the outermost 12 visual-
        # spiral points squashed by (0.85 + 0.025*|x|), colored with the
        # pitch-class palette, in front of the balls; baked from the glyph
        # atlas into a premultiplied layer
        self.text_premul = self.text_a = None
        if cfg.with_pitch_names:
            layer = self._pitch_name_layer(cfg, rng, xs, ys)
            if layer is not None:
                self.text_premul = torch.from_numpy(layer[0]).to(device)
                self.text_a = torch.from_numpy(layer[1]).to(device)

        self.background = torch.from_numpy(np.ascontiguousarray(background, np.float32)).to(device)
        self.bass_idx = torch.from_numpy(bass_idx).to(device)
        self.bass_cov = torch.from_numpy(bass_cov).to(device)
        self.n_cylinders = n_cyl

    @staticmethod
    def _pitch_name_layer(cfg: RenderConfig, rng: VqtRange, xs, ys):
        """Rasterizes the 12 pitch-name glyphs into one premultiplied (rgb,
        alpha) overlay layer, or None if the atlas is missing."""
        from .glyph_atlas import ATLAS_FONT_PX, REFERENCE_FONT_PX, load_atlas

        atlas = load_atlas()
        if atlas is None:
            warnings.warn(
                "pitch-name atlas missing; run `python -m pitchvis_tpu_torch.models.glyph_atlas` to regenerate",
                stacklevel=2,
            )
            return None
        hp, wp = cfg.padded_height, cfg.padded_width
        H, W = cfg.height, cfg.width
        s = cfg.pixel_size
        # raster px per atlas px: Text2d scale 0.02 applied to the 40px
        # font, atlas rendered at ATLAS_FONT_PX
        scale = 0.02 * (REFERENCE_FONT_PX / ATLAS_FONT_PX) / s
        # outermost 12 points of the (octaves, 12) spiral (setup.rs:395-397)
        tx, ty = bin_to_spiral(12, np.arange((rng.octaves - 1) * 12, rng.octaves * 12, dtype=np.float32))
        tx, ty = tx.numpy(), ty.numpy()
        premul = np.zeros((hp, wp, 3), np.float32)
        alpha = np.zeros((hp, wp, 1), np.float32)
        for idx in range(12):
            pitch_idx = (idx + 12 - 3) % 12  # setup.rs:398
            x, y = tx[idx], ty[idx]
            squash = 0.85 + 0.025 * abs(x)  # setup.rs:401
            x, y = x * squash, y * squash
            bitmap, center = atlas[pitch_idx]
            cov, a_lin, b_off = _scale_bitmap(bitmap, scale)
            # glyph layout-box center -> raster pixel position
            col_c = x / s + (W - 1) / 2.0
            row_c = (H - 1) / 2.0 - y / s
            col0 = col_c - (a_lin * float(center[0]) + b_off)
            row0 = row_c - (a_lin * float(center[1]) + b_off)
            _stamp_bitmap(premul, alpha, cov, _srgb_to_linear_np(COLORS[pitch_idx]), row0, col0)
        return premul, alpha


def make_scene(cfg: RenderConfig, rng: VqtRange, device="cuda") -> SceneStatics:
    """The scene's static layers for ``cfg`` and ``rng`` on ``device`` (the
    card unless ``device="cpu"``), built once and cached: the first call
    for a device copies to it."""
    return _make_scene(cfg, rng, resolve_device(device))


@functools.lru_cache(maxsize=8)
def _make_scene(cfg: RenderConfig, rng: VqtRange, device: torch.device) -> SceneStatics:
    return SceneStatics(cfg, rng, device)


def _resample_matrix(n_out: int, n_in: int, taps, texel_offsets=True) -> np.ndarray:
    """1-D clamp-to-edge bilinear resampling operator M (n_out, n_in):
    ``M @ x`` equals GPU-sampler bilinear sampling of x at every output
    pixel center, summed over ``taps`` = [(offset, weight), ...]. Offsets
    are in SOURCE texels (``texel_offsets=True``, the WGSL
    ``textureSample(..., offset)`` convention) or source-texture UV units.
    Expressing the taps as dense operators turns the whole bloom pyramid
    into pairs of small products (one per axis)."""
    m = np.zeros((n_out, n_in), np.float64)
    for off, w in taps:
        o = off if texel_offsets else off * n_in
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5 + o
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        i0 = np.clip(i0, 0, n_in - 1)
        np.add.at(m, (np.arange(n_out), i0), w * (1.0 - frac))
        np.add.at(m, (np.arange(n_out), i1), w * frac)
    return m.astype(np.float32)


def _bloom_mip_sizes(view_w: int, view_h: int):
    """bevy_core_pipeline bloom texture sizing: internal height capped at
    MAX_MIP_DIMENSION (512), width scaled to keep the viewport aspect,
    BLOOM_MIP_COUNT mips halving from there."""
    w0 = max(int(round(view_w * BLOOM_MAX_MIP_DIMENSION / view_h)), 1)
    return [(max(w0 >> i, 1), max(BLOOM_MAX_MIP_DIMENSION >> i, 1)) for i in range(BLOOM_MIP_COUNT)]


# The 13-tap downsample filter (Jimenez SIGGRAPH 2014, as shipped in Bevy's
# bloom downsampling shader): center/edge/corner weights 0.125/0.0625/
# 0.03125 on the +-2 texel grid plus 0.125 on each +-1 diagonal. Both tap
# groups factor exactly into per-axis 1-D kernels (the +-1 group:
# sqrt(0.125) per axis tap; the +-2 group: 4:2:1 weights scaling to
# 0.03125 at the corners), which is what makes the separable form exact.
_DOWN_INNER_1D = [(-1.0, math.sqrt(0.125)), (1.0, math.sqrt(0.125))]
_DOWN_OUTER_1D = [(-2.0, math.sqrt(0.03125)), (0.0, 2.0 * math.sqrt(0.03125)), (2.0, math.sqrt(0.03125))]


@functools.lru_cache(maxsize=8)
def _bloom_ops(view_w: int, view_h: int):
    """Per-(view size) static operator matrices of the bloom pyramid (NumPy):
    downsample pairs (inner + outer 13-tap groups) and tent-upsample pairs
    per mip transition, each pair (rows (n_out, n_in), columns^T (w_in,
    w_out))."""
    sizes = [(view_w, view_h)] + _bloom_mip_sizes(view_w, view_h)
    down = []
    for (w_in, h_in), (w_out, h_out) in zip(sizes[:-1], sizes[1:]):
        down.append(tuple(
            (_resample_matrix(h_out, h_in, taps), _resample_matrix(w_out, w_in, taps).T)
            for taps in (_DOWN_INNER_1D, _DOWN_OUTER_1D)
        ))
    # upsampling tent: 0.004 UV radius, x scaled by the viewport aspect
    # ratio (Bevy's uniforms.aspect), weights (0.25, 0.5, 0.25) per axis
    aspect = view_w / view_h
    up = []
    for (w_in, h_in), (w_out, h_out) in zip(sizes[::-1][:-1], sizes[::-1][1:]):
        taps_y = [(-0.004, 0.25), (0.0, 0.5), (0.004, 0.25)]
        taps_x = [(-0.004 / aspect, 0.25), (0.0, 0.5), (0.004 / aspect, 0.25)]
        up.append((
            _resample_matrix(h_out, h_in, taps_y, texel_offsets=False),
            _resample_matrix(w_out, w_in, taps_x, texel_offsets=False).T,
        ))
    return down, up


@functools.lru_cache(maxsize=8)
def _bloom_tables(view_w: int, view_h: int, device: torch.device):
    """``_bloom_ops`` as contiguous float32 tensors on ``device``, copied
    once."""
    down, up = _bloom_ops(view_w, view_h)

    def t(m):
        return torch.from_numpy(np.ascontiguousarray(m)).to(device)

    return ([tuple((t(my), t(mxT)) for my, mxT in level) for level in down],
            [(t(my), t(mxT)) for my, mxT in up])


_MATMUL_LOCK = threading.Lock()


@contextlib.contextmanager
def _full_f32_matmul(device: torch.device):
    """On the card, float32 products in IEEE float32 (no TF32) for the
    duration, whatever the caller set, restored after: the JAX package's
    bloom asks for Precision.HIGHEST. The setting is process-wide, so the
    render takes a lock around it; a product on another thread meanwhile
    also runs in full float32."""
    if device.type != "cuda":
        yield
        return
    with _MATMUL_LOCK:
        prev = torch.backends.cuda.matmul.fp32_precision
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.fp32_precision = prev


def _apply_pair(x: torch.Tensor, pair) -> torch.Tensor:
    """(B, 3, H_in, W_in) -> (B, 3, H_out, W_out) by the separable operator
    pair: one product over the rows (batched, the operator shared) and one
    over the columns (a single product of all rows)."""
    my, mxT = pair
    return torch.matmul(torch.matmul(my, x), mxT)


def _bloom_blend_factor(intensity, mip: float, max_mip: float):
    """Bevy's compute_blend_factor for the reference's settings
    (setup.rs:367-377: low_frequency_boost 1.0, curvature 1.0, high-pass
    0.52, Additive). curvature=1.0 makes the boost exponent infinite:
    (1 - mip/max)^inf is 1.0 at mip 0 and 0.0 beyond (IEEE pow), so the
    composite weight is ``intensity`` at the finest mip and
    (intensity + 1) * high_pass(mip) below."""
    frac = mip / max_mip
    powed = 1.0 if frac <= 0.0 else 0.0
    lf_boost = (1.0 - powed) * BLOOM_LF_BOOST  # Additive: no (1-I) scaling
    high_pass = 1.0 - min(max((frac - BLOOM_HIGH_PASS) / BLOOM_HIGH_PASS, 0.0), 1.0)
    return (intensity + lf_boost) * high_pass


def _per_stream(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def _bloom(img: torch.Tensor, intensity: torch.Tensor, view_w: int, view_h: int) -> torch.Tensor:
    """Bevy's mip-chain bloom (bevy_core_pipeline/src/bloom, behind the
    reference's Bloom component, setup.rs:367-377), as separable products:

    * 13-tap downsample pyramid at the fixed 512-high internal resolution,
      first level clamped to [1e-4, 3.4e38] and soft-thresholded with the
      published knee curve (threshold 0.17, softness 0.82),
    * 3x3 tent upsampling (0.004 UV radius, aspect-corrected),
    * per-mip composite weights from compute_blend_factor, applied through
      one accumulating upsample chain, Additive composite into the view.

    ``img`` is the VISIBLE linear view (B, 3, H, W); ``intensity`` (B,) is
    1.3 * scene_calmness clamped (update.rs:336-351)."""
    down, up = _bloom_tables(view_w, view_h, img.device)
    with _full_f32_matmul(img.device):
        inner, outer = down[0]
        m0 = _apply_pair(img, inner) + _apply_pair(img, outer)
        m0 = torch.clamp(m0, 1e-4, _f32(3.40282347e38))
        knee = BLOOM_THRESHOLD * min(max(BLOOM_SOFTNESS, 0.0), 1.0)
        brightness = m0.amax(dim=1, keepdim=True)
        softness = torch.clamp(brightness - (BLOOM_THRESHOLD - knee), 0.0, 2.0 * knee)
        softness = softness * softness * (0.25 / (knee + 0.00001))
        contribution = torch.maximum(brightness - BLOOM_THRESHOLD, softness)
        contribution = contribution / torch.clamp_min(brightness, 0.00001)
        m0 = m0 * contribution

        mips = [m0]
        for inner, outer in down[1:]:
            mips.append(_apply_pair(mips[-1], inner) + _apply_pair(mips[-1], outer))

        max_mip = float(BLOOM_MIP_COUNT - 1)
        v = mips[-1] * _per_stream(_bloom_blend_factor(intensity, max_mip, max_mip))
        for i, pair in enumerate(up[:-1]):
            mip_idx = BLOOM_MIP_COUNT - 2 - i
            v = _apply_pair(v, pair) + mips[mip_idx] * _per_stream(
                _bloom_blend_factor(intensity, float(mip_idx), max_mip)
            )
        return img + _apply_pair(v, up[-1])


def _tonemap(img: torch.Tensor) -> torch.Tensor:
    """Bevy's ``Tonemapping::SomewhatBoringDisplayTransform`` (setup.rs:358),
    Stachowiak's SBDT as shipped in Bevy's tonemapping.wgsl, on (B, 3, H, W):
    luminance tonemapped by 1-exp(-v), bright saturated colors desaturated
    toward luma via the BT.709 YCbCr chroma magnitude, blended by bt^2,
    final 0.97 multiplier."""
    col = torch.clamp_min(img, 0.0)
    r, g, b = col[:, 0], col[:, 1], col[:, 2]
    # rgb_to_ycbcr (BT.709 matrix, column-major in the WGSL)
    y = 0.2126 * r + 0.7152 * g + 0.0722 * b
    cb = -0.1146 * r - 0.3854 * g + 0.5 * b
    cr = 0.5 * r - 0.4542 * g - 0.0458 * b

    def curve(v):
        return 1.0 - torch.exp(-v)

    bt = curve(torch.sqrt(cb * cb + cr * cr) * 2.4)
    desat = torch.clamp_min((bt - 0.7) * 0.8, 0.0)
    desat = (desat * desat)[:, None]
    desat_col = col * (1.0 - desat) + y[:, None] * desat
    tm_luma = curve(y)
    tm0 = col * torch.clamp_min(tm_luma / torch.clamp_min(y, 1e-5), 0.0)[:, None]
    tm1 = curve(desat_col)
    w = (bt * bt)[:, None]
    return (tm0 * (1.0 - w) + tm1 * w) * 0.97


@dataclasses.dataclass
class DebugInputs:
    """Per-frame data for the Debugging display mode's overlay panels
    (update.rs: spectrum 474-638, scene-calmness graph 640-744, calmness
    histogram 745-869, spectrogram 1007-1087, chroma 1090-1144), each with
    the stream axis first."""

    x_vqt_smoothed: torch.Tensor  # (B, n)
    peaks: torch.Tensor  # (B, n) bool
    peak_center: torch.Tensor  # (B, n)
    peak_size: torch.Tensor  # (B, n)
    calmness: torch.Tensor  # (B, n)
    graph_values: torch.Tensor  # (B, capacity) scene calmness oldest->newest
    spectrogram: torch.Tensor  # (B, height, n, 4) u8 circular rows
    spectrogram_write_index: torch.Tensor  # (B,) int32
    chroma: torch.Tensor  # (B, 12)


def _colors_table() -> torch.Tensor:
    return torch.from_numpy(COLORS.copy())


def _srgb_u8_table() -> torch.Tensor:
    """(256,) linear value of each 8-bit sRGB level (Rgba8UnormSrgb
    sampling)."""
    return srgb_to_linear(exact_div(torch.arange(256, dtype=torch.float32), 255.0))


def _calmness_palette_linear() -> torch.Tensor:
    return srgb_to_linear(_calmness_palette())


def _spectrum_segment_colors(rng: VqtRange) -> torch.Tensor:
    """(n-1, 3) linear color of each spectrum segment: bucket
    (i+0.5+rot)%bpo with easing_pow 10.0 (update.rs:516-580)."""
    bpo = rng.buckets_per_octave
    segi = torch.arange(rng.n_buckets - 1, dtype=torch.float32)
    bucket = torch.remainder(segi + 0.5 + pitch_color_rotation(bpo), bpo)
    return srgb_to_linear(calculate_color(bpo, bucket, COLORS, GRAY_LEVEL, 10.0))


def _calmness_linear(calmness: torch.Tensor) -> torch.Tensor:
    """viewer.calmness_to_color, decoded to linear, by a static table."""
    level = (calmness > 0.3).to(torch.int64) + (calmness > 0.7).to(torch.int64)
    return static_table(_calmness_palette_linear, device=calmness.device)[level]


def _overlay_polyline(cfg, img, x0, dx, ys_world, seg_rgb_lin, seg_alpha, thickness):
    """Alpha-blends one polyline a stream onto the (B, Hp, Wp, 3) linear
    raster by column sampling: point i sits at (x0 + i*dx, ys_world[:, i]);
    segment attributes (B or none, n-1) color/alpha. Lines thinner than a
    pixel draw one antialiased pixel row."""
    s = cfg.pixel_size
    H, W = cfg.height, cfg.width
    Hp, Wp = cfg.padded_height, cfg.padded_width
    dev = img.device
    n = ys_world.shape[-1]
    colw = (torch.arange(Wp, dtype=torch.float32, device=dev) - (W - 1) / 2.0) * s
    f = exact_div(colw - x0, dx)
    valid = (f >= 0.0) & (f <= n - 1.0)
    i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, n - 2)
    t = torch.clamp(f - i0.to(torch.float32), 0.0, 1.0)
    y = ys_world[:, i0] * (1.0 - t) + ys_world[:, i0 + 1] * t  # (B, Wp)
    rgb = seg_rgb_lin[..., i0, :]  # (B or none, Wp, 3)
    a_col = seg_alpha[..., i0] * valid.to(torch.float32)  # (B or none, Wp)
    roww = ((H - 1) / 2.0 - torch.arange(Hp, dtype=torch.float32, device=dev)) * s
    near = float(np.float32(max(thickness * 0.5, s * 0.5)) + np.float32(0.5 * s))
    cov = torch.clamp(exact_div(near - torch.abs(roww[:, None] - y[:, None, :]), s), 0.0, 1.0)
    a = (cov * a_col[..., None, :])[..., None]
    return rgb[..., None, :, :] * a + img * (1.0 - a)


def _spectrum_panel_origin(cfg: RenderConfig, rng: VqtRange):
    """update.rs:495-501: top-right anchored at (max.x - n*0.011 - 0.2,
    max.y - 4.2) of the orthographic view area."""
    max_x = cfg.viewport_height * cfg.width / cfg.height / 2.0
    max_y = cfg.viewport_height / 2.0
    return max_x - rng.n_buckets * 0.011 - 0.2, max_y - 4.2


def _debug_world_panels(cfg: RenderConfig, rng: VqtRange, img: torch.Tensor, d: DebugInputs) -> torch.Tensor:
    """The debug meshes under the balls: spectrum line + peak circles
    (update.rs:474-638), the mirrored calmness histogram (745-869) and the
    scene-calmness graph (640-744)."""
    n = rng.n_buckets
    bpo = rng.buckets_per_octave
    rot = pitch_color_rotation(bpo)
    x0, y0 = _spectrum_panel_origin(cfg, rng)
    dev = img.device
    B = img.shape[0]

    # spectrum: points (i*0.011, v/10); segment i colored at bucket
    # (i+0.5+rot)%bpo with easing_pow 10.0 and alpha
    # 1-(0.5 - v_i/max/2)^0.5 (update.rs:516-580)
    v = d.x_vqt_smoothed
    vmax = torch.clamp_min(v.amax(dim=-1, keepdim=True), 1e-30)
    seg_rgb = static_table(_spectrum_segment_colors, rng, device=dev)
    seg_alpha = 1.0 - torch.sqrt(torch.clamp(0.5 - v[:, :-1] / vmax / 2.0, 0.0, 1.0))
    img = _overlay_polyline(cfg, img, x0, 0.011, y0 + exact_div(v, 10.0), seg_rgb, seg_alpha, 0.02)

    # peak circles: filled disks r=0.08 at (center*0.011, size/10), colored
    # at bucket (round(center)+0.5+rot)%bpo, alpha 0.9 (update.rs:582-616);
    # the first KP peaks in bin order, drawn in that order
    s = cfg.pixel_size
    H, W = cfg.height, cfg.width
    Hp, Wp = cfg.padded_height, cfg.padded_width
    KP = min(16, n)
    order = torch.argsort(-d.peaks.to(torch.float32), dim=-1, stable=True)[:, :KP]
    gate = d.peaks.gather(1, order).to(torch.float32)
    center = d.peak_center.gather(1, order)
    pxw = x0 + center * 0.011
    pyw = y0 + exact_div(d.peak_size.gather(1, order), 10.0)
    pbucket = torch.remainder(rust_round(center) + 0.5 + rot, bpo)
    prgb = srgb_to_linear(calculate_color(bpo, pbucket, COLORS, GRAY_LEVEL, 10.0))  # (B, KP, 3)
    PR = 0.08
    P2 = min(max(int(2.0 * PR / s) + 3, 4), Hp, Wp)
    ci = torch.clamp(torch.round(exact_div(pxw, s) + (W - 1) / 2.0).to(torch.int32) - P2 // 2, 0, max(Wp - P2, 0))
    cj = torch.clamp(torch.round((H - 1) / 2.0 - exact_div(pyw, s)).to(torch.int32) - P2 // 2, 0, max(Hp - P2, 0))
    dp = torch.arange(P2, dtype=torch.float32, device=dev)
    wxp = (ci[..., None].to(torch.float32) + dp - (W - 1) / 2.0) * s  # (B, KP, P2)
    wyp = ((H - 1) / 2.0 - cj[..., None].to(torch.float32) - dp) * s
    ddx = (wxp - pxw[..., None])[:, :, None, :]
    ddy = (wyp - pyw[..., None])[:, :, :, None]
    rr = torch.sqrt(ddx * ddx + ddy * ddy)  # (B, KP, P2, P2)
    cov = torch.clamp(exact_div((PR + 0.5 * s) - rr, s), 0.0, 1.0)
    pa = cov * 0.9 * gate[..., None, None]
    # one color a disk: a broadcast view, no copy
    img = composite_patches(img, prgb[:, :, None, None, :].expand(B, KP, P2, P2, 3), pa, ci, cj)

    # calmness histogram: the same anchor, y mirrored (scale (1,-1,1)),
    # heights calmness*0.5, midpoint threshold colors (update.rs:773-846)
    mid = (d.calmness[:, :-1] + d.calmness[:, 1:]) * 0.5
    ones = torch.ones((B, n - 1), dtype=torch.float32, device=dev)
    img = _overlay_polyline(cfg, img, x0, 0.011, y0 - d.calmness * 0.5, _calmness_linear(mid), ones, 0.01)

    # scene-calmness graph at (-5, -6.5), scale (3, 1): x = i/cap - 0.5,
    # segment color keyed off the OLDER endpoint (update.rs:663-688)
    cap = d.graph_values.shape[-1]
    img = _overlay_polyline(
        cfg, img, -5.0 - 1.5, 3.0 / cap, -6.5 + d.graph_values, _calmness_linear(d.graph_values[:, :-1]),
        torch.ones((B, cap - 1), dtype=torch.float32, device=dev), 0.01,
    )
    return img


def _blit_spectrogram(cfg: RenderConfig, rng: VqtRange, img: torch.Tensor, d: DebugInputs) -> torch.Tensor:
    """The spectrogram display quad (setup.rs:493-515: center (-7, 6) above
    the balls, frequency axis vertical spanning 12 world units with low bins
    at the bottom, time horizontal with the newest row at the right edge:
    spectrogram_scroll.wgsl's fract(v + 1 - write_index/height) scroll,
    nearest sampling)."""
    tex = d.spectrogram
    Hs = tex.shape[1]
    n = rng.n_buckets
    vis_h = 12.0
    vis_w = vis_h * Hs / n  # setup.rs:498-499
    s = cfg.pixel_size
    H, W = cfg.height, cfg.width
    Hp, Wp = cfg.padded_height, cfg.padded_width
    dev = img.device
    colw = (torch.arange(Wp, dtype=torch.float32, device=dev) - (W - 1) / 2.0) * s
    roww = ((H - 1) / 2.0 - torch.arange(Hp, dtype=torch.float32, device=dev)) * s
    u = exact_div(colw - (-7.0 - vis_w / 2.0), vis_w)  # 0 left -> 1 right
    vf = exact_div(roww - (6.0 - vis_h / 2.0), vis_h)  # 0 bottom -> 1 top
    valid = ((u >= 0.0) & (u < 1.0))[None, :] & ((vf >= 0.0) & (vf < 1.0))[:, None]
    bin_idx = torch.clamp(torch.round(vf * (n - 1)).to(torch.int64), 0, n - 1)
    # newest row (write_index-1) at u=1; the cleared next line at u=0
    back = torch.round((1.0 - u) * (Hs - 1)).to(torch.int64)
    trow = torch.remainder(d.spectrogram_write_index.to(torch.int64)[:, None] - 1 - back, Hs)  # (B, Wp)
    streams = torch.arange(tex.shape[0], device=dev)[:, None, None]
    px = tex[streams, trow[:, None, :], bin_idx[None, :, None]]  # (B, Hp, Wp, 4) u8
    a = (exact_div(px[..., 3].to(torch.float32), 255.0) * valid.to(torch.float32))[..., None]
    rgb = static_table(_srgb_u8_table, device=dev)[px[..., :3].to(torch.int64)]  # Rgba8UnormSrgb texture
    return rgb * a + img * (1.0 - a)


def _chroma_boxes(cfg: RenderConfig, srgb_img: torch.Tensor, chroma: torch.Tensor) -> torch.Tensor:
    """The 12 chroma UI boxes (setup.rs:518-540: 40px squares at
    left=400+45*pc, bottom=10 in the reference's UI pixels, scaled here by
    height/720; alpha = normalized pitch-class power, update.rs:1133-1144)
    on the (B, 3, H, W) display sRGB image: UI draws after tonemapping.
    Border radius and the 0.5-alpha border are not rasterized."""
    u = cfg.height / 720.0
    H, W = cfg.height, cfg.width
    dev = srgb_img.device
    rows = torch.arange(srgb_img.shape[2], dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(srgb_img.shape[3], dtype=torch.float32, device=dev)[None, :]
    colors = static_table(_colors_table, device=dev)
    for pc in range(12):
        left = (400.0 + 45.0 * pc) * u
        size = 40.0 * u
        top = H - (10.0 + 40.0) * u
        mask = (rows >= top) & (rows < top + size) & (cols >= left) & (cols < left + size) & (rows < H) & (cols < W)
        a = torch.where(mask, chroma[:, pc, None, None], 0.0)[:, None]  # (B, 1, H, W)
        srgb_img = colors[pc][None, :, None, None] * a + srgb_img * (1.0 - a)
    return srgb_img


# ---- the frame, in stages ---------------------------------------------------


def layers_under(cfg: RenderConfig, rng: VqtRange, st: SceneStatics, bass: BassSpiralOutputs,
                 debug: DebugInputs | None) -> torch.Tensor:
    """(B, Hp, Wp, 3) linear raster under the balls: the background, the
    bass spiral (a pixel is lit iff its segment index is below the stream's
    lit count) and the debug world panels."""
    B = bass.rgba.shape[0]
    img = st.background.expand(B, *st.background.shape)
    if cfg.with_bass:
        n_lit = bass.visible.sum(dim=-1, dtype=torch.int32)
        lit = (st.bass_idx >= 0) & (st.bass_idx < n_lit[:, None, None])
        bass_rgb = srgb_to_linear(bass.rgba[:, :3])[:, None, None, :]
        a = torch.where(lit, st.bass_cov * bass.rgba[:, 3, None, None], 0.0)[..., None]
        img = bass_rgb * a + img * (1.0 - a)
    if debug is not None:
        img = _debug_world_panels(cfg, rng, img, debug)
    return img


def ball_patches(cfg: RenderConfig, balls: BallOutputs, time: float):
    """The fragment stage: each stream's K frontmost visible balls (K =
    min(max_balls, n); a stable sort, so equal z keep bin order), back to
    front, shaded into P x P patches. Returns (rgb (B, K, P, P, 3), alpha
    (B, K, P, P), column origins (B, K), row origins (B, K)), the patches'
    windows clipped into the raster."""
    s = cfg.pixel_size
    H, W = cfg.height, cfg.width  # the visible image (centering math)
    Hp, Wp = cfg.padded_height, cfg.padded_width  # the compute raster
    P = min(cfg.ball_patch, Hp, Wp)  # a patch cannot exceed the raster
    K = min(cfg.max_balls, balls.position.shape[1])
    dev = balls.position.device

    gate_all = balls.visible & (balls.scale > 1e-5)
    key = torch.where(gate_all, balls.position[..., 2], -torch.inf)
    order = torch.argsort(-key, dim=-1, stable=True)[:, :K].flip(-1)  # composite back to front

    def take(x):
        return x.gather(1, order)

    pos = balls.position.gather(1, order[..., None].expand(-1, -1, 3))
    rgba = balls.rgba.gather(1, order[..., None].expand(-1, -1, 4))
    cx, cy = pos[..., 0], pos[..., 1]
    rgb_lin = srgb_to_linear(rgba[..., :3])
    mat_a = rgba[..., 3]
    gate = take(gate_all).to(torch.float32)
    half = torch.clamp_min(BALL_HALF_EXTENT * take(balls.scale), 1e-6)

    # pixel index of the ball center
    pi = exact_div(cx, s) + (W - 1) / 2.0
    pj = (H - 1) / 2.0 - exact_div(cy, s)
    start_i = torch.clamp(torch.round(pi).to(torch.int32) - P // 2, 0, max(Wp - P, 0))
    start_j = torch.clamp(torch.round(pj).to(torch.int32) - P // 2, 0, max(Hp - P, 0))

    di = torch.arange(P, dtype=torch.float32, device=dev)
    # world coords of every patch pixel: (B, K, P)
    wx = (start_i[..., None].to(torch.float32) + di - (W - 1) / 2.0) * s
    wy = ((H - 1) / 2.0 - start_j[..., None].to(torch.float32) - di) * s
    uv_x = (wx - cx[..., None])[:, :, None, :] / half[..., None, None]  # (B, K, 1, P)
    uv_y = -(wy - cy[..., None])[:, :, :, None] / half[..., None, None]  # (B, K, P, 1)

    patch_rgb, patch_a = ball_fragment(
        uv_x, uv_y, rgb_lin[:, :, None, None, :], mat_a[..., None, None], take(balls.calmness)[..., None, None],
        time, take(balls.pitch_accuracy)[..., None, None], take(balls.pitch_deviation)[..., None, None],
    )  # (B, K, P, P, 3), (B, K, P, P)
    return patch_rgb, patch_a * gate[..., None, None], start_i, start_j


def layers_over(cfg: RenderConfig, rng: VqtRange, st: SceneStatics, img: torch.Tensor,
                debug: DebugInputs | None) -> torch.Tensor:
    """The layers over the balls: the pitch-name ring (a premultiplied
    layer) and the debug spectrogram quad."""
    if st.text_premul is not None:
        img = st.text_premul + img * (1.0 - st.text_a)
    if debug is not None:
        img = _blit_spectrogram(cfg, rng, img, debug)
    return img


def post(cfg: RenderConfig, img: torch.Tensor, scene_calmness: torch.Tensor) -> torch.Tensor:
    """Crops the raster to the visible view, channel-first (B, 3, H, W), and
    adds the bloom (Bevy sizes its pyramid from the camera viewport)."""
    img = img[:, : cfg.height, : cfg.width].permute(0, 3, 1, 2).contiguous()
    if cfg.with_bloom:
        img = _bloom(img, bloom_intensity(scene_calmness), cfg.width, cfg.height)
    return img


def encode(cfg: RenderConfig, img: torch.Tensor, debug: DebugInputs | None) -> torch.Tensor:
    """Tonemap, sRGB encode, the chroma UI boxes (post-tonemap, in sRGB) and
    the 8-bit quantization: (B, 3, H, W) linear -> (B, H, W, 3) uint8."""
    srgb = linear_to_srgb(torch.clamp_min(_tonemap(img), 0.0))
    if debug is not None:
        srgb = _chroma_boxes(cfg, srgb, debug.chroma)
    u8 = torch.clamp(torch.round(srgb * 255.0), 0.0, 255.0).to(torch.uint8)
    return u8.permute(0, 2, 3, 1).contiguous()


def _render(cfg, rng, st, balls, bass, scene_calmness, time, debug):
    img = layers_under(cfg, rng, st, bass, debug)
    rgb, a, si, sj = ball_patches(cfg, balls, time)
    img = composite_patches(img, rgb, a, si, sj)
    img = layers_over(cfg, rng, st, img, debug)
    return encode(cfg, post(cfg, img, scene_calmness), debug)


def _no_bass(st: SceneStatics, n_streams: int, device) -> BassSpiralOutputs:
    return BassSpiralOutputs(
        visible=torch.zeros((n_streams, st.n_cylinders), dtype=torch.bool, device=device),
        rgba=torch.zeros((n_streams, 4), dtype=torch.float32, device=device),
    )


def _stream_values(v, n_streams: int, device) -> torch.Tensor:
    """(B,) float32 per-stream values on ``device`` from a tensor, or from a
    host scalar by a fill (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(n_streams)
    return torch.full((n_streams,), float(v), dtype=torch.float32, device=device)


def render_batch(
    cfg: RenderConfig,
    rng: VqtRange,
    balls: BallOutputs,
    bass: BassSpiralOutputs | None,
    scene_calmness,
    time,
    statics: SceneStatics | None = None,
    debug: DebugInputs | None = None,
) -> torch.Tensor:
    """Rasterizes a batch -> (B, height, width, 3) uint8 sRGB. ``balls``,
    ``bass`` and ``debug`` (if given) carry a leading stream axis (the
    shapes the fused pipeline emits); ``scene_calmness`` is (B,) or a
    scalar; ``time`` is a host scalar shared by all streams. Runs on the
    device of ``balls``; the scene's static layers come from
    :func:`make_scene` unless given. Sharded inputs (``balls``, ``bass``,
    ``scene_calmness``, ``debug``, split alike over a mesh) render each
    slice on its own device, with that device's :func:`make_scene`, into
    Sharded frames; ``statics`` must then be None."""
    if isinstance(balls.position, Sharded):
        if statics is not None:
            raise ValueError("sharded inputs render with each device's own statics; pass statics=None")
        return map_shards(
            lambda b, bs, sc, dbg: render_batch(cfg, rng, b, bs, sc, time, debug=dbg),
            balls, bass, scene_calmness, debug,
        )
    dev = balls.position.device
    st = statics if statics is not None else make_scene(cfg, rng, dev)
    n_streams = balls.position.shape[0]
    if bass is None:
        bass = _no_bass(st, n_streams, dev)
    sc = _stream_values(scene_calmness, n_streams, dev)
    return _render(cfg, rng, st, balls, bass, sc, _f32(time), debug)


def render_frame(
    cfg: RenderConfig,
    rng: VqtRange,
    balls: BallOutputs,
    bass: BassSpiralOutputs | None,
    scene_calmness,
    time,
    statics: SceneStatics | None = None,
    debug: DebugInputs | None = None,
) -> torch.Tensor:
    """Rasterizes one stream's frame -> (height, width, 3) uint8 sRGB. The
    inputs are a batch of one (convert.py gives a JAX frame's leaves that
    stream axis). Passing ``debug`` adds the Debugging display mode's
    overlay panels."""
    if balls.position.shape[0] != 1:
        raise ValueError(f"render_frame renders one stream, got {balls.position.shape[0]}; use render_batch")
    return render_batch(cfg, rng, balls, bass, scene_calmness, time, statics, debug)[0]


def _select(streams, device):
    """An index of stream rows: a slice for a range (a view, no launch),
    else a tensor on ``device``."""
    if isinstance(streams, range) and streams.step > 0:
        return slice(streams.start, streams.stop, streams.step)
    if isinstance(streams, torch.Tensor):
        return streams.to(device)
    return torch.as_tensor(list(streams), dtype=torch.int64).to(device)


def render_streams(
    cfg: RenderConfig,
    rng: VqtRange,
    viewer,
    scene_calmness,
    time,
    streams=(0,),
    statics: SceneStatics | None = None,
) -> torch.Tensor:
    """Rasterizes selected stream rows of a batched serving output ->
    (len(streams), height, width, 3) uint8. ``viewer`` is the
    ``ViewerOutputs`` a StreamServer or StreamingPipeline step emits under
    ``with_viewer=True``; ``scene_calmness`` the matching (B,) analysis
    output. A ``range`` of rows is a view; any other sequence is copied to
    the device as an index (a host-to-device copy). This is the display-rate
    consumer path: a deployment renders the handful of streams somebody is
    watching, not the whole batch. The viewer outputs of a server over a
    mesh (Sharded) render each slot's selected rows on that slot's device
    and return Sharded frames in the order of ``streams``."""
    if isinstance(viewer.balls.position, Sharded):
        balls, bass, sc = select_rows((viewer.balls, viewer.bass, scene_calmness), list(streams))
        return render_batch(cfg, rng, balls, bass, sc, time, statics=statics)
    idx = _select(streams, viewer.balls.position.device)

    def rows(obj):
        return type(obj)(**{f.name: getattr(obj, f.name)[idx] for f in dataclasses.fields(obj)})

    return render_batch(cfg, rng, rows(viewer.balls), rows(viewer.bass), scene_calmness[idx], time, statics=statics)
