"""Display-derived outputs, batched over streams.

Port of ``pitchvis_tpu/models/viewer.py``. The reference's Bevy/WGSL
presentation layer is out of scope, but every quantity it derives from the
analysis is computed here, so a renderer (or a headless consumer) gets
exactly what `update_display` computes:

* log-spiral ball geometry (display_system/util.rs:9-20)
* per-ball state: position, color, alpha, scale, calmness/accuracy shader
  params, exponential fade, proximity hiding (update.rs:136-334)
* bloom intensity = clamp(1.3 * scene_calmness) (update.rs:336-351)
* chroma vector: power per pitch class, C4-referenced, max-normalized
  (update.rs:1090-1144)
* scrolling spectrogram rows in VQT and Peaks modes (update.rs:930-1087)
* the bass spiral and the calmness histogram and graph of the debugging
  overlay (update.rs:353-426, 640-869)

Where the JAX package vmaps a per-stream function, every function here
carries the stream axis first: per-bin tensors are (B, n), per-stream ones
(B,), and every reduction (a max, the lowest peak's cumsum, the chroma sums)
stays within its row. The tables that depend only on the bin layout (the
spectrogram's pitch colors, the fade's base, the chroma's pitch classes) are
static tables (ops/colors.py::static_table), built once on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import VqtRange
from ..core.device import resolve_device
from ..ops.colors import COLORS, EASING_POW, GRAY_LEVEL, calculate_color, static_table
from ..ops.peaks import _shift
from ..utils.rounding import exact_div, rust_round
from .analysis import dt_batch

PITCH_BALL_SCALE_FACTOR = 1.0 / 305.0  # update.rs:23
VISIBILITY_CUTOFF = 0.019  # update.rs:147 — compared against transform.scale
FADE_ALPHA_FLOOR = 0.7  # update.rs:169 — fading balls never drop below this
C4_FREQ = 261.626  # update.rs:1108
PEAK_RADIUS = 2.0  # spectrogram peak splat radius (update.rs)
SPIRAL_SEGMENTS_PER_SEMITONE = 6  # update.rs:22
HIGHEST_BASSNOTE = 28  # semitones; setup.rs:24 (12*2+4)
CALMNESS_HISTORY_CAPACITY = 300  # app/common.rs:2037
CALMNESS_HISTOGRAM_HEIGHT_SCALE = 0.5  # update.rs:795


def bass_cylinder_count(octaves: int) -> int:
    """Number of bass-spiral cylinders the reference spawns (setup.rs:127-172):
    consecutive-point segments over the first HIGHEST_BASSNOTE*6 visual spiral
    points (72 per octave), i.e. `take(168).tuple_windows()` -> one less
    segment than points."""
    n_points = min(HIGHEST_BASSNOTE * SPIRAL_SEGMENTS_PER_SEMITONE,
                   octaves * 12 * SPIRAL_SEGMENTS_PER_SEMITONE)
    return n_points - 1


def bin_to_spiral(buckets_per_octave: int, x) -> tuple:
    """Log-spiral coordinates of a (fractional) bin (util.rs:9-20):
    radius = 2*(0.3 + (x/bpo)^0.75), one turn per octave, bin 0 at angle 0
    measured so that (-cos, sin) orients like the reference."""
    x = torch.as_tensor(x, dtype=torch.float32)
    radius = 2.0 * (0.3 + torch.pow(x / buckets_per_octave, 0.75))
    angle = (x + buckets_per_octave) / buckets_per_octave * 2.0 * math.pi
    return -torch.cos(angle) * radius, torch.sin(angle) * radius


def spiral_points(octaves: int, buckets_per_octave: int) -> np.ndarray:
    """(n_buckets, 2) static ball positions (util.rs:3-7)."""
    x, y = bin_to_spiral(buckets_per_octave, torch.arange(octaves * buckets_per_octave))
    return np.stack([x.numpy(), y.numpy()], axis=-1)


def bloom_intensity(scene_calmness) -> torch.Tensor:
    """update.rs:346-347."""
    return torch.clamp(torch.as_tensor(scene_calmness) * 1.3, 0.0, 1.0)


def pitch_color_rotation(buckets_per_octave: int) -> int:
    """The viewer rotates bins by (bpo - 3*(bpo/12)) so bin 0 (A) maps to
    pitch class A (update.rs:220-222)."""
    return buckets_per_octave - 3 * (buckets_per_octave // 12)


def _chroma_index(rng: VqtRange) -> torch.Tensor:
    """(12, m) bin indices of each pitch class, padded with index n (a zero
    column the caller appends); a static table
    (ops/colors.py::static_table)."""
    n = rng.n_buckets
    semitones_from_c4 = 12.0 * math.log2(rng.min_freq / C4_FREQ)
    # Rust f32::round is half away from zero (Python round is half-to-even)
    bin0 = math.floor(abs(semitones_from_c4) + 0.5) * (-1 if semitones_from_c4 < 0 else 1)
    bin0_class = (bin0 % 12 + 12) % 12
    # half away from zero like the reference's .round(); the operand is
    # non-negative so floor(x+0.5) suffices
    semitone = torch.floor(
        exact_div(torch.arange(n, dtype=torch.float32) * 12.0, rng.buckets_per_octave) + 0.5
    ).to(torch.int64)
    pitch_class = ((semitone + bin0_class) % 12).numpy()
    members = [np.flatnonzero(pitch_class == c) for c in range(12)]
    width = max(len(m) for m in members)
    index = np.full((12, width), n, np.int64)
    for c, m in enumerate(members):
        index[c, : len(m)] = m
    return torch.from_numpy(index)


def chroma_vector(x_vqt_smoothed: torch.Tensor, rng: VqtRange) -> torch.Tensor:
    """(B, 12) chroma: power summed per pitch class (C4-referenced), then
    max-normalized per stream (update.rs:1103-1131). The sums run over a
    fixed gather of each class's bins (no atomics: the same order on every
    call and device)."""
    power = torch.pow(10.0, x_vqt_smoothed / 10.0)
    padded = torch.nn.functional.pad(power, (0, 1))
    chroma = padded[:, static_table(_chroma_index, rng, device=power.device)].sum(dim=-1)
    mx = chroma.amax(dim=-1, keepdim=True)
    return torch.where(mx > 0.0, chroma / torch.clamp_min(mx, 1e-30), chroma)


@dataclass
class BallState:
    """Per-bin "pitch ball" carry of every stream (scale decays
    exponentially when the bin's peak disappears; update.rs:136-184).
    `center` keeps the last placed fractional position so a fading ball
    stays where its peak was; `rgba` and `calm` keep the last placed
    color/shader params the same way (the reference's ball entities keep
    their Transform and material while fading, with alpha decaying toward
    the 0.7 floor, update.rs:166-170)."""

    scale: torch.Tensor  # (B, n)
    z_offset: torch.Tensor  # (B, n) background drift of fading balls
    center: torch.Tensor  # (B, n) last placed fractional bin position
    rgba: torch.Tensor  # (B, n, 4) last placed color (alpha decays while fading)
    calm: torch.Tensor  # (B, n) last placed calmness shader param

    @classmethod
    def init(cls, n_streams: int, n_buckets: int, device="cuda") -> "BallState":
        """Fresh carries, on the card unless ``device="cpu"``."""
        device = resolve_device(device)

        def z(*shape):
            return torch.zeros((n_streams, *shape), dtype=torch.float32, device=device)

        return cls(
            scale=z(n_buckets),
            z_offset=z(n_buckets),
            center=torch.arange(n_buckets, dtype=torch.float32, device=device).expand(n_streams, -1).clone(),
            rgba=z(n_buckets, 4),
            calm=z(n_buckets),
        )


BALL_LEAVES = ("scale", "z_offset", "center", "rgba", "calm")


@dataclass
class BallOutputs:
    position: torch.Tensor  # (B, n, 3) spiral x, y, z-order
    rgba: torch.Tensor  # (B, n, 4)
    scale: torch.Tensor  # (B, n)
    visible: torch.Tensor  # (B, n) bool
    calmness: torch.Tensor  # shader params (update.rs:263-266)
    pitch_accuracy: torch.Tensor
    pitch_deviation: torch.Tensor


def _dropoff_base(n: int) -> torch.Tensor:
    """(n,) per-bin fade base 0.85 - 0.15*i/n (update.rs:155-166)."""
    return 0.85 - exact_div(0.15 * torch.arange(n, dtype=torch.float32), n)


def update_balls(
    rng: VqtRange,
    state: BallState,
    peaks: torch.Tensor,
    peak_center: torch.Tensor,
    peak_size: torch.Tensor,
    calmness: torch.Tensor,
    pitch_accuracy: torch.Tensor,
    pitch_deviation: torch.Tensor,
    dt,
    *,
    shader_params: bool = True,
    ball_scale_factor: float = 1.0,
) -> tuple[BallState, BallOutputs]:
    """One display frame of ball state (update.rs:136-334) for every stream:
    fade all balls with the per-bin dropoff (0.85 - 0.15*i/n)^(30*dt), then
    re-place/refresh balls whose bin holds a continuous peak (keyed by
    trunc(center)), hide balls within 0.23 semitones of any peak, keep peaks
    themselves visible. Per-bin inputs are (B, n); ``dt`` is a scalar or
    (B,), in any form models/analysis.py::dt_batch takes.

    ``shader_params=False`` models display modes other than
    Normal/Debugging: the calmness/accuracy/deviation material params are
    zeroed (update.rs:268-272), which also drops the calmness size boost
    (calmness_scale reads the zeroed param, update.rs:276).
    ``ball_scale_factor=0.7`` is VisualsMode::Performance
    (update.rs:292-297)."""
    n = rng.n_buckets
    bpo = rng.buckets_per_octave
    device = peak_center.device
    idx = torch.arange(n, device=device)
    dt = dt_batch(dt, peak_center.shape[0], device)[:, None]

    # fade (update.rs:155-166)
    dropoff = torch.pow(static_table(_dropoff_base, n, device=device), 30.0 * dt)
    scale = state.scale * dropoff
    z_offset = state.z_offset - 0.001 * 30.0 * dt

    # active peaks keyed by trunc(center) (update.rs:208-212). Peak centers
    # clamp to one bin of their source (ops/peaks.py enhance), so the key
    # scatter is three static shifts; d descending: when two peaks key the
    # same bin (possible at the 2-bin min distance with ±1-bin centers), the
    # higher source bin wins, like the reference's ascending peak iteration
    # with overwrite
    key_off = torch.clamp(peak_center.to(torch.int64), 0, n - 1) - idx
    active = torch.zeros_like(peaks)
    center_at = torch.zeros_like(peak_center)
    size_at = torch.zeros_like(peak_size)
    for d in (1, 0, -1):
        # a peak at bin i moves to bin i + d
        hit = _shift(peaks & (key_off == d), -d, False)
        active = active | hit
        center_at = torch.where(hit, _shift(peak_center, -d, 0.0), center_at)
        size_at = torch.where(hit, _shift(peak_size, -d, 0.0), size_at)

    max_size = torch.clamp_min(torch.where(peaks, peak_size, 0.0).amax(dim=-1, keepdim=True), 1e-30)
    color_coefficient = 1.0 - (1.0 - size_at / max_size) ** 2.0

    bucket = torch.remainder(center_at + pitch_color_rotation(bpo), bpo)
    rgb = calculate_color(bpo, bucket, COLORS, GRAY_LEVEL, EASING_POW)

    if shader_params:
        calm_param = torch.clamp(calmness - 0.27, 0.0, 1.0)  # update.rs:264
        out_accuracy = pitch_accuracy
        out_deviation = pitch_deviation
    else:  # update.rs:268-272 — params zeroed outside Normal/Debugging
        calm_param = torch.zeros_like(calmness)
        out_accuracy = torch.zeros_like(pitch_accuracy)
        out_deviation = torch.zeros_like(pitch_deviation)
    calmness_scale = 1.0 + 0.2 * calm_param

    new_scale = torch.where(
        active,
        size_at * ball_scale_factor * PITCH_BALL_SCALE_FACTOR * calmness_scale,
        scale,
    )
    z_order = torch.where(active, (size_at / max_size - 1.01) * 12.5, z_offset)
    z_offset = torch.where(active, 0.0, z_offset)

    # fading balls keep the position and material their peak last had;
    # active bins get fresh color + alpha = color_coefficient
    new_center = torch.where(active, center_at, state.center)
    faded_alpha = torch.clamp_min(state.rgba[..., 3] * dropoff, FADE_ALPHA_FLOOR)
    new_rgba = torch.where(
        active[..., None],
        torch.cat([rgb, color_coefficient[..., None]], dim=-1),
        torch.cat([state.rgba[..., :3], faded_alpha[..., None]], dim=-1),
    )
    new_calm = torch.where(active, calm_param, state.calm)
    x, y = bin_to_spiral(bpo, new_center)
    position = torch.stack([x, y, z_order], dim=-1)

    # visibility compares the transform scale against the cutoff
    # (update.rs:153,175: size * PITCH_BALL_SCALE_FACTOR >= 0.019);
    # placement additionally shows any active ball above 0.002
    # (update.rs:299-302)
    visible = (new_scale >= VISIBILITY_CUTOFF) | (active & (new_scale >= 0.002))

    # hide every integer bin in [round(center-radius), round(center+radius)]
    # around each peak, except the peak bins themselves (update.rs:305-327;
    # radius uses the reference's integer division bpo/12). round() in Rust
    # is half away from zero -> floor(x+0.5) on these non-negative centers.
    # Bin j is hidden by the peak at source bin i iff lo_i <= j <= hi_i;
    # |j - i| <= radius + 1.5, so this is a static-shift window too
    radius = (bpo // 12) * 0.23
    lo = torch.floor(peak_center - radius + 0.5)
    hi = torch.floor(peak_center + radius + 0.5)
    hide = torch.zeros_like(peaks)
    span = int(radius) + 2
    for d in range(-span, span + 1):
        j = idx + d
        src = peaks & (lo <= j) & (j <= hi)
        hide = hide | _shift(src, -d, False)
    visible = visible & ~(hide & ~active)

    new_state = BallState(
        scale=new_scale, z_offset=z_offset, center=new_center, rgba=new_rgba, calm=new_calm,
    )
    return new_state, BallOutputs(
        position=position,
        rgba=new_rgba,
        scale=new_scale,
        visible=visible,
        calmness=new_calm,
        pitch_accuracy=out_accuracy,
        pitch_deviation=out_deviation,
    )


def _spectrogram_rgb_u8(rng: VqtRange) -> torch.Tensor:
    """(n, 3) u8 color channels of a VQT-mode spectrogram row: the rotated
    pitch color of each bin * 1.2, clamped and truncated (a static table)."""
    n = rng.n_buckets
    bpo = rng.buckets_per_octave
    bucket = torch.remainder(torch.arange(n) + pitch_color_rotation(bpo), bpo)
    rgb = calculate_color(bpo, bucket.to(torch.float32), COLORS, GRAY_LEVEL, EASING_POW)
    return torch.floor(torch.clamp(rgb * 1.2 * 255.0, 0.0, 255.0)).to(torch.uint8)


def spectrogram_row_vqt(rng: VqtRange, x_vqt_smoothed: torch.Tensor) -> torch.Tensor:
    """(B, n, 4) RGBA8 spectrogram rows in VQT mode (update.rs:960-1005):
    brightness = clamp((1-(1-v/max)^2)*1.5), color = pitch color * 1.2."""
    mx = x_vqt_smoothed.amax(dim=-1, keepdim=True)
    normalized = x_vqt_smoothed / (mx + 0.001)
    brightness = torch.where(
        mx > 0.0, torch.clamp((1.0 - (1.0 - normalized) ** 2.0) * 1.5, 0.0, 1.0), 0.0
    )
    # the reference clamps then `as u8`: truncation, not rounding
    # (update.rs:998-1001)
    alpha = torch.floor(torch.clamp(brightness * 1.2 * 255.0, 0.0, 255.0)).to(torch.uint8)
    rgb = static_table(_spectrogram_rgb_u8, rng, device=x_vqt_smoothed.device).expand(*alpha.shape, 3)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def spectrogram_row_peaks(
    rng: VqtRange, peaks: torch.Tensor, peak_center: torch.Tensor, peak_size: torch.Tensor
) -> torch.Tensor:
    """(B, n, 4) RGBA8 rows in Peaks mode (update.rs:1008-1065): each
    continuous peak splats a Gaussian of radius 2 bins with its pitch
    color."""
    n = rng.n_buckets
    bpo = rng.buckets_per_octave
    idx = torch.arange(n, dtype=torch.float32, device=peak_center.device)
    max_size = torch.clamp_min(torch.where(peaks, peak_size, 0.0).amax(dim=-1, keepdim=True), 1e-30)

    brightness = torch.clamp((1.0 - (1.0 - peak_size / max_size) ** 2.0) * 1.5, 0.0, 1.0)
    bucket = torch.remainder(peak_center + pitch_color_rotation(bpo), bpo)
    # channels before bins, so the bin shifts act on the last axis
    rgb = calculate_color(bpo, bucket, COLORS, GRAY_LEVEL, EASING_POW).movedim(-1, -2)

    rgba = torch.zeros((peaks.shape[0], 4, n), dtype=torch.float32, device=peak_center.device)
    # Pixel j is painted by the peak at source bin j-s whose bin window
    # [floor(c-R), ceil(c+R)) contains j with |j-c| <= R (update.rs:1038-1046;
    # centers sit within one bin of their source, so s spans [-(R+1), R+1]).
    # The reference iterates peaks ascending by center with overwrite
    # (update.rs:1017-1058), so the highest in-radius peak wins every
    # contested pixel: s descends (= source bin ascending) with selects.
    radius = int(PEAK_RADIUS)
    for s in range(radius + 1, -radius - 2, -1):
        src_center = _shift(peak_center, -s, 0.0)
        distance = torch.abs(idx - src_center)
        # the reference's bin loop runs floor(c-R) .. ceil(c+R) exclusive:
        # when c+R is exactly integral that upper-edge bin is skipped even
        # though its distance == R
        valid = (
            _shift(peaks, -s, False)
            & (distance <= PEAK_RADIUS)
            & (idx < torch.ceil(src_center + PEAK_RADIUS))
        )
        falloff = torch.exp(-distance * distance / (PEAK_RADIUS * PEAK_RADIUS * 0.5))
        px = torch.cat(
            [_shift(rgb, -s, 0.0) * 1.2, (_shift(brightness, -s, 0.0) * falloff)[:, None] * 1.2],
            dim=1,
        )
        rgba = torch.where(valid[:, None], px, rgba)
    # clamp then truncate, like the reference's `as u8` (update.rs:1052-1058)
    return torch.floor(torch.clamp(rgba * 255.0, 0.0, 255.0)).to(torch.uint8).movedim(1, 2)


@dataclass
class BassSpiralOutputs:
    visible: torch.Tensor  # (B, n_segments) bool — lit cylinders, base upward
    rgba: torch.Tensor  # (B, 4) shared color of every lit segment


def bass_spiral(
    rng: VqtRange,
    peaks: torch.Tensor,
    peak_center: torch.Tensor,
    peak_size: torch.Tensor,
) -> BassSpiralOutputs:
    """Bass-spiral coloring up to each stream's lowest continuous peak
    (update.rs:353-426): segments 0..round(center_semitones)*6 light up in
    the pitch color of the rounded semitone, with alpha
    1-(1-size/max_size)^2. No peaks, or a lowest peak beyond the cylinder
    range, leaves every segment hidden (the reference hides all cylinders
    first and returns early when round(center)*6 >= the spawned cylinder
    count, update.rs:382-387; only HIGHEST_BASSNOTE*6 spiral points get
    cylinders, setup.rs:134-137)."""
    n_segments = bass_cylinder_count(rng.octaves)
    bpo = rng.buckets_per_octave

    has_peak = peaks.any(dim=-1, keepdim=True)
    # the lowest peak of each row: the first bin where the row's running
    # count of peaks is 1
    first = peaks & (torch.cumsum(peaks, dim=-1) == 1)
    # semitones, divided exactly: the quotient is rounded next
    center = exact_div(torch.where(first, peak_center, 0.0).sum(dim=-1, keepdim=True), bpo) * 12.0
    size = torch.where(first, peak_size, 0.0).sum(dim=-1, keepdim=True)
    rounded = rust_round(center)  # center.round(), update.rs:382/390
    n_lit = rounded * SPIRAL_SEGMENTS_PER_SEMITONE  # update.rs:390
    in_range = n_lit < n_segments  # cylinder_entities.len(), update.rs:382-387

    lit = torch.arange(n_segments, device=peaks.device) < n_lit.to(torch.int64)
    visible = lit & has_peak & in_range

    # one color for every lit segment: the rounded semitone's pitch class
    # (update.rs:398-406)
    color_map_ref = exact_div(rounded * bpo, 12.0)
    bucket = torch.remainder(color_map_ref + pitch_color_rotation(bpo), bpo)
    rgb = calculate_color(bpo, bucket, COLORS, GRAY_LEVEL, EASING_POW)[:, 0]
    max_size = torch.clamp_min(torch.where(peaks, peak_size, 0.0).amax(dim=-1, keepdim=True), 1e-30)
    alpha = 1.0 - (1.0 - size / max_size) ** 2.0
    return BassSpiralOutputs(visible=visible, rgba=torch.cat([rgb, alpha], dim=-1))


def _calmness_palette() -> torch.Tensor:
    """red, yellow, cyan (update.rs:27-35)."""
    return torch.tensor([[1.0, 0.5, 0.5], [1.0, 1.0, 0.5], [0.5, 0.8, 1.0]])


def calmness_to_color(calmness: torch.Tensor) -> torch.Tensor:
    """(...,) calmness -> (..., 3) srgb: cyan >0.7, yellow >0.3, red below
    (update.rs:27-35)."""
    calmness = torch.as_tensor(calmness)
    level = (calmness > 0.3).to(torch.int64) + (calmness > 0.7).to(torch.int64)
    return static_table(_calmness_palette, device=calmness.device)[level]


@dataclass
class CalmnessHistogramOutputs:
    heights: torch.Tensor  # (B, n) contour heights = calmness * 0.5
    segment_rgb: torch.Tensor  # (B, n-1, 3) per-segment color from midpoint


def calmness_histogram(calmness: torch.Tensor) -> CalmnessHistogramOutputs:
    """Per-bin calmness contour of the debugging overlay (update.rs:745-869):
    line heights are calmness * 0.5 and each segment is colored by the
    calmness_to_color threshold palette at the midpoint of its endpoints.
    The quad/triangle mesh the reference builds from these is presentation
    glue; the heights + colors are the data content."""
    heights = calmness * CALMNESS_HISTOGRAM_HEIGHT_SCALE
    mid = (calmness[..., :-1] + calmness[..., 1:]) * 0.5
    return CalmnessHistogramOutputs(heights=heights, segment_rgb=calmness_to_color(mid))


@dataclass
class ViewerOutputs:
    """Display-derived quantities of the reference's update_display pass,
    per stream (ops/viewer_stage.py::viewer_stage computes them in one
    go)."""

    balls: BallOutputs  # per-bin ball position/rgba/scale/visibility
    chroma: torch.Tensor  # (B, 12) C4-referenced pitch-class power
    bloom: torch.Tensor  # (B,) bloom intensity = clamp(1.3*scene_calmness)
    spectrogram_row: torch.Tensor  # (B, n_buckets, 4) RGBA8 VQT-mode row
    bass: BassSpiralOutputs  # spiral coloring up to the lowest peak
    calmness_histogram: CalmnessHistogramOutputs  # debug-overlay contour


def _at(index: torch.Tensor, length: int) -> torch.Tensor:
    """(B, length) mask of position ``index[b]`` in each row: a write at a
    device index as a select, with no host synchronisation."""
    return torch.arange(length, device=index.device) == index[:, None]


@dataclass
class CalmnessGraphState:
    """Scene-calmness history ring of the debugging overlay, one a stream
    (update.rs:640-744; capacity 300 at app/common.rs:2037). ``push`` writes
    the newest smoothed scene calmness; ``trace`` returns the values ordered
    oldest -> newest plus the per-segment threshold colors — the x/y line
    positions the reference derives from these are presentation glue."""

    values: torch.Tensor  # (B, capacity) circular
    write_index: torch.Tensor  # (B,) int32

    @classmethod
    def init(cls, n_streams: int, capacity: int = CALMNESS_HISTORY_CAPACITY, device="cuda") -> "CalmnessGraphState":
        device = resolve_device(device)
        return cls(
            values=torch.zeros((n_streams, capacity), dtype=torch.float32, device=device),
            write_index=torch.zeros(n_streams, dtype=torch.int32, device=device),
        )

    def push(self, scene_calmness: torch.Tensor) -> "CalmnessGraphState":
        cap = self.values.shape[-1]
        new = torch.as_tensor(scene_calmness, dtype=torch.float32, device=self.values.device)
        vals = torch.where(_at(self.write_index, cap), new[..., None], self.values)
        return CalmnessGraphState(values=vals, write_index=(self.write_index + 1) % cap)

    def trace(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(values oldest->newest (B, capacity), segment colors
        (B, capacity-1, 3)). Segment i's color keys off its older endpoint,
        like update.rs:683-688."""
        cap = self.values.shape[-1]
        order = (torch.arange(cap, device=self.values.device) + self.write_index[:, None].to(torch.int64)) % cap
        ordered = self.values.gather(-1, order)
        return ordered, calmness_to_color(ordered[..., :-1])


@dataclass
class SpectrogramState:
    """Circular-buffer spectrogram (B, height, n, 4) u8, each stream's newest
    row at its write_index; the scroll shader's V-offset equals
    write_index/height (spectrogram_scroll.wgsl)."""

    image: torch.Tensor
    write_index: torch.Tensor  # (B,) int32

    @classmethod
    def init(cls, n_streams: int, height: int, n_buckets: int, device="cuda") -> "SpectrogramState":
        device = resolve_device(device)
        return cls(
            image=torch.zeros((n_streams, height, n_buckets, 4), dtype=torch.uint8, device=device),
            write_index=torch.zeros(n_streams, dtype=torch.int32, device=device),
        )

    def push(self, row: torch.Tensor) -> "SpectrogramState":
        """Writes (B, n, 4) rows and clears each stream's next line
        (update.rs:1068-1074)."""
        h = self.image.shape[1]
        img = torch.where(_at(self.write_index, h)[:, :, None, None], row[:, None], self.image)
        nxt = (self.write_index + 1) % h
        img = img.masked_fill(_at(nxt, h)[:, :, None, None], 0)
        return SpectrogramState(image=img, write_index=nxt)
