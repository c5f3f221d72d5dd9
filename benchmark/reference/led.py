# Frozen copy of pitchvis_tpu_torch/io/led.py at commit 5c134db8c4ad,
# the plain reference of the benchmark: it imports nothing of the program.
"""LED serial output stage.

Port of ``pitchvis_tpu/io/led.py``, itself a vectorized port of
`pitchvis_serial`'s `update_serial` (pitchvis_serial/src/main.rs:122-175):
splat continuous peaks onto bins with a fract^1.9 split between adjacent
bins, color-map each bin with the serial palette (GRAY_LEVEL=5.0,
EASING_POW=2.3, pitch rotation so bin 0 = A), scale by size/max, and frame
the bytes as ``0xFF <n_hi> <n_lo> <r g b>*`` with values quantized by *254
truncation (<= 0xFE, so 0xFF stays a frame marker).

Where the JAX package runs one stream under ``jax.vmap``, every function
here carries the stream axis first: (B, n) masks and peaks in, a (B, n, 3)
u8 color block out, with the max a per-row max. `led_frame_values` runs on
the inputs' device; `frame_bytes` adds the 3-byte header on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import VqtRange
from .colors import SERIAL_COLORS, calculate_color, static_table
from .peaks import _shift

SERIAL_GRAY_LEVEL = 5.0  # pitchvis_serial/src/main.rs:58
SERIAL_EASING_POW = 2.3  # main.rs:59
SPLAT_POW = 1.9  # main.rs:133


def splat_peaks(
    peak_mask: torch.Tensor, center: torch.Tensor, size: torch.Tensor, n_buckets: int
) -> torch.Tensor:
    """Splat continuous peaks onto the bin grid (main.rs:130-140): bin
    floor(c) gets size*(1 - fract^1.9), bin floor(c)+1 gets size*fract^1.9.
    Matching the reference, overlapping peaks overwrite rather than add
    (iteration in ascending center order => the higher peak index wins).

    (B, n) in, (B, n) out. Continuous centers are within one bin of their
    peak bin (ops/peaks.py::enhance_peaks_continuous clamps the parabola
    offset), so a bin t can only receive from peaks at bins t-2..t+1: each
    candidate source is a static shift, applied in ascending source order,
    which reproduces the overwrite precedence without a scatter."""
    n = n_buckets
    idx = torch.arange(n, device=center.device)
    floor_c = torch.floor(center)
    lower = torch.clamp(floor_c.to(torch.int64), 0, n - 1)
    rel = lower - idx  # in {-1, 0, 1} at peak bins
    frac_pow = torch.pow(center - floor_c, SPLAT_POW)
    v_lo = size * (1.0 - frac_pow)
    v_hi = size * frac_pow
    hi_valid = peak_mask & (lower < n - 1)

    x = torch.zeros_like(center)
    # the source peak of position t is at bin t + i_rel; ascending i_rel =
    # ascending overwrite precedence (the last write wins, like the
    # reference's loop)
    for i_rel in (-2, -1, 0, 1):
        mask_s = _shift(peak_mask, i_rel, False)
        rel_s = _shift(rel, i_rel, 0)
        # the lo write lands at t when lower(i) = i + rel = t: rel == -i_rel
        x = torch.where(mask_s & (rel_s == -i_rel), _shift(v_lo, i_rel, 0.0), x)
        # the hi write lands at t when lower(i) + 1 = t: rel == -i_rel - 1
        write_hi = _shift(hi_valid, i_rel, False) & (rel_s == -i_rel - 1)
        x = torch.where(write_hi, _shift(v_hi, i_rel, 0.0), x)
    return x


def _led_rgb(range_: VqtRange) -> torch.Tensor:
    """(n, 3) RGB of each LED bin under the serial palette; it depends only
    on the bin layout (a static table, ops/colors.py::static_table)."""
    n = range_.n_buckets
    bpo = range_.buckets_per_octave
    # pitch rotation: bin 0 (min_freq = A) -> pitch class A (main.rs:153-155)
    bucket = torch.remainder(torch.arange(n) + (bpo - 3 * (bpo // 12)), bpo).to(torch.float32)
    return calculate_color(bpo, bucket, SERIAL_COLORS, SERIAL_GRAY_LEVEL, SERIAL_EASING_POW)


def led_frame_values(
    range_: VqtRange,
    peak_mask: torch.Tensor,
    center: torch.Tensor,
    size: torch.Tensor,
) -> torch.Tensor:
    """(B, n_buckets, 3) uint8 RGB triples of one LED frame per stream
    (main.rs:146-168), from (B, n_buckets) peak masks, centers and sizes."""
    x = splat_peaks(peak_mask, center, size, range_.n_buckets)

    # one max a stream
    max_size = x.amax(dim=-1, keepdim=True)
    # color_coefficient = size / max; silence (max==0) -> all zeros
    # (Rust 0/0 = NaN, cast to u8 saturates to 0; main.rs:162)
    coeff = torch.where(max_size > 0.0, x / torch.clamp_min(max_size, 1e-30), 0.0)

    scaled = static_table(_led_rgb, range_, device=x.device) * coeff[..., None]
    return torch.floor(scaled * 254.0).to(torch.uint8)


def frame_bytes(values_u8: np.ndarray) -> bytes:
    """0xFF-framed byte stream of one frame (main.rs:146-150): header 0xFF +
    u16 count, then the RGB triples. ``values_u8``: (n, 3), a NumPy array or
    a tensor on the CPU."""
    values = np.asarray(values_u8, np.uint8)
    n = values.shape[0]
    header = bytes([0xFF, (n // 256) & 0xFF, n % 256])
    return header + values.tobytes()


def led_frame(range_: VqtRange, peak_mask, center, size) -> bytes:
    """Full LED frame for one stream, from its (n,) mask, centers and
    sizes."""
    values = led_frame_values(range_, peak_mask[None], center[None], size[None])
    return frame_bytes(values[0].cpu().numpy())


class SerialWriter:
    """Host-side serial port writer (optional; requires pyserial or a file
    path / fd). The framework side produces the exact byte frames; this shim
    just writes them at the configured FPS like pitchvis_serial's main loop
    (main.rs:177-231)."""

    def __init__(self, port_or_file, baud_rate: int = 115_200):
        self._own = False
        if hasattr(port_or_file, "write"):
            self._port = port_or_file
            return
        try:
            import serial  # type: ignore
        except ImportError:
            self._port = open(port_or_file, "wb")
            self._own = True
            return
        import os
        import stat

        try:
            mode = os.stat(port_or_file).st_mode
        except OSError:
            mode = None
        if mode is not None and not stat.S_ISCHR(mode):
            # an existing target that is no device (regular file, FIFO): file
            # output, as the docstring promises
            self._port = open(port_or_file, "wb")
        else:
            try:
                self._port = serial.Serial(port_or_file, baud_rate, timeout=10)
            except serial.SerialException:
                if mode is not None:
                    # a real character device that failed to open (busy,
                    # permissions, bad baud) is a genuine serial error:
                    # writing frames to a plain file would mask it
                    raise
                import warnings

                warnings.warn(
                    f"serial port {port_or_file!r} does not exist; "
                    "writing LED frames to a new plain file instead"
                )
                self._port = open(port_or_file, "wb")
        self._own = True

    def write_frame(self, frame: bytes) -> None:
        self._port.write(frame)
        self._port.flush()

    def close(self) -> None:
        if self._own:
            self._port.close()
