"""The viewer stage of a hop: every display-derived quantity of the
reference's update_display, for every stream.

The JAX package computes them in ``models/viewer.py`` (``update_balls``,
``chroma_vector``, ``bloom_intensity``, ``spectrogram_row_vqt``,
``bass_spiral``, ``calmness_histogram``), which XLA fuses into a few
kernels. Here the same stage is:

* :func:`viewer_stage`, the hand-written kernel ``csrc/viewer.cu`` on CUDA
  tensors (one launch a hop: one block a stream row, each input read once
  and each output written once); on CPU tensors its plain version;
* :func:`viewer_stage_plain`, the unchanged functions of
  ``models/viewer.py`` composed as ``models/pipeline.py::derived_stages``
  runs them, what the CPU runs (some 400 eager kernels a hop on a card).

The two agree bit for bit on the card but for the chroma sums (the kernel
adds each pitch class's bins in the order of its class table, PyTorch's
reduction in its own): the kernel rounds each operation on its own in the
order of PyTorch's eager kernels (``-fmad=false``), multiplies by the float
reciprocal where PyTorch's CUDA kernels divide by a Python number, and
calls the same math library.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.config import VqtRange
from ..models.analysis import AnalysisOutputs, dt_batch
from ..models.viewer import (
    BallOutputs,
    BallState,
    BassSpiralOutputs,
    CalmnessHistogramOutputs,
    ViewerOutputs,
    _calmness_palette,
    _chroma_index,
    _dropoff_base,
    _spectrogram_rgb_u8,
    bass_cylinder_count,
    bass_spiral,
    bloom_intensity,
    calmness_histogram,
    chroma_vector,
    pitch_color_rotation,
    spectrogram_row_vqt,
    update_balls,
)
from ..utils import nvcc
from .colors import _WHITE, _XYZ2RGB, COLORS, _palette_lch_host, static_table

# launches of the CUDA kernel (the plain version does not count)
launches = 0

_viewer_f32 = None


def _kernel():
    """``viewer_stage_f32`` of the built library, its signature bound once."""
    global _viewer_f32
    if _viewer_f32 is None:
        fn = nvcc.library("viewer").viewer_stage_f32
        fn.restype = ctypes.c_int
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [ptr] * 12 + [i64] + [ptr] * 3 + [i32] + [ptr] * 3  # inputs and tables
            + [ptr] * 14  # outputs
            + [i32] * 5 + [ctypes.c_float, i32, ptr]  # geometry, stream
        )
        _viewer_f32 = fn
    return _viewer_f32


def _color_constants() -> torch.Tensor:
    """(12,) float32: the XYZ -> linear sRGB matrix by rows, then the white
    point, each as ops/colors.py::lab_to_srgb_u8 hands it to a float32
    kernel."""
    return torch.from_numpy(np.concatenate([_XYZ2RGB.astype(np.float32).ravel(), _WHITE.astype(np.float32)]))


def _check(rng: VqtRange, state: BallState, outputs: AnalysisOutputs, dt_b: torch.Tensor) -> None:
    """Raises on what the kernel does not take: a (B, n) bool peak mask and
    float32 (B, n) analysis rows, float32 (B,) scene calmness and frame
    times (the frame times may be a broadcast view), the float32 ball carry
    ((B, n), rgba (B, n, 4)), n the layout's bins; every array the kernel
    reads contiguous; all on one device. (The kernel's launcher refuses a
    row too long for its shared memory.)"""
    b, n = outputs.peaks.shape if outputs.peaks.dim() == 2 else (None, None)
    if b is None or n != rng.n_buckets:
        raise ValueError(f"expected peaks (B, {rng.n_buckets}), got {tuple(outputs.peaks.shape)}")
    if outputs.peaks.dtype != torch.bool:
        raise TypeError(f"expected bool peaks, got {outputs.peaks.dtype}")
    rows = {name: getattr(outputs, name) for name in ("peak_center", "peak_size", "calmness", "x_vqt_smoothed",
                                                      "pitch_accuracy", "pitch_deviation")}
    rows.update({f"balls.{name}": getattr(state, name) for name in ("scale", "z_offset", "center", "calm")})
    shapes = dict.fromkeys(rows, (b, n))
    rows["balls.rgba"], shapes["balls.rgba"] = state.rgba, (b, n, 4)
    rows["scene_calmness"], shapes["scene_calmness"] = outputs.scene_calmness, (b,)
    rows["dt"], shapes["dt"] = dt_b, (b,)
    for name, x in rows.items():
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"expected {name} {shapes[name]}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32 {name}, got {x.dtype}")
    # the pitch accuracy and deviation pass through unread
    read = [outputs.peaks] + [x for name, x in rows.items() if name not in ("pitch_accuracy", "pitch_deviation", "dt")]
    if any(not x.is_contiguous() for x in read):
        raise ValueError("the viewer stage takes contiguous peaks, analysis rows and ball carry")
    if b and dt_b.stride(0) not in (0, 1):
        raise ValueError(f"expected frame times with stride 0 or 1, got {dt_b.stride(0)}")
    if len({x.device for x in [outputs.peaks, *rows.values()]}) > 1:
        raise ValueError("the viewer stage takes tensors on one device")


def viewer_stage_plain(
    rng: VqtRange, state: BallState, outputs: AnalysisOutputs, dt
) -> tuple[BallState, ViewerOutputs]:
    """Plain PyTorch version: the functions of models/viewer.py on one hop's
    analysis outputs. Returns (the new ball carry, the viewer outputs)."""
    new_balls, ball_out = update_balls(
        rng, state, outputs.peaks, outputs.peak_center, outputs.peak_size, outputs.calmness,
        outputs.pitch_accuracy, outputs.pitch_deviation, dt,
    )
    return new_balls, ViewerOutputs(
        balls=ball_out,
        chroma=chroma_vector(outputs.x_vqt_smoothed, rng),
        bloom=bloom_intensity(outputs.scene_calmness),
        spectrogram_row=spectrogram_row_vqt(rng, outputs.x_vqt_smoothed),
        bass=bass_spiral(rng, outputs.peaks, outputs.peak_center, outputs.peak_size),
        calmness_histogram=calmness_histogram(outputs.calmness),
    )


def _viewer_stage_cuda(rng, state, outputs, dt_b):
    global launches
    b, n = outputs.peaks.shape
    bpo = rng.buckets_per_octave
    device = outputs.peaks.device
    if state.rgba.data_ptr() % 16:
        raise ValueError("the viewer stage takes a ball rgba carry on a 16-byte aligned base")
    n_segments = bass_cylinder_count(rng.octaves)

    def empty(*shape, dtype=torch.float32):
        return torch.empty((b, *shape), dtype=dtype, device=device)

    new = BallState(scale=empty(n), z_offset=empty(n), center=empty(n), rgba=empty(n, 4), calm=empty(n))
    position, visible = empty(n, 3), empty(n, dtype=torch.bool)
    chroma, bloom, spectrogram = empty(12), empty(), empty(n, 4, dtype=torch.uint8)
    bass = BassSpiralOutputs(visible=empty(n_segments, dtype=torch.bool), rgba=empty(4))
    contour = CalmnessHistogramOutputs(heights=empty(n), segment_rgb=empty(n - 1, 3))
    balls = BallOutputs(position=position, rgba=new.rgba, scale=new.scale, visible=visible, calmness=new.calm,
                        pitch_accuracy=outputs.pitch_accuracy, pitch_deviation=outputs.pitch_deviation)
    viewer = ViewerOutputs(balls=balls, chroma=chroma, bloom=bloom, spectrogram_row=spectrogram, bass=bass,
                           calmness_histogram=contour)
    if b == 0:
        return new, viewer

    chroma_index = static_table(_chroma_index, rng, device=device)
    palette = np.ascontiguousarray(COLORS, np.float32).tobytes()
    hide_radius = (bpo // 12) * 0.23
    args = (
        state.scale.data_ptr(), state.z_offset.data_ptr(), state.center.data_ptr(), state.rgba.data_ptr(),
        state.calm.data_ptr(), outputs.peaks.data_ptr(), outputs.peak_center.data_ptr(),
        outputs.peak_size.data_ptr(), outputs.calmness.data_ptr(), outputs.x_vqt_smoothed.data_ptr(),
        outputs.scene_calmness.data_ptr(), dt_b.data_ptr(), dt_b.stride(0),
        static_table(_dropoff_base, n, device=device).data_ptr(),
        static_table(_spectrogram_rgb_u8, rng, device=device).data_ptr(),
        chroma_index.data_ptr(), chroma_index.shape[1],
        static_table(_calmness_palette, device=device).data_ptr(),
        static_table(_palette_lch_host, palette, device=device).data_ptr(),
        static_table(_color_constants, device=device).data_ptr(),
        new.scale.data_ptr(), new.z_offset.data_ptr(), new.center.data_ptr(), new.rgba.data_ptr(),
        new.calm.data_ptr(), position.data_ptr(), visible.data_ptr(), chroma.data_ptr(), bloom.data_ptr(),
        spectrogram.data_ptr(), bass.visible.data_ptr(), bass.rgba.data_ptr(), contour.heights.data_ptr(),
        contour.segment_rgb.data_ptr(),
        b, n, bpo, pitch_color_rotation(bpo), n_segments, hide_radius, int(hide_radius) + 2,
        torch.cuda.current_stream(device).cuda_stream,
    )
    fn = _kernel()
    # the launch goes to the current device: switch only if the tensors lie elsewhere
    if device.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(device):
            rc = fn(*args)
    nvcc.check(rc, "viewer_stage_f32")
    launches += 1
    return new, viewer


def viewer_stage(
    rng: VqtRange, state: BallState, outputs: AnalysisOutputs, dt
) -> tuple[BallState, ViewerOutputs]:
    """One display frame for every stream from one hop's analysis outputs
    and the ball carry ``state``: the balls (models/viewer.py::update_balls
    with its defaults, the display's Normal mode), the chroma vector, the
    bloom, the VQT-mode spectrogram row, the bass spiral and the calmness
    contour. ``dt`` is the frame time in any form models/analysis.py::
    dt_batch takes. Returns (the new ball carry, the viewer outputs); the
    outputs' ball rgba, scale and calmness are the new carry's tensors, and
    the pitch accuracy and deviation those of ``outputs``. CUDA tensors go
    to the kernel (one launch, no host synchronisation), CPU tensors to
    :func:`viewer_stage_plain`."""
    device = outputs.peaks.device
    dt_b = dt_batch(dt, outputs.peaks.shape[0], device)
    _check(rng, state, outputs, dt_b)
    if device.type == "cuda":
        return _viewer_stage_cuda(rng, state, outputs, dt_b)
    if device.type == "cpu":
        return viewer_stage_plain(rng, state, outputs, dt_b)
    raise ValueError(f"unsupported device {device}")
