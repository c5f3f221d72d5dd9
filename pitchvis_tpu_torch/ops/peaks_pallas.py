"""The peaks kernel: from spectra to finished peak masks in one launch.

Port of ``pitchvis_tpu/ops/peaks_pallas.py::local_maxima_and_prominences_pallas``
as the hand-written CUDA kernel ``csrc/peaks.cu`` (one block per spectrum,
the row in shared memory). The JAX package lets XLA fuse the filters of
``find_peaks_mask`` behind its Pallas kernel; here the one kernel function
carries on through them itself:

* :func:`find_peaks_masks` (the analysis step's call): local maxima, then for
  each of up to two ``PeakDetectionParameters`` the ``min_height`` filter, the
  min-distance suppression as Jacobi rounds inside the block (to convergence
  by a block-wide vote, or a fixed number of rounds), the prominence at the
  surviving bins only, ``min_prominence`` and the first allowed bin. One bool
  mask per configuration, no host synchronisation.
* :func:`local_maxima_and_prominences`: the Pallas kernel's own outputs, the
  local-maximum mask and the prominence at every bin, from the same kernel
  function with its primitive outputs switched on.

Both equal their plain versions bit for bit (:func:`find_peaks_masks_plain`,
:func:`local_maxima_and_prominences_plain`, composed of
:mod:`~pitchvis_tpu_torch.ops.peaks`), which run for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..core.config import PeakDetectionParameters
from ..utils import nvcc
from .peaks import (
    find_peaks_mask,
    first_allowed_bin,
    local_maxima,
    min_separation_bins,
    prominences,
)

# launches of the CUDA kernel (the plain versions do not count)
launches = 0

# frames per chunk of the plain versions: their (rows, n, n) intermediates at
# n=588 are ~1.4 MB a frame and plane
_PLAIN_ROWS = 128

_peaks_f32 = None


def _kernel():
    """``peaks_f32`` of the built library, its signature bound once."""
    global _peaks_f32
    if _peaks_f32 is None:
        fn = nvcc.library("peaks").peaks_f32
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_float] * 4
            + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 5
        )
        _peaks_f32 = fn
    return _peaks_f32


def _launch(x, configs, distance, rounds, min_bin, out, lmax, prom) -> None:
    """One launch of the kernel on (B, n) f32 rows of unit inner stride.
    ``out``: (len(configs), B, n) bool; ``lmax``, ``prom``: (B, n) bool and
    f32; contiguous, or None for outputs the call does not ask for."""
    global launches
    b, n = x.shape
    thresholds = [0.0] * 4
    for c, cfg in enumerate(configs):
        thresholds[2 * c] = cfg.min_height
        thresholds[2 * c + 1] = cfg.min_prominence
    out0 = None if out is None else out.data_ptr()
    out1 = out0 + b * n if len(configs) > 1 else None
    args = (
        x.data_ptr(), x.stride(0), b, n, len(configs), *thresholds, distance, rounds, min_bin,
        out0, out1,
        None if lmax is None else lmax.data_ptr(),
        None if prom is None else prom.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    # the launch goes to the current device: switch only if x lies elsewhere
    if x.device.index == torch.cuda.current_device():
        rc = _kernel()(*args)
    else:
        with torch.cuda.device(x.device):
            rc = _kernel()(*args)
    nvcc.check(rc, "peaks_f32")
    launches += 1


def _kernel_rows(x: torch.Tensor) -> torch.Tensor:
    """Checks what the kernel takes and returns rows of unit inner stride
    (any row stride and any alignment go to the kernel as they are)."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"peaks kernel takes (B, n) float32, got {x.dtype} {tuple(x.shape)}")
    return x if x.stride(1) == 1 else x.contiguous()


def local_maxima_and_prominences_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, chunked over frames to bound its memory."""
    masks, proms = [], []
    for part in torch.split(x, _PLAIN_ROWS, dim=0):
        masks.append(local_maxima(part))
        proms.append(prominences(part))
    if not masks:
        return torch.zeros_like(x, dtype=torch.bool), torch.empty_like(x)
    return torch.cat(masks), torch.cat(proms)


def local_maxima_and_prominences(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) spectra -> ((B, n) bool local-max mask, (B, n) f32 prominence).
    A CUDA tensor goes to the kernel, a CPU tensor to the plain version."""
    if x.device.type == "cpu":
        return local_maxima_and_prominences_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = _kernel_rows(x)
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    prom = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel():
        _launch(x, (), 0, 0, 0, None, mask, prom)
    return mask, prom


def _check_configs(configs: Sequence[PeakDetectionParameters], suppress_iterations) -> None:
    if not 1 <= len(configs) <= 2:
        raise ValueError(f"find_peaks_masks takes one or two configurations, got {len(configs)}")
    if suppress_iterations is not None and suppress_iterations < 0:
        raise ValueError(f"suppress_iterations must be None or >= 0, got {suppress_iterations}")


def find_peaks_masks_plain(
    x: torch.Tensor,
    configs: Sequence[PeakDetectionParameters],
    buckets_per_octave: int,
    suppress_iterations: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`find_peaks_masks`: the local maxima
    and prominences once, then ``find_peaks_mask`` for each configuration.
    Chunked over frames to bound its memory."""
    _check_configs(configs, suppress_iterations)
    parts = [[] for _ in configs]
    for part in torch.split(x, _PLAIN_ROWS, dim=0):
        pre = (local_maxima(part), prominences(part))
        for out, cfg in zip(parts, configs):
            out.append(
                find_peaks_mask(
                    part, cfg, buckets_per_octave,
                    precomputed=pre, suppress_iterations=suppress_iterations,
                )
            )
    if not parts[0]:
        return tuple(torch.zeros_like(x, dtype=torch.bool) for _ in configs)
    return tuple(torch.cat(p) for p in parts)


def find_peaks_masks(
    x: torch.Tensor,
    configs: Sequence[PeakDetectionParameters],
    buckets_per_octave: int,
    suppress_iterations: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """(B, n) dB spectra -> one (B, n) bool peak mask per configuration,
    each equal to ``ops.peaks.find_peaks_mask(x, config, buckets_per_octave,
    suppress_iterations=...)``: local maxima at or above ``min_height``,
    thinned to the minimum separation (``suppress_iterations=None``: to the
    exact greedy result; an int: that many Jacobi rounds), with at least
    ``min_prominence``, from the first allowed bin up.

    A CUDA tensor goes to the kernel (one launch, no host synchronisation),
    a CPU tensor to the plain version."""
    if x.device.type == "cpu":
        return find_peaks_masks_plain(x, configs, buckets_per_octave, suppress_iterations)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_configs(configs, suppress_iterations)
    x = _kernel_rows(x)
    b, n = x.shape
    out = torch.empty((len(configs), b, n), dtype=torch.bool, device=x.device)
    if x.numel():
        _launch(
            x, configs,
            min_separation_bins(buckets_per_octave),
            -1 if suppress_iterations is None else suppress_iterations,
            first_allowed_bin(buckets_per_octave),
            out, None, None,
        )
    return tuple(out.unbind(0))
