"""Batched VQT transform.

Port of ``pitchvis_tpu/ops/vqt.py``, the counterpart of
`Vqt::calculate_vqt_instant_in_db` (pitchvis_analysis/src/vqt.rs:866-916).
Paths, both driven by the packed kernel from
:mod:`pitchvis_tpu_torch.kernel.builder`:

* ``path="time"``: the sparsified frequency kernel folded through the DFT at
  build time, so each window group is one dense product
  ``x_window @ w_time -> [Re y | Im y]``, left to ``torch.matmul`` with TF32
  off (the JAX package leaves it to XLA outside any kernel).
* ``path="pallas"``: the fused hand-written kernel of
  :mod:`pitchvis_tpu_torch.ops.vqt_pallas` (all groups in one launch).

The ``freq`` path (batched rFFT + one product per group) is not ported yet.
The dB conversion (vqt.rs:922-954) is plain PyTorch after the product.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import VqtParameters
from ..core.device import resolve_device
from ..kernel.builder import VqtKernel, get_kernel

REF_POWER = 0.3 * 0.3
A_MIN = 1e-6 * 1e-6
TOP_DB = 60.0


def power_to_db(power: torch.Tensor) -> torch.Tensor:
    """dB relative to REF_POWER, clamped to TOP_DB below the frame max and
    shifted non-negative (vqt.rs:922-954). ``power`` is |y|^2 with shape
    (..., n_buckets); reductions run over the last axis."""
    ref_db = 10.0 * np.log10(REF_POWER)
    log_spec = 10.0 * torch.log10(torch.clamp_min(power, A_MIN)) - ref_db

    log_spec_max = log_spec.amax(dim=-1, keepdim=True)
    log_spec_min = log_spec.amin(dim=-1, keepdim=True)
    floor = log_spec_max - TOP_DB
    log_spec_min = torch.maximum(log_spec_min, floor)

    clamped = torch.maximum(log_spec, floor)
    return torch.where(log_spec_min > 0.0, clamped - log_spec_min, torch.clamp_min(clamped, 0.0))


def precision_for(weight_dtype: torch.dtype) -> torch.dtype:
    """The pairing every entry point makes with a weight dtype: the dtype
    the input frames are rounded to before the product. bf16 weights -> bf16
    inputs (fast mode: every bf16 x bf16 product is exact in f32 and summed in
    f32); f32 weights -> f32 inputs, products to f32 accuracy summed in f32
    (never single-pass TF32; the fused kernel's 3xTF32 keeps 3e-4 dB to the
    float64 oracle)."""
    return torch.bfloat16 if weight_dtype == torch.bfloat16 else torch.float32


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with both operands in float32, the counterpart of XLA's
    Precision.HIGHEST. On the card it raises if TF32 is on
    (``torch.backends.cuda.matmul.allow_tf32``) instead of changing that
    process-wide flag itself: :func:`make_vqt_arrays` turns it off once for
    the ``time`` path."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the float32 VQT product needs torch.backends.cuda.matmul.allow_tf32 = False"
        )
    return a.float() @ w.float()


@dataclass
class VqtArrays:
    """Device-resident dense weights of the ``time`` path."""

    w_time: tuple[torch.Tensor, ...]  # per group (window, 2*n_filt)
    windows: tuple[tuple[int, int], ...]
    n_filters: tuple[int, ...]
    n_fft: int
    n_buckets: int

    @classmethod
    def from_kernel(
        cls, kernel: VqtKernel, dtype=torch.float32, device="cuda"
    ) -> "VqtArrays":
        device = resolve_device(device)
        groups = kernel.window_groups
        return cls(
            w_time=tuple(
                torch.from_numpy(g.w_time).to(device=device, dtype=dtype) for g in groups
            ),
            windows=tuple(g.window for g in groups),
            n_filters=tuple(g.n_filters for g in groups),
            n_fft=kernel.params.n_fft,
            n_buckets=kernel.n_buckets,
        )


def _group_power_time(x_win: torch.Tensor, w_time: torch.Tensor) -> torch.Tensor:
    """Single time-domain product -> |y|^2 for one window group. The product
    runs in f32 on inputs rounded to the weights' pairing (precision_for):
    ``torch.matmul`` of two bf16 tensors would round its output to bf16."""
    y = matmul_f32(x_win.to(precision_for(w_time.dtype)), w_time)
    n_filt = w_time.shape[1] // 2
    re = y[:, :n_filt]
    im = y[:, n_filt:]
    return re * re + im * im


def vqt_power_batch(arrays: VqtArrays, x: torch.Tensor, *, path: str = "time") -> torch.Tensor:
    """|VQT|^2 of a batch of frames. x: (B, n_fft) f32 -> (B, n_buckets)."""
    if x.dim() != 2 or x.shape[1] != arrays.n_fft:
        raise ValueError(f"input must be (B, n_fft={arrays.n_fft}), got {tuple(x.shape)}")
    if path != "time":
        raise ValueError(f"unknown VQT path {path!r} (the port has 'time' and 'pallas')")
    parts = [
        _group_power_time(x[:, begin:end], w)
        for (begin, end), w in zip(arrays.windows, arrays.w_time)
    ]
    return torch.cat(parts, dim=-1)


def vqt_db_batch(arrays: VqtArrays, x: torch.Tensor, *, path: str = "time") -> torch.Tensor:
    """Batched VQT in dB. (B, n_fft) -> (B, n_buckets)."""
    return power_to_db(vqt_power_batch(arrays, x, path=path))


def make_vqt_arrays(
    kernel: VqtKernel, *, path: str = "time", fast: bool = False, device="cuda"
):
    """Uniform kernel-upload constructor for every serving entry point.

    Returns :class:`VqtArrays` for ``path="time"`` or
    :class:`~pitchvis_tpu_torch.ops.vqt_pallas.PallasVqtArrays` for the fused
    kernel (``path="pallas"``). ``fast=True`` stores the weights in bf16.
    ``device`` defaults to the card and raises without CUDA. On the card the
    ``time`` path's products go to ``torch.matmul`` in full float32, so this
    sets ``torch.backends.cuda.matmul.allow_tf32 = False`` for the process."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if fast else torch.float32
    if path == "pallas":
        from .vqt_pallas import PallasVqtArrays

        return PallasVqtArrays.from_kernel(kernel, dtype=dtype, device=device)
    if path != "time":
        raise ValueError(f"unknown VQT path {path!r} (the port has 'time' and 'pallas')")
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return VqtArrays.from_kernel(kernel, dtype=dtype, device=device)


def vqt_db_auto(arrays, x: torch.Tensor, *, path: str = "time") -> torch.Tensor:
    """Path-dispatching dB VQT used by the streaming pipeline: routes
    ``path="pallas"`` to the fused kernel and ``"time"`` through
    :func:`vqt_db_batch`."""
    if path == "pallas":
        from .vqt_pallas import vqt_db_pallas

        return vqt_db_pallas(arrays, x)
    return vqt_db_batch(arrays, x, path=path)


class Vqt:
    """User-facing VQT analyzer, API-compatible in spirit with the reference's
    ``Vqt`` (vqt.rs:440-505): ``Vqt(params)`` builds + uploads the kernel;
    :meth:`calculate_vqt_instant_in_db` computes one frame; the batched entry
    points are the extension.

    ``path``: "time" (dense products) or "pallas" (the fused hand-written
    kernel). ``fast=True`` stores the weights in bf16 and rounds the input to
    bf16, with products and sums in f32. ``device`` defaults to the card.
    """

    def __init__(
        self,
        params: VqtParameters | None = None,
        *,
        path: str = "time",
        fast: bool = False,
        device="cuda",
    ):
        self.params = params or VqtParameters()
        self.device = resolve_device(device)
        self.kernel = get_kernel(self.params)
        self.path = path
        self.fast = fast
        self.delay_secs = self.kernel.delay_secs
        self.arrays = make_vqt_arrays(self.kernel, path=path, fast=fast, device=self.device)

    @property
    def n_buckets(self) -> int:
        return self.params.n_buckets

    @property
    def delay(self) -> float:
        """Algorithmic latency in seconds (vqt.rs:505, 756)."""
        return self.delay_secs

    def _frames(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, dtype=np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    def calculate_vqt_instant_in_db(self, x) -> np.ndarray:
        """Single-frame convenience wrapper (vqt.rs:866). x: (n_fft,)."""
        return self.calculate_vqt_batch_in_db(self._frames(x)[None, :])[0].cpu().numpy()

    def calculate_vqt_batch_in_db(self, x) -> torch.Tensor:
        """Batched frames: (B, n_fft) -> (B, n_buckets) in dB."""
        return vqt_db_auto(self.arrays, self._frames(x), path=self.path)

    def calculate_vqt_batch_power(self, x) -> torch.Tensor:
        frames = self._frames(x)
        if self.path == "pallas":
            from .vqt_pallas import vqt_power_pallas

            return vqt_power_pallas(self.arrays, frames)
        return vqt_power_batch(self.arrays, frames, path=self.path)
