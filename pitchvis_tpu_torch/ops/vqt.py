"""Batched VQT transform.

Port of ``pitchvis_tpu/ops/vqt.py``, the counterpart of
`Vqt::calculate_vqt_instant_in_db` (pitchvis_analysis/src/vqt.rs:866-916).
Paths, all driven by the packed kernel from
:mod:`pitchvis_tpu_torch.kernel.builder`:

* ``path="time"``: the sparsified frequency kernel folded through the DFT at
  build time, so each window group is one dense product
  ``x_window @ w_time -> [Re y | Im y]``, left to ``torch.matmul`` with TF32
  off (the JAX package leaves it to XLA outside any kernel).
* ``path="freq"``: per window group, the batched real FFT of the input slice
  (``torch.fft.rfft``, cuFFT on the card), then one product
  ``[Re X | Im X] @ w_freq -> [Re y | Im y]``, again ``torch.matmul`` with
  TF32 off (the JAX package computes both outside any kernel).
* ``path="pallas"``: the fused hand-written kernel of
  :mod:`pitchvis_tpu_torch.ops.vqt_pallas` (all groups in one launch).

The dB conversion (vqt.rs:922-954) is plain PyTorch after the product.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import VqtParameters
from ..core.device import resolve_device
from ..kernel.builder import VqtKernel, get_kernel
from ..utils.profiling import annotate

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


PRECISIONS = ("highest", "default")


def check_precision(precision) -> str | None:
    """``Vqt(precision=)``: None, "highest" or "default" (the JAX package's
    jax.lax.Precision names, case aside). The dense paths round their input
    to the weights' dtype and multiply in float32, TF32 off, under both:
    "highest" is float32 products; "default" is the one-pass pairing of the
    weight dtype (bf16 x bf16 products, exact in float32, for bf16 weights;
    float32 weights have one pairing, float32 products)."""
    if precision is None:
        return None
    name = str(precision).lower()
    if name not in PRECISIONS:
        raise ValueError(f"precision must be None, 'highest' or 'default', got {precision!r}")
    return name


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with both operands in float32, the counterpart of XLA's
    Precision.HIGHEST. On the card it raises if TF32 is on
    (``torch.backends.cuda.matmul.allow_tf32``) instead of changing that
    process-wide flag itself: :func:`make_vqt_arrays` turns it off once for
    the ``time`` and ``freq`` paths."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the float32 VQT product needs torch.backends.cuda.matmul.allow_tf32 = False"
        )
    return a.float() @ w.float()


@dataclass
class VqtArrays:
    """Device-resident dense weights of the ``time`` and ``freq`` paths."""

    w_freq: tuple[torch.Tensor, ...]  # per group (2*n_spec, 2*n_filt); () unless uploaded
    w_time: tuple[torch.Tensor, ...]  # per group (window, 2*n_filt); () unless uploaded
    windows: tuple[tuple[int, int], ...]
    n_filters: tuple[int, ...]
    n_fft: int
    n_buckets: int

    @classmethod
    def from_kernel(
        cls, kernel: VqtKernel, dtype=torch.float32, path: str | None = None, device="cuda"
    ) -> "VqtArrays":
        """``path``: upload only the weight set that path uses ("time" or
        "freq"); None uploads both (the sets are comparable in size, and the
        unused one would double the weights' device memory)."""
        device = resolve_device(device)
        groups = kernel.window_groups

        def upload(name):
            return tuple(torch.from_numpy(getattr(g, name)).to(device=device, dtype=dtype) for g in groups)

        return cls(
            w_freq=upload("w_freq") if path in (None, "freq") else (),
            w_time=upload("w_time") if path in (None, "time") else (),
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


def _group_power_freq(x_win: torch.Tensor, w_freq: torch.Tensor) -> torch.Tensor:
    """rFFT + one product -> |y|^2 for one window group. x_win: (B,
    window_size) f32; returns (B, n_filt) f32. The packed spectrum
    ``[Re X | Im X]`` is rounded to the weights' pairing (precision_for)
    before the float32 product, as in :func:`_group_power_time`."""
    spec = torch.fft.rfft(x_win.float())  # (B, n_spec) complex64
    packed = torch.cat([spec.real, spec.imag], dim=-1)  # (B, 2*n_spec)
    y = matmul_f32(packed.to(precision_for(w_freq.dtype)), w_freq)
    n_filt = w_freq.shape[1] // 2
    re = y[:, :n_filt]
    im = y[:, n_filt:]
    return re * re + im * im


def vqt_power_batch(arrays: VqtArrays, x: torch.Tensor, *, path: str = "time") -> torch.Tensor:
    """|VQT|^2 of a batch of frames. x: (B, n_fft) f32 -> (B, n_buckets)."""
    if x.dim() != 2 or x.shape[1] != arrays.n_fft:
        raise ValueError(f"input must be (B, n_fft={arrays.n_fft}), got {tuple(x.shape)}")
    if path == "time":
        group_power, weights = _group_power_time, arrays.w_time
    elif path == "freq":
        group_power, weights = _group_power_freq, arrays.w_freq
    else:
        raise ValueError(f"unknown VQT path {path!r}")
    if len(weights) != len(arrays.windows):
        raise ValueError(f"these VqtArrays hold no weights for path {path!r} (VqtArrays.from_kernel(path=))")
    parts = [group_power(x[:, begin:end], w) for (begin, end), w in zip(arrays.windows, weights)]
    return torch.cat(parts, dim=-1)


def vqt_db_batch(arrays: VqtArrays, x: torch.Tensor, *, path: str = "time") -> torch.Tensor:
    """Batched VQT in dB. (B, n_fft) -> (B, n_buckets)."""
    return power_to_db(vqt_power_batch(arrays, x, path=path))


def make_vqt_arrays(
    kernel: VqtKernel, *, path: str = "time", fast: bool = False, device="cuda"
):
    """Uniform kernel-upload constructor for every serving entry point.

    Returns :class:`VqtArrays` for the dense paths ("time" / "freq", only
    that path's weights) or
    :class:`~pitchvis_tpu_torch.ops.vqt_pallas.PallasVqtArrays` for the fused
    kernel (``path="pallas"``). ``fast=True`` stores the weights in bf16.
    ``device`` defaults to the card and raises without CUDA. On the card the
    dense paths' products go to ``torch.matmul`` in full float32, so this
    sets ``torch.backends.cuda.matmul.allow_tf32 = False`` for the process."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if fast else torch.float32
    if path == "pallas":
        from .vqt_pallas import PallasVqtArrays

        return PallasVqtArrays.from_kernel(kernel, dtype=dtype, device=device)
    if path not in ("time", "freq"):
        raise ValueError(f"unknown VQT path {path!r}")
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return VqtArrays.from_kernel(kernel, dtype=dtype, path=path, device=device)


def vqt_db_auto(arrays, x: torch.Tensor, *, path: str = "time") -> torch.Tensor:
    """Path-dispatching dB VQT used by the streaming pipeline and the
    server: routes ``path="pallas"`` to the fused kernel and the dense paths
    ("time" / "freq") through :func:`vqt_db_batch`."""
    with annotate("stage.vqt"):
        if path == "pallas":
            from .vqt_pallas import vqt_db_pallas

            return vqt_db_pallas(arrays, x)
        return vqt_db_batch(arrays, x, path=path)


class Vqt:
    """User-facing VQT analyzer, API-compatible in spirit with the reference's
    ``Vqt`` (vqt.rs:440-505): ``Vqt(params)`` builds + uploads the kernel;
    :meth:`calculate_vqt_instant_in_db` computes one frame; the batched entry
    points are the extension.

    ``path``: "time" (dense products), "freq" (batched rFFT + one product
    per group, the reference's structure) or "pallas" (the fused
    hand-written kernel). ``fast=True`` stores the weights in bf16 and
    rounds the input to bf16, with products and sums in f32. ``precision``
    (None, "highest" or "default"; :func:`check_precision`) applies to the
    dense paths; ``path="pallas"`` pairs it with the weight dtype and
    raises if one is given. ``device`` defaults to the card.
    """

    def __init__(
        self,
        params: VqtParameters | None = None,
        *,
        path: str = "time",
        precision=None,
        fast: bool = False,
        device="cuda",
    ):
        self.params = params or VqtParameters()
        self.device = resolve_device(device)
        precision = check_precision(precision)
        if precision is not None and path == "pallas":
            # the fused kernel derives its precision from the weight dtype
            # (fast=False -> f32, fast=True -> bf16 one-pass); silently
            # accepting e.g. "highest" with bf16 weights would hand the user
            # less precision than they asked for
            raise ValueError(
                "path='pallas' pairs precision with the weight dtype "
                "(use fast=False for exact f32); precision applies to the "
                "dense 'time'/'freq' paths"
            )
        self.kernel = get_kernel(self.params)
        self.path = path
        self.fast = fast
        # the pairing every other entry point uses: bf16 weights -> one-pass
        # "default", f32 -> "highest". An explicit argument wins.
        self.precision = precision or ("default" if fast else "highest")
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
