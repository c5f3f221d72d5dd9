"""Peak primitives kernel: local-maximum mask and prominence at every bin.

Port of ``pitchvis_tpu/ops/peaks_pallas.py::local_maxima_and_prominences_pallas``
as the hand-written CUDA kernel ``csrc/peaks.cu`` (one block per spectrum,
one thread per bin, each scanning outward only as far as it must). Its
outputs equal :func:`~pitchvis_tpu_torch.ops.peaks.local_maxima` and
:func:`~pitchvis_tpu_torch.ops.peaks.prominences` bit for bit; those two are
its plain version, run for CPU tensors.

Unlike the JAX package, whose analysis step lets XLA fuse the O(n^2)
reductions of ``prominences_compact``, the port's analysis step calls this
kernel twice a hop (smoothed and raw spectrum).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc
from .peaks import local_maxima, prominences

# launches of the CUDA kernel (the plain version does not count)
launches = 0

# frames per chunk of the plain version: its (rows, n, n) intermediates at
# n=588 are ~1.4 MB a frame and plane
_PLAIN_ROWS = 128


def local_maxima_and_prominences_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, chunked over frames to bound its memory."""
    masks, proms = [], []
    for part in torch.split(x, _PLAIN_ROWS, dim=0):
        masks.append(local_maxima(part))
        proms.append(prominences(part))
    if not masks:
        return torch.zeros_like(x, dtype=torch.bool), torch.empty_like(x)
    return torch.cat(masks), torch.cat(proms)


def _peaks_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"peaks kernel takes (B, n) float32, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    b, n = x.shape
    mask = torch.empty((b, n), dtype=torch.bool, device=x.device)
    prom = torch.empty((b, n), dtype=torch.float32, device=x.device)
    fn = nvcc.library("peaks").peaks_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), b, n, mask.data_ptr(), prom.data_ptr(), stream)
    nvcc.check(rc, "peaks_f32")
    launches += 1
    return mask, prom


def local_maxima_and_prominences(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) spectra -> ((B, n) bool local-max mask, (B, n) f32 prominence).
    A CUDA tensor goes to the kernel, a CPU tensor to the plain version."""
    if x.device.type == "cuda":
        return _peaks_cuda(x)
    if x.device.type == "cpu":
        return local_maxima_and_prominences_plain(x)
    raise ValueError(f"unsupported device {x.device}")
