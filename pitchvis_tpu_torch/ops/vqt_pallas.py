"""Fused multi-group VQT kernel.

Port of ``pitchvis_tpu/ops/vqt_pallas.py``: one launch of the hand-written
CUDA kernel ``csrc/vqt.cu`` computes the whole multi-group VQT power
spectrum. Every window group reads its slice of the batch's trailing
``tail`` samples in place (all groups nest inside the largest group's
window), and the complex magnitude-squared is fused into the kernel, so only
(B, n_buckets) power leaves it.

Group weights are zero-padded to multiples of 128 filter columns at pack
time, the re and im halves separately, as in the JAX package; the kernel
tiles filters by 64, which divides the padding. One kernel serves both
weight dtypes: f32 (exact FFMA sums, never TF32) and bf16 (fast mode: bf16
inputs and weights, products and sums in f32).

:func:`vqt_power_pallas_plain` is the kernel's plain PyTorch version, run
for CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..kernel.builder import VqtKernel
from ..utils import nvcc
from .vqt import matmul_f32, power_to_db, precision_for

LANE = 128
MAX_GROUPS = 16  # csrc/vqt.cu MAX_GROUPS
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel (the plain version does not count)
launches = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class PallasVqtArrays:
    """Padded per-group weights + static geometry for the fused kernel."""

    weights: tuple[torch.Tensor, ...]  # per group (w_g, 2*nf_pad_g)
    offsets: tuple[int, ...]  # group window offset within the tail
    window_sizes: tuple[int, ...]
    nf: tuple[int, ...]  # true filter counts
    nf_pad: tuple[int, ...]
    tail: int  # tail window size (largest group window)
    n_fft: int
    n_buckets: int

    @classmethod
    def from_kernel(
        cls, kernel: VqtKernel, dtype=torch.float32, device="cpu"
    ) -> "PallasVqtArrays":
        n_fft = kernel.params.n_fft
        tail_begin = min(g.window[0] for g in kernel.window_groups)
        tail = n_fft - tail_begin
        weights, offsets, sizes, nf, nf_pad = [], [], [], [], []
        for g in kernel.window_groups:
            begin, end = g.window
            if begin < tail_begin or end > n_fft:
                raise ValueError("group window outside tail")
            w = g.w_time  # (window, 2*nf)
            f = g.n_filters
            fp = _round_up(f, LANE)
            padded = np.zeros((w.shape[0], 2 * fp), np.float32)
            padded[:, :f] = w[:, :f]  # re half
            padded[:, fp : fp + f] = w[:, f:]  # im half
            weights.append(torch.from_numpy(padded).to(device=device, dtype=dtype))
            offsets.append(begin - tail_begin)
            sizes.append(w.shape[0])
            nf.append(f)
            nf_pad.append(fp)
        return cls(
            weights=tuple(weights),
            offsets=tuple(offsets),
            window_sizes=tuple(sizes),
            nf=tuple(nf),
            nf_pad=tuple(nf_pad),
            tail=tail,
            n_fft=n_fft,
            n_buckets=kernel.n_buckets,
        )


def _tail(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"expected (B, n_fft) or (B, tail) frames, got {tuple(x.shape)}")
    if x.shape[1] == arrays.n_fft:
        x = x[:, arrays.n_fft - arrays.tail :]
    if x.shape[1] != arrays.tail:
        raise ValueError(f"expected tail {arrays.tail}, got {x.shape[1]}")
    return x


def vqt_power_pallas_plain(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per group, the input slice rounded
    to the weights' pairing, an f32 product with the padded weights, then
    re^2 + im^2 on the true filter columns."""
    x = _tail(arrays, x)
    parts = []
    for w, off, size, f, fp in zip(
        arrays.weights, arrays.offsets, arrays.window_sizes, arrays.nf, arrays.nf_pad
    ):
        y = matmul_f32(x[:, off : off + size].to(precision_for(w.dtype)), w)
        re = y[:, :f]
        im = y[:, fp : fp + f]
        parts.append(re * re + im * im)
    return torch.cat(parts, dim=-1)


def _vqt_power_cuda(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    global launches
    x = _tail(arrays, x)
    w_dtype = arrays.weights[0].dtype
    if w_dtype not in _DTYPE_CODE:
        raise TypeError(f"VQT kernel takes f32 or bf16 weights, got {w_dtype}")
    n_groups = len(arrays.weights)
    if n_groups > MAX_GROUPS:
        raise ValueError(f"VQT kernel takes at most {MAX_GROUPS} window groups, got {n_groups}")
    for w, size, fp in zip(arrays.weights, arrays.window_sizes, arrays.nf_pad):
        if w.device != x.device or w.dtype != w_dtype or not w.is_contiguous():
            raise ValueError("weights must be contiguous, of one dtype, on the input's device")
        if tuple(w.shape) != (size, 2 * fp) or fp % 64 != 0:
            raise ValueError(f"weights {tuple(w.shape)} do not match the group geometry")
    if x.dtype != torch.float32:
        raise TypeError(f"VQT kernel takes f32 frames, got {x.dtype}")
    # fast mode: round the tail to bf16 before the launch (as the JAX package
    # casts before its pallas_call), which also halves the kernel's input reads
    x = x.to(precision_for(w_dtype))
    if x.stride(1) != 1:
        x = x.contiguous()
    b = x.shape[0]
    out = torch.empty((b, arrays.n_buckets), dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * n_groups)(*[w.data_ptr() for w in arrays.weights])

    def ints(v):
        return (ctypes.c_int * n_groups)(*v)

    fn = nvcc.library("vqt").vqt_power
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODE[w_dtype], x.data_ptr(), b, x.stride(0), n_groups,
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(ints(arrays.offsets), ctypes.c_void_p),
            ctypes.cast(ints(arrays.window_sizes), ctypes.c_void_p),
            ctypes.cast(ints(arrays.nf), ctypes.c_void_p),
            ctypes.cast(ints(arrays.nf_pad), ctypes.c_void_p),
            out.data_ptr(), arrays.n_buckets, stream,
        )
    nvcc.check(rc, "vqt_power")
    launches += 1
    return out


def vqt_power_pallas(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    """|VQT|^2 of a batch of frames via the fused kernel.

    x: (B, n_fft) or (B, tail) f32 -> (B, n_buckets) f32. A CUDA tensor goes
    to the kernel, a CPU tensor to :func:`vqt_power_pallas_plain`."""
    if x.device.type == "cuda":
        return _vqt_power_cuda(arrays, x)
    if x.device.type == "cpu":
        return vqt_power_pallas_plain(arrays, x)
    raise ValueError(f"unsupported device {x.device}")


def vqt_db_pallas(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    return power_to_db(vqt_power_pallas(arrays, x))
