"""Digital automatic gain control.

Port of ``pitchvis_tpu/ops/agc.py``: the dagc `MonoAgc` recurrence
(dagc_fork/src/lib.rs:76-87):

    x' = x * gain
    if not frozen:
        y = x'^2 / desired_output_rms
        g = max(1 + k * (1 - y), k)        # k = distortion_factor
        gain *= g

The gain is frozen for a whole chunk when the *pre-gain* chunk energy is
below 1e-6 (pitchvis_audio/src/audio_desktop.rs:99-127).

On the card :func:`agc_chunk` launches the hand-written kernel
``csrc/agc.cu`` (one thread per stream); on the CPU it runs
:func:`agc_chunk_plain`, a loop over the chunk's samples. Both round as the
JAX package's CPU scan does, where XLA contracts ``1 - y`` and
``1 + k * (1 - y)`` into fused multiply-adds: the kernel calls ``__fmaf_rn``
and the plain version computes those two fused products exactly in float64
(:func:`fma_f32`), so the three agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.config import AgcParameters
from ..utils import nvcc

SILENCE_ENERGY = 1e-6

# launches of the CUDA kernel (the plain version does not count)
launches = 0


def _constants(params: AgcParameters) -> tuple[float, float]:
    """(k, 1/desired_rms) as float32 values, the constants JAX folds."""
    return (
        float(np.float32(params.distortion_factor)),
        float(np.float32(1.0 / params.desired_output_rms)),
    )


def fma_f32(a: torch.Tensor, b: torch.Tensor | float, c: torch.Tensor | float) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, like the hardware's fused
    multiply-add. The product of two float32 values is exact in float64; the
    float64 sum is rounded once more, which can only go wrong where it lands
    exactly halfway between two float32 values, and there the exact error of
    the sum (Knuth's TwoSum) decides the direction."""
    a64 = a.double()
    b64 = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    c64 = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    p = a64 * b64
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    r = s.float()
    r64 = r.double()
    toward = torch.where(s > r64, torch.inf, -torch.inf).float()
    nb = torch.nextafter(r, toward)
    halfway = (s != r64) & (s == (r64 + nb.double()) * 0.5) & (err != 0)
    up = torch.maximum(r, nb)
    down = torch.minimum(r, nb)
    return torch.where(halfway, torch.where(err > 0, up, down), r)


def agc_chunk_plain(
    gain: torch.Tensor, chunk: torch.Tensor, params: AgcParameters = AgcParameters()
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (B,) gain, (B, T) chunk ->
    (new_gain, processed_chunk)."""
    k, inv_rms = _constants(params)
    frozen = (chunk * chunk).sum(dim=-1) < SILENCE_ENERGY
    kt = torch.tensor(k, dtype=torch.float32, device=chunk.device)
    g = gain
    outs = []
    for t in range(chunk.shape[-1]):
        out = chunk[:, t] * g
        outs.append(out)
        one_minus_y = fma_f32(-(out * out), inv_rms, 1.0)
        upd = torch.maximum(fma_f32(one_minus_y, k, 1.0), kt)
        g = torch.where(frozen, g, g * upd)
    processed = torch.stack(outs, dim=-1) if outs else torch.empty_like(chunk)
    return g, processed


def _agc_chunk_cuda(gain, chunk, params):
    global launches
    if chunk.dtype != torch.float32 or gain.dtype != torch.float32:
        raise TypeError("agc kernel takes float32 gain and chunk")
    if chunk.dim() != 2 or gain.shape != (chunk.shape[0],):
        raise ValueError(f"expected gain (B,) and chunk (B, T), got {tuple(gain.shape)}, {tuple(chunk.shape)}")
    if gain.device != chunk.device:
        raise ValueError("gain and chunk must be on the same device")
    chunk = chunk.contiguous()
    gain = gain.contiguous()
    b, t = chunk.shape
    out = torch.empty_like(chunk)
    gain_out = torch.empty_like(gain)
    k, inv_rms = _constants(params)
    lib = nvcc.library("agc")
    fn = lib.agc_chunk_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(chunk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            chunk.data_ptr(), gain.data_ptr(), out.data_ptr(), gain_out.data_ptr(),
            b, t, k, inv_rms, SILENCE_ENERGY, stream,
        )
    nvcc.check(rc, "agc_chunk_f32")
    launches += 1
    return gain_out, out


def agc_chunk(
    gain: torch.Tensor, chunk: torch.Tensor, params: AgcParameters = AgcParameters()
) -> tuple[torch.Tensor, torch.Tensor]:
    """Applies AGC to one chunk of samples per stream.

    gain: (B,) current gain per stream; chunk: (B, T) raw samples.
    Returns (new_gain, processed_chunk). A CUDA tensor goes to the kernel, a
    CPU tensor to :func:`agc_chunk_plain`."""
    if chunk.device.type == "cuda":
        return _agc_chunk_cuda(gain, chunk, params)
    if chunk.device.type == "cpu":
        return agc_chunk_plain(gain, chunk, params)
    raise ValueError(f"unsupported device {chunk.device}")

