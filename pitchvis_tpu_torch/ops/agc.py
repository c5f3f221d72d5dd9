"""Digital automatic gain control, and the ring push that carries it.

Port of ``pitchvis_tpu/ops/agc.py``: the dagc `MonoAgc` recurrence
(dagc_fork/src/lib.rs:76-87):

    x' = x * gain
    if not frozen:
        y = x'^2 / desired_output_rms
        g = max(1 + k * (1 - y), k)        # k = distortion_factor
        gain *= g

The gain is frozen for a whole chunk when the *pre-gain* chunk energy is
below 1e-6 (pitchvis_audio/src/audio_desktop.rs:99-127).

The hand-written kernel ``csrc/agc.cu`` has two modes of one function:

* :func:`agc_ring_push` (what ``stream/ring.py::ring_push`` calls for CUDA
  tensors): the whole ring push in one launch, non-finite rejection, the
  recurrence, the roll of the buffer and the append.
* :func:`agc_chunk`: the recurrence alone, (gain, chunk) -> (new gain,
  processed chunk); a CPU tensor goes to :func:`agc_chunk_plain`, a loop over
  the chunk's samples.

Both round as the JAX package's CPU scan does, where XLA contracts ``1 - y``
and ``1 + k * (1 - y)`` into fused multiply-adds: the kernel calls
``__fmaf_rn`` and the plain version computes those two fused products
exactly in float64 (:func:`fma_f32`), so the three agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.config import AgcParameters
from ..utils import nvcc

SILENCE_ENERGY = 1e-6

# launches of the CUDA kernel, both modes (the plain versions do not count)
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


_lib = None


def _kernels() -> ctypes.CDLL:
    """The built library, the signatures of its two entry points bound once."""
    global _lib
    if _lib is None:
        lib = nvcc.library("agc")
        ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        lib.agc_ring_push_f32.restype = ctypes.c_int
        lib.agc_ring_push_f32.argtypes = [ptr, i64, ptr, ptr, i64, ptr, ptr] + [i32] * 3 + [f32] * 3 + [ptr]
        lib.agc_chunk_f32.restype = ctypes.c_int
        lib.agc_chunk_f32.argtypes = [ptr, i64, ptr, ptr, ptr] + [i32] * 2 + [f32] * 3 + [ptr]
        _lib = lib
    return _lib


def _check(gain: torch.Tensor, chunk: torch.Tensor, buffer: torch.Tensor | None = None) -> None:
    """Raises on what the kernel does not take, before any library is
    loaded: float32 (B,) gain, (B, T) chunk and (B, L) buffer with T <= L,
    all on one CUDA device."""
    tensors = (gain, chunk) if buffer is None else (gain, chunk, buffer)
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"agc kernel takes float32 tensors, got {[x.dtype for x in tensors]}")
    if chunk.dim() != 2 or gain.shape != (chunk.shape[0],):
        raise ValueError(f"expected gain (B,) and chunk (B, T), got {tuple(gain.shape)}, {tuple(chunk.shape)}")
    if buffer is not None:
        if buffer.dim() != 2 or buffer.shape[0] != chunk.shape[0]:
            raise ValueError(f"expected buffer (B, L) for chunk {tuple(chunk.shape)}, got {tuple(buffer.shape)}")
        if chunk.shape[1] > buffer.shape[1]:
            raise ValueError(f"chunk of {chunk.shape[1]} samples exceeds the {buffer.shape[1]}-sample buffer")
    if len({x.device for x in tensors}) > 1:
        raise ValueError(f"agc kernel takes tensors on one device, got {[str(x.device) for x in tensors]}")
    if chunk.device.type != "cuda":
        raise ValueError(f"agc kernel takes CUDA tensors, got {chunk.device}")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x itself if its rows have unit inner stride (any row stride and
    alignment go to the kernel as they are), else a contiguous copy."""
    return x if x.shape[1] <= 1 or x.stride(1) == 1 else x.contiguous()


def _launch(fn, name: str, device: torch.device, args) -> None:
    global launches
    stream = torch.cuda.current_stream(device).cuda_stream
    # the launch goes to the current device: switch only if the tensors lie elsewhere
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    nvcc.check(rc, name)
    launches += 1


def agc_ring_push(
    buffer: torch.Tensor,
    gain: torch.Tensor,
    chunk: torch.Tensor,
    params: AgcParameters = AgcParameters(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ring push in one launch of the kernel on CUDA tensors: (B, L)
    buffer, (B,) gain, (B, T) chunk -> (new (B, L) buffer, new (B,) gain).
    A row whose chunk holds any non-finite sample keeps its buffer and gain;
    every other row is shifted left by T with its AGC-processed chunk
    appended. The inputs are left as they were. No host synchronisation."""
    _check(gain, chunk, buffer)
    b, length = buffer.shape
    t = chunk.shape[1]
    buffer, chunk, gain = _rows(buffer), _rows(chunk), gain.contiguous()
    new_buffer = torch.empty((b, length), dtype=torch.float32, device=buffer.device)
    new_gain = torch.empty_like(gain)
    if b:
        k, inv_rms = _constants(params)
        _launch(
            _kernels().agc_ring_push_f32, "agc_ring_push_f32", buffer.device,
            (buffer.data_ptr(), buffer.stride(0), gain.data_ptr(), chunk.data_ptr(), chunk.stride(0),
             new_buffer.data_ptr(), new_gain.data_ptr(), b, length, t, k, inv_rms, SILENCE_ENERGY),
        )
    return new_buffer, new_gain


def _agc_chunk_cuda(gain, chunk, params):
    _check(gain, chunk)
    b, t = chunk.shape
    chunk, gain = _rows(chunk), gain.contiguous()
    out = torch.empty((b, t), dtype=torch.float32, device=chunk.device)
    gain_out = torch.empty_like(gain)
    if b:
        k, inv_rms = _constants(params)
        _launch(
            _kernels().agc_chunk_f32, "agc_chunk_f32", chunk.device,
            (chunk.data_ptr(), chunk.stride(0), gain.data_ptr(), out.data_ptr(), gain_out.data_ptr(),
             b, t, k, inv_rms, SILENCE_ENERGY),
        )
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

