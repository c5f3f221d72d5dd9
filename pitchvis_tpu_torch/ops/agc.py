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

The hand-written kernel ``csrc/agc.cu`` has three modes:

* :func:`agc_ring_push` (what ``stream/ring.py::ring_push`` calls for CUDA
  tensors): the whole ring push in one launch, non-finite rejection, the
  recurrence, the roll of the buffer and the append.
* :func:`agc_chunk`: the recurrence alone, (gain, chunk) -> (new gain,
  processed chunk); a CPU tensor goes to :func:`agc_chunk_plain`, a loop over
  the chunk's samples.
* :func:`agc_signal`: the recurrence over whole signals cut into chunks, each
  chunk with its own silence freeze and the gain carried from chunk to chunk
  (the dataset's AGC, ``train/device_dataset.py``), all chunks of every row in
  one launch; a CPU tensor goes to :func:`agc_signal_plain`, a loop over the
  chunks of :func:`agc_chunk_plain`.

All round as the JAX package's CPU scan does, where XLA contracts ``1 - y``
and ``1 + k * (1 - y)`` into fused multiply-adds: the kernel calls
``__fmaf_rn`` and the plain version computes those two fused products
exactly in float64 (:func:`fma_f32`), so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.config import AgcParameters
from ..core.device import resolve_device
from ..utils import nvcc

SILENCE_ENERGY = 1e-6

# launches of the CUDA kernel (the plain versions do not count): its ring and
# chunk modes, and apart from them its signal mode
launches = 0
signal_launches = 0


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
    the sum (Knuth's TwoSum) decides the direction.

    Such a halfway value has at most 25 significant bits (the low 28 of its
    52 stored mantissa bits are zero) and is no float32 value itself. The
    correction runs only when some element is one: this test reads a flag
    back to the host, so on a CUDA tensor the function synchronises (it is
    the plain reference of the kernel, not a path of the card)."""
    a64 = a.double()
    b64 = b.double() if isinstance(b, torch.Tensor) else float(b)
    c64 = c.double() if isinstance(c, torch.Tensor) else float(c)
    p = a64 * b64
    s = p + c64
    r = s.float()
    maybe = ((s.view(torch.int64) & 0x0FFFFFFF) == 0) & (s != r.double())
    if not bool(maybe.any()):
        return r
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    r64 = r.double()
    toward = torch.where(s > r64, torch.inf, -torch.inf).float()
    nb = torch.nextafter(r, toward)
    halfway = (s != r64) & (s == (r64 + nb.double()) * 0.5) & (err != 0)
    up = torch.maximum(r, nb)
    down = torch.minimum(r, nb)
    return torch.where(halfway, torch.where(err > 0, up, down), r)


def agc_chunk_plain(
    gain: torch.Tensor,
    chunk: torch.Tensor,
    params: AgcParameters = AgcParameters(),
    frozen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (B,) gain, (B, T) chunk ->
    (new_gain, processed_chunk). ``frozen``: optional (B,) bool; by default
    the silence freeze (pre-gain energy under 1e-6)."""
    k, inv_rms = _constants(params)
    if frozen is None:
        frozen = (chunk * chunk).sum(dim=-1) < SILENCE_ENERGY
    g = gain
    outs = []
    for x_t in chunk.unbind(dim=-1):
        out = x_t * g
        outs.append(out)
        one_minus_y = fma_f32(-(out * out), inv_rms, 1.0)
        upd = torch.clamp_min(fma_f32(one_minus_y, k, 1.0), k)  # NaN-propagating, as jnp.maximum
        g = torch.where(frozen, g, g * upd)
    processed = torch.stack(outs, dim=-1) if outs else torch.empty_like(chunk)
    return g, processed


def agc_signal_plain(
    signal: torch.Tensor, chunk: int, params: AgcParameters = AgcParameters()
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the signal mode: (B, N) signals, cut into
    C = N // chunk chunks (a ragged tail is dropped) -> ((B, C * chunk)
    processed, (B, C) gain after each chunk). The gain starts at 1 and each
    chunk freezes it on its own pre-gain energy: a loop over the chunks of
    :func:`agc_chunk_plain`."""
    b, n = signal.shape
    n_chunks = n // chunk
    g = torch.ones(b, dtype=torch.float32, device=signal.device)
    outs, gains = [], []
    for c in range(n_chunks):
        g, out = agc_chunk_plain(g, signal[:, c * chunk : (c + 1) * chunk], params)
        outs.append(out)
        gains.append(g)
    processed = torch.cat(outs, dim=1) if outs else signal.new_zeros((b, 0))
    gains_t = torch.stack(gains, dim=1) if gains else signal.new_zeros((b, 0))
    return processed, gains_t


_lib = None


def _kernels() -> ctypes.CDLL:
    """The built library, the signatures of its three entry points bound once."""
    global _lib
    if _lib is None:
        lib = nvcc.library("agc")
        ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        lib.agc_ring_push_f32.restype = ctypes.c_int
        lib.agc_ring_push_f32.argtypes = [ptr, i64, ptr, ptr, i64, ptr, ptr] + [i32] * 3 + [f32] * 3 + [ptr]
        lib.agc_chunk_f32.restype = ctypes.c_int
        lib.agc_chunk_f32.argtypes = [ptr, i64, ptr, ptr, ptr, ptr] + [i32] * 2 + [f32] * 3 + [ptr]
        lib.agc_signal_f32.restype = ctypes.c_int
        lib.agc_signal_f32.argtypes = [ptr, i64, ptr, ptr] + [i32] * 3 + [f32] * 3 + [ptr]
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
    stream = torch.cuda.current_stream(device).cuda_stream
    # the launch goes to the current device: switch only if the tensors lie elsewhere
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    nvcc.check(rc, name)


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
    global launches
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
        launches += 1
    return new_buffer, new_gain


def _agc_chunk_cuda(gain, chunk, params, frozen):
    global launches
    _check(gain, chunk)
    b, t = chunk.shape
    if frozen is not None:
        if frozen.shape != (b,) or frozen.device != chunk.device:
            raise ValueError(f"frozen must be ({b},) on {chunk.device}, got {tuple(frozen.shape)} on {frozen.device}")
        frozen = frozen.to(torch.uint8).contiguous()
    chunk, gain = _rows(chunk), gain.contiguous()
    out = torch.empty((b, t), dtype=torch.float32, device=chunk.device)
    gain_out = torch.empty_like(gain)
    if b:
        k, inv_rms = _constants(params)
        _launch(
            _kernels().agc_chunk_f32, "agc_chunk_f32", chunk.device,
            (chunk.data_ptr(), chunk.stride(0), gain.data_ptr(), 0 if frozen is None else frozen.data_ptr(),
             out.data_ptr(), gain_out.data_ptr(), b, t, k, inv_rms, SILENCE_ENERGY),
        )
        launches += 1
    return gain_out, out


def agc_chunk(
    gain: torch.Tensor,
    chunk: torch.Tensor,
    params: AgcParameters = AgcParameters(),
    frozen: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Applies AGC to one chunk of samples per stream.

    gain: (B,) current gain per stream; chunk: (B, T) raw samples; frozen:
    optional (B,) bool, by default the per-chunk silence freeze (pre-gain
    energy under 1e-6). Returns (new_gain, processed_chunk). A CUDA tensor
    goes to the kernel, a CPU tensor to :func:`agc_chunk_plain`."""
    if chunk.device.type == "cuda":
        return _agc_chunk_cuda(gain, chunk, params, frozen)
    if chunk.device.type == "cpu":
        return agc_chunk_plain(gain, chunk, params, frozen)
    raise ValueError(f"unsupported device {chunk.device}")


def agc_init(n_streams: int, device="cuda") -> torch.Tensor:
    """(n_streams,) float32 gains of 1, on the card unless asked otherwise."""
    return torch.ones(n_streams, dtype=torch.float32, device=resolve_device(device))


def agc_signal(
    signal: torch.Tensor, chunk: int, params: AgcParameters = AgcParameters()
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dagc recurrence over whole signals, chunk by chunk: (B, N) float32
    -> ((B, C * chunk) processed, (B, C) gain after each chunk), C = N //
    chunk (a ragged tail is dropped). The gain starts at 1; a chunk whose
    pre-gain energy is under 1e-6 keeps it. A CUDA tensor goes to the
    kernel's signal mode, one launch for every chunk of every row, without a
    host synchronisation; each row's chain runs on its own block, so B rows
    take about the time of the longest. A CPU tensor goes to
    :func:`agc_signal_plain`."""
    global signal_launches
    if signal.device.type == "cpu":
        return agc_signal_plain(signal, chunk, params)
    if signal.dtype != torch.float32:
        raise TypeError(f"agc kernel takes float32 tensors, got {signal.dtype}")
    if signal.dim() != 2 or chunk < 1:
        raise ValueError(f"expected a (B, N) signal and chunk >= 1, got {tuple(signal.shape)}, {chunk}")
    if signal.device.type != "cuda":
        raise ValueError(f"agc kernel takes CUDA tensors, got {signal.device}")
    b, n = signal.shape
    n_chunks = n // chunk
    x = _rows(signal[:, : n_chunks * chunk])
    out = torch.empty((b, n_chunks * chunk), dtype=torch.float32, device=signal.device)
    gains = torch.empty((b, n_chunks), dtype=torch.float32, device=signal.device)
    if b and n_chunks:
        k, inv_rms = _constants(params)
        _launch(
            _kernels().agc_signal_f32, "agc_signal_f32", signal.device,
            (x.data_ptr(), x.stride(0), out.data_ptr(), gains.data_ptr(), b, n_chunks, chunk,
             k, inv_rms, SILENCE_ENERGY),
        )
        signal_launches += 1
    return out, gains
