"""Device-resident ring buffer for batched audio streams.

Port of ``pitchvis_tpu/stream/ring.py``. The reference's communication
backend is a mutex-protected host ring buffer written by the audio callback
and snapshotted per frame (pitchvis_audio/src/lib.rs:17-28). Here a
(B, buffer_len) buffer lives on the device: each push shifts the window left
by the chunk size and appends the AGC-processed chunk, so the last sample is
always "now" and the VQT reads the trailing n_fft samples with no host
round-trip.

On the card a push is one launch of the AGC kernel in its ring mode
(``ops/agc.py::agc_ring_push``); on the CPU it runs :func:`ring_push_plain`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.config import AgcParameters
from ..core.device import resolve_device
from ..ops.agc import agc_chunk, agc_ring_push


@dataclass
class RingState:
    """(B, L) sample window (last column is "now") and (B,) AGC gain."""

    buffer: torch.Tensor
    gain: torch.Tensor

    @classmethod
    def init(cls, n_streams: int, buffer_len: int, device="cuda") -> "RingState":
        device = resolve_device(device)
        return cls(
            buffer=torch.zeros((n_streams, buffer_len), dtype=torch.float32, device=device),
            gain=torch.ones(n_streams, dtype=torch.float32, device=device),
        )


def ring_push(
    state: RingState,
    chunk: torch.Tensor,
    agc_params: AgcParameters = AgcParameters(),
) -> RingState:
    """Pushes one chunk per stream: AGC-process the chunk (silence-freeze
    semantics) and append it; whole chunks containing any NON-FINITE sample
    are rejected for that stream (audio_desktop.rs:102-105 — an Inf would
    collapse the AGC gain and poison every VQT frame the window covers).

    Returns a new state; the old one is left as it was. A ring on the card
    goes to the kernel (one launch, no host synchronisation), a ring on the
    CPU to :func:`ring_push_plain`."""
    b, t = chunk.shape
    length = state.buffer.shape[1]
    if state.buffer.shape[0] != b:
        raise ValueError(f"chunk batch {b} != ring batch {state.buffer.shape[0]}")
    if t > length:
        raise ValueError(
            f"chunk of {t} samples exceeds the {length}-sample "
            "ring buffer; raise buffer_len or lower the hop"
        )
    if state.buffer.device.type == "cuda":
        return RingState(*agc_ring_push(state.buffer, state.gain, chunk, agc_params))
    if state.buffer.device.type == "cpu":
        return ring_push_plain(state, chunk, agc_params)
    raise ValueError(f"unsupported device {state.buffer.device}")


def ring_push_plain(
    state: RingState,
    chunk: torch.Tensor,
    agc_params: AgcParameters = AgcParameters(),
) -> RingState:
    """Plain PyTorch version of :func:`ring_push` (which checks the shapes),
    op by op as the JAX package writes it. On the card its AGC step is the
    kernel's chunk mode (:func:`~pitchvis_tpu_torch.ops.agc.agc_chunk`)."""
    t = chunk.shape[1]
    length = state.buffer.shape[1]
    bad = (~torch.isfinite(chunk)).any(dim=-1)
    keep = bad[:, None]
    safe_chunk = torch.where(keep, torch.zeros((), dtype=chunk.dtype, device=chunk.device), chunk)

    new_gain, processed = agc_chunk(state.gain, safe_chunk, agc_params)

    # a rejected stream keeps its whole buffer; the others roll by t. Two
    # selects over the two column ranges instead of concatenate-then-select
    # spare one full pass over the (B, L) buffer.
    buf = state.buffer
    new_buffer = torch.empty_like(buf)
    torch.where(keep, buf[:, : length - t], buf[:, t:], out=new_buffer[:, : length - t])
    torch.where(keep, buf[:, length - t :], processed, out=new_buffer[:, length - t :])
    new_gain = torch.where(bad, state.gain, new_gain)
    return RingState(buffer=new_buffer, gain=new_gain)


def ring_window(state: RingState, n_fft: int) -> torch.Tensor:
    """The trailing n_fft samples per stream (the VQT input), as a view."""
    if n_fft > state.buffer.shape[1]:
        # buffer[:, -n_fft:] would silently return the whole (shorter)
        # buffer and surface later as an opaque VQT shape mismatch
        raise ValueError(
            f"n_fft {n_fft} exceeds the {state.buffer.shape[1]}-sample ring "
            "buffer; init the ring with buffer_len >= n_fft"
        )
    return state.buffer[:, state.buffer.shape[1] - n_fft :]
