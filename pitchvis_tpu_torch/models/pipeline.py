"""The end-to-end streaming pipeline: one hop for B streams.

Port of ``pitchvis_tpu/models/pipeline.py``. Reference data flow
(ARCHITECTURE.md:44-48): Audio -> Ring Buffer (AGC in the audio callback)
-> VQT -> Analysis. Here one hop for every stream is

    state, outputs = pipeline_step(vqt_arrays, state, chunk, dt, vqt_params=...)

ring push (non-finite rejection, AGC kernel, roll), the trailing n_fft
window, the VQT in dB (the fused VQT kernel on ``path="pallas"``) and the
batched analysis step (two launches of the peaks kernel). The ML, LED and
viewer stages of the JAX package are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..core.config import AgcParameters, AnalysisParameters, VqtParameters
from ..core.device import resolve_device
from ..kernel.builder import get_kernel
from ..ops.vqt import make_vqt_arrays, vqt_db_auto
from ..stream.ring import RingState, ring_push, ring_window
from .analysis import AnalysisOutputs, AnalysisState, analysis_step_batch, init_state_batch


def build_rebuilt_arrays(old_params, new_params, *, max_n_fft: int, path: str,
                         fast: bool, device="cuda"):
    """Validation + construction for a live rebuild
    (StreamingPipeline.rebuild). Returns (kernel, arrays, layout_changed).
    Raises ValueError for sets the running pipeline cannot host."""
    if float(new_params.sr) != float(old_params.sr):
        raise ValueError(
            "sample-rate changes require a new pipeline (buffered audio is rate-bound)"
        )
    if new_params.n_fft > max_n_fft:
        raise ValueError(
            f"n_fft {new_params.n_fft} exceeds the available ring length "
            f"{max_n_fft}; construct with a larger buffer (StreamingPipeline(buffer_len=...))"
        )
    kernel = get_kernel(new_params)  # validates; VqtError on bad combos
    arrays = make_vqt_arrays(kernel, path=path, fast=fast, device=device)
    return kernel, arrays, new_params.range != old_params.range


def reset_state_row(state, fresh, idx: int):
    """Overwrites batch row ``idx`` of every tensor of a carried state (a
    tensor, or a dataclass of tensors and such dataclasses) with row 0 of the
    freshly initialized (B=1) ``fresh`` of the same structure: the device
    side of stream-slot recycling (StreamingPipeline.reset_stream,
    runtime/server.py::StreamServer.reset_stream). Functional: each tensor is
    cloned before the write, so a tensor that a caller captured earlier (an
    in-flight hop, outputs already returned) never changes."""
    if isinstance(state, torch.Tensor):
        out = state.clone()
        out[idx] = fresh[0]
        return out
    return type(state)(**{
        f.name: reset_state_row(getattr(state, f.name), getattr(fresh, f.name), idx)
        for f in fields(state)
    })


@dataclass
class PipelineState:
    ring: RingState
    analysis: AnalysisState


@dataclass
class PipelineOutputs:
    x_vqt: torch.Tensor  # (B, n_buckets) raw dB spectra
    gain: torch.Tensor  # (B,) AGC gain (RingBuffer.gain diagnostic)
    analysis: AnalysisOutputs


def init_pipeline_state(
    n_streams: int,
    params: VqtParameters,
    buffer_len: int | None = None,
    device="cuda",
) -> PipelineState:
    """Fresh state for ``n_streams`` streams, on the card unless
    ``device="cpu"``; without CUDA the default raises."""
    device = resolve_device(device)
    buffer_len = buffer_len or params.n_fft
    if buffer_len < params.n_fft:
        raise ValueError(f"buffer_len {buffer_len} is shorter than n_fft {params.n_fft}")
    return PipelineState(
        ring=RingState.init(n_streams, buffer_len, device=device),
        analysis=init_state_batch(n_streams, params.n_buckets, device=device),
    )


def pipeline_step(
    vqt_arrays,  # VqtArrays, or PallasVqtArrays when path="pallas"
    state: PipelineState,
    chunk: torch.Tensor,
    dt,
    *,
    vqt_params: VqtParameters,
    analysis_params: AnalysisParameters = AnalysisParameters(),
    agc_params: AgcParameters = AgcParameters(),
    path: str = "time",
) -> tuple[PipelineState, PipelineOutputs]:
    """One hop for all streams: push chunk (non-finite-guarded,
    silence-frozen AGC), VQT on the trailing n_fft window, full analysis
    step. chunk: (B, hop) raw samples; dt: scalar or (B,) seconds per hop."""
    ring = ring_push(state.ring, chunk, agc_params)
    window = ring_window(ring, vqt_params.n_fft)
    x_vqt = vqt_db_auto(vqt_arrays, window, path=path)
    new_analysis, outputs = analysis_step_batch(
        analysis_params, vqt_params.range, state.analysis, x_vqt, dt
    )
    return (
        PipelineState(ring=ring, analysis=new_analysis),
        PipelineOutputs(x_vqt=x_vqt, gain=ring.gain, analysis=outputs),
    )


def _stack(items):
    """Stacks a list of equal-structured output dataclasses along a new
    leading axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return type(first)(**{f.name: _stack([getattr(it, f.name) for it in items]) for f in fields(first)})


def _no_hops(state: PipelineState, n_buckets: int) -> PipelineOutputs:
    """The outputs of zero hops: each leaf has the shape and type of one
    hop's, behind a leading axis of 0 (what lax.scan returns for K=0)."""
    b = state.ring.buffer.shape[0]
    device = state.ring.buffer.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty((0, b, *shape), dtype=dtype, device=device)

    per_stream = ("scene_calmness", "tuning_inaccuracy")
    analysis = AnalysisOutputs(**{
        f.name: empty() if f.name in per_stream
        else empty(n_buckets, dtype=torch.bool if f.name == "peaks" else torch.float32)
        for f in fields(AnalysisOutputs)
    })
    return PipelineOutputs(x_vqt=empty(n_buckets), gain=empty(), analysis=analysis)


def pipeline_step_multi(
    vqt_arrays,
    state: PipelineState,
    chunks: torch.Tensor,
    dt,
    **kwargs,
) -> tuple[PipelineState, PipelineOutputs]:
    """K hops in order (the JAX package's lax.scan over the hop axis).
    chunks: (K, B, hop). Outputs are stacked along a leading K axis; K=0
    leaves the state as it was and returns outputs with a leading axis of 0."""
    outs = []
    for chunk in chunks:
        state, out = pipeline_step(vqt_arrays, state, chunk, dt, **kwargs)
        outs.append(out)
    if not outs:
        return state, _no_hops(state, kwargs["vqt_params"].n_buckets)
    return state, _stack(outs)


class StreamingPipeline:
    """Convenience wrapper owning the kernel arrays and state.

    Mirrors the reference's per-frame loop (pitchvis_serial/src/main.rs:
    207-230 / vqt_system.rs:40-68) but batched: feed `hop`-sized host chunks
    for B streams, receive the full analysis outputs. Runs on the card
    unless ``device="cpu"``; without CUDA the default raises.
    """

    def __init__(
        self,
        n_streams: int,
        vqt_params: VqtParameters | None = None,
        analysis_params: AnalysisParameters | None = None,
        agc_params: AgcParameters | None = None,
        path: str = "time",
        fast: bool = False,
        buffer_len: int | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.vqt_params = vqt_params or VqtParameters()
        self.analysis_params = analysis_params or AnalysisParameters()
        self.agc_params = agc_params or AgcParameters()
        self.path = path
        self.fast = fast
        self.kernel = get_kernel(self.vqt_params)
        self.arrays = make_vqt_arrays(self.kernel, path=path, fast=fast, device=self.device)
        self.state = init_pipeline_state(
            n_streams, self.vqt_params, buffer_len=buffer_len, device=self.device
        )
        self.delay_secs = self.kernel.delay_secs

    def _kwargs(self):
        return dict(
            vqt_params=self.vqt_params,
            analysis_params=self.analysis_params,
            agc_params=self.agc_params,
            path=self.path,
        )

    def _samples(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def step(self, chunk, dt) -> PipelineOutputs:
        self.state, out = pipeline_step(
            self.arrays, self.state, self._samples(chunk), dt, **self._kwargs()
        )
        return out

    def step_multi(self, chunks, dt) -> PipelineOutputs:
        """(K, B, hop) chunks -> K hops, outputs stacked along K."""
        self.state, out = pipeline_step_multi(
            self.arrays, self.state, self._samples(chunks), dt, **self._kwargs()
        )
        return out

    def rebuild(self, vqt_params: VqtParameters) -> None:
        """Swaps in a new VQT parameter set while streaming. The ring audio
        and AGC gains are preserved; the analysis carries persist when the
        bin layout is unchanged and re-initialize when it changes. Raises
        ValueError for sets this pipeline cannot host (different sample
        rate, n_fft beyond the ring length)."""
        buffer_len = int(self.state.ring.buffer.shape[1])
        kernel, arrays, layout_changed = build_rebuilt_arrays(
            self.vqt_params, vqt_params, max_n_fft=buffer_len,
            path=self.path, fast=self.fast, device=self.device,
        )
        self.arrays = arrays
        if layout_changed:
            n_streams = int(self.state.ring.buffer.shape[0])
            self.state = PipelineState(
                ring=self.state.ring,  # audio survives the swap
                analysis=init_state_batch(n_streams, vqt_params.n_buckets, device=self.device),
            )
        self.kernel = kernel
        self.vqt_params = vqt_params
        self.delay_secs = kernel.delay_secs

    def reset_stream(self, idx: int) -> None:
        """Recycles batch slot `idx` for a NEW stream: ring samples, AGC
        gain and analysis carries return to their fresh values. Other slots
        are untouched. Outputs returned earlier (which share tensors with the
        state) are left as they were."""
        fresh = init_pipeline_state(
            1, self.vqt_params,
            buffer_len=int(self.state.ring.buffer.shape[1]), device=self.device,
        )
        self.state = reset_state_row(self.state, fresh, idx)
