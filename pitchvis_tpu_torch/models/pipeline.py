"""The end-to-end streaming pipeline: one hop for B streams.

Port of ``pitchvis_tpu/models/pipeline.py``. Reference data flow
(ARCHITECTURE.md:44-48): Audio -> Ring Buffer (AGC in the audio callback)
-> VQT -> Analysis. Here one hop for every stream is

    state, outputs = pipeline_step(vqt_arrays, state, chunk, dt, vqt_params=...)

ring push (non-finite rejection, AGC kernel, roll), the trailing n_fft
window, the VQT in dB (the fused VQT kernel on ``path="pallas"``), the
batched analysis step (two launches of the peaks kernel) and, when asked
for, the stages after it (:func:`derived_stages`): the ML inference on a
rolling history of smoothed spectra (models/ml_system.py), the LED color
block (io/led.py), in plain PyTorch, and every display-derived quantity
of the reference's update_display (models/viewer.py; on a card one kernel
a hop, ops/viewer_stage.py).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core.config import AgcParameters, AnalysisParameters, VqtParameters
from ..core.device import resolve_device
from ..io.led import led_frame_values
from ..kernel.builder import get_kernel
from ..ops import agc, peaks_pallas, viewer_stage, vqt_pallas
from ..ops.vqt import make_vqt_arrays, vqt_db_auto
from ..stream.ring import RingState, ring_push, ring_window
from ..utils.profiling import annotate
from .analysis import AnalysisOutputs, AnalysisState, analysis_step_batch, dt_batch, init_state_batch
from .ml_system import MlState, init_ml_state_batch, ml_step_batch, serving_copy
from .pitch_mlp import DEFAULT_T
from .viewer import BallState, ViewerOutputs


def build_rebuilt_arrays(old_params, new_params, *, max_n_fft: int, path: str,
                         fast: bool, ml_attached: bool = False, device="cuda"):
    """Validation + construction for a live rebuild
    (StreamingPipeline.rebuild, StreamServer.rebuild). Returns (kernel,
    arrays, layout_changed). Raises ValueError for sets the running
    pipeline or server cannot host."""
    if float(new_params.sr) != float(old_params.sr):
        raise ValueError(
            "sample-rate changes require a new pipeline (buffered audio is rate-bound)"
        )
    if new_params.n_fft > max_n_fft:
        raise ValueError(
            f"n_fft {new_params.n_fft} exceeds the available ring length "
            f"{max_n_fft}; construct with a larger buffer (StreamingPipeline(buffer_len=...))"
        )
    if ml_attached and new_params.range != old_params.range:
        raise ValueError(
            "bin-layout changes are incompatible with the attached ML "
            "model (its params are trained for the current layout); "
            "construct a new pipeline/server with matching ml_params"
        )
    kernel = get_kernel(new_params)  # validates; VqtError on bad combos
    arrays = make_vqt_arrays(kernel, path=path, fast=fast, device=device)
    return kernel, arrays, new_params.range != old_params.range


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a tree (a tensor, None, or a tuple or
    dataclass of these) and the matching tensors of the trees ``rest`` of
    the same structure: a tree of its results, None where ``tree`` is
    None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, *parts) for parts in zip(tree, *rest))
    return type(tree)(**{
        f.name: _tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
        for f in fields(tree)
    })


def reset_state_row(state, fresh, idx: int):
    """Overwrites batch row ``idx`` of every tensor of a carried state (a
    tensor, None, or a tuple or dataclass of these) with row 0 of the
    freshly initialized (B=1) ``fresh`` of the same structure: the device
    side of stream-slot recycling (StreamingPipeline.reset_stream,
    runtime/server.py::StreamServer.reset_stream). Functional: each tensor is
    cloned before the write, so a tensor that a caller captured earlier (an
    in-flight hop, outputs already returned) never changes."""

    def reset(leaf, new):
        out = leaf.clone()
        out[idx] = new[0]
        return out

    return _tree_map(reset, state, fresh)


@dataclass
class PipelineState:
    ring: RingState
    analysis: AnalysisState
    # rolling smoothed-VQT history of the ML stage; None without it
    ml: MlState | None = None
    # per-stream pitch-ball fade carry of the viewer stage; None without it
    balls: BallState | None = None


@dataclass
class PipelineOutputs:
    x_vqt: torch.Tensor  # (B, n_buckets) raw dB spectra
    gain: torch.Tensor  # (B,) AGC gain (RingBuffer.gain diagnostic)
    analysis: AnalysisOutputs
    ml_midi: torch.Tensor | None = None  # (B, 128) MIDI strengths of the ML stage
    led: torch.Tensor | None = None  # (B, n_buckets, 3) u8 LED colors
    viewer: ViewerOutputs | None = None  # display-derived outputs


def init_pipeline_state(
    n_streams: int,
    params: VqtParameters,
    buffer_len: int | None = None,
    ml_t_window: int | None = None,
    with_viewer: bool = False,
    device="cuda",
) -> PipelineState:
    """Fresh state for ``n_streams`` streams (with a zero ML history of
    ``ml_t_window`` frames when given, and the ball carry of the viewer stage
    when ``with_viewer``), on the card unless ``device="cpu"``; without
    CUDA the default raises."""
    device = resolve_device(device)
    buffer_len = buffer_len or params.n_fft
    if buffer_len < params.n_fft:
        raise ValueError(f"buffer_len {buffer_len} is shorter than n_fft {params.n_fft}")
    return PipelineState(
        ring=RingState.init(n_streams, buffer_len, device=device),
        analysis=init_state_batch(n_streams, params.n_buckets, device=device),
        ml=init_ml_state_batch(n_streams, ml_t_window, params.n_buckets, device=device) if ml_t_window else None,
        balls=BallState.init(n_streams, params.n_buckets, device=device) if with_viewer else None,
    )


def derived_stages(
    rng_cfg,
    outputs: AnalysisOutputs,
    dt_b: torch.Tensor,
    *,
    ml_model=None,
    ml_params=None,
    ml_state: MlState | None = None,
    with_led: bool = False,
    balls_state: BallState | None = None,
    with_viewer: bool = False,
):
    """Post-analysis output stages shared by pipeline_step and the
    ingest-fed StreamServer: the ML inference (the smoothed spectrum pushed
    onto ``ml_state``'s history, ml_system.rs:24-38; ``ml_params`` a
    state_dict, or None for ``ml_model``'s own weights), the LED color block
    (io/led.py) and every display-derived quantity of update_display
    (models/viewer.py). ``dt_b`` is the (B,) frame time. Returns
    (new_ml_state, ml_midi, led, new_balls_state, viewer), the JAX package's
    tuple; disabled stages pass their state through and emit None."""
    with annotate("stage.outputs"):
        new_ml = ml_state
        ml_midi = None
        if ml_model is not None:
            if ml_state is None:
                raise ValueError("ml_model needs the ML history (init_pipeline_state(ml_t_window=...))")
            with annotate("outputs.ml"):
                new_ml, ml_midi = ml_step_batch(ml_model, ml_params, ml_state, outputs.x_vqt_smoothed)

        led = None
        if with_led:
            with annotate("outputs.led"):
                led = led_frame_values(rng_cfg, outputs.peaks, outputs.peak_center, outputs.peak_size)

        new_balls = balls_state
        viewer = None
        if with_viewer:
            if balls_state is None:
                raise ValueError(
                    "with_viewer=True needs the ball carry (init_pipeline_state(with_viewer=True))"
                )
            with annotate("outputs.viewer"):
                new_balls, viewer = viewer_stage.viewer_stage(rng_cfg, balls_state, outputs, dt_b)
        return new_ml, ml_midi, led, new_balls, viewer


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
    ml_model=None,
    ml_params=None,
    with_led: bool = False,
    with_viewer: bool = False,
) -> tuple[PipelineState, PipelineOutputs]:
    """One hop for all streams: push chunk (non-finite-guarded,
    silence-frozen AGC), VQT on the trailing n_fft window, full analysis
    step, and the output stages asked for. chunk: (B, hop) raw samples; dt:
    scalar or (B,) seconds per hop. ml_model/ml_params: a PitchMLP and a
    state_dict for it (None: its own weights); requires state.ml
    (init_pipeline_state(ml_t_window=...)). with_led: emit the per-stream
    (n_buckets, 3) u8 LED color block (io/led.py). with_viewer: emit every
    display-derived quantity of update_display (pitch balls with fade carry,
    chroma, bloom, spectrogram row, bass spiral, calmness histogram);
    requires state.balls (init_pipeline_state(with_viewer=True))."""
    with annotate("pipeline.hop"):
        with annotate("stage.ring"):
            ring = ring_push(state.ring, chunk, agc_params)
            window = ring_window(ring, vqt_params.n_fft)
        x_vqt = vqt_db_auto(vqt_arrays, window, path=path)
        dt_b = dt_batch(dt, x_vqt.shape[0], x_vqt.device)
        new_analysis, outputs = analysis_step_batch(
            analysis_params, vqt_params.range, state.analysis, x_vqt, dt_b
        )
        new_ml, ml_midi, led, new_balls, viewer = derived_stages(
            vqt_params.range, outputs, dt_b,
            ml_model=ml_model, ml_params=ml_params, ml_state=state.ml,
            with_led=with_led, balls_state=state.balls, with_viewer=with_viewer,
        )
    return (
        PipelineState(ring=ring, analysis=new_analysis, ml=new_ml, balls=new_balls),
        PipelineOutputs(x_vqt=x_vqt, gain=ring.gain, analysis=outputs, ml_midi=ml_midi, led=led, viewer=viewer),
    )


def _stack(items):
    """Stacks a list of equal-structured output dataclasses along a new
    leading axis (None leaves stay None)."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *items)


def _no_hops(state: PipelineState, vqt_params: VqtParameters, ml_model, ml_params, with_led: bool,
             with_viewer: bool) -> PipelineOutputs:
    """The outputs of zero hops: each leaf has the shape and type of one
    hop's, behind a leading axis of 0 (what lax.scan returns for K=0). The
    output stages' shapes come from running them on zero analysis outputs
    (their state is not kept)."""
    b = state.ring.buffer.shape[0]
    n = vqt_params.n_buckets
    device = state.ring.buffer.device

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((b, *shape), dtype=dtype, device=device)

    per_stream = ("scene_calmness", "tuning_inaccuracy")
    analysis = AnalysisOutputs(**{
        f.name: zeros() if f.name in per_stream
        else zeros(n, dtype=torch.bool if f.name == "peaks" else torch.float32)
        for f in fields(AnalysisOutputs)
    })
    _, ml_midi, led, _, viewer = derived_stages(
        vqt_params.range, analysis, zeros(),
        ml_model=ml_model, ml_params=ml_params, ml_state=state.ml,
        with_led=with_led, balls_state=state.balls, with_viewer=with_viewer,
    )
    one = PipelineOutputs(x_vqt=zeros(n), gain=zeros(), analysis=analysis, ml_midi=ml_midi, led=led, viewer=viewer)
    # each leaf empty, behind a leading axis of 0
    return _tree_map(lambda leaf: leaf.new_empty((0, *leaf.shape)), one)


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
        return state, _no_hops(
            state, kwargs["vqt_params"], kwargs.get("ml_model"), kwargs.get("ml_params"),
            kwargs.get("with_led", False), kwargs.get("with_viewer", False),
        )
    with annotate("pipeline.stack"):
        return state, _stack(outs)


# StreamingPipeline.graph_counts: calls captured, calls replayed, calls run
# eagerly (step(), K = 0, a device without graphs, a key's first call),
# copies of a state set from outside into a graph's state buffers, and the
# bytes of outputs cloned out of the graphs' pools, summed over the replays
GRAPH_COUNTERS = ("graph_captures", "graph_replays", "graph_eager_calls", "graph_state_stagings",
                  "graph_output_bytes")
# how many captured calls a pipeline keeps, the most recently used; the
# least recently used beyond them is dropped with its memory pool
GRAPHS_KEPT = 4
# the module counters of the hand-written kernels' launches in a hop (each
# wrapper counts one as it launches)
_LAUNCH_COUNTERS = ((vqt_pallas, "launches"), (peaks_pallas, "launches"), (agc, "launches"),
                    (viewer_stage, "launches"))


def _launch_counts() -> tuple:
    return tuple(getattr(module, name) for module, name in _LAUNCH_COUNTERS)


def _add_launch_counts(deltas) -> None:
    for (module, name), delta in zip(_LAUNCH_COUNTERS, deltas):
        setattr(module, name, getattr(module, name) + delta)


def _replays_on(device: torch.device) -> bool:
    """Whether StreamingPipeline.step_multi captures and replays calls on
    ``device``."""
    return device.type == "cuda"


def _nbytes(tree) -> int:
    """The bytes of the tensors of a tree."""
    sizes = []
    _tree_map(lambda leaf: sizes.append(leaf.nbytes), tree)
    return sum(sizes)


def _layout(tree) -> tuple:
    """The shape and dtype of each tensor of a tree, in order."""
    out = []
    _tree_map(lambda leaf: out.append((tuple(leaf.shape), leaf.dtype)), tree)
    return tuple(out)


def graph_key(state: PipelineState, shape, *, arrays, analysis_params, agc_params, path, ml_model, with_led,
              with_viewer) -> tuple:
    """Everything a captured K-hop call bakes in, for (K, B, hop) samples of
    ``shape``: the state's layout, K, B and the hop, the VQT arrays (a
    rebuild replaces them), the analysis and AGC parameters, the path, the
    ML model and the output stages. The samples and ``dt`` are the graph's
    inputs, whatever their form. A call whose key matches a captured one
    can replay it."""
    return (_layout(state), tuple(shape), id(arrays), analysis_params, agc_params, path, id(ml_model), with_led,
            with_viewer)


def _record(fn, device):
    """Captures ``fn()`` on ``device`` as one CUDA graph, without running
    it: (a function that replays the graph on the device's current stream,
    what ``fn`` returned)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(
        graph, stream=torch.cuda.Stream(device), capture_error_mode="thread_local"
    ):
        result = fn()

    def replay():
        with torch.cuda.device(device):
            graph.replay()

    return replay, result


@dataclass
class _Replay:
    """One captured K-hop call: what replays it, the inputs it reads
    (samples and the (B,) frame time), the state it reads and writes back in
    place, the outputs it writes and their bytes, the hand-written kernels'
    launches it holds (as ``_launch_counts`` counts them), and what else it
    reads by address (kept alive with it)."""

    launch: object
    chunks: torch.Tensor
    dt: torch.Tensor
    state: PipelineState
    outputs: PipelineOutputs
    output_bytes: int
    launches: tuple
    reads: tuple


class StreamingPipeline:
    """Convenience wrapper owning the kernel arrays and state.

    Mirrors the reference's per-frame loop (pitchvis_serial/src/main.rs:
    207-230 / vqt_system.rs:40-68) but batched: feed `hop`-sized host chunks
    for B streams, receive the full analysis outputs, with ``ml_model`` the
    MIDI strengths of the ML stage, and with ``with_led`` / ``with_viewer``
    the LED colors and the display-derived outputs. Runs on the card unless
    ``device="cpu"``; without CUDA the default raises.

    ``ml_model`` (a PitchMLP) with ``ml_params`` (a state_dict, as
    convert.py returns it; None: the module's own weights) attaches the ML
    stage over a history of ``ml_t_window`` frames (default DEFAULT_T, the
    training window). The pipeline serves its own copy of the model
    (models/ml_system.py::serving_copy), on its device and frozen:
    ``self.ml_model``.

    On a CUDA device :meth:`step_multi` replays each K-hop call as one CUDA
    graph after the first call of its :func:`graph_key`; ``graph_counts``
    counts what each call did (``GRAPH_COUNTERS``). ``self.state`` stays a
    value that later calls leave as they found it, as on the eager path.
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
        ml_model=None,
        ml_params=None,
        ml_t_window: int | None = None,
        with_led: bool = False,
        with_viewer: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.vqt_params = vqt_params or VqtParameters()
        self.analysis_params = analysis_params or AnalysisParameters()
        self.agc_params = agc_params or AgcParameters()
        self.path = path
        self.fast = fast
        self.ml_model = serving_copy(ml_model, ml_params, self.device) if ml_model is not None else None
        # a history window that does not match the model's input fails on the
        # first hop, so it defaults to the training window
        self.ml_t_window = (DEFAULT_T if ml_t_window is None else ml_t_window) if ml_model is not None else None
        self.with_led = with_led
        self.with_viewer = with_viewer
        self.kernel = get_kernel(self.vqt_params)
        self.arrays = make_vqt_arrays(self.kernel, path=path, fast=fast, device=self.device)
        self.graph_counts = dict.fromkeys(GRAPH_COUNTERS, 0)
        self._graphs = OrderedDict()  # graph_key -> _Replay, the most recently used last
        self._graph_state = None  # the state buffers of the newest capture
        self.state = self._fresh_state(n_streams, buffer_len)
        self.delay_secs = self.kernel.delay_secs

    @property
    def state(self) -> PipelineState:
        """The carried state, a value that later calls leave as it is.
        After a replayed call it lives in the graph's state buffers, which
        the next replay writes in place, so reading it then returns a copy
        of them (one a replay, however often it is read)."""
        if self._state_in_graph and self._state_copy is None:
            self._state_copy = _tree_map(torch.Tensor.clone, self._state)
        return self._state_copy if self._state_in_graph else self._state

    @state.setter
    def state(self, value: PipelineState) -> None:
        # set from outside or by an eager call: the next replay copies it in
        self._state, self._state_in_graph, self._state_copy = value, False, None

    def _fresh_state(self, n_streams: int, buffer_len: int | None) -> PipelineState:
        return init_pipeline_state(
            n_streams, self.vqt_params, buffer_len=buffer_len, ml_t_window=self.ml_t_window,
            with_viewer=self.with_viewer, device=self.device,
        )

    def _kwargs(self):
        return dict(
            vqt_params=self.vqt_params,
            analysis_params=self.analysis_params,
            agc_params=self.agc_params,
            path=self.path,
            ml_model=self.ml_model,
            with_led=self.with_led,
            with_viewer=self.with_viewer,
        )

    def _samples(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def step(self, chunk, dt) -> PipelineOutputs:
        with annotate("pipeline.call"):
            self.graph_counts["graph_eager_calls"] += 1
            self.state, out = pipeline_step(
                self.arrays, self.state, self._samples(chunk), dt, **self._kwargs()
            )
        return out

    def step_multi(self, chunks, dt) -> PipelineOutputs:
        """(K, B, hop) chunks -> K hops, outputs stacked along K.

        On a CUDA device the first call of a :func:`graph_key` runs eagerly
        and then captures the call as one CUDA graph (the capture runs
        nothing); a later call with that key copies its samples and ``dt``
        into the graph's inputs, copies a state set since by other means (a
        reset, a rebuild, an assignment) into the graph's state, and replays
        it, without synchronising. The replay writes the same state and
        outputs as the eager call, and returns fresh output tensors, which
        later calls leave as they are. The pipeline keeps the GRAPHS_KEPT
        most recently used graphs. On the CPU, and for K = 0, every call
        runs eagerly."""
        with annotate("pipeline.call"):
            x = self._samples(chunks)
            key = None
            if _replays_on(self.device) and len(x):
                key = graph_key(self._state, x.shape, arrays=self.arrays, analysis_params=self.analysis_params,
                                agc_params=self.agc_params, path=self.path, ml_model=self.ml_model,
                                with_led=self.with_led, with_viewer=self.with_viewer)
                replay = self._graphs.get(key)
                if replay is not None:
                    self._graphs.move_to_end(key)
                    with annotate("pipeline.replay"):
                        return self._replay(replay, x, dt)
            self.graph_counts["graph_eager_calls"] += 1
            self.state, out = pipeline_step_multi(self.arrays, self.state, x, dt, **self._kwargs())
            if key is not None:
                with annotate("pipeline.capture"):
                    self._graphs[key] = self._capture(x)
                if len(self._graphs) > GRAPHS_KEPT:
                    self._graphs.popitem(last=False)
        return out

    def _capture(self, x: torch.Tensor) -> _Replay:
        """Captures ``pipeline_step_multi`` over state buffers shaped like
        ``self.state`` (shared with the newest capture of the same layout),
        a (K, B, hop) sample buffer and a (B,) frame time. Its last hop's
        state is copied back into the state buffers inside the graph. The
        launch counters keep what the capture counted for the replays."""
        if self._graph_state is None or _layout(self._graph_state) != _layout(self._state):
            self._graph_state = _tree_map(torch.empty_like, self._state)
        state = self._graph_state
        chunks = torch.empty_like(x)
        dt = torch.empty(x.shape[1], dtype=torch.float32, device=x.device)
        kwargs = self._kwargs()
        arrays = self.arrays

        def call():
            new, outputs = pipeline_step_multi(arrays, state, chunks, dt, **kwargs)
            _tree_map(torch.Tensor.copy_, state, new)
            return outputs

        before = _launch_counts()
        launch, outputs = _record(call, self.device)
        # the wrappers counted the kernels they recorded: nothing ran yet
        recorded = tuple(after - b for after, b in zip(_launch_counts(), before))
        _add_launch_counts(-n for n in recorded)
        self.graph_counts["graph_captures"] += 1
        return _Replay(launch, chunks, dt, state, outputs, _nbytes(outputs), recorded,
                       reads=(arrays, self.ml_model))

    def _replay(self, replay: _Replay, x: torch.Tensor, dt) -> PipelineOutputs:
        if not self._state_in_graph or self._state is not replay.state:
            _tree_map(torch.Tensor.copy_, replay.state, self._state)
            self.graph_counts["graph_state_stagings"] += 1
        replay.chunks.copy_(x)
        if isinstance(dt, torch.Tensor) or np.ndim(dt):
            replay.dt.copy_(dt_batch(dt, len(replay.dt), replay.dt.device))
        else:
            replay.dt.fill_(float(dt))
        replay.launch()
        _add_launch_counts(replay.launches)
        self._state, self._state_in_graph, self._state_copy = replay.state, True, None
        self.graph_counts["graph_replays"] += 1
        # the next replay writes the same buffers: the caller gets copies
        self.graph_counts["graph_output_bytes"] += replay.output_bytes
        return _tree_map(torch.Tensor.clone, replay.outputs)

    def rebuild(self, vqt_params: VqtParameters) -> None:
        """Swaps in a new VQT parameter set while streaming. The ring audio
        and AGC gains are preserved; the analysis, ML and ball carries
        persist when the bin layout is unchanged and re-initialize when it
        changes (they are bin-indexed). Raises ValueError for sets this
        pipeline cannot host (different sample rate, n_fft beyond the ring
        length, or a bin-layout change while an ML model is attached: its
        trained params are layout-bound)."""
        buffer_len = int(self._state.ring.buffer.shape[1])
        kernel, arrays, layout_changed = build_rebuilt_arrays(
            self.vqt_params, vqt_params, max_n_fft=buffer_len, path=self.path, fast=self.fast,
            ml_attached=self.ml_model is not None, device=self.device,
        )
        self.arrays = arrays
        self.kernel = kernel
        self.vqt_params = vqt_params
        self.delay_secs = kernel.delay_secs
        self._graphs.clear()  # they read the old arrays
        if layout_changed:
            fresh = self._fresh_state(int(self._state.ring.buffer.shape[0]), buffer_len)
            # audio survives the swap
            self.state = PipelineState(ring=self.state.ring, analysis=fresh.analysis, ml=fresh.ml, balls=fresh.balls)

    def reset_stream(self, idx: int) -> None:
        """Recycles batch slot `idx` for a NEW stream: ring samples, AGC
        gain, analysis carries and (with those stages) the ML history and the
        ball-fade carry return to their fresh values. Other slots are
        untouched. Outputs returned earlier (which share tensors with the
        state) are left as they were."""
        fresh = self._fresh_state(1, int(self._state.ring.buffer.shape[1]))
        self.state = reset_state_row(self._state, fresh, idx)
