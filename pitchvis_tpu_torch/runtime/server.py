"""Multi-stream serving runtime on the card.

Port of ``pitchvis_tpu/runtime/server.py``. It combines the native
lock-free ring bank (the ingest side, written by any producer threads; AGC
runs there, in C++ on the host, per chunk like the reference's audio
callback) with the hop on the card (the compute side). In the default
``ingest="delta"`` mode the rolling analysis windows live on the card: each
hop consumes only the newly pushed samples per stream (native read cursors,
freeze on underrun), copies them over, rolls the windows, and runs the VQT
(the fused VQT kernel on ``path="pallas"``) and the analysis step (two
launches of the peaks kernel). ``ingest="snapshot"`` re-sends the trailing
window every hop, for parity tests and one-shot analyses. This is the
production counterpart of the reference's audio-thread / main-thread split
(pitchvis_viewer/src/vqt_system.rs:40-68) scaled to thousands of streams.

Where the JAX package builds and memoizes jitted programs, the port runs
plain methods of a small plan object (:class:`_Plan`) captured with the
carried state under the server's lock, so the race rules are the JAX
server's line for line: a hop computes under the parameters it captured,
a reset that lands mid-flight is re-applied before the write-back, and a
rebuild that lands mid-flight makes the hop retry under the new set.

The window and the chunks stay float32 on the host and the link. The JAX
server casts them to bf16 on the host in ``fast`` mode; the port's VQT
kernel rounds its f32 frames to bf16 in registers (its plain version rounds
the same way), and rounding commutes with the roll and the select, so the
numbers are the same at twice the bytes over the link.

The stages after the analysis run as in the pipeline
(models/pipeline.py::derived_stages): ``ml_model`` adds the ML inference
over a rolling history of smoothed spectra, ``with_led`` the LED color
block, ``with_viewer`` the display-derived outputs with their ball-fade
carry. The server carries the ML history and the ball carry beside the
analysis carries and the window under the same race rules, and serves its
own frozen copy of the model (models/ml_system.py::serving_copy).
``fetch="led"`` returns only the LED block and the two per-stream scalars
(the ML history still advances). Entry points run on the card unless given
``device="cpu"``.

``mesh`` (parallel/sharding.py::Mesh) splits the stream batch into
contiguous row slices, one a mesh slot, as the JAX server's ``shard_map``
does: one native ring bank holds every stream on the host, each hop's
consumed rows go to their slot's device through a staging buffer of that
slot, each slot carries its own rows of the window and of the analysis, ML
and ball state, and the VQT arrays, the ML model and the hop's plan are
replicated once a device (:class:`_ShardedPlan`). One host thread enqueues
every slot's hop in turn; no hop calls a collective, and the outputs stay
sharded (``Sharded`` leaves, gathered by ``numpy()``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import AnalysisParameters, VqtParameters, VqtRange
from ..core.device import resolve_device
from ..kernel.builder import get_kernel
from ..models.analysis import AnalysisOutputs, analysis_step_batch, dt_batch, init_state_batch
from ..models.ml_system import init_ml_state_batch, serving_copy
from ..models.pitch_mlp import DEFAULT_T
from ..models.pipeline import ViewerOutputs, build_rebuilt_arrays, derived_stages, reset_state_row
from ..models.viewer import BallState
from ..ops.vqt import make_vqt_arrays, vqt_db_auto
from ..parallel.sharding import (
    Replicated,
    Sharded,
    join,
    map_shards,
    piece,
    replicate,
    shard_batch,
    stream_sharding,
    with_piece,
)
from .native import NativeResamplerBank, NativeRingBank

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.bool_): torch.bool}


@dataclass
class ServeOutputs:
    """Per-hop outputs when a stage after the analysis (ML / LED / viewer)
    is enabled on the server; mirrors models.pipeline.PipelineOutputs minus
    the device-ring diagnostics (gains come from the native ingest)."""

    analysis: AnalysisOutputs
    ml_midi: torch.Tensor | None = None  # (B, 128) MIDI strengths when ml_model is set
    led: torch.Tensor | None = None  # (B, n_buckets, 3) u8 LED colors when with_led
    viewer: ViewerOutputs | None = None  # models.pipeline.ViewerOutputs when with_viewer


@dataclass
class CompactOutputs:
    """fetch="led": only what an LED/display consumer reads per hop, the u8
    colors and two scalars a stream instead of the full analysis outputs."""

    led: torch.Tensor  # (B, n_buckets, 3) u8
    scene_calmness: torch.Tensor  # (B,)
    tuning_inaccuracy: torch.Tensor  # (B,)


@dataclass(frozen=True)
class _Plan:
    """What one hop runs under, captured with the carried state under the
    server's lock: the VQT arrays and path, the analysis parameters and bin
    layout, the window length the VQT reads (the fused kernel reads its
    ``tail``, 8192 samples at default parameters; the time path the whole
    ``n_fft``) and the output stages (``ml_model`` the server's frozen copy
    or None). The carried state is the triple (analysis carries, ML history
    or None, ball carry or None). Every method is functional: no tensor it
    is given changes."""

    arrays: object
    path: str
    analysis_params: AnalysisParameters
    rng: VqtRange
    snap_len: int
    ml_model: object = None
    with_led: bool = False
    with_viewer: bool = False
    fetch: str = "full"

    def fused(self, state, x: torch.Tensor, dt):
        """VQT in dB of (B, snap_len) frames, the analysis step and the
        output stages. Returns (new state, packed outputs): the bare
        AnalysisOutputs without stages, else ServeOutputs, or CompactOutputs
        for fetch="led"."""
        analysis, ml, balls = state
        x_vqt = vqt_db_auto(self.arrays, x, path=self.path)
        dt_b = dt_batch(dt, x_vqt.shape[0], x_vqt.device)
        new_analysis, outputs = analysis_step_batch(self.analysis_params, self.rng, analysis, x_vqt, dt_b)
        new_ml, ml_midi, led, new_balls, viewer = derived_stages(
            self.rng, outputs, dt_b,
            ml_model=self.ml_model, ml_state=ml,
            with_led=self.with_led, balls_state=balls, with_viewer=self.with_viewer,
        )
        if self.fetch == "led":
            packed = CompactOutputs(
                led=led, scene_calmness=outputs.scene_calmness, tuning_inaccuracy=outputs.tuning_inaccuracy
            )
        elif self.ml_model is not None or self.with_led or self.with_viewer:
            packed = ServeOutputs(analysis=outputs, ml_midi=ml_midi, led=led, viewer=viewer)
        else:
            packed = outputs  # the bare analysis outputs
        return (new_analysis, new_ml, new_balls), packed

    def roll_window(self, window: torch.Tensor, chunk: torch.Tensor, advanced: torch.Tensor) -> torch.Tensor:
        """Rolls the window by one hop; streams whose producer underran keep
        their old window (freeze == the stall a trailing snapshot gives)."""
        hop = chunk.shape[1]
        if hop >= self.snap_len:
            rolled = chunk[:, -self.snap_len :]
        else:
            rolled = torch.cat([window[:, hop:], chunk], dim=1)
        return torch.where(advanced[:, None], rolled, window)

    def fused_delta(self, state, window, chunk, advanced, dt):
        window = self.roll_window(window, chunk, advanced)
        new_state, outputs = self.fused(state, window, dt)
        return new_state, window, outputs


@dataclass(frozen=True)
class _ShardedPlan:
    """A :class:`_Plan` on each mesh device (its VQT arrays and ML model
    that device's copies), run on each slot's rows by ``map_shards``: the
    counterpart of the JAX server's ``shard_map``-wrapped programs. The
    state, window, chunks, flags and per-stream dt it is given are Sharded;
    a scalar dt goes to every slot as it is."""

    plans: Replicated
    snap_len: int

    def fused(self, state, x, dt):
        return map_shards(lambda p, *a: p.fused(*a), self.plans, state, x, dt)

    def fused_delta(self, state, window, chunk, advanced, dt):
        return map_shards(lambda p, *a: p.fused_delta(*a), self.plans, state, window, chunk, advanced, dt)


class _Slot:
    __slots__ = ("array", "pinned", "event", "busy", "sent", "dim")

    def __init__(self, array, pinned=None, event=None):
        self.array = array  # the NumPy view the host fills
        self.pinned = pinned  # the pinned tensor behind it (card only)
        self.event = event  # recorded after its copy was enqueued
        self.busy = False
        self.sent = 0
        self.dim = 0  # the stream axis of the array (a _MeshStage splits it)


class _HostStage:
    """Host buffers that feed the card without a synchronous copy.

    A copy from pageable memory waits for all the work queued before it,
    which would make a pipelined step wait for the previous hop's analysis.
    So on the card each buffer is pinned, its copy is enqueued with
    ``non_blocking=True``, and an event recorded after the copy guards the
    buffer: it is handed out again only once that copy has completed. On the
    CPU a fresh array is handed over as it is."""

    DEPTH = 4  # buffers of one shape before take() waits for the oldest copy

    def __init__(self, device: torch.device):
        self.device = device
        self._lock = threading.Lock()
        self._slots: dict = {}
        self._sent = 0

    def take(self, shape, dtype, dim: int = 0) -> _Slot:
        """A free host buffer of this shape and type; fill ``slot.array``,
        then :meth:`send` or :meth:`drop` it. (``dim``, the stream axis,
        matters only to a _MeshStage.)"""
        shape, dtype = tuple(shape), np.dtype(dtype)
        if self.device.type != "cuda":
            return _Slot(np.empty(shape, dtype))
        with self._lock:
            slots = self._slots.setdefault((shape, dtype), [])
            free = [s for s in slots if not s.busy]
            slot = next((s for s in free if s.event.query()), None)
            if slot is None and len(slots) < self.DEPTH:
                pinned = torch.empty(shape, dtype=_TORCH_DTYPE[dtype], pin_memory=True)
                slot = _Slot(pinned.numpy(), pinned, torch.cuda.Event())
                slots.append(slot)
            elif slot is None:
                if not free:
                    raise RuntimeError(f"all {self.DEPTH} staging buffers of shape {shape} are taken")
                slot = min(free, key=lambda s: s.sent)
                # all in flight: wait for the oldest copy (and the work queued
                # before it) to have run
                slot.event.synchronize()
            slot.busy = True
        return slot

    def send(self, slot: _Slot) -> torch.Tensor:
        """The buffer's contents on the device (a copy enqueued on the
        current stream; the CPU takes the array as it is)."""
        if slot.pinned is None:
            return torch.from_numpy(slot.array)
        out = slot.pinned.to(self.device, non_blocking=True)
        slot.event.record(torch.cuda.current_stream(self.device))
        with self._lock:
            self._sent += 1
            slot.sent = self._sent
            slot.busy = False
        return out

    def drop(self, slot: _Slot) -> None:
        with self._lock:
            slot.busy = False

    def put(self, array: np.ndarray, dim: int = 0) -> torch.Tensor:
        """``array`` on the device through a staging buffer."""
        slot = self.take(array.shape, array.dtype)
        np.copyto(slot.array, array)
        return self.send(slot)


class _MeshStage:
    """The batch's rows split into the mesh's slices, each slice sent to its
    slot's device through a :class:`_HostStage` of that slot. The native
    ring bank fills one host array of all B rows (unpinned); each slice is
    copied once more on the host, into its slot's pinned buffer, and sent
    from there without a synchronous copy."""

    def __init__(self, slices):
        self._slices = slices  # (device, start, stop) per slot
        self._stages = [_HostStage(device) for device, _, _ in slices]

    def take(self, shape, dtype, dim: int = 0) -> _Slot:
        slot = _Slot(np.empty(shape, dtype))
        slot.dim = dim
        return slot

    def send(self, slot: _Slot) -> Sharded:
        return self.put(slot.array, slot.dim)

    def drop(self, slot: _Slot) -> None:
        pass

    def put(self, array: np.ndarray, dim: int = 0) -> Sharded:
        index = [slice(None)] * array.ndim
        pieces = []
        for stage, (_, start, stop) in zip(self._stages, self._slices):
            index[dim] = slice(start, stop)
            pieces.append(stage.put(array[tuple(index)]))
        return Sharded(pieces, dim)


def _zero_row(t: torch.Tensor, row: int) -> torch.Tensor:
    out = t.clone()
    out[row] = 0
    return out


def _hop_dt(adv, hop_dt: float):
    """Per-stream dt of a catch-up hop: ``hop_dt`` where the stream
    advanced, else 0."""
    if isinstance(adv, Sharded):
        return map_shards(_hop_dt, adv, hop_dt=hop_dt)
    return torch.where(adv, hop_dt, 0.0)


class StreamServer:
    """Ingest + batched analysis server for ``n_streams`` concurrent streams."""

    def __init__(
        self,
        n_streams: int,
        vqt_params: VqtParameters | None = None,
        analysis_params: AnalysisParameters | None = None,
        buffer_seconds: float = 4.0,
        path: str = "time",
        fast: bool = False,
        ingest: str = "delta",
        hop_seconds: float = 1.0 / 60.0,
        max_lag_seconds: float = 0.25,
        max_catchup_hops: int = 1,
        ml_model=None,
        ml_params=None,
        ml_t_window: int | None = None,
        with_led: bool = False,
        with_viewer: bool = False,
        fetch: str = "full",
        mesh=None,
        device="cuda",
    ):
        """``path="pallas"`` serves the fused VQT kernel; ``fast=True``
        stores its weights in bf16. Reference analog: the viewer's one VQT
        in its frame loop (pitchvis_viewer/src/vqt_system.rs:40-68).

        ``ingest`` picks how audio reaches the card each hop:

        * ``"delta"`` (default): the rolling analysis window lives on the
          card; each hop sends only the newly ingested ``hop_seconds`` of
          samples per stream. Underrunning producers freeze their window
          (all-or-nothing consume); backlogs drain through up to
          ``max_catchup_hops`` extra hops per step and are skipped
          realtime-style beyond ``max_lag_seconds``. The window is
          (re)materialized from the full ring on the first step and after
          rebuild()/restore, so push-then-serve warmups see all audio.
        * ``"snapshot"``: re-send the trailing window every hop.

        Output stages (the ones models.pipeline runs after its analysis):
        ``ml_model`` (a PitchMLP) with ``ml_params`` (a state_dict; None: the
        module's own weights) adds the ML inference over a history of
        ``ml_t_window`` smoothed spectra (default DEFAULT_T, the training
        window); the server serves its own frozen copy, ``self.ml_model``.
        ``with_led`` adds the per-stream LED color block, ``with_viewer``
        every display-derived output (pitch balls with their fade carry,
        chroma, bloom, spectrogram row, bass spiral, calmness histogram).

        ``step()`` returns ``(outputs, gains)``: tensors on the server's
        device and the (B,) AGC gains as a NumPy array. ``outputs`` are the
        bare ``AnalysisOutputs`` without output stages, ``ServeOutputs``
        with one, and ``CompactOutputs`` (the LED block and two scalars a
        stream) for ``fetch="led"``, which implies ``with_led``. Runs on
        the card unless ``device="cpu"``; raises if the native ingest
        library cannot be built or loaded.

        ``mesh`` (a one-host ``parallel.sharding.Mesh``, e.g.
        ``make_mesh()``) splits the streams over the mesh's devices, which
        then place everything (``device`` is not used): each slot serves
        its contiguous slice of ``n_streams``, which must divide evenly over
        the mesh. Every output leaf is then a ``Sharded`` value and
        ``self.devices`` names the distinct devices; one server process
        drives every local device, and multi-host scale-out runs one server
        (or runtime/multihost_serve.py) a host."""
        if ingest not in ("delta", "snapshot"):
            raise ValueError(f"ingest must be 'delta' or 'snapshot', got {ingest!r}")
        if fetch not in ("full", "led"):
            raise ValueError(f"fetch must be 'full' or 'led', got {fetch!r}")
        if mesh is not None and n_streams % mesh.size != 0:
            raise ValueError(f"n_streams {n_streams} must divide evenly over the {mesh.size}-device mesh")
        if mesh is not None and mesh.n_processes > 1:
            raise ValueError("a server drives one process's devices: give it a one-host mesh")
        if fetch == "led":
            with_led = True
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self._slices = [(self.device, 0, n_streams)]
        else:
            self._slices = stream_sharding(mesh).local_slices(n_streams)
            self.device = self._slices[0][0]
        # the distinct devices, in slot order
        self.devices = tuple(dict.fromkeys(d for d, _, _ in self._slices))
        self.vqt_params = vqt_params or VqtParameters()
        self.analysis_params = analysis_params or AnalysisParameters()
        self.path = path
        self.fast = fast
        self.ingest = ingest
        self._hop = max(1, int(self.vqt_params.sr * hop_seconds))
        self._max_lag = max(self._hop, int(self.vqt_params.sr * max_lag_seconds))
        self._max_catchup = max(0, int(max_catchup_hops))
        self._window = None  # the rolling window on the device (delta mode)
        capacity = max(int(round(self.vqt_params.sr * buffer_seconds)), self.vqt_params.n_fft)
        if self._hop > capacity:
            # pv_rb_consume's all-or-nothing read could then never be
            # satisfied: every stream would silently freeze forever
            raise ValueError(
                f"hop_seconds ({self._hop} samples) exceeds the ring "
                f"capacity ({capacity}); raise buffer_seconds or lower the hop"
            )
        self.rings = NativeRingBank(n_streams, capacity)
        self.kernel = get_kernel(self.vqt_params)
        self.arrays = self._replicated(make_vqt_arrays(self.kernel, path=path, fast=fast, device=self.device))
        self.n_streams = n_streams
        self.ml_model = None
        if ml_model is not None and mesh is None:
            self.ml_model = serving_copy(ml_model, ml_params, self.device)
        elif ml_model is not None:
            self.ml_model = Replicated.build(mesh.local_devices, lambda d: serving_copy(ml_model, ml_params, d))
        self._ml_t = DEFAULT_T if ml_model is not None and ml_t_window is None else ml_t_window
        self.with_led, self.with_viewer, self.fetch = with_led, with_viewer, fetch
        self.analysis_state = self._rows(lambda n, d: init_state_batch(n, self.vqt_params.n_buckets, device=d))
        self.ml_state = self._rows(self._init_ml)
        self.balls_state = self._rows(self._init_balls)
        self._stage = _HostStage(self.device) if mesh is None else _MeshStage(self._slices)
        self._last_step = None
        self._pending = None  # in-flight (outputs, gains) when pipelining
        self._serve_loop = None  # active self-driving loop (see serve())
        # serving counters, updated by the analysis thread and read by anyone
        self.stats = {
            "hops": 0,  # hops dispatched (incl. catch-up and multi inner hops)
            "catchup_hops": 0,  # extra hops draining bursty backlogs
            "advanced": 0,  # stream-hops that consumed audio
            "frozen": 0,  # stream-hops frozen by producer underrun
            "materializations": 0,  # full-window rebuilds (init/rebuild/restore)
        }
        # serializes the read-modify-write of the carried state between the
        # analysis thread (step) and the control plane (reset_stream, rebuild)
        self._state_lock = threading.Lock()
        # resets that land while a hop is in flight, re-applied to its result
        # before it is written back (see _capture / _writeback)
        self._resets_in_flight: set[int] = set()
        # ingest resamplers, one bank per producer rate, created lazily
        self._resamplers: dict[int, NativeResamplerBank] = {}
        self._resampler_lock = threading.Lock()
        self._refresh_dispatch()

    # -- placement (one device, or row slices over self.mesh) ----------------
    def _rows(self, make):
        """``make(n, device)`` for all ``n_streams`` rows on the server's
        device, or for each slot's slice on its device, joined into Sharded
        leaves."""
        if self.mesh is None:
            return make(self.n_streams, self.device)
        return join([make(stop - start, d) for d, start, stop in self._slices])

    def _replicated(self, value):
        """``value`` (built on ``self.device``), or a copy on every mesh
        device."""
        return value if self.mesh is None else replicate(self.mesh, value)

    def _put_state(self, tree):
        """A carried-state tree of host or device tensors of all rows ->
        split over the mesh (the identity without one)."""
        return tree if self.mesh is None or tree is None else shard_batch(self.mesh, tree)

    def _reset_rows(self, state, window, stream: int):
        """The carried state and window with row ``stream`` fresh (window
        row zeroed); functional. On a mesh the row is located in its slot,
        whose fresh row is made on that slot's device."""
        if self.mesh is None:
            state = reset_state_row(state, self._fresh_rows(self.device), stream)
            return state, (None if window is None else _zero_row(window, stream))
        i, (device, start, _) = next((i, sl) for i, sl in enumerate(self._slices) if sl[1] <= stream < sl[2])
        row = stream - start
        state = with_piece(state, i, reset_state_row(piece(state, i), self._fresh_rows(device), row))
        if window is not None:
            window = window.replace(i, _zero_row(window.shards[i], row))
        return state, window

    def _init_ml(self, n: int, device):
        if self.ml_model is None:
            return None
        return init_ml_state_batch(n, self._ml_t, self.vqt_params.n_buckets, device=device)

    def _init_balls(self, n: int, device):
        if not self.with_viewer:
            return None
        return BallState.init(n, self.vqt_params.n_buckets, device=device)

    def _fresh_rows(self, device):
        """One freshly initialized (B=1) row of the carried state (analysis,
        ml, balls) on ``device``. Call with self._state_lock held (reads the
        live n_buckets)."""
        return (
            init_state_batch(1, self.vqt_params.n_buckets, device=device),
            self._init_ml(1, device),
            self._init_balls(1, device),
        )

    def _refresh_dispatch(self) -> None:
        """Re-reads the arrays and parameters into the plan the next hop
        captures; called at init and after every rebuild()/retune_analysis(),
        with the lock held. (The JAX package builds and memoizes its jitted
        programs here; the port has nothing to trace.) On a mesh the plan
        is made once a device, with that device's arrays and model."""

        def plan(device):
            arrays = self.arrays if self.mesh is None else self.arrays.on(device)
            return _Plan(
                arrays=arrays,
                path=self.path,
                analysis_params=self.analysis_params,
                rng=self.vqt_params.range,
                snap_len=int(getattr(arrays, "tail", self.vqt_params.n_fft)),
                ml_model=self.ml_model.on(device) if isinstance(self.ml_model, Replicated) else self.ml_model,
                with_led=self.with_led,
                with_viewer=self.with_viewer,
                fetch=self.fetch,
            )

        if self.mesh is None:
            self._plan = plan(self.device)
        else:
            plans = Replicated.build(self.mesh.local_devices, plan)
            self._plan = _ShardedPlan(plans, plans.on(self.device).snap_len)

    # -- ingest side (any thread) -------------------------------------------
    def push(self, stream: int, samples: np.ndarray, sr: float | None = None) -> bool:
        """Appends raw samples for one stream (AGC applied natively).

        ``sr`` declares the producer's sample rate: 44.1/48 kHz feeds are
        resampled to the server rate in the native ingest path (per-stream
        streaming polyphase state; the reference's rubato FftFixedIn stage,
        pitchvis_audio/src/audio_wasm.rs:176-209) before AGC and the ring
        write. A stream must keep one rate between resets."""
        if sr is not None and int(sr) != int(self.vqt_params.sr):
            bank = self._resamplers.get(int(sr))
            if bank is None:
                with self._resampler_lock:
                    bank = self._resamplers.get(int(sr))
                    if bank is None:
                        bank = NativeResamplerBank(self.n_streams, int(sr), int(self.vqt_params.sr))
                        self._resamplers[int(sr)] = bank
            samples = bank.process(stream, samples)
            if len(samples) == 0:
                return True  # carried to the next chunk
        return self.rings.write(stream, samples)

    def push_batch(self, samples: np.ndarray, streams: np.ndarray | None = None,
                   sr: float | None = None) -> np.ndarray:
        """Appends one equal-length chunk to many streams in a single
        native call: row k of ``samples`` (rows, n) goes to stream
        ``streams[k]`` (``None`` = streams 0..rows-1). AGC is applied
        natively per row; returns an ok[rows] bool array (NaN-guard
        rejections per row, like ``push``). With a producer rate ``sr``
        other than the server's, the resampled lengths are ragged, so the
        rows are written one by one."""
        samples = np.asarray(samples, np.float32)
        if samples.ndim != 2:
            raise ValueError(f"samples must be (rows, n), got {samples.shape}")
        rows = samples.shape[0]
        ids = (np.arange(rows, dtype=np.int64) if streams is None
               else np.ascontiguousarray(streams, np.int64))
        if ids.shape != (rows,):
            raise ValueError(f"streams shape {ids.shape} != ({rows},)")
        if rows and (ids.min() < 0 or ids.max() >= self.n_streams):
            raise ValueError("stream id out of range")
        if sr is not None and int(sr) != int(self.vqt_params.sr):
            return np.array([self.push(int(s), row, sr=sr) for s, row in zip(ids, samples)], bool)
        return self.rings.write_batch(ids, samples)

    # -- control plane -------------------------------------------------------
    def reset_stream(self, stream: int) -> None:
        """Recycles one slot for a new client stream: clears the native ring
        (audio, write position, AGC gain), the slot's resampler state, its
        analysis carries, ML history and ball carry and its row of the window, so the new stream starts
        from what a fresh server would give it. Call after the slot's
        previous producer has stopped; safe against a concurrent step()."""
        self.rings.reset(stream)
        with self._resampler_lock:
            for bank in self._resamplers.values():
                bank.reset(stream)
        with self._state_lock:
            # the fresh row is built inside the lock: a layout-changing
            # rebuild() between an unlocked read and the write would make it
            # the wrong shape; the window row is zeroed (delta mode never
            # re-sends the old client's audio)
            state, self._window = self._reset_rows(
                (self.analysis_state, self.ml_state, self.balls_state), self._window, stream
            )
            self.analysis_state, self.ml_state, self.balls_state = state
            self._resets_in_flight.add(int(stream))

    def retune_analysis(self, analysis_params: AnalysisParameters) -> None:
        """Swaps the analysis parameter set while serving (the analysis half
        of live tuning, common.rs:847-1102). The carries do not depend on
        these parameters and persist."""
        with self._state_lock:
            self.analysis_params = analysis_params
            self._refresh_dispatch()

    def rebuild(self, vqt_params: VqtParameters) -> None:
        """Swaps in a new VQT parameter set while serving (the reference's
        debounced rebuild, common.rs:1105-1165). The ring bank and its audio
        are kept; the analysis, ML and ball carries persist when the bin
        layout is unchanged and are re-initialized when it changes; the
        window is re-materialized from the ring on the next step. Raises
        ValueError for sets this server cannot host (another sample rate,
        n_fft beyond the ring capacity, a bin-layout change with an ML
        model attached)."""
        kernel, arrays, layout_changed = build_rebuilt_arrays(
            self.vqt_params, vqt_params, max_n_fft=self.rings.capacity,
            path=self.path, fast=self.fast, ml_attached=self.ml_model is not None, device=self.device,
        )
        arrays = self._replicated(arrays)
        with self._state_lock:
            self.kernel = kernel
            self.arrays = arrays
            self.vqt_params = vqt_params
            if layout_changed:
                self.analysis_state = self._rows(lambda n, d: init_state_batch(n, vqt_params.n_buckets, device=d))
                self.ml_state = self._rows(self._init_ml)
                self.balls_state = self._rows(self._init_balls)
            self._refresh_dispatch()
            self._window = None

    # -- compute side (analysis thread) --------------------------------------
    def _dispatch(self, dt: float | None):
        """Stages and enqueues one hop; returns (outputs, gains) with the
        outputs still being computed on the card. Arrays and parameters are
        captured under the lock; a rebuild landing mid-hop retries it under
        the new parameter set."""
        now = time.monotonic()
        if dt is None:
            dt = 1.0 / 60.0 if self._last_step is None else max(now - self._last_step, 1e-4)
        self._last_step = now
        if self.ingest == "delta":
            return self._dispatch_delta(dt)

        for _ in range(3):  # retried only if a rebuild lands mid-step
            plan, params, state, _ = self._capture()
            windows, gains = self.rings.snapshot(plan.snap_len)
            new_state, outputs = plan.fused(state, self._stage.put(windows), dt)
            if self._writeback(params, new_state, None):
                return outputs, gains
        raise RuntimeError("rebuild storm: step() could not complete")

    def _capture(self):
        """Captures the plan and the carried state under the lock, and
        clears the resets-in-flight set (a reset added after this point
        landed mid-flight and is re-applied by _writeback)."""
        with self._state_lock:
            captured = (
                self._plan, self.vqt_params, (self.analysis_state, self.ml_state, self.balls_state), self._window
            )
            self._resets_in_flight.clear()
        return captured

    def _materialize_window(self, snap_len: int) -> torch.Tensor:
        """(Re)builds the window on the device from the ring: a fused native
        snapshot + mark against one head read per stream, so samples racing
        the copy stay unconsumed."""
        w, _ = self.rings.snapshot_consume(snap_len)
        self.stats["materializations"] += 1
        return self._stage.put(w)

    def _writeback(self, params, new_state, new_window) -> bool:
        """Commits a hop's carried state; False = a rebuild landed mid-step
        (the caller recomputes under the new parameter set). Resets that
        raced the hop are re-applied: their rows were computed from the
        captured pre-reset state and would otherwise resurrect the old
        client."""
        with self._state_lock:
            if self.vqt_params is not params:
                return False
            for s in self._resets_in_flight:
                new_state, new_window = self._reset_rows(new_state, new_window, s)
            self.analysis_state, self.ml_state, self.balls_state = new_state
            if new_window is not None:
                self._window = new_window
            return True

    def _consume_hop(self):
        """The next hop of every stream, staged: (slot holding the (B, hop)
        chunks, gains, advanced)."""
        slot = self._stage.take((self.n_streams, self._hop), np.float32)
        _, gains, adv = self.rings.consume(self._hop, self._max_lag, out=slot.array)
        return slot, gains, adv

    def _dispatch_delta(self, dt: float):
        """Delta-ingest hop: consume the newly pushed ``hop`` samples per
        stream and roll the window on the device instead of re-sending it.
        The window follows the same capture/write-back discipline as the
        analysis carries and is re-materialized from the ring whenever it is
        invalid (first step, after a rebuild or a restore)."""
        hop_dt = float(np.float32(self._hop / self.vqt_params.sr))
        b = self.n_streams
        for _ in range(3):  # retried only if a rebuild lands mid-step
            plan, params, state, window = self._capture()
            if window is None or window.shape[1] != plan.snap_len:
                window = self._materialize_window(plan.snap_len)
            new_state, new_window = state, window
            outputs = gains = None
            # committed only on a successful write-back, so the hops of an
            # attempt a rebuild discarded are not counted
            acc = {"hops": 0, "catchup_hops": 0, "advanced": 0, "frozen": 0}
            for k in range(1 + self._max_catchup):
                slot, g, adv = self._consume_hop()
                if k > 0 and not adv.any():
                    self._stage.drop(slot)
                    break  # backlog drained; nothing would advance
                chunk = self._stage.send(slot)
                adv_t = self._stage.put(adv)
                # per-stream dt, made on the device: hop 0 advances every
                # stream by the caller's wall-clock dt (streams that underran
                # still decay, like a stalled snapshot); a catch-up hop
                # advances only the draining streams' audio clocks
                if k == 0:
                    dt_b = self._rows(lambda n, d: torch.full((n,), float(dt), dtype=torch.float32, device=d))
                else:
                    dt_b = _hop_dt(adv_t, hop_dt)
                new_state, new_window, outputs = plan.fused_delta(new_state, new_window, chunk, adv_t, dt_b)
                gains = g
                n_adv = int(adv.sum())
                acc["hops"] += 1
                acc["catchup_hops"] += int(k > 0)
                acc["advanced"] += n_adv
                if k == 0:
                    # only wall-clock hops count underruns
                    acc["frozen"] += b - n_adv
            if self._writeback(params, new_state, new_window):
                for key, v in acc.items():
                    self.stats[key] += v
                return outputs, gains
        raise RuntimeError("rebuild storm: step() could not complete")

    def _guard_manual_dispatch(self) -> None:
        """While a serve loop is active, its thread is the only dispatcher:
        a second thread stepping concurrently would race the pipelined
        _pending swap and advance the analysis clock twice."""
        loop = self._serve_loop
        if loop is not None and loop.running and threading.current_thread() is not loop._thread:
            raise RuntimeError(
                "a serve loop owns this server's dispatch; stop() it before stepping manually"
            )

    def step_multi(self, k: int, dt: float | None = None, per_hop: bool = False):
        """``k`` hops enqueued back to back from one staged (k, B, hop)
        block: the ingest-fed twin of ``pipeline_step_multi``, for
        throughput deployments (catch-up faster than real time, offline
        drains). Returns the last hop's (outputs, gains); every hop advances
        analysis time by hop/sr (the audio clock; ``dt`` overrides that
        pacing). Requires ingest="delta".

        ``per_hop=True`` returns every hop's outputs as a k-tuple, with
        ``gains`` as (k, B): the cadenced serving mode
        (``serve(publish="per_hop")``), equal to k single ``step()`` calls
        at audio-clock pacing."""
        if self.ingest != "delta":
            raise RuntimeError("step_multi requires ingest='delta'")
        if k < 1:
            raise ValueError("k must be >= 1")
        self._guard_manual_dispatch()
        hop_dt = float(self._hop / self.vqt_params.sr) if dt is None else float(dt)
        self._last_step = time.monotonic()
        b = self.n_streams
        for _ in range(3):  # retried only if a rebuild lands mid-step
            plan, params, state, window = self._capture()
            if window is None or window.shape[1] != plan.snap_len:
                window = self._materialize_window(plan.snap_len)
            slot = self._stage.take((k, b, self._hop), np.float32, dim=1)
            advs = np.empty((k, b), bool)
            gains_all = np.empty((k, b), np.float32)
            for i in range(k):
                # consume writes each hop's chunks straight into its row of
                # the staging block
                _, gains_all[i], advs[i] = self.rings.consume(self._hop, self._max_lag, out=slot.array[i])
            chunks = self._stage.send(slot)
            advs_t = self._stage.put(advs, dim=1)
            n_adv = int(advs.sum())
            new_state, new_window = state, window
            per = []
            for i in range(k):
                new_state, new_window, outputs = plan.fused_delta(
                    new_state, new_window, chunks[i], advs_t[i], hop_dt
                )
                per.append(outputs)
            if self._writeback(params, new_state, new_window):
                self.stats["hops"] += k
                self.stats["advanced"] += n_adv
                self.stats["frozen"] += k * b - n_adv
                if per_hop:
                    return tuple(per), gains_all
                return per[-1], gains_all[-1]
        raise RuntimeError("rebuild storm: step_multi() could not complete")

    def step(self, pipelined: bool = False, dt: float | None = None):
        """One analysis update over all streams. Returns (outputs, gains).

        ``pipelined=True`` keeps one hop in flight, as the reference's
        audio-thread/main-thread split does (pitchvis_viewer/src/
        vqt_system.rs:59-67): this hop is staged and enqueued, and the
        previous hop's (outputs, gains), which the card finished while the
        host prepared this one, are returned (None on the first call; drain
        the last hop with ``flush()``). Nothing in a delta hop waits for the
        card, so the caller pays only for the host's part.

        ``dt`` overrides the wall-clock frame delta (deterministic replays
        and tests); by default it is measured between step calls."""
        self._guard_manual_dispatch()
        result = self._dispatch(dt)
        if not pipelined:
            return result
        prev, self._pending = self._pending, result
        return prev

    def flush(self):
        """Returns the in-flight pipelined hop's (outputs, gains) without
        dispatching a new one (None if nothing is pending)."""
        prev, self._pending = self._pending, None
        return prev

    def serve(
        self,
        rate_hz: float = 60.0,
        pipelined: bool = True,
        on_outputs=None,
        sync: str = "element",
        hops_per_dispatch: int = 1,
        publish: str = "latest",
    ):
        """Starts the self-driving loop (runtime/loop.py::ServeLoop): a
        background thread paces ``step(pipelined=...)`` at ``rate_hz`` and
        publishes each hop's (outputs, gains) for consumers (``latest()`` /
        ``wait_next()``), mirroring the reference viewer's framework-driven
        Update schedule (common.rs:2082-2118). ``on_outputs(seq, outputs,
        gains)`` runs on the loop thread per hop. ``sync``: ``"element"``
        (default) waits for each published hop's work on the card,
        ``"host"`` publishes NumPy copies, ``"none"`` the raw tensors.
        ``hops_per_dispatch=k`` (delta ingest) is the throughput mode
        (``step_multi(k)``, the newest hop published); ``publish="per_hop"``
        the cadenced mode (every hop of each k-hop dispatch published on its
        own 1/rate_hz slot). One loop per server; ``stop()`` (or the context
        manager) releases it. The control plane stays usable while
        serving."""
        from .loop import ServeLoop

        # check-and-assign under the lock: two racing serve() calls must
        # not both start loops stepping the same server
        with self._state_lock:
            if self._serve_loop is not None and self._serve_loop.running:
                raise RuntimeError("server is already serving (stop() the active loop)")
            # a leftover of manual pipelined stepping must not become the
            # loop's first publish
            self._pending = None
            self._serve_loop = ServeLoop(
                self, rate_hz, pipelined, on_outputs, sync, hops_per_dispatch, publish,
            )
            return self._serve_loop

    def close(self) -> None:
        loop = self._serve_loop
        if loop is not None and loop.running:
            try:
                loop.stop()
            except RuntimeError:
                pass  # the loop's error stays readable on loop.error
        self.rings.close()
        with self._resampler_lock:
            for bank in self._resamplers.values():
                bank.close()
            self._resamplers.clear()
