"""Tracing / profiling / observability.

Port of ``pitchvis_tpu/utils/profiling.py``. The reference surfaces runtime
metrics in a debug UI: FPS (FrameTimeDiagnosticsPlugin), audio latency and
chunk size from the ring buffer, VQT algorithmic delay, current smoothing
horizon (pitchvis_viewer/src/app/common.rs:148-334). The equivalents here:

* `StageTimer` — per-stage wall-clock timers with EMA'd rates (the FPS /
  latency overlay data source), cheap enough for production loops (a copy);
* `debug_report` — one-call snapshot of pipeline health: stage timings,
  algorithmic delay, kernel stats, the torch device;
* `trace()` — context manager around ``torch.profiler.profile`` that writes
  a Chrome trace (viewable in Perfetto or chrome://tracing), with the
  program's spans recorded for the block;
* `annotate()` — the program's span: a named region of the hop (the stage
  functions open one each), recorded into a :class:`SpanLog` while
  :func:`recording` is on and a shared null context otherwise;
* `recording()` — turns spans on for a block and yields their log.

A span's start and end are ``time.monotonic_ns()``, the clock the
benchmark's device trace is put on, so a device event can be set beside the
span that launched it. While a torch profiler is active a recorded span also
enters ``torch.profiler.record_function(name)``, so the profiler links each
kernel launch to its span. Span names: ``pipeline.call``, ``pipeline.hop``,
``pipeline.stack``, ``stage.ring``, ``stage.vqt``, ``stage.analysis`` (with
``analysis.smooth``, ``analysis.peaks``, ``analysis.core`` inside it),
``stage.outputs``, and ``server.hop`` around the server's VQT, analysis and
output stages.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch


class StageTimer:
    """EMA'd per-stage timings (seconds) + rates, frame-rate independent."""

    def __init__(self, horizon: float = 2.0):
        self.horizon = horizon
        self._ema: dict[str, float] = {}
        self._last: dict[str, float] = {}
        self._seen: dict[str, float] = {}  # wall time of the last observation
        self._gap_ema: dict[str, float] = {}  # EMA'd inter-observation gap
        self._count: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.observe(name, dt)

    def observe(self, name: str, dt: float) -> None:
        self._last[name] = dt
        self._count[name] += 1
        now = time.perf_counter()
        prev = self._ema.get(name)
        if prev is None:
            self._ema[name] = dt
        else:
            # the EMA timestep is the WALL time since this stage was last
            # observed, not the stage's own duration — using dt would make a
            # fast stage's EMA converge arbitrarily slowly (a 1 ms stage at
            # 60 fps would need ~33 s of wall time for a 2 s horizon)
            step = now - self._seen.get(name, now - dt)
            alpha = 1.0 - math.exp(-2.0 * max(step, 1e-9) / self.horizon)
            self._ema[name] = prev + alpha * (dt - prev)
            gap_prev = self._gap_ema.get(name, step)
            self._gap_ema[name] = gap_prev + alpha * (step - gap_prev)
        self._seen[name] = now

    def ema(self, name: str) -> float:
        return self._ema.get(name, 0.0)

    def last(self, name: str) -> float:
        return self._last.get(name, 0.0)

    def fps(self, name: str) -> float:
        """The OBSERVED invocation rate (1 / EMA'd gap between calls) — the
        number an FPS overlay means. A 1 ms stage called once per 16.7 ms
        frame reports 60, not its theoretical-max 1000 (that inverse-duration
        figure is still available via :meth:`max_fps`)."""
        g = self._gap_ema.get(name, 0.0)
        return 1.0 / g if g > 0 else 0.0

    def max_fps(self, name: str) -> float:
        """The stage's maximum achievable rate: 1 / EMA'd stage duration."""
        e = self.ema(name)
        return 1.0 / e if e > 0 else 0.0

    def report(self) -> dict:
        return {
            name: {
                "ema_ms": round(1000.0 * self._ema[name], 3),
                "last_ms": round(1000.0 * self._last.get(name, 0.0), 3),
                "count": self._count[name],
                "fps": round(self.fps(name), 1),
            }
            for name in self._ema
        }


@contextlib.contextmanager
def trace(log_dir: str, activities=None, filename: str = "trace.json"):
    """Profiler trace of the block, written to ``log_dir/filename`` as a
    Chrome trace when the block ends; yields the ``torch.profiler.profile``
    (its ``key_averages()`` sum the ops by name). The program's spans are
    recorded for the block (:func:`recording`), so the trace shows them as
    ranges. ``activities`` defaults to the CPU and, when torch sees a card,
    CUDA."""
    from torch.profiler import ProfilerActivity, profile

    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, filename))


# records a log holds unless told otherwise: a 45-s window of the serial
# capacity deployment (3840 streams, 16 hops a call) finishes some 130 spans
# a call in 200-350 calls
SPAN_CAPACITY = 1 << 16

_NULL = contextlib.nullcontext()
_active = None  # the SpanLog that spans go to, while recording() is on


class SpanRecord(NamedTuple):
    """One finished span. ``index`` counts the spans begun in its log;
    ``parent`` is the index of the span open around it on its thread (-1
    at the top); ``call`` numbers the top-level spans of the log and is
    shared by everything inside one (a hop's index is the place of its
    ``pipeline.hop`` among the call's); times are ``time.monotonic_ns()``."""

    index: int
    name: str
    parent: int
    call: int
    start_ns: int
    end_ns: int


class _Span:
    """An open span, entered as a context manager; its record goes to the
    log when it closes."""

    __slots__ = ("log", "name", "index", "parent", "call", "start_ns", "_stack", "_rf")

    def __init__(self, log, name):
        self.log = log
        self.name = name
        self._rf = None

    def __enter__(self):
        log = self.log
        try:
            stack = log._local.stack
        except AttributeError:
            stack = log._local.stack = []
        self.index = next(log._begun)  # next() of a count is atomic
        if stack:
            self.parent, self.call = stack[-1].index, stack[-1].call
        else:
            self.parent, self.call = -1, next(log._calls)
        self._stack = stack
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.monotonic_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._stack.pop()
        self.log._add(SpanRecord(self.index, self.name, self.parent, self.call, self.start_ns, end_ns))
        return False


class SpanLog:
    """The spans that finished while it was active, at most ``capacity``:
    past that it keeps the newest and counts the ones it dropped, so a
    long-running process cannot grow it. Each thread nests its own
    spans."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be at least 1, got {capacity}")
        self.capacity = capacity
        self.dropped = 0  # records pushed out since the last drain
        self._records = deque(maxlen=capacity)
        self._lock = threading.Lock()  # the records and the dropped count, across threads
        self._local = threading.local()
        self._begun = itertools.count()
        self._calls = itertools.count()

    def _add(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._records) == self.capacity:
                self.dropped += 1
            self._records.append(record)

    def spans(self) -> list:
        """The finished spans it holds, in the order they began."""
        with self._lock:
            return sorted(self._records)

    def last_call(self) -> list:
        """The spans of the newest finished call it holds (a top-level span
        and what ran inside it), in the order they began."""
        spans = self.spans()
        tops = [s.call for s in spans if s.parent == -1]
        return [s for s in spans if s.call == tops[-1]] if tops else []

    def drain(self) -> list:
        """:meth:`spans`, and forgets them (the open ones stay open)."""
        with self._lock:
            out = sorted(self._records)
            self._records.clear()
            self.dropped = 0
        return out


@contextlib.contextmanager
def recording(log: SpanLog | None = None):
    """Spans are recorded into ``log`` (a new :class:`SpanLog` by default)
    for the block; yields the log. The spans of every thread go to it."""
    global _active
    log = SpanLog() if log is None else log
    previous, _active = _active, log
    try:
        yield log
    finally:
        _active = previous


def annotate(name: str):
    """The program's span around a named region: ``with annotate("stage.vqt"):``.
    Off (no :func:`recording` block open) it returns one shared null
    context: no allocation, no clock read, no profiler range. On, the span
    is recorded, and enters ``record_function(name)`` while a torch
    profiler is active."""
    log = _active
    if log is None:
        return _NULL
    return _Span(log, name)


def self_ns(spans: list) -> dict:
    """{span index: its duration less the time its children cover} for the
    records ``spans`` (children of one thread do not overlap)."""
    own = {s.index: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def call_times(spans: list) -> dict:
    """{span name: {"ms": summed duration, "self_ms": summed self time,
    "count": spans}} over the records ``spans`` (one call's:
    :meth:`SpanLog.last_call`)."""
    own = self_ns(spans)
    out = {}
    for s in spans:
        entry = out.setdefault(s.name, {"ms": 0.0, "self_ms": 0.0, "count": 0})
        entry["ms"] += (s.end_ns - s.start_ns) / 1e6
        entry["self_ms"] += own[s.index] / 1e6
        entry["count"] += 1
    return out


def debug_report(pipeline, timer: StageTimer | None = None, spans: SpanLog | None = None) -> dict:
    """Pipeline health snapshot (the debug-overlay data of common.rs:148-334
    as a dict): algorithmic delay, kernel structure, stage timings, and the
    torch device the pipeline runs on (its type, and the names of the cards
    when it is CUDA). With ``spans``, the host time of each span of the last
    call it recorded (:func:`call_times`) under ``"spans"``."""
    from ..kernel.builder import kernel_stats

    device = torch.device(pipeline.device)
    if device.type == "cuda":
        devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        devices = [str(device)]
    report = {
        "vqt_delay_ms": round(1000.0 * pipeline.delay_secs, 2),
        "kernel": kernel_stats(pipeline.kernel),
        "n_buckets": pipeline.vqt_params.n_buckets,
        "backend": device.type,
        "devices": devices,
    }
    if timer is not None:
        report["stages"] = timer.report()
    if spans is not None:
        report["spans"] = call_times(spans.last_call())
    return report
