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
  a Chrome trace (viewable in Perfetto or chrome://tracing);
* `annotate()` — ``torch.profiler.record_function`` for named regions.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict

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
    (its ``key_averages()`` sum the ops by name). ``activities`` defaults to
    the CPU and, when torch sees a card, CUDA."""
    from torch.profiler import ProfilerActivity, profile

    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, filename))


def annotate(name: str):
    """Named trace region for the profiler timeline."""
    return torch.profiler.record_function(name)


def debug_report(pipeline, timer: StageTimer | None = None) -> dict:
    """Pipeline health snapshot (the debug-overlay data of common.rs:148-334
    as a dict): algorithmic delay, kernel structure, stage timings, and the
    torch device the pipeline runs on (its type, and the names of the cards
    when it is CUDA)."""
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
    return report
