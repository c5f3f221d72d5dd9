"""The device side of a traced window, from torch.profiler.

The profiler runs in the thread that opens it and records the device's
kernels, copies and fills of every thread (CUPTI). Their times are put on
the host's monotonic clock by a marker span recorded at a known instant,
so the idle gaps can be named after the host span that was running when
the device went idle. Spans are ``(start, end, label)`` in monotonic
seconds, recorded by the harness's own wrappers around the calls into the
program.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

_COPY_PREFIXES = ("Memcpy", "Memset")


@dataclasses.dataclass
class DeviceTrace:
    start: float  # monotonic seconds
    end: float
    events: list  # (device index, name, start, end), monotonic seconds
    devices: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self) -> list:
        return [e for e in self.events if not e[1].startswith(_COPY_PREFIXES)]

    def kernel_time(self, part: str) -> tuple[int, float]:
        """(launches, summed device seconds) of the kernels whose name
        contains ``part``."""
        hits = [e for e in self.kernels() if part in e[1]]
        return len(hits), sum(e[3] - e[2] for e in hits)

    def busy_s(self) -> float:
        """Seconds with an operation on the device, averaged over the
        devices the run uses (a union of intervals per device, clipped to
        the window)."""
        per = collections.defaultdict(list)
        for dev, _, a, b in self.events:
            a, b = max(a, self.start), min(b, self.end)
            if b > a:
                per[dev].append((a, b))
        total = 0.0
        for spans in per.values():
            spans.sort()
            cur_a, cur_b = spans[0]
            for a, b in spans[1:]:
                if a > cur_b:
                    total += cur_b - cur_a
                    cur_a, cur_b = a, b
                else:
                    cur_b = max(cur_b, b)
            total += cur_b - cur_a
        return total / self.devices

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        by = collections.Counter()
        for _, name, a, b in self.events:
            by[short(name)] += b - a
        return [[name, s] for name, s in by.most_common(n)]

    def idle_gaps(self, spans: list, idle_label: str, n: int = 10) -> list:
        """The longest gaps with nothing on the device (on the device the
        host feeds first), each named by the host span running when the
        gap ended and the operation that ended it: [[name, seconds]]."""
        first = min(e[0] for e in self.events) if self.events else 0
        ops = sorted((a, b, name) for dev, name, a, b in self.events if dev == first)
        gaps = []
        busy_until = self.start
        for a, b, name in ops:
            if a > busy_until:
                label = idle_label
                for s0, s1, what in spans:
                    if s0 <= a <= s1:
                        label = what  # the innermost span recorded last wins
                gaps.append((a - busy_until, f"{label}, then {short(name)}"))
            busy_until = max(busy_until, b)
        gaps.sort(reverse=True)
        return [[name, s] for s, name in gaps[:n]]


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 96 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:96]


class Profiler:
    """``with Profiler(devices) as p: ...`` traces the block; ``p.trace``
    is then a :class:`DeviceTrace`. A window in which the profiler saw no
    device event leaves ``p.trace`` with no events (the caller may trace
    another)."""

    def __init__(self, devices: int, until: float | None = None):
        self.devices = devices
        self.until = until  # the trace ends here if the profiler stops later
        self.trace = None

    @staticmethod
    def warm() -> None:
        """Starts and stops the profiler once on a tiny op, so that the
        tracing library's own set-up (a second or two) falls into the run's
        set-up and not into its window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = time.monotonic()
        with torch.profiler.record_function("benchmark_clock_mark"):
            pass
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc):
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        end = time.monotonic() if self.until is None else min(time.monotonic(), self.until)
        self._prof.__exit__(*exc)
        events = self._prof.events()
        mark = next(e for e in events if e.name == "benchmark_clock_mark")
        offset = self._mark - mark.time_range.start / 1e6
        device = [
            (e.device_index, e.name, e.time_range.start / 1e6 + offset, e.time_range.end / 1e6 + offset)
            for e in events if e.device_type == torch.autograd.DeviceType.CUDA
        ]
        device = [e for e in device if e[2] < end]
        self.trace = DeviceTrace(self._start, end, device, self.devices)
        return False
