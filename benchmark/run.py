"""One run of one cell of the benchmark of ``pitchvis_tpu_torch``.

    python3 -m benchmark --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic, limits and
per-layer readers are found by name (benchmark/spec.py); the traffic's
``kind`` picks the runner (benchmark/live.py, benchmark/capacity.py). With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled part of the
window. The last line of standard output is the result; the last lines of
standard error are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from .spec import ROOT, load_cell, metric_reader

# top-level module names that no run may load: JAX and the JAX package
# (the port's own name begins with the JAX package's, so names are
# compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "pitchvis_tpu")


def cache_dirs(root=ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build", "benchmark")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "nv_compute_cache")


def process_start() -> float:
    """The process's start on the monotonic clock (from /proc/self/stat)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class GcPauses:
    """The interpreter's garbage collections while it is installed: a
    collection of the oldest generation scans every object of the process
    and holds the interpreter meanwhile."""

    def __init__(self):
        self.pauses = []  # (generation, start, seconds)
        self._t = None
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.monotonic()
        elif self._t is not None:
            self.pauses.append((info["generation"], self._t, time.monotonic() - self._t))

    def close(self):
        gc.callbacks.remove(self._callback)

    def summary(self, start: float, end: float) -> str:
        inside = [p for p in self.pauses if start <= p[1] < end]
        by = {g: [s for gen, _, s in inside if gen == g] for g in (0, 1, 2)}
        return ", ".join(f"generation {g}: {len(v)} taking {sum(v) * 1e3:.1f} ms (longest {max(v, default=0) * 1e3:.1f})"
                         for g, v in by.items())


def _cpu_seconds() -> tuple[float, float]:
    """(all, stolen) CPU seconds of the host since boot (/proc/stat): steal
    is the time the hypervisor ran something else on this machine's cores."""
    with open("/proc/stat") as f:
        ticks = [int(x) for x in f.readline().split()[1:9]]
    hz = os.sysconf("SC_CLK_TCK")
    return sum(ticks) / hz, ticks[7] / hz


def _core_mhz() -> float | None:
    """The mean clock of the cores as /proc/cpuinfo reports it."""
    with open("/proc/cpuinfo") as f:
        mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
    return sum(mhz) / len(mhz) if mhz else None


def _probe_ms() -> float:
    """Milliseconds of a fixed piece of interpreter work: the speed of this
    process's host thread, to set beside a host-bound rate."""
    t = time.perf_counter()
    s = 0
    for i in range(300_000):
        s += i * i
    return (time.perf_counter() - t) * 1e3


class Result:
    """What a runner fills: end-to-end values, host spans and counters for
    the per-layer readers, the trace, the comparison's readings."""

    def __init__(self, device):
        self.device = device
        self.e2e, self.spans, self.counters, self.shapes, self.readings = {}, {}, {}, {}, {}
        self.trace = None
        self.host_spans, self.idle_label = [], "host"
        self.attempted = self.failed = 0
        self.peak_bytes = 0
        self.window_start = None
        self.host = {}  # the host's state around the window (stderr only)
        self._host_open = None

    def host_probe(self) -> None:
        """In set-up: the speed of the host thread."""
        self.host["probe_ms"] = _probe_ms()
        self.host["cores"] = len(os.sched_getaffinity(0))

    def host_open(self) -> None:
        """At the window's start."""
        try:
            self._host_open = (_cpu_seconds(), _core_mhz())
        except (OSError, ValueError, IndexError):
            self._host_open = None

    def host_close(self) -> None:
        """At the window's end: the share of the host's CPU time stolen by
        the hypervisor, and the cores' clock at the start and the end."""
        if self._host_open is None:
            return
        try:
            (all1, steal1), mhz1 = _cpu_seconds(), _core_mhz()
        except (OSError, ValueError, IndexError):
            return
        (all0, steal0), mhz0 = self._host_open
        self.host.update(steal_pct=100.0 * (steal1 - steal0) / max(all1 - all0, 1e-9), mhz_open=mhz0, mhz_close=mhz1)

    def note(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def memory_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)

    def free_device(self) -> None:
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", fast=None,
             traffic=None, started=None, compare=True, record=None, root=ROOT) -> dict:
    """One run; returns the result line's object. ``traffic`` overrides
    keys of the traffic mix (the CPU tests' small sizes, the knee sweep's
    stream counts); ``fast`` the configuration's precision (the control);
    ``compare=False`` leaves out the comparison (the sweep); ``record``, a
    list, receives the run's Result; ``root`` is the checkout whose
    BENCHMARK.json and benchmark/ files define the cell."""
    import torch

    from . import capacity, judge, live

    started = process_start() if started is None else started
    cell = load_cell(workload, root)
    if traffic:
        cell.traffic = {**cell.traffic, **traffic}
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    runner = {"live": live.run, "capacity": capacity.run}[cell.traffic["kind"]]
    result = Result(device)
    fast = bool(cell.config["fast"]) if fast is None else fast
    pauses = GcPauses()
    try:
        runner(cell, seed, seconds, trace, device, fast, result, compare)
    finally:
        pauses.close()
    result.note(f"host: {result.host}")
    result.note(f"garbage collections in the window: {pauses.summary(result.window_start, result.window_start + seconds)}")
    if record is not None:
        record.append(result)
    setup_s = result.window_start - started

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else result.e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = metric_reader(m["name"], root)(result)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checks = judge.decide(result.readings, cell.limits)
    if compare:
        result.note(f"comparison: {result.readings.get('compared')}")
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": int(result.peak_bytes)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    line = {"correct": bool(correct), "attempted": int(result.attempted), "failed": int(result.failed),
            "metrics": metrics, "device": dev}
    if trace and result.trace is not None:
        result.note(f"trace: {result.trace.window_s:.3f} s, {len(result.trace.events)} device operations")
    if trace and result.trace is not None:
        dev["busy_s"] = result.trace.busy_s()
        dev["window_s"] = result.trace.window_s
        line["breakdown"] = {
            "device_ops": result.trace.top_ops(),
            "idle_gaps": result.trace.idle_gaps(result.host_spans, result.idle_label),
        }
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = process_start()
    cache_dirs()
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
