"""Where a capacity cell's hop spends its host time and its launches, span
by span: the program's spans (``pitchvis_tpu_torch.utils.profiling``) set
beside a device trace on the monotonic clock.

    python3 -m benchmark.spans --workload pv_serial.capacity --seed <n> [--calls 40] [--out FILE]

on a CUDA card, from the root of a checkout whose program records spans.
The cell's program, banks and pinned enqueueing thread are those of
``benchmark/capacity.py``. It runs, in one process:

1. the cost of one span off, on, and on under ``torch.profiler``:
   ``with annotate(name): pass`` against an empty loop;
2. ``--calls`` calls with spans off and as many with spans on, in turns,
   one in flight while the next is enqueued: the host's enqueue a hop of
   each, and the host time of every span;
3. two calls with spans on under ``torch.profiler`` (CPU and CUDA), as the
   traced run does. Each span's range is its ``record_function`` range, so
   spans, launches and device events share the profiler's clock. Each
   device event is put down to the innermost span whose range holds its
   launch (the CUDA runtime call with the kernel's correlation id), and
   counted a second way by the profiler's own tree (the operator that
   launched it and its parents). Each stretch with nothing on the device
   goes to the spans, or garbage collections, the host was in meanwhile;
4. ``torch.equal`` of a call's outputs with spans on under the profiler
   against the same call's with spans off, on two pipelines in one state.

The last line of standard output is one JSON object; ``--out`` writes it
with every idle gap too.

This module stands in for the harness's own traced run until that run
records spans: it reaches into ``benchmark/capacity.py``'s private
program. Once ``benchmark/trace.py`` and ``benchmark/capacity.py`` read
spans themselves, its pure functions (:func:`timeline`, :func:`attribute`)
move there and the rest of it goes.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import statistics
import sys
import time

import torch

STAGES = ("stage.ring", "stage.vqt", "stage.analysis", "stage.outputs")
OUTSIDE = "outside the program's spans"
_COPIES = ("Memcpy", "Memset")


def timeline(spans: list, pauses=()) -> list:
    """[(start_s, end_s, span index or None, label)], sorted: one thread's
    host time cut where its innermost open span changes; inside a garbage
    collection (``pauses``: (generation, start_s, seconds)) the label is
    the collection's. Between spans the index is None and the label
    ``OUTSIDE``."""
    events = [(s.start_ns / 1e9, 1, s.index, s.name) for s in spans]
    events += [(s.end_ns / 1e9, 0, s.index, s.name) for s in spans]
    events += [(t, 1, None, f"gc generation {g}") for g, t, _ in pauses]
    events += [(t + d, 0, None, f"gc generation {g}") for g, t, d in pauses]
    events.sort(key=lambda e: (e[0], e[1]))  # an end before a start at one instant
    out, stack, gcs = [], [], []
    prev = None
    for t, starts, index, name in events:
        if prev is not None and t > prev:
            if gcs:
                out.append((prev, t, stack[-1][0] if stack else None, gcs[-1]))
            elif stack:
                out.append((prev, t, stack[-1][0], stack[-1][1]))
        if index is None:
            (gcs.append if starts else gcs.remove)(name)
        elif starts:
            stack.append((index, name))
        else:
            stack.remove((index, name))
        prev = t
    return out


def _at(segments: list, starts: list, t: float):
    """The segment holding instant ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segments[i][0] <= t <= segments[i][1]:
        return segments[i]
    return None


def _stage_of(index, parents: dict, names: dict):
    """The stage span (``STAGES``) at or around span ``index``, or None."""
    while index in names:
        if names[index] in STAGES:
            return names[index]
        index = parents.get(index)
    return None


def attribute(device: list, spans: list, pauses, hops: int, window: tuple) -> dict:
    """Per-span readings of a traced stretch. ``device``: [(start_s, end_s,
    name, launch_s or None, is_kernel)] on the monotonic clock; ``spans``:
    the span records of the stretch; ``window``: (start_s, end_s). Returns
    {"by_span": {label: {launches, host_ms, device_ms, idle_ms} a hop},
    "stages": {stage: launches a hop, children included}, "kernels": all
    kernels a hop, "gaps": [[seconds, label at its end, label holding most
    of it]] longest first}."""
    parents = {s.index: s.parent for s in spans}
    names = {s.index: s.name for s in spans}
    bare = timeline(spans)
    bare_starts = [s[0] for s in bare]
    own = collections.Counter()
    for seg in bare:
        own[seg[3]] += seg[1] - seg[0]
    by = collections.defaultdict(lambda: {"launches": 0.0, "host_ms": 0.0, "device_ms": 0.0, "idle_ms": 0.0})
    stages = collections.Counter()
    kernels = 0
    for a, b, _, launch, is_kernel in device:
        seg = _at(bare, bare_starts, launch) if launch is not None else None
        label = seg[3] if seg else OUTSIDE
        by[label]["device_ms"] += (b - a) * 1e3 / hops
        if is_kernel:
            kernels += 1
            by[label]["launches"] += 1 / hops
            stage = _stage_of(seg[2], parents, names) if seg else None
            stages[stage or OUTSIDE] += 1 / hops
    for label, seconds in own.items():
        by[label]["host_ms"] += seconds * 1e3 / hops
    # stretches with nothing on the device, each split over the host's spans
    host = timeline(spans, pauses)
    host_starts = [s[0] for s in host]
    ops = sorted((a, b) for a, b, *_ in device)
    gaps, busy = [], window[0]
    for a, b in ops + [(window[1], window[1])]:
        a = min(a, window[1])
        if a > busy:
            split = collections.Counter()
            i = max(0, bisect.bisect_right(host_starts, busy) - 1)
            covered = 0.0
            while i < len(host) and host[i][0] < a:
                lo, hi = max(host[i][0], busy), min(host[i][1], a)
                if hi > lo:
                    split[host[i][3]] += hi - lo
                    covered += hi - lo
                i += 1
            split[OUTSIDE] += (a - busy) - covered
            for label, seconds in split.items():
                by[label]["idle_ms"] += seconds * 1e3 / hops
            end = _at(host, host_starts, a)
            gaps.append([a - busy, end[3] if end else OUTSIDE, split.most_common(1)[0][0]])
        busy = max(busy, b)
    gaps.sort(reverse=True)
    for entry in by.values():
        entry["us_per_launch"] = entry["host_ms"] * 1e3 / entry["launches"] if entry["launches"] else None
    return {"by_span": dict(by), "stages": dict(stages), "kernels": kernels / hops, "gaps": gaps}


def stage_host_ms(spans: list) -> dict:
    """{stage: the median over hops of its span's duration, ms}."""
    return {name: statistics.median([(s.end_ns - s.start_ns) / 1e6 for s in spans if s.name == name])
            for name in STAGES if any(s.name == name for s in spans)}


def self_ms_per_hop(spans: list, hops: int) -> dict:
    """{span name: its summed self time over ``hops`` hops, ms a hop}."""
    from pitchvis_tpu_torch.utils.profiling import self_ns

    own = self_ns(spans)
    out = collections.Counter()
    for s in spans:
        out[s.name] += own[s.index] / 1e6 / hops
    return dict(out)


def _host_events(events) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events if e.device_type != cuda]


def on_profiler_clock(events, spans: list) -> tuple[list, float] | None:
    """``spans`` (records of the profiled calls) with each range replaced
    by its ``record_function`` range in the profiler's ``events`` (the
    k-th range of a name is the k-th span of that name), shifted by the
    median offset between the two clocks, so that launches, device events
    and spans share the profiler's clock; and that offset (seconds, added
    to a profiler time to give a monotonic one). None if the ranges and
    the spans do not pair up."""
    names = {s.name for s in spans}
    ranges = collections.defaultdict(list)
    for e in _host_events(events):
        if e.name in names:
            ranges[e.name].append(e)
    mine = collections.defaultdict(list)
    for s in spans:
        mine[s.name].append(s)
    if any(len(ranges[n]) != len(mine[n]) for n in names):
        return None
    pairs = []
    for n in names:
        pairs += zip(sorted(mine[n], key=lambda s: s.start_ns), sorted(ranges[n], key=lambda e: e.time_range.start))
    offset = statistics.median(s.start_ns / 1e9 - e.time_range.start / 1e6 for s, e in pairs)
    moved = [s._replace(start_ns=round((e.time_range.start / 1e6 + offset) * 1e9),
                        end_ns=round((e.time_range.end / 1e6 + offset) * 1e9)) for s, e in pairs]
    return sorted(moved, key=lambda s: s.index), offset


def device_events(events, offset: float, span_names: set, found: collections.Counter) -> tuple[list, int]:
    """([(start_s, end_s, name, launch_s or None, is_kernel)], user
    annotations the profiler put on the device) of a finished profile's
    ``events``, on the monotonic clock (``offset`` added). A kernel's
    launch is the CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernel``)
    that carries its correlation id; ``found`` counts the events whose
    call was found and those whose was not."""
    cuda = torch.autograd.DeviceType.CUDA
    # the CUDA API calls (names begin with "cu"); their id is the correlation id
    runtime = {e.id: e for e in _host_events(events) if e.name.startswith("cu")}
    out, annotations = [], 0
    for e in events:
        if e.device_type != cuda:
            continue
        if getattr(e, "is_user_annotation", False) or e.name in span_names:
            annotations += 1
            continue
        launch = runtime.get(e.id)
        found["runtime call" if launch is not None else "none"] += 1
        out.append((e.time_range.start / 1e6 + offset, e.time_range.end / 1e6 + offset, e.name,
                    launch.time_range.start / 1e6 + offset if launch is not None else None,
                    not e.name.startswith(_COPIES)))
    return out, annotations


def kernels_by_owner(events, span_names: set, hops: int) -> dict:
    """Kernels a hop by the innermost span around the operator that
    launched them, read from the profiler's own tree (each host event's
    ``kernels``, its ``cpu_parent`` chain): no clock is read."""
    out = collections.Counter()
    for e in _host_events(events):
        launched = [k for k in e.kernels if not k.name.startswith(_COPIES)]
        if not launched:
            continue
        owner = e
        while owner is not None and owner.name not in span_names:
            owner = owner.cpu_parent
        out[owner.name if owner is not None else OUTSIDE] += len(launched) / hops
    return dict(out)


def span_cost_ns(n: int = 200_000, on: bool = False, profiled: bool = False) -> float:
    """Nanoseconds of one ``with annotate(name): pass`` over an empty
    loop's: spans off, on, or on under ``torch.profiler`` (CPU and the
    card's activity)."""
    from torch.profiler import ProfilerActivity, profile

    from pitchvis_tpu_torch.utils.profiling import SpanLog, annotate, recording

    best = float("inf")
    for _ in range(5 if not profiled else 1):
        with contextlib.ExitStack() as stack:
            if on or profiled:
                stack.enter_context(recording(SpanLog(1024)))
            if profiled:
                activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
                stack.enter_context(profile(activities=activities))
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with annotate("stage.vqt"):
                    pass
            t1 = time.perf_counter_ns()
        for _ in range(n):
            pass
        t2 = time.perf_counter_ns()
        best = min(best, ((t1 - t0) - (t2 - t1)) / n)
    return best


def run(workload: str, seed: int, calls: int, device="cuda", traffic=None, cost_n: int = 200_000) -> dict:
    """The readings of the module's docstring; ``traffic`` overrides keys
    of the cell's traffic mix, ``cost_n`` sets the spans of step 1's loops
    (the CPU tests' small sizes)."""
    from pitchvis_tpu_torch.utils.profiling import SpanLog, recording
    from torch.profiler import ProfilerActivity, profile

    from . import audio
    from .capacity import _finite_count, _Program, _sync
    from .judge import flatten
    from .live import program_params
    from .run import GcPauses
    from .spec import load_cell

    cell = load_cell(workload)
    cfg, tr = cell.config, {**cell.traffic, **(traffic or {})}
    params = program_params(cfg)
    sr, fps = params.sr, float(cfg["fps"])
    hop = int(sr / fps)
    n_streams, hops, n_banks = int(tr["streams"]), int(tr["hops_per_call"]), int(tr["banks"])
    device = torch.device(device)
    fast = bool(cfg["fast"])
    music = audio.make_music(seed, n_streams, hops * n_banks, hop, sr, tr["music"], cfg["vqt"], device)
    prog = _Program(cfg, params, n_streams, device, fast, music, hops, hop, n_banks)
    twin = _Program(cfg, params, n_streams, device, fast, music, hops, hop, n_banks)
    del music.tracks
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])

    # 4. a call with spans on under the profiler against the same call with
    # spans off, from one state (the first call of two fresh pipelines)
    want = flatten(prog(0))
    with recording(), profile(activities=activities):
        got = flatten(twin(0))
    _sync(device)
    equal = want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    del twin, want, got

    cores = os.sched_getaffinity(0)
    if device.type == "cuda":
        os.sched_setaffinity(0, {max(cores)})
    cost_ns = {"off": span_cost_ns(cost_n), "on": span_cost_ns(cost_n, on=True),
               "profiled": span_cost_ns(cost_n // 10, profiled=True)}
    log = SpanLog()
    pauses = GcPauses()
    enqueue = {"off": [], "on": [], "profiled": []}
    bad = torch.zeros((), dtype=torch.int64, device=device)
    pending = []
    traced = None
    plan = ["off", "on"] * calls + ["profiled", "profiled", "off", "off"]
    try:
        for i, mode in enumerate(plan):
            if mode == "profiled" and traced is None:
                unprofiled = log.drain()
                prof = profile(activities=activities)
                prof.__enter__()
                traced = (time.monotonic(), None)
            t_in = time.monotonic()
            if mode == "off":
                o = prog((i + 1) % n_banks)
            else:
                with recording(log):
                    o = prog((i + 1) % n_banks)
            enqueue[mode].append((time.monotonic() - t_in) / hops)
            bad = bad + _finite_count(o)
            marks = prog.mark()
            for e in pending:
                e.synchronize()
            pending = marks
            if mode == "profiled" and plan[i + 1] != "profiled":
                _sync(device)
                traced = (traced[0], time.monotonic())
                prof.__exit__(None, None, None)
                profiled = log.drain()
        _sync(device)
    finally:
        pauses.close()
        os.sched_setaffinity(0, cores)

    span_names = {s.name for s in unprofiled}
    n_traced = 2 * hops
    events = prof.events()
    paired = on_profiler_clock(events, profiled)
    if paired is None:
        raise RuntimeError("the profiler's ranges do not pair up with the recorded spans")
    profiled, offset = paired
    found = collections.Counter()
    device_list, annotations = device_events(events, offset, span_names, found)
    device_list = [d for d in device_list if d[0] < traced[1]]
    reading = attribute(device_list, profiled, pauses.pauses, n_traced, traced)
    by_owner = kernels_by_owner(events, span_names, n_traced)
    n_on = calls * hops
    per_hop = {m: statistics.median(v) * 1e3 for m, v in enqueue.items() if v}
    spans_per_hop = len(unprofiled) / n_on
    host_self = self_ms_per_hop(unprofiled, n_on)
    for label, entry in reading["by_span"].items():  # host ms a hop from the unprofiled calls
        entry["host_ms_profiled"] = entry.pop("host_ms")
        entry["host_ms"] = host = host_self.get(label)
        entry["us_per_launch"] = host * 1e3 / entry["launches"] if entry["launches"] and host else None
    return {
        "workload": workload, "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "calls_each": calls, "hops_per_call": hops, "streams": n_streams,
        "enqueue_ms_per_hop": per_hop,
        "on_cost_pct": 100.0 * (per_hop["on"] / per_hop["off"] - 1.0),
        "profiled_cost_pct": 100.0 * (per_hop["profiled"] / per_hop["off"] - 1.0),
        "ns_per_span": cost_ns, "spans_per_hop": spans_per_hop,
        "span_cost_pct": {k: 100.0 * v * spans_per_hop / 1e6 / per_hop["off"] for k, v in cost_ns.items()},
        "stage_host_ms_per_hop": stage_host_ms(unprofiled),
        "stage_launches_per_hop": reading["stages"],
        "kernels_per_hop": reading["kernels"],
        "kernels_by_owner": by_owner,
        "clock_offset_s": offset,
        "device_user_annotations": annotations,
        "launch_found_by": dict(found),
        "by_span": reading["by_span"],
        "gaps": reading["gaps"][:10],
        "all_gaps": reading["gaps"],
        "gc_in_profiled": [p for p in pauses.pauses if traced[0] <= p[1] < traced[1]],
        "traced_equal_untraced": bool(equal),
        "not_finite": int(bad),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.spans", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="pv_serial.capacity")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--calls", type=int, default=40)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    from .run import cache_dirs

    cache_dirs()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("benchmark.spans: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = run(args.workload, args.seed, args.calls, args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1, default=float)
    line.pop("all_gaps")
    print(json.dumps(line, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
