"""The program's spans (utils/profiling.py: annotate, recording, SpanLog)
on the CPU: off they cost a shared null context and record nothing; on,
a StreamingPipeline call records one span a stage a hop with the right
parents and call, on the monotonic clock a torch profiler's ranges are put
on; the server's hop records the same stage spans under one call; outputs
do not change; threads nest apart; the log keeps the newest records."""

import dataclasses
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pitchvis_tpu_torch import StreamingPipeline
from pitchvis_tpu_torch.runtime.server import StreamServer
from pitchvis_tpu_torch.utils import profiling

from conftest import SMALL_PARAMS
from torch_port_helpers import streams, to_port

B = 2
K = 3
HOP = 367
DT = HOP / SMALL_PARAMS.sr
STAGES = ("stage.ring", "stage.vqt", "stage.analysis", "stage.outputs")
ANALYSIS = ("analysis.smooth", "analysis.peaks", "analysis.core")


def _pipe():
    return StreamingPipeline(B, to_port(SMALL_PARAMS), path="pallas", with_led=True, device="cpu")


def _chunks(seed=0):
    """(K, B, HOP) seeded chunks."""
    sig = streams(B, K * HOP, SMALL_PARAMS.sr, seed=seed)
    return sig.reshape(B, K, HOP).transpose(1, 0, 2).copy()


def _leaves(tree, prefix=""):
    """{dotted name: tensor} of an outputs dataclass (None leaves left out)."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for f in dataclasses.fields(tree):
        out.update(_leaves(getattr(tree, f.name), f"{prefix}.{f.name}" if prefix else f.name))
    return out


def test_off_returns_one_shared_null_context_and_records_nothing():
    assert profiling.annotate("stage.vqt") is profiling.annotate("stage.ring")
    log = profiling.SpanLog(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _pipe().step_multi(_chunks(), DT)
    assert log.spans() == [] and log.dropped == 0
    names = {"pipeline.call", "pipeline.hop", "pipeline.stack", *STAGES, *ANALYSIS}
    assert not names & {e.name for e in prof.events()}  # no profiler range either


def test_step_multi_records_each_stage_of_each_hop():
    pipe = _pipe()
    chunks = _chunks()
    with profiling.recording() as log:
        t0 = time.monotonic_ns()
        pipe.step_multi(chunks, DT)
        t1 = time.monotonic_ns()
    spans = log.spans()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert {n: len(v) for n, v in by.items()} == {
        "pipeline.call": 1, "pipeline.hop": K, "pipeline.stack": 1,
        **{n: K for n in STAGES}, **{n: K for n in ANALYSIS},
    }
    index = {s.index: s for s in spans}
    (call,) = by["pipeline.call"]
    hops = by["pipeline.hop"]  # in the order they began: hop i is the i-th
    assert call.parent == -1 and all(h.parent == call.index for h in hops)
    assert [h.start_ns for h in hops] == sorted(h.start_ns for h in hops)
    assert by["pipeline.stack"][0].parent == call.index and by["pipeline.stack"][0].start_ns > hops[-1].end_ns
    for name in STAGES:
        assert [s.parent for s in by[name]] == [h.index for h in hops]
    for name in ANALYSIS:
        assert [index[s.parent].name for s in by[name]] == ["stage.analysis"] * K
        assert [index[index[s.parent].parent].index for s in by[name]] == [h.index for h in hops]
    assert {s.call for s in spans} == {call.call}
    for s in spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1
        parent = index.get(s.parent)
        if parent is not None:
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    # self time: a call's duration less what its children cover
    own = profiling.self_ns(spans)
    children = sum(s.end_ns - s.start_ns for s in spans if s.parent == call.index)
    assert own[call.index] == call.end_ns - call.start_ns - children >= 0


def test_a_second_call_gets_the_next_call_number():
    pipe = _pipe()
    with profiling.recording() as log:
        pipe.step(_chunks()[0], DT)
        pipe.step(_chunks(seed=1)[0], DT)
    spans = log.spans()
    calls = [s for s in spans if s.name == "pipeline.call"]
    assert [c.call for c in calls] == [0, 1]
    assert sorted(s.call for s in spans if s.name == "stage.vqt") == [0, 1]
    last = log.last_call()
    assert [s.index for s in last] == [s.index for s in spans if s.call == 1]
    times = profiling.call_times(last)
    assert times["pipeline.hop"]["count"] == 1 and set(times) == {"pipeline.call", "pipeline.hop", *STAGES, *ANALYSIS}
    assert times["stage.analysis"]["self_ms"] <= times["stage.analysis"]["ms"]
    report = profiling.debug_report(pipe, spans=log)
    assert report["spans"] == times


def test_server_step_records_the_shared_stage_spans():
    server = StreamServer(B, to_port(SMALL_PARAMS), buffer_seconds=1.0, with_led=True, device="cpu")
    hop = int(SMALL_PARAMS.sr / 60.0)
    server.push_batch(streams(B, 4 * hop, SMALL_PARAMS.sr, seed=2))
    with profiling.recording() as log:
        server.step()
    names = [s.name for s in log.spans()]
    for name in ("server.hop", "stage.vqt", "stage.analysis", "stage.outputs", *ANALYSIS):
        assert names.count(name) == 1, names
    # the hop's spans share one call: the last call's stage times are the hop's
    times = profiling.call_times(log.last_call())
    assert set(times) == {"server.hop", "stage.vqt", "stage.analysis", "stage.outputs", *ANALYSIS}
    assert times["server.hop"]["ms"] >= sum(times[n]["ms"] for n in ("stage.vqt", "stage.analysis", "stage.outputs"))


def test_outputs_are_the_same_with_spans_on_and_off():
    chunks = _chunks(seed=3)
    off = _pipe().step_multi(chunks, DT)
    with profiling.recording() as log, profile(activities=[ProfilerActivity.CPU]):
        on = _pipe().step_multi(chunks, DT)
    assert log.spans()
    a, b = _leaves(off), _leaves(on)
    assert a.keys() == b.keys() and "led" in a
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_profiler_ranges_match_the_spans_on_the_monotonic_clock():
    pipe = _pipe()
    with profiling.recording() as log, profile(activities=[ProfilerActivity.CPU]) as prof:
        mark = time.monotonic_ns()
        with torch.profiler.record_function("clock_mark"):
            pass
        pipe.step_multi(_chunks(), DT)
    events = prof.events()
    (m,) = [e for e in events if e.name == "clock_mark"]
    offset_us = mark / 1e3 - m.time_range.start  # profiler microseconds -> monotonic
    spans = log.spans()
    ranges = {}
    for e in events:
        if e.is_user_annotation and e.name != "clock_mark":
            ranges.setdefault(e.name, []).append(e.time_range.start + offset_us)
    assert {n: len(v) for n, v in ranges.items()} == {
        n: sum(s.name == n for s in spans) for n in {s.name for s in spans}
    }
    for name, starts in ranges.items():
        mine = sorted(s.start_ns / 1e3 for s in spans if s.name == name)
        for got, want in zip(sorted(starts), mine):
            assert abs(got - want) < 1e3, (name, got - want)  # within 1 ms


def test_spans_of_another_thread_do_not_nest_under_an_open_span():
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait(10)
        with profiling.annotate("worker.outer"):
            with profiling.annotate("worker.inner"):
                pass
        done.set()

    with profiling.recording() as log:
        worker = threading.Thread(target=other)
        worker.start()
        with profiling.annotate("main.outer"):
            opened.set()
            assert done.wait(10)
        worker.join(10)
    assert not worker.is_alive()
    by = {s.name: s for s in log.spans()}
    assert by["main.outer"].parent == -1 and by["worker.outer"].parent == -1
    assert by["worker.inner"].parent == by["worker.outer"].index
    assert by["worker.outer"].call != by["main.outer"].call
    assert by["worker.inner"].call == by["worker.outer"].call


def test_many_threads_record_every_span_once():
    threads, each = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording(profiling.SpanLog(threads * each * 2)) as log:
            start = threading.Barrier(threads)
            workers = [threading.Thread(target=_nested_spans, args=(each, start)) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    spans = log.spans()
    assert sorted(s.index for s in spans) == list(range(threads * each * 2)) and log.dropped == 0
    index = {s.index: s for s in spans}
    for s in spans:
        if s.name == "inner":
            outer = index[s.parent]
            assert outer.name == "outer" and outer.call == s.call
    assert len({s.call for s in spans}) == threads * each


def test_many_threads_past_the_bound_count_every_dropped_span():
    threads, each, capacity = 16, 300, 1000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording(profiling.SpanLog(capacity)) as log:
            start = threading.Barrier(threads)
            workers = [threading.Thread(target=_nested_spans, args=(each, start)) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    spans = log.spans()
    assert len(spans) == capacity and log.dropped == threads * each * 2 - capacity
    assert len({s.index for s in spans}) == capacity


def _nested_spans(n, start):
    start.wait(30)
    for i in range(n):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                pass


def test_the_ring_keeps_the_newest_records_and_counts_the_dropped():
    with profiling.recording(profiling.SpanLog(8)) as log:
        for i in range(20):
            with profiling.annotate(f"s{i}"):
                pass
        with profiling.annotate("open"):
            assert [s.name for s in log.spans()] == [f"s{i}" for i in range(12, 20)] and log.dropped == 12
    assert [s.name for s in log.spans()] == [f"s{i}" for i in range(13, 20)] + ["open"]
    assert [s.index for s in log.spans()] == list(range(13, 21)) and log.dropped == 13
    assert len(log.drain()) == 8 and log.spans() == [] and log.dropped == 0
    with profiling.recording(log):
        with profiling.annotate("again"):
            pass
    assert [s.name for s in log.spans()] == ["again"]
    with pytest.raises(ValueError, match="capacity"):
        profiling.SpanLog(0)


def test_recording_restores_what_was_on_before():
    outer, inner = profiling.SpanLog(4), profiling.SpanLog(4)
    with profiling.recording(outer):
        with profiling.recording(inner):
            with profiling.annotate("in"):
                pass
        with profiling.annotate("out"):
            pass
    assert [s.name for s in inner.spans()] == ["in"] and [s.name for s in outer.spans()] == ["out"]
    assert profiling.annotate("after") is profiling.annotate("after")


def test_trace_records_the_spans_as_ranges(tmp_path):
    pipe = _pipe()
    with profiling.trace(str(tmp_path)) as prof:
        pipe.step(_chunks()[0], DT)
    names = {e.key for e in prof.key_averages()}
    assert {"pipeline.call", "pipeline.hop", *STAGES, *ANALYSIS} <= names
    text = (tmp_path / "trace.json").read_text()
    assert '"stage.analysis"' in text and '"analysis.peaks"' in text


def test_default_capacity_holds_a_traced_window():
    # some 130 spans a call of 16 hops, up to some 450 calls in a 45-s window
    assert profiling.SPAN_CAPACITY >= 450 * (16 * 8 + 2)
    assert profiling.SpanLog().capacity == profiling.SPAN_CAPACITY
