"""benchmark/spans.py: the host timeline of a span log, the attribution of
device events to the innermost span around their launch and of idle
stretches to the spans the host was in, on hand-made records; and one run
of the tool at a tiny size on the CPU."""

import pytest

from benchmark import spans as tool
from benchmark.tests.conftest import tiny_traffic
from pitchvis_tpu_torch.utils.profiling import SpanRecord

MS = 1_000_000  # ns


def _span(index, name, parent, start_ms, end_ms):
    return SpanRecord(index, name, parent, 0, start_ms * MS, end_ms * MS)


# one call of two hops: call [0, 20] ms; hop h at [1 + 9h, 9 + 9h] with the
# ring [+0, +1], the VQT [+1, +2], the analysis [+2, +6] (its peaks [+3,
# +5]) and the outputs [+6, +8]; the stack [19, 20]. Hop 0: ring [1, 2],
# VQT [2, 3], analysis [3, 7], peaks [4, 6], outputs [7, 9].
SPANS = [_span(0, "pipeline.call", -1, 0, 20)]
for h in range(2):
    base, first = 1 + 9 * h, 1 + 7 * h
    SPANS += [
        _span(first, "pipeline.hop", 0, base, base + 8),
        _span(first + 1, "stage.ring", first, base, base + 1),
        _span(first + 2, "stage.vqt", first, base + 1, base + 2),
        _span(first + 3, "stage.analysis", first, base + 2, base + 6),
        _span(first + 4, "analysis.peaks", first + 3, base + 3, base + 5),
        _span(first + 5, "stage.outputs", first, base + 6, base + 8),
    ]
SPANS.append(_span(15, "pipeline.stack", 0, 19, 20))


def _kernel(launch_ms, run_ms, dur_ms=0.1, name="k"):
    return (run_ms / 1e3, (run_ms + dur_ms) / 1e3, name, launch_ms / 1e3, True)


def test_timeline_gives_the_innermost_span_and_gc_pauses():
    segs = tool.timeline(SPANS, pauses=[(2, 4.2 / 1e3, 0.5 / 1e3)])
    at = {round(a * 1e3, 3): label for a, _, _, label in segs}
    assert at[0.0] == "pipeline.call" and at[1.0] == "stage.ring" and at[4.0] == "analysis.peaks"
    assert at[4.2] == "gc generation 2" and at[4.7] == "analysis.peaks" and at[6.0] == "stage.analysis"
    assert at[9.0] == "pipeline.call" and at[19.0] == "pipeline.stack"
    assert sum(b - a for a, b, _, _ in segs) == pytest.approx(20e-3)


def test_attribute_counts_launches_host_and_idle_by_span():
    device = [
        _kernel(1.5, 1.6),  # hop 0's ring
        _kernel(2.5, 2.6), _kernel(2.6, 2.7),  # its VQT
        _kernel(3.5, 3.6, name="Memcpy DtoH"),  # a copy in the analysis: not a launch
        _kernel(4.5, 4.6),  # the peaks
        _kernel(7.5, 7.6),  # the outputs
        _kernel(10.5, 10.6),  # hop 1's ring
        _kernel(19.5, 19.6),  # the stack
        _kernel(20.5, 20.6),  # between calls: outside the spans
    ]
    device[3] = device[3][:4] + (False,)
    r = tool.attribute(device, SPANS, [(0, 8.0 / 1e3, 1.0 / 1e3)], hops=2, window=(0.0, 21e-3))
    by = r["by_span"]
    assert by["stage.ring"]["launches"] == 1.0 and by["stage.vqt"]["launches"] == 1.0
    assert by["analysis.peaks"]["launches"] == 0.5 and by["stage.outputs"]["launches"] == 0.5
    assert by["pipeline.stack"]["launches"] == 0.5 and by[tool.OUTSIDE]["launches"] == 0.5
    assert "stage.analysis" not in by or by["stage.analysis"]["launches"] == 0
    # children included, and every kernel counted once
    assert r["stages"] == pytest.approx({"stage.ring": 1.0, "stage.vqt": 1.0, "stage.analysis": 0.5,
                                         "stage.outputs": 0.5, tool.OUTSIDE: 1.0})
    assert sum(r["stages"].values()) == pytest.approx(r["kernels"]) and r["kernels"] == 4.0
    # host ms a hop of each span's own time: the peaks 2 ms of each hop
    assert by["analysis.peaks"]["host_ms"] == pytest.approx(2.0)
    assert by["stage.analysis"]["host_ms"] == pytest.approx(2.0)
    assert by["pipeline.call"]["host_ms"] == pytest.approx(3.0 / 2)
    assert by["stage.ring"]["us_per_launch"] == pytest.approx(1000.0)
    # the longest idle stretch: from 10.6 to 19.5 ms, hop 1's stages, named
    # by the stack that ends it and by the analysis that holds most of it
    longest = r["gaps"][0]
    assert longest == [pytest.approx(8.9e-3), "pipeline.stack", "stage.analysis"]
    # every idle millisecond goes to one label; the collection at 8-9 ms
    # holds 1 ms of the stretch from 7.6 to 10.5 ms
    idle = sum(e["idle_ms"] for e in by.values()) * 2
    busy = 9 * 0.1
    assert idle == pytest.approx(21.0 - busy)
    assert by["gc generation 0"]["idle_ms"] == pytest.approx(1.0 / 2)


def test_stage_host_ms_is_the_median_over_hops():
    assert tool.stage_host_ms(SPANS) == pytest.approx(
        {"stage.ring": 1.0, "stage.vqt": 1.0, "stage.analysis": 4.0, "stage.outputs": 2.0})
    assert tool.self_ms_per_hop(SPANS, 2)["stage.analysis"] == pytest.approx(2.0)


def test_the_tool_runs_on_the_cpu():
    line = tool.run("pv_serial.capacity", 2**33 + 7, calls=2, device="cpu", traffic=tiny_traffic("pv_serial.capacity", hops=2),
                    cost_n=2_000)
    assert line["traced_equal_untraced"] and line["not_finite"] == 0
    assert set(line["stage_host_ms_per_hop"]) == set(tool.STAGES)
    assert line["spans_per_hop"] == pytest.approx(8 + 2 / 2)  # eight a hop, two a call of two hops
    assert line["kernels_per_hop"] == 0 and line["device_user_annotations"] == 0  # no device on the CPU
    assert line["kernels_by_owner"] == {} and abs(line["clock_offset_s"]) < 1e6
    assert set(line["ns_per_span"]) == {"off", "on", "profiled"} and line["enqueue_ms_per_hop"]["off"] > 0
