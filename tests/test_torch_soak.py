"""The port's soak legs and long-haul run (pitchvis_tpu_torch/bench/soak.py,
longhaul.py) on the CPU at small parameters: each leg runs for a few
seconds and reports the JAX package's keys (pitchvis_tpu/bench/soak.py
:152-163, :254-285, :397-412; longhaul.py:110-124, :178-201, :219-239), and
the long-haul smoke of tests/test_bench_gate.py:67-94."""

import json
import os

import pytest
import torch

from pitchvis_tpu_torch.bench import longhaul, soak

from conftest import SMALL_PARAMS
from torch_port_helpers import to_port

P = to_port(SMALL_PARAMS)
LEG_MINUTES = 0.03  # 1.8 s a leg

PIPELINE_KEYS = {"leg", "minutes", "n_streams", "path", "fast", "wall_s", "hops", "resets", "rebuild_wall_s",
                 "aggregate_realtime_factor", "streams_sustainable_at_60hz", "outputs_finite"}
SERVER_KEYS = {"leg", "minutes", "n_streams", "path", "fast", "hops_per_call", "wall_s", "steps", "hops",
               "hops_per_s", "hop_p50_ms", "hop_p95_ms", "samples_ingested", "ingest_realtime_fraction",
               "served_realtime_fraction", "resets", "rebuild_wall_s", "outputs_finite", "serving_stats"}
LOOP_KEYS = {"leg", "minutes", "n_streams", "rate_hz", "path", "fast", "hops_per_dispatch", "publish", "wall_s",
             "served_realtime_fraction", "published", "published_per_s", "consumer_observed",
             "consumer_gap_p50_ms", "consumer_gap_p95_ms", "samples_ingested", "ingest_realtime_fraction",
             "resets", "rebuild_wall_s", "outputs_finite", "loop_stats", "serving_stats"}
MINUTE_KEYS = {"minute", "rss_mb", "device_mb", "published", "publish_gap_p50_ms", "publish_gap_p95_ms",
               "served_realtime_fraction", "ingest_realtime_fraction", "resets_total", "rebuilds_total",
               "skipped_deadlines_total", "outputs_finite"}
SUMMARY_KEYS = {"minutes_recorded", "resets", "rebuilds", "rebuild_wall_s", "rss_mb_end", "rss_mb_max",
                "rss_mb_drift_steady", "device_mb_end", "publish_gap_p50_ms_min", "publish_gap_p50_ms_max",
                "served_realtime_fraction_mean", "all_outputs_finite"}


def test_pipeline_leg():
    r = soak.soak_pipeline(2, LEG_MINUTES, hops_per_call=2, reset_every_s=0.5, vqt_params=P, device="cpu")
    assert set(r) == PIPELINE_KEYS
    assert r["leg"] == "pipeline" and r["hops"] > 0 and r["hops"] % 2 == 0
    assert r["outputs_finite"] and r["resets"] >= 1 and len(r["rebuild_wall_s"]) == 1


@pytest.mark.parametrize("hops_per_call,leg", [(1, "server"), (4, "server_capacity")])
def test_server_legs(hops_per_call, leg):
    r = soak.soak_server(4, LEG_MINUTES, n_producers=2, reset_every_s=0.5, hops_per_call=hops_per_call, leg=leg,
                         vqt_params=P, device="cpu")
    assert set(r) == SERVER_KEYS
    assert r["leg"] == leg and r["hops_per_call"] == hops_per_call
    assert r["steps"] > 0 and r["hops"] == r["steps"] * hops_per_call
    assert r["outputs_finite"] and r["samples_ingested"] > 0 and len(r["rebuild_wall_s"]) == 1
    assert r["serving_stats"]["advanced"] > 0


@pytest.mark.parametrize("hops_per_dispatch,publish,leg", [
    (1, "latest", "serve_loop"), (4, "latest", "serve_loop_throughput"), (2, "per_hop", "serve_loop_cadenced"),
])
def test_serve_loop_legs(hops_per_dispatch, publish, leg):
    r = soak.soak_serve_loop(4, LEG_MINUTES, n_producers=2, reset_every_s=0.5, hops_per_dispatch=hops_per_dispatch,
                             publish=publish, leg=leg, vqt_params=P, device="cpu")
    assert set(r) == LOOP_KEYS
    assert r["leg"] == leg and r["publish"] == publish and r["hops_per_dispatch"] == hops_per_dispatch
    assert r["published"] > 0 and r["consumer_observed"] > 0 and r["outputs_finite"]
    assert r["loop_stats"]["hops"] >= r["published"] and len(r["rebuild_wall_s"]) == 1


def test_soak_main_keeps_skipped_legs(tmp_path):
    """main writes its report where --out says; a leg it skips keeps the
    report's earlier entry; the JSON lines it prints are the legs'."""
    out = tmp_path / "SOAK.json"
    out.write_text(json.dumps({"server": {"leg": "server", "kept": True}}))
    rc = soak.main(["--minutes", "0.02", "--streams", "2", "--skip-server", "--skip-capacity", "--skip-loop",
                    "--device", "cpu", "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["server"] == {"leg": "server", "kept": True}
    assert set(report["pipeline"]) == PIPELINE_KEYS and report["minutes_per_leg"] == 0.02


def test_soak_main_skips_server_legs_only_on_the_cpu(tmp_path, monkeypatch):
    """Without the native ingest library the server legs are recorded as
    skipped on the CPU (the JAX soak's skip); on the card main raises
    before any leg runs."""
    from pitchvis_tpu_torch.runtime import native

    def does_not_build():
        raise RuntimeError("the native ingest library does not build here")

    monkeypatch.setattr(native, "load", does_not_build)
    out = tmp_path / "SOAK.json"
    argv = ["--minutes", "0.01", "--skip-pipeline", "--skip-loop", "--out", str(out)]
    assert soak.main([*argv, "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    assert report["server"] == report["server_capacity"] == {"skipped": "native library unavailable"}
    out.unlink()
    monkeypatch.setattr(soak, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(soak, "soak_pipeline", lambda *a, **k: pytest.fail("a leg ran"))
    with pytest.raises(RuntimeError, match="does not build"):
        soak.main([*argv[:2], "--out", str(out)])
    assert not out.exists()


def test_longhaul_smoke(tmp_path):
    """One sub-minute pass on tiny shapes: the cadenced serve loop, a
    per-minute row with every field, its own churn survived, a valid report
    on disk, and no device memory on the CPU."""
    out = str(tmp_path / "LONGHAUL.json")
    report = longhaul.longhaul(n_streams=2, minutes=0.15, rate_hz=30.0, hops_per_dispatch=2, n_producers=1,
                               path="time", fast=False, reset_every_s=3.0, rebuild_every_s=5.0, out_path=out,
                               vqt_params=P, device="cpu")
    with open(out) as f:
        on_disk = json.load(f)
    assert on_disk["per_minute"] == report["per_minute"] and len(report["per_minute"]) == 1
    row = report["per_minute"][0]
    assert set(row) == MINUTE_KEYS and row["rss_mb"] > 0 and row["device_mb"] is None
    assert row["published"] > 0 and row["rebuilds_total"] >= 1 and row["resets_total"] >= 1
    assert set(report["summary"]) == SUMMARY_KEYS
    assert report["summary"]["minutes_recorded"] == 1 and report["summary"]["all_outputs_finite"]
    assert report["device_mb_start"] is None and os.path.exists(out)


def test_mains_refuse_a_missing_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert soak.main([]) == 1 and longhaul.main([]) == 1
    assert capsys.readouterr().err.count("CUDA is not available") == 2


def test_at_most_one_producer_a_stream():
    """More producers than streams: one a stream, each with its own stream
    (an empty range would have nothing to push)."""
    threads, writes = soak._start_producers(None, None, 2, 4, 22050)
    assert len(threads) == len(writes) == 2
    assert [t._args[4:6] for t in threads] == [(0, 1), (1, 2)]
