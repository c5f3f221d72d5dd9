"""Sustained capacity soak of the serving paths on one card, with churn.
Counterpart of the JAX package's ``bench/soak.py``: the same legs and the
same report keys, written by default to ``build/SOAK_torch.json``.

* **pipeline leg** -- StreamingPipeline(path="pallas", fast=True) at 3840
  streams for the leg's wall time, hops in calls of ``step_multi``, with
  serving churn beside them: a ``reset_stream`` every few seconds and ONE
  live ``rebuild`` halfway (a parameter change at an unchanged bin layout,
  the debounced tuner's shape). Records the sustained aggregate realtime
  factor (audio-seconds processed a wall-second, every pause of the churn
  counted).
* **server leg** -- the live-ingest stack (StreamServer, native ring bank)
  at 1024 streams with producer threads, pipelined stepping, churn and one
  live rebuild; records the sustained hop rate and p50/p95 hop times.
* **server_capacity leg** -- live ingest at 3840 streams through the
  throughput serving mode (``step_multi``).
* **serve_loop legs** -- the self-driving loop (``StreamServer.serve()``)
  pacing 60 Hz hops on its own thread at 512 streams, with producers, a
  consumer (``wait_next`` and a one-element read each published hop),
  churn and one live rebuild; records the consumer-observed publish rate,
  the p50/p95 gaps between publishes and the loop's deadline skips. The
  second pass (``serve_loop_throughput``) runs ``hops_per_dispatch=k``
  (each dispatch ``step_multi(k)``, the newest hop published), the third
  (``serve_loop_cadenced``) the interactive mode ``publish="per_hop"``
  (every hop of each k-hop dispatch published on its own 1/rate_hz slot).

Every hop is eager on the port (some 444 launches an analysis step), so the
legs measure the host-bound hop a deployment serves today.

Run:  python -m pitchvis_tpu_torch.bench.soak [--streams 3840] [--minutes 3]
[--device cpu] ... (also ``python -m pitchvis_tpu_torch.xtask soak``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from ..core.device import resolve_device
from . import SOAK_PATH


def _tone_producer(server, stop, writes, k, lo, hi, sr):
    """Shared producer loop of the live-ingest legs: pushes 100 ms of tone
    to every stream in its range once per 100 ms in ONE batched native call
    (``push_batch``; a ``push`` a stream caps ingest on Python calls alone,
    thousands of streams short of the ring's bandwidth). Realtime ingest
    when the host keeps up; the report's ingest_realtime_fraction records
    whether it did. The native writes release the GIL."""
    rng = np.random.default_rng(k)
    t = np.arange(sr // 10) / sr
    block = np.stack([
        (0.1 * np.sin(2 * np.pi * 110.0 * (1 + (s % 32)) * float(rng.uniform(0.98, 1.02)) * t)).astype(np.float32)
        for s in range(lo, hi)
    ])
    ids = np.arange(lo, hi, dtype=np.int64)
    while not stop.is_set():
        t0 = time.monotonic()
        server.push_batch(block, ids)
        writes[k] += block.size
        time.sleep(max(0.0, 0.1 - (time.monotonic() - t0)))


def _start_producers(server, stop, n_streams, n_producers, sr):
    """The producer threads, unstarted, and their sample counts: at most one
    producer a stream (a producer with no stream of its own would have
    nothing to push)."""
    n_producers = min(n_producers, n_streams)
    writes = [0] * n_producers
    threads = [
        threading.Thread(
            target=_tone_producer,
            args=(server, stop, writes, k,
                  k * n_streams // n_producers, (k + 1) * n_streams // n_producers, sr),
            daemon=True,
        )
        for k in range(n_producers)
    ]
    return threads, writes


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def soak_pipeline(
    n_streams: int = 3840,
    minutes: float = 3.0,
    hops_per_call: int = 16,
    path: str = "pallas",
    fast: bool = True,
    reset_every_s: float = 5.0,
    vqt_params=None,
    device="cuda",
) -> dict:
    """Device-ring capacity leg. The input chunks are staged on the device
    once and alternated (ingest bandwidth is the server legs' part)."""
    from ..core.config import VqtParameters
    from ..models.pipeline import StreamingPipeline

    dev = resolve_device(device)
    params = vqt_params or VqtParameters()
    pipe = StreamingPipeline(n_streams, params, path=path, fast=fast, device=dev)
    hop = int(params.sr / 60.0)
    dt_hop = hop / params.sr
    rng = np.random.default_rng(0)
    banks = [
        torch.from_numpy((rng.standard_normal((hops_per_call, n_streams, hop)) * 0.05).astype(np.float32)).to(dev)
        for _ in range(2)
    ]

    out = pipe.step_multi(banks[0], dt_hop)  # first use
    out.x_vqt[-1, 0, 0].item()  # barrier

    deadline = time.monotonic() + minutes * 60.0
    rebuild_at = time.monotonic() + minutes * 30.0  # halfway
    next_reset = time.monotonic() + reset_every_s
    hops = resets = 0
    rebuilds = []
    t_start = time.monotonic()
    i = 0
    while time.monotonic() < deadline:
        out = pipe.step_multi(banks[i % 2], dt_hop)
        out.x_vqt[-1, 0, 0].item()  # keeps the loop honest (no pile-up of enqueued hops)
        hops += hops_per_call
        i += 1
        now = time.monotonic()
        if now >= next_reset:
            pipe.reset_stream(int(rng.integers(0, n_streams)))
            resets += 1
            next_reset = now + reset_every_s
        if rebuild_at is not None and now >= rebuild_at:
            t0 = time.monotonic()
            pipe.rebuild(dataclasses.replace(params, quality=params.quality * 1.1))
            rebuilds.append(round(time.monotonic() - t0, 2))
            rebuild_at = None
    wall = time.monotonic() - t_start
    audio_secs = hops * dt_hop * n_streams
    return {
        "leg": "pipeline",
        "minutes": minutes,
        "n_streams": n_streams,
        "path": path,
        "fast": fast,
        "wall_s": round(wall, 1),
        "hops": hops,
        "resets": resets,
        "rebuild_wall_s": rebuilds,
        "aggregate_realtime_factor": round(audio_secs / wall, 1),
        "streams_sustainable_at_60hz": int(audio_secs / wall),
        "outputs_finite": _finite(out.x_vqt[-1]),
    }


def soak_server(
    n_streams: int = 1024,
    minutes: float = 3.0,
    n_producers: int = 4,
    path: str = "pallas",
    fast: bool = True,
    reset_every_s: float = 5.0,
    hops_per_call: int = 1,
    leg: str = "server",
    vqt_params=None,
    device="cuda",
) -> dict:
    """Live-ingest leg: producer threads push tones into the native ring
    bank while this thread runs pipelined steps; churn and one live rebuild
    happen halfway. ``hops_per_call=k`` soaks the throughput serving mode
    instead (``step_multi``: k ingest-fed hops in one call); the hop
    percentiles are then the per-hop charge, the call's time over k."""
    from ..core.config import VqtParameters
    from ..runtime.server import StreamServer

    dev = resolve_device(device)
    params = vqt_params or VqtParameters()
    server = StreamServer(n_streams, params, buffer_seconds=2.0, path=path, fast=fast, device=dev)
    sr = int(params.sr)
    stop = threading.Event()
    threads, writes = _start_producers(server, stop, n_streams, n_producers, sr)

    if hops_per_call > 1:
        out, _ = server.step_multi(hops_per_call, dt=1.0 / 60.0)  # first use
    else:
        out, _ = server.step(dt=1.0 / 60.0)  # first use
    out.peaks[0].cpu()

    for th in threads:
        th.start()
    rng = np.random.default_rng(1)
    deadline = time.monotonic() + minutes * 60.0
    rebuild_at = time.monotonic() + minutes * 30.0
    next_reset = time.monotonic() + reset_every_s
    steps = resets = 0
    rebuilds = []
    times = []
    res = None  # a deadline that lapses before the first step leaves no result
    t_start = time.monotonic()
    advanced0 = server.stats["advanced"]  # leaves out the first-use and priming hops
    if hops_per_call == 1:
        server.step(pipelined=True, dt=None)  # prime
    try:
        while time.monotonic() < deadline:
            t0 = time.perf_counter()
            if hops_per_call > 1:
                res = server.step_multi(hops_per_call)
            else:
                res = server.step(pipelined=True)
            if res is not None:
                res[0].peaks[0, 0].item()
            times.append((time.perf_counter() - t0) / hops_per_call)
            steps += 1
            now = time.monotonic()
            if now >= next_reset:
                server.reset_stream(int(rng.integers(0, n_streams)))
                resets += 1
                next_reset = now + reset_every_s
            if rebuild_at is not None and now >= rebuild_at:
                t0 = time.monotonic()
                server.rebuild(dataclasses.replace(params, quality=params.quality * 1.1))
                rebuilds.append(round(time.monotonic() - t0, 2))
                rebuild_at = None
        # the multi mode has no pipelined tail to flush; its last result is res
        final = server.flush() if hops_per_call == 1 else res
        finite = final is not None and _finite(final[0].x_vqt_smoothed)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
        server.close()
    wall = time.monotonic() - t_start
    times.sort()
    hops = steps * hops_per_call
    stats = dict(server.stats)
    return {
        "leg": leg,
        "minutes": minutes,
        "n_streams": n_streams,
        "path": path,
        "fast": fast,
        "hops_per_call": hops_per_call,
        "wall_s": round(wall, 1),
        "steps": steps,
        "hops": hops,
        "hops_per_s": round(hops / wall, 2),
        # the per-hop charge (amortized when hops_per_call > 1); None when
        # the deadline lapsed before the first step
        "hop_p50_ms": round(times[len(times) // 2] * 1e3, 1) if times else None,
        "hop_p95_ms": round(times[int(len(times) * 0.95)] * 1e3, 1) if times else None,
        "samples_ingested": sum(writes),
        "ingest_realtime_fraction": round(sum(writes) / (n_streams * sr * wall), 3),
        # audio ADVANCED through the analysis a stream-second of wall: the
        # sustained serving realtime fraction at this scale
        "served_realtime_fraction": round(
            (stats["advanced"] - advanced0) * (server._hop / sr) / (n_streams * wall), 3
        ),
        "resets": resets,
        "rebuild_wall_s": rebuilds,
        "outputs_finite": finite,
        "serving_stats": stats,
    }


def soak_serve_loop(
    n_streams: int = 512,
    minutes: float = 3.0,
    rate_hz: float = 60.0,
    n_producers: int = 4,
    path: str = "pallas",
    fast: bool = True,
    reset_every_s: float = 5.0,
    hops_per_dispatch: int = 1,
    publish: str = "latest",
    leg: str = "serve_loop",
    vqt_params=None,
    device="cuda",
) -> dict:
    """Self-driving-loop leg: ``StreamServer.serve()`` owns the dispatch
    cadence while producers push and this thread plays the consumer
    (``wait_next`` and a one-element read each published hop, the barrier a
    display client provides); churn and one live rebuild run on the control
    plane halfway. Records the consumer-observed publish rate and the
    p50/p95 gaps between publishes against the target rate."""
    from ..core.config import VqtParameters
    from ..runtime.server import StreamServer

    dev = resolve_device(device)
    params = vqt_params or VqtParameters()
    server = StreamServer(n_streams, params, buffer_seconds=2.0, path=path, fast=fast, device=dev)
    sr = int(params.sr)
    stop = threading.Event()
    threads, writes = _start_producers(server, stop, n_streams, n_producers, sr)

    # first use of what the loop will dispatch, before pacing starts, for
    # BOTH parameter sets, so that the live rebuild halfway finds each set's
    # arrays and kernels built (longhaul primes the same way)
    retuned = dataclasses.replace(params, quality=params.quality * 1.1)

    def prime():
        if publish == "per_hop":
            # the cadenced loop's catch-up windows dispatch 2k hops
            server.step_multi(2 * hops_per_dispatch, dt=1.0 / 60.0, per_hop=True)
            out, _ = server.step_multi(hops_per_dispatch, dt=1.0 / 60.0, per_hop=True)
            out = out[-1]  # per_hop returns a k-tuple of the hops' outputs
        elif hops_per_dispatch > 1:
            out, _ = server.step_multi(hops_per_dispatch, dt=1.0 / 60.0)
        else:
            out, _ = server.step(dt=1.0 / 60.0)
        out.peaks[0].cpu()

    prime()
    server.rebuild(retuned)
    prime()
    server.rebuild(params)
    prime()

    for th in threads:
        th.start()
    rng = np.random.default_rng(1)
    deadline = time.monotonic() + minutes * 60.0
    rebuild_at = time.monotonic() + minutes * 30.0
    next_reset = time.monotonic() + reset_every_s
    resets = 0
    rebuilds = []
    publish_t = []
    last_seq = 0
    t_start = time.monotonic()
    advanced0 = server.stats["advanced"]  # leaves out the priming hops
    loop = server.serve(rate_hz=rate_hz, hops_per_dispatch=hops_per_dispatch, publish=publish)
    try:
        while time.monotonic() < deadline:
            nxt = loop.wait_next(seq=last_seq, timeout=30.0)
            if nxt is None:
                continue
            last_seq, outputs, _gains = nxt
            outputs.scene_calmness[0].item()  # the consumer's read: a barrier
            publish_t.append(time.monotonic())
            now = publish_t[-1]
            if now >= next_reset:
                server.reset_stream(int(rng.integers(0, n_streams)))
                resets += 1
                next_reset = now + reset_every_s
            if rebuild_at is not None and now >= rebuild_at:
                t0 = time.monotonic()
                server.rebuild(dataclasses.replace(params, quality=params.quality * 1.1))
                rebuilds.append(round(time.monotonic() - t0, 2))
                rebuild_at = None
        final = loop.stop()
        finite = final is not None and _finite(final[1].x_vqt_smoothed)
        loop_stats = dict(loop.stats)
        serving_stats = dict(server.stats)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
        server.close()
    wall = time.monotonic() - t_start
    # fewer than two observations give no gap statistic: null, not NaN
    gaps = sorted(np.diff(publish_t)) if len(publish_t) > 1 else []
    return {
        "leg": leg,
        "minutes": minutes,
        "n_streams": n_streams,
        "rate_hz": rate_hz,
        "path": path,
        "fast": fast,
        "hops_per_dispatch": hops_per_dispatch,
        "publish": publish,
        "wall_s": round(wall, 1),
        # audio advanced through the analysis a stream-second of wall
        "served_realtime_fraction": round(
            (serving_stats["advanced"] - advanced0) * (server._hop / sr) / (n_streams * wall), 3
        ),
        "published": loop_stats["published"],
        "published_per_s": round(loop_stats["published"] / wall, 2),
        # the consumer reads the NEWEST hop (latest wins, as a display
        # client does); it observes fewer publishes than the loop makes when
        # its own read takes longer than the publish period
        "consumer_observed": len(publish_t),
        "consumer_gap_p50_ms": round(float(gaps[len(gaps) // 2]) * 1e3, 1) if gaps else None,
        "consumer_gap_p95_ms": round(float(gaps[int(len(gaps) * 0.95)]) * 1e3, 1) if gaps else None,
        "samples_ingested": sum(writes),
        "ingest_realtime_fraction": round(sum(writes) / (n_streams * sr * wall), 3),
        "resets": resets,
        "rebuild_wall_s": rebuilds,
        "outputs_finite": finite,
        "loop_stats": loop_stats,
        "serving_stats": serving_stats,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=3840)
    ap.add_argument("--server-streams", type=int, default=1024)
    ap.add_argument("--capacity-streams", type=int, default=3840)
    ap.add_argument("--capacity-hops-per-call", type=int, default=16)
    ap.add_argument("--loop-streams", type=int, default=512)
    ap.add_argument("--loop-throughput-hops", type=int, default=16)
    ap.add_argument("--loop-cadenced-hops", type=int, default=8)
    ap.add_argument("--minutes", type=float, default=3.0)
    ap.add_argument("--out", default=SOAK_PATH)
    ap.add_argument("--skip-server", action="store_true")
    ap.add_argument("--skip-capacity", action="store_true")
    ap.add_argument("--skip-pipeline", action="store_true")
    ap.add_argument("--skip-loop", action="store_true")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    from ..runtime import native

    # the JAX soak's skip of the server legs where the ingest library does
    # not build is kept for the CPU; on the card the library's RuntimeError
    # propagates before any leg runs
    server_legs = not (args.skip_server and args.skip_capacity and args.skip_loop)
    if server_legs and dev.type == "cuda":
        native.load()

    # skipped legs keep their previous results (one leg re-run without
    # discarding the others')
    report: dict = {}
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                report = json.load(f)
        except (OSError, json.JSONDecodeError):
            report = {}
    # each leg's own "minutes" holds (skipped legs keep theirs); this field
    # describes THIS invocation only
    report["minutes_per_leg"] = args.minutes
    if not args.skip_pipeline:
        report["pipeline"] = soak_pipeline(args.streams, args.minutes, device=dev)
        print(json.dumps(report["pipeline"]), flush=True)

    legs = []
    if not args.skip_server:
        legs.append(("server", lambda: soak_server(args.server_streams, args.minutes, device=dev)))
    if not args.skip_capacity:
        # live ingest at the full stream count through the throughput mode
        legs.append(("server_capacity", lambda: soak_server(
            args.capacity_streams, args.minutes, hops_per_call=args.capacity_hops_per_call,
            leg="server_capacity", device=dev)))
    if not args.skip_loop:
        legs.append(("serve_loop", lambda: soak_serve_loop(args.loop_streams, args.minutes, device=dev)))
        # throughput cadence: each dispatch runs k ingest-fed hops and
        # publishes the newest
        legs.append(("serve_loop_throughput", lambda: soak_serve_loop(
            args.loop_streams, args.minutes, hops_per_dispatch=args.loop_throughput_hops,
            leg="serve_loop_throughput", device=dev)))
        # the cadenced interactive mode: one k-hop dispatch, one barrier,
        # every hop published on its own slot
        legs.append(("serve_loop_cadenced", lambda: soak_serve_loop(
            args.loop_streams, args.minutes, hops_per_dispatch=args.loop_cadenced_hops,
            publish="per_hop", leg="serve_loop_cadenced", device=dev)))
    runs_server = native.available()
    for name, run in legs:
        if runs_server:
            report[name] = run()
            print(json.dumps(report[name]), flush=True)
        else:
            report[name] = {"skipped": "native library unavailable"}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
