"""Long-haul serving stability run on one card. Counterpart of the JAX
package's ``bench/longhaul.py``: the same per-minute rows and summary,
written by default to ``build/LONGHAUL_torch.json``.

One sustained ``StreamServer.serve()`` run (30-60 minutes at B >= 1024 in
the cadenced interactive mode) with producer ingest throughout, serving
churn (``reset_stream`` every few seconds) and a live ``rebuild`` every few
minutes, recording PER MINUTE:

* host RSS (VmRSS from /proc/self/status): host-side leaks (staging
  buffers, the ring bank, resampler banks);
* device memory (``torch.cuda.memory_allocated``; None on the CPU):
  device-side leaks (tensors pinned by stale references, arrays of earlier
  parameter sets kept across rebuilds);
* publish cadence p50/p95 and publishes a minute: cadence rot;
* the served realtime fraction of the minute (advanced-hops delta);
* output finiteness of the newest published hop.

The JSON report is (re)written after every minute, so a crash still leaves
the rows up to that point. The reference never runs at this scale (its one
stream runs on a desktop); this is the serving deployment's counterpart: a
leak that a soak leg of a few minutes cannot catch.

Run:  python -m pitchvis_tpu_torch.bench.longhaul [--streams 1024]
[--minutes 45] [--device cpu] (also ``python -m pitchvis_tpu_torch.xtask
longhaul``).
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
from . import LONGHAUL_PATH
from .soak import _start_producers


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return round(int(line.split()[1]) / 1024.0, 1)
    return -1.0


def _device_mb(device) -> float | None:
    """MB allocated by torch on ``device``, or None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return round(torch.cuda.memory_allocated(device) / 1e6, 1)


def longhaul(
    n_streams: int = 1024,
    minutes: float = 45.0,
    rate_hz: float = 60.0,
    hops_per_dispatch: int = 8,
    n_producers: int = 4,
    path: str = "pallas",
    fast: bool = True,
    reset_every_s: float = 5.0,
    rebuild_every_s: float = 150.0,
    out_path: str = LONGHAUL_PATH,
    vqt_params=None,
    device="cuda",
) -> dict:
    from ..core.config import VqtParameters
    from ..runtime.server import StreamServer

    dev = resolve_device(device)
    params = vqt_params or VqtParameters()
    server = StreamServer(n_streams, params, buffer_seconds=2.0, path=path, fast=fast, device=dev)
    sr = int(params.sr)
    stop = threading.Event()
    threads, writes = _start_producers(server, stop, n_streams, n_producers, sr)

    # first use of both parameter sets up front, so that the rebuilds swap
    # built arrays and kernels (the live tuner's debounce assumes this)
    retuned = dataclasses.replace(params, quality=params.quality * 1.1)
    for pset in (params, retuned, params):
        if pset is not params or server.vqt_params is not pset:
            server.rebuild(pset)
        server.step_multi(2 * hops_per_dispatch, dt=1.0 / 60.0, per_hop=True)
        out, _ = server.step_multi(hops_per_dispatch, dt=1.0 / 60.0, per_hop=True)
        out[-1].peaks[0].cpu()  # per_hop returns a k-tuple of the hops' outputs

    publish_t: list[float] = []  # appended by the consumer thread (GIL-atomic)
    consumer_stop = threading.Event()

    def consumer(loop):
        last = 0
        while not consumer_stop.is_set():
            trip = loop.wait_next(seq=last, timeout=1.0)
            if trip is None:
                continue
            last = trip[0]
            publish_t.append(time.monotonic())

    report: dict = {
        "leg": "longhaul",
        "n_streams": n_streams,
        "minutes": minutes,
        "rate_hz": rate_hz,
        "hops_per_dispatch": hops_per_dispatch,
        "publish": "per_hop",
        "path": path,
        "fast": fast,
        "reset_every_s": reset_every_s,
        "rebuild_every_s": rebuild_every_s,
        "rss_mb_start": _rss_mb(),
        "device_mb_start": _device_mb(dev),
        "per_minute": [],
    }

    def flush_report():
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)

    rng = np.random.default_rng(42)
    for th in threads:
        th.start()
    loop = server.serve(rate_hz=rate_hz, hops_per_dispatch=hops_per_dispatch, publish="per_hop")
    cons = threading.Thread(target=consumer, args=(loop,), daemon=True)
    cons.start()

    t_start = time.monotonic()
    deadline = t_start + minutes * 60.0
    next_reset = t_start + reset_every_s
    next_rebuild = t_start + rebuild_every_s
    resets = 0
    rebuilds: list[float] = []
    pub_done = 0  # publish_t entries already aggregated
    adv_done = server.stats["advanced"]
    writes_done = 0
    current = params
    try:
        while time.monotonic() < deadline:
            minute_end = min(time.monotonic() + 60.0, deadline)
            while time.monotonic() < minute_end:
                now = time.monotonic()
                if now >= next_reset:
                    server.reset_stream(int(rng.integers(0, n_streams)))
                    resets += 1
                    next_reset = now + reset_every_s
                if now >= next_rebuild:
                    t0 = time.monotonic()
                    current = retuned if current is params else params
                    server.rebuild(current)
                    rebuilds.append(round(time.monotonic() - t0, 2))
                    next_rebuild = now + rebuild_every_s
                time.sleep(min(1.0, max(0.0, minute_end - time.monotonic())))
            # -- per-minute aggregation ----------------------------------------
            n_pub = len(publish_t)
            gaps = sorted(np.diff(publish_t[max(pub_done - 1, 0) : n_pub])) if n_pub - pub_done > 1 else []
            adv = server.stats["advanced"]
            w = sum(writes)
            latest = loop.latest()
            finite = latest is not None and bool(torch.isfinite(latest[1].scene_calmness).all())
            wall = time.monotonic() - t_start
            report["per_minute"].append({
                "minute": len(report["per_minute"]) + 1,
                "rss_mb": _rss_mb(),
                "device_mb": _device_mb(dev),
                "published": n_pub - pub_done,
                "publish_gap_p50_ms": round(float(gaps[len(gaps) // 2]) * 1e3, 1) if gaps else None,
                "publish_gap_p95_ms": round(float(gaps[int(len(gaps) * 0.95)]) * 1e3, 1) if gaps else None,
                "served_realtime_fraction": round(
                    (adv - adv_done) * (server._hop / sr) / (n_streams * min(60.0, wall)), 3
                ),
                "ingest_realtime_fraction": round((w - writes_done) / (n_streams * sr * min(60.0, wall)), 3),
                "resets_total": resets,
                "rebuilds_total": len(rebuilds),
                "skipped_deadlines_total": loop.stats["skipped_deadlines"],
                "outputs_finite": finite,
            })
            pub_done, adv_done, writes_done = n_pub, adv, w
            t_start = time.monotonic()  # the next minute's rate base
            flush_report()
    finally:
        consumer_stop.set()
        try:
            loop.stop()
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=10)
            cons.join(timeout=10)
            server.close()

    pm = report["per_minute"]
    rss = [m["rss_mb"] for m in pm]
    p50s = [m["publish_gap_p50_ms"] for m in pm if m["publish_gap_p50_ms"]]
    report["summary"] = {
        "minutes_recorded": len(pm),
        "resets": resets,
        "rebuilds": len(rebuilds),
        "rebuild_wall_s": rebuilds,
        "rss_mb_end": rss[-1] if rss else None,
        "rss_mb_max": max(rss) if rss else None,
        # the host-leak verdict: RSS growth over the steady window (minute 3
        # on; the first minutes include first-use builds and warm-up)
        "rss_mb_drift_steady": round(rss[-1] - rss[min(2, len(rss) - 1)], 1) if rss else None,
        "device_mb_end": pm[-1]["device_mb"] if pm else None,
        "publish_gap_p50_ms_min": min(p50s) if p50s else None,
        "publish_gap_p50_ms_max": max(p50s) if p50s else None,
        "served_realtime_fraction_mean": (
            round(float(np.mean([m["served_realtime_fraction"] for m in pm])), 3) if pm else None
        ),
        "all_outputs_finite": all(m["outputs_finite"] for m in pm),
    }
    flush_report()
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=1024)
    ap.add_argument("--minutes", type=float, default=45.0)
    ap.add_argument("--rate-hz", type=float, default=60.0)
    ap.add_argument("--hops-per-dispatch", type=int, default=8)
    ap.add_argument("--rebuild-every-s", type=float, default=150.0)
    ap.add_argument("--out", default=LONGHAUL_PATH)
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1

    report = longhaul(
        n_streams=args.streams,
        minutes=args.minutes,
        rate_hz=args.rate_hz,
        hops_per_dispatch=args.hops_per_dispatch,
        rebuild_every_s=args.rebuild_every_s,
        out_path=args.out,
        device=dev,
    )
    print(json.dumps(report.get("summary", {}), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
