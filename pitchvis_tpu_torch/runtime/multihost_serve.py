"""Runnable multi-host serving recipe.

Port of ``pitchvis_tpu/runtime/multihost_serve.py``: the deployment shape
for serving thousands of audio streams over several hosts with GPUs.

* every host runs THIS script as one ``torch.distributed`` process (the
  gloo backend: it carries the start-up and the one host-side float of the
  bench gather, never a tensor of the hop; NCCL would refuse two ranks on
  one GPU, which the single-machine demo makes);
* ingest is host-local: each host owns a native lock-free ring bank
  (native/pitchvis_native.cpp) fed by its producer threads (here synthetic
  tone producers standing in for network receivers), with AGC applied at
  write time like the reference's audio callback;
* each hop, each host snapshots its local streams' trailing windows and
  splits them over its own devices (the (hosts, dp) mesh of
  parallel/sharding.py::make_multihost_mesh, its row of this host); the hop
  calls no collective (checked at start-up), so nothing crosses hosts on
  the hot path;
* only the end-of-run bench line reduces across hosts (one gather outside
  the serving loop); process 0 prints ONE JSON line: the aggregate streams
  x realtime factor of the cluster.

Run one process per host:

    python -m pitchvis_tpu_torch.runtime.multihost_serve \\
        --coordinator <host0>:<port> --processes N --process-id I \\
        --streams-per-host 512 --seconds 10

or demo the whole recipe on one machine (the processes then share the
machine's devices):

    python -m pitchvis_tpu_torch.runtime.multihost_serve --spawn 2 \\
        --streams-per-host 1024 --seconds 3 --path pallas --fast

    python -m pitchvis_tpu_torch.runtime.multihost_serve --spawn 2 \\
        --device cpu --devices-per-host 2 --streams-per-host 8 --seconds 2 --small
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import AnalysisParameters, VqtParameters, VqtRange
from ..core.device import resolve_device
from ..kernel.builder import get_kernel
from ..models.analysis import analysis_step_batch, init_state_batch
from ..ops.vqt import make_vqt_arrays, vqt_db_auto
from ..parallel.sharding import (
    device_scope,
    make_multihost_mesh,
    map_shards,
    multihost_stream_sharding,
    no_collectives,
    replicate,
)
from .native import NativeRingBank

def _parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--spawn", type=int, default=0, help="single-machine demo: spawn N local host processes")
    p.add_argument("--devices-per-host", type=int, default=0,
                   help="devices a host drives: N GPUs (at most the host's), or N virtual slots "
                        "with --device cpu; 0 = every GPU (one CPU slot)")
    p.add_argument("--streams-per-host", type=int, default=64)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--hop-hz", type=float, default=60.0)
    p.add_argument("--path", default="time", choices=["time", "freq", "pallas"])
    p.add_argument("--fast", action="store_true", help="bf16 VQT weights")
    p.add_argument("--small", action="store_true", help="reduced VQT parameters (CI/demo)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or the CPU with the kernels' plain versions")
    return p.parse_args(argv)


def _spawn(args) -> int:
    """Launcher: N local host processes with a fresh coordinator port."""
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    cmd_base = [
        sys.executable, "-m", "pitchvis_tpu_torch.runtime.multihost_serve",
        "--coordinator", f"127.0.0.1:{port}",
        "--processes", str(args.spawn),
        "--devices-per-host", str(args.devices_per_host),
        "--streams-per-host", str(args.streams_per_host),
        "--seconds", str(args.seconds),
        "--hop-hz", str(args.hop_hz),
        "--path", args.path,
        "--device", args.device,
    ] + (["--small"] if args.small else []) + (["--fast"] if args.fast else [])
    procs = [subprocess.Popen(cmd_base + ["--process-id", str(i)]) for i in range(args.spawn)]
    rc = 0
    try:
        for p in procs:
            rc |= p.wait()
    finally:
        for p in procs:  # a failed rank must not leave the others waiting on it
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if args.spawn:
        return _spawn(args)

    device = resolve_device(args.device)  # raises without CUDA unless --device cpu
    distributed = bool(args.coordinator) and args.processes > 1
    if distributed:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{args.coordinator}", world_size=args.processes, rank=args.process_id
        )
    try:
        return _serve(args, device)
    finally:
        if distributed:
            dist.destroy_process_group()


def _serve(args, device: torch.device) -> int:
    pid = dist.get_rank() if dist.is_initialized() else 0
    n_hosts = dist.get_world_size() if dist.is_initialized() else 1
    params = (
        VqtParameters(n_fft=2048, range=VqtRange(min_freq=220.0, octaves=3, buckets_per_octave=12))
        if args.small
        else VqtParameters()
    )
    aparams = AnalysisParameters()
    kernel = get_kernel(params)
    sr = params.sr
    hop = int(sr / args.hop_hz)
    local_streams = args.streams_per_host
    global_streams = local_streams * n_hosts

    mesh = make_multihost_mesh(n_devices=args.devices_per_host or None, device=device)
    if global_streams % mesh.size:
        raise SystemExit(f"streams ({global_streams}) must divide over the {mesh.size}-device mesh")
    rows = multihost_stream_sharding(mesh)
    local_devices = tuple(dict.fromkeys(mesh.local_devices))

    arrays = replicate(mesh, make_vqt_arrays(kernel, path=args.path, fast=args.fast, device=local_devices[0]))
    # init rows are uniform, so each host makes only its own rows
    analysis_state = rows.put_local(init_state_batch(local_streams, params.n_buckets, device="cpu"))
    snap_len = int(getattr(arrays.on(local_devices[0]), "tail", params.n_fft))

    # --- host-local ingest: native ring bank + producer thread -------------
    capacity = max(int(sr * 2.0), params.n_fft)
    rings = NativeRingBank(local_streams, capacity)
    stop = threading.Event()

    def producer():
        """Synthetic per-stream tones (stand-in for network receivers)."""
        rng = np.random.default_rng(1000 + pid)
        freqs = rng.uniform(params.range.min_freq * 1.5, params.range.min_freq * 5.0, local_streams)
        t0 = 0
        while not stop.is_set():
            t = (t0 + np.arange(hop)) / sr
            block = (0.1 * np.sin(2 * np.pi * freqs[:, None] * t[None, :])).astype(np.float32)
            rings.write_batch(None, block)  # one call for all local streams
            t0 += hop
            time.sleep(0.2 / args.hop_hz)  # produce ~5x realtime, bounded

    producer_thread = threading.Thread(target=producer, daemon=True)
    producer_thread.start()

    def _step(a, st, x, dt):
        return analysis_step_batch(aparams, params.range, st, vqt_db_auto(a, x, path=args.path), dt)

    def one_step(state):
        windows, _gains = rings.snapshot(snap_len)
        x = rows.put_local(np.ascontiguousarray(windows, np.float32))
        state, _out = map_shards(_step, arrays, state, x, 1.0 / args.hop_hz)
        for d in local_devices:  # a barrier on every local device's work
            if d.type == "cuda":
                with device_scope(d):
                    torch.cuda.synchronize()
        return state

    try:
        # the warm-up hop is also the start-up check that the hop calls no
        # collective (not an assert: it must hold under python -O)
        with no_collectives():
            analysis_state = one_step(analysis_state)

        # --- serve loop -----------------------------------------------------
        t0 = time.monotonic()
        deadline = t0 + args.seconds
        steps = 0
        while time.monotonic() < deadline:
            analysis_state = one_step(analysis_state)
            steps += 1
        elapsed = max(time.monotonic() - t0, 1e-9)

        # --- aggregated bench line (the only cross-host reduction, off the
        # hot path): gather each host's step rate; process 0 reports
        local_rate = torch.tensor([steps * local_streams / elapsed], dtype=torch.float64)
        if dist.is_initialized():
            gathered = [torch.zeros(1, dtype=torch.float64) for _ in range(n_hosts)]
            dist.all_gather(gathered, local_rate)
            total_rate = float(sum(g.item() for g in gathered))
        else:
            total_rate = float(local_rate.item())
    finally:
        # stop and JOIN the producer before the ring bank is closed: a write
        # racing its destruction would use a freed handle
        stop.set()
        producer_thread.join(timeout=10)
        if not producer_thread.is_alive():
            # a producer still alive after the timeout must not have the
            # handle freed under it; leaking the bank at exit is the safe failure
            rings.close()
    if pid == 0:
        print(json.dumps({
            "metric": "multihost_streams_realtime_factor",
            "value": round(total_rate / args.hop_hz, 1),
            "unit": "x realtime (aggregate)",
            "hosts": n_hosts,
            "streams": global_streams,
            "steps_per_host": steps,
            "native_ingest": True,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
