"""The ``capacity`` traffic kind: a backlog of streams drained through the
device ring, as fast as the program goes.

``StreamingPipeline(B, ...).step_multi`` takes ``hops_per_call`` hops of every stream a call from one
of ``banks`` banks of chunks made on the device in set-up from the seeded
music, the banks in turn. One call is in flight while the host enqueues the
next. The window's rate is every stream-hop completed over every second of
the window, the wait for the last call included.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import audio, judge
from .live import program_params
from .reference.agc import agc_chunks


class _Program:
    """The step and its banks."""

    def __init__(self, cfg, params, n_streams, device, fast, music, hops, hop, banks):
        from pitchvis_tpu_torch.models.pipeline import StreamingPipeline

        out = cfg["outputs"]
        self.dt = hop / params.sr
        self.device = device
        self.pipe = StreamingPipeline(n_streams, params, path=cfg["path"], fast=fast, device=device,
                                      with_led=bool(out["with_led"]), with_viewer=bool(out["with_viewer"]))
        # banks[k][h, s] = chunk k * hops + h of stream s
        streams = np.arange(n_streams)
        self.banks = [_bank(music, music.tracks.to(device), streams, k * hops, hops, device) for k in range(banks)]

    def __call__(self, k: int):
        return self.pipe.step_multi(self.banks[k], self.dt)

    def mark(self):
        if self.device.type != "cuda":
            return []
        e = torch.cuda.Event()
        e.record(torch.cuda.current_stream(self.device))
        return [e]


def _bank(music, tracks, streams, first, hops, device) -> torch.Tensor:
    """(hops, len(streams), hop) float32 chunks on ``device``."""
    view = tracks.reshape(-1, music.hop)
    idx = np.stack([music.chunk_index(streams, first + h) for h in range(hops)])
    level = torch.from_numpy(music.level[streams]).to(device)
    return view[torch.from_numpy(idx).to(device)] * level[None, :, None]


def _rows(leaf: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    """Rows ``rows`` (stream axis 1) of a (K, B, ...) output leaf, on the CPU."""
    return leaf[:, torch.from_numpy(rows).to(leaf.device)].cpu()


def _finite_count(out) -> torch.Tensor:
    """A device scalar: stream-hops whose VQT or smoothed spectrum is not
    finite."""
    return sum((~torch.isfinite(leaf)).any(dim=-1).sum() for leaf in (out.x_vqt, out.analysis.x_vqt_smoothed))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device, fast: bool, result, compare=True) -> None:
    from .trace import Profiler

    cfg, tr = cell.config, cell.traffic
    params = program_params(cfg)
    sr, fps = params.sr, float(cfg["fps"])
    hop = int(sr / fps)  # the server's own rule: int(sr * hop_seconds)
    n_streams = int(tr["streams"])
    hops, n_banks = int(tr["hops_per_call"]), int(tr["banks"])
    rows = audio.sample_streams(seed, n_streams, int(tr["compare"]["streams"]), tr["music"])
    music = audio.make_music(seed, n_streams, hops * n_banks, hop, sr, tr["music"], cfg["vqt"], device)
    prog = _Program(cfg, params, n_streams, device, fast, music, hops, hop, n_banks)
    del music.tracks
    cores = os.sched_getaffinity(0)
    if device.type == "cuda":  # the host thread that enqueues on a core of its own, for the window
        os.sched_setaffinity(0, {max(cores)})

    # warm-up: one call of the cell's shape
    if trace and device.type == "cuda":
        Profiler.warm()
    out = prog(0)
    _sync(device)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    result.host_probe()
    rng = np.random.default_rng([seed, 5])
    picks = sorted(rng.uniform(0.05, 0.95, int(tr["compare"]["calls"])))
    kept = {}  # call index -> outputs
    enqueue = []
    host_spans = []
    calls = 0
    pending = []
    profiler = None
    traced_from = None
    result.host_open()
    w0 = time.monotonic()
    result.window_start = w0
    while True:
        t_in = time.monotonic()
        if t_in - w0 >= seconds:
            break
        if trace and profiler is None and t_in - w0 >= seconds / 3:
            profiler = Profiler(1).__enter__()
            traced_from = calls
        calls += 1
        out = prog(calls % n_banks)
        t_enq = time.monotonic()
        enqueue.append(t_enq - t_in)
        bad = bad + _finite_count(out)
        if picks and t_in - w0 >= picks[0] * seconds:
            kept[calls] = out
            picks.pop(0)
        last_out = out
        marks = prog.mark()
        for e in pending:  # one call in flight while the next is enqueued
            e.synchronize()
        pending = marks
        host_spans += [(t_in, t_enq, "host enqueue"), (t_enq, time.monotonic(), "host waits for a call")]
        if traced_from is not None and calls - traced_from == int(tr["trace_calls"]):
            profiler.__exit__(None, None, None)
            traced_from = None
            result.counters["traced_hops"] = int(tr["trace_calls"]) * hops
    _sync(device)
    wall = time.monotonic() - w0
    result.host_close()
    os.sched_setaffinity(0, cores)
    if picks and calls not in kept:  # the window closed before a pick: its last call stands in
        kept[calls] = last_out
    result.memory_peak()
    n_bad = int(bad)
    result.attempted = calls * hops * n_streams
    result.failed = n_bad
    result.e2e["realtime_x"] = calls * hops * n_streams * (hop / sr) / wall
    result.spans["enqueue_per_hop"] = [e / hops for e in enqueue]
    if traced_from is not None:  # the window closed while tracing
        profiler.__exit__(None, None, None)
        result.counters["traced_hops"] = (calls - traced_from) * hops
    if profiler is not None:
        result.trace = profiler.trace
        result.host_spans = [s for s in host_spans if s[1] >= profiler.trace.start]
        result.idle_label = "host between calls"
    from .bounds import vqt_geometry
    from .reference.chain import Deployment

    result.shapes.update(per_device=n_streams, bins=params.n_buckets, n_fft=params.n_fft, hop=hop, fast=fast,
                         buffer_len=params.n_fft)
    result.note(f"window: {calls} calls of {hops} hops of {n_streams} streams "
                f"in {wall:.3f} s; one warm-up call; {n_bad} stream-hops not finite")

    program = {}
    for c, o in kept.items():
        leaves = judge.flatten(o)
        program[c] = {name: _rows(leaf, rows) for name, leaf in leaves.items()
                      if name == "analysis.x_vqt_smoothed" or name in judge.served_leaves(leaves)}
    bank_rows = [_rows(b, rows) for b in prog.banks]  # (hops, S, hop) each
    del prog, out, kept, last_out
    result.free_device()
    ref = Deployment(cfg, len(rows), vqt_device=device)
    result.shapes["geometry"] = vqt_geometry(ref.kernel)
    if compare:
        result.readings = _compare(ref, bank_rows, program, hops, hop, sr)


def _compare(ref, bank_rows, program: dict, hops: int, hop: int, sr: float) -> dict:
    """Replays calls 0 (the warm-up) .. the last compared one for the
    sampled streams and compares the compared calls' hops."""
    last = max(program)
    n_banks = len(bank_rows)
    s = bank_rows[0].shape[1]
    chunks = torch.cat([bank_rows[c % n_banks] for c in range(last + 1)])  # (H, S, hop)
    raw = chunks.permute(1, 0, 2).numpy()  # (S, H, hop)
    processed, _ = agc_chunks(raw)
    n_fft = ref.params.n_fft
    signal = torch.nn.functional.pad(torch.from_numpy(processed.reshape(s, -1)), (n_fft, 0))
    fl = ref.frame_len
    h_total = chunks.shape[0]
    db = []
    for part in np.array_split(np.arange(h_total), max(1, h_total // 128)):
        frames = torch.stack([signal[i, n_fft + (h + 1) * hop - fl : n_fft + (h + 1) * hop]
                              for h in part for i in range(s)])
        db.append(ref.vqt.db(frames).reshape(len(part), s, -1))
    x_vqt = torch.cat(db)
    dt = torch.full((h_total, s), hop / sr, dtype=torch.float64).float()
    calls = sorted(program)
    keep = [c * hops + h for c in calls for h in range(hops)]
    out = ref.run(x_vqt, dt, keep)
    ref_leaves = judge.flatten(out)
    got = {name: torch.cat([program[c][name] for c in calls]) for name in program[calls[0]]}
    gaps = judge.spectrum_gaps(got["analysis.x_vqt_smoothed"], ref_leaves["analysis.x_vqt_smoothed"])
    served = judge.served_leaves(ref_leaves)
    by_leaf = {}
    off = judge.off_rows(got, served, lead=2, by_leaf=by_leaf)
    leaf_gaps = {}
    values = judge.readings(gaps, off, judge.output_gaps(got, served, 2, leaf_gaps))
    values["compared"] = f"{gaps.size} stream-hops of {len(calls)} calls, {s} streams, {len(served)} served leaves; off by leaf {by_leaf}; p75 gap by leaf {leaf_gaps}"
    return values
