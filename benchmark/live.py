"""The ``live`` traffic kind: streams served by the self-driving loop.

``StreamServer.serve(rate_hz=fps, pipelined=True)`` paces hops on its own
thread; producer threads, each owning a contiguous range of streams, push
chunk n of every stream in the range (one hop of audio) by one
``push_batch`` at that chunk's due time; a consumer holds each published
hop with ``wait_next`` and reads the LED block to the host, as an LED user
does. The schedule is open and phase-locked to the loop's grid: the grid
starts at the loop's first dispatch, t0, and chunk n is due at
``t0 + n / fps - phase / fps``, ``phase`` periods before grid slot n.

A chunk's latency runs from its due time to the moment the consumer holds
the first published hop that carries it. Which dispatch carried which chunk
is read from the program's own counters, the ``advanced`` flags of each
native consume, not assumed one a slot. A chunk that is never published, or
published more than the server's ``max_lag_seconds`` after its due time,
has failed.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

import numpy as np
import torch

from . import audio, judge
from .reference.agc import agc_chunks


@dataclasses.dataclass
class Dispatch:
    index: int
    t_in: float
    t_out: float = 0.0
    last_step: float = 0.0
    skipped: int = 0  # the loop's skipped deadlines when the dispatch began
    stats: dict = dataclasses.field(default_factory=dict)  # the server's counters after it
    consumes: list = dataclasses.field(default_factory=list)  # (advanced (B,), t0, t1, sampled rows)
    smoothed: object = None  # the carried smoothed spectrum after it, when captured


class Recorder:
    """Wraps ``step`` and ``rings.consume`` of one server instance: what each
    dispatch consumed, when, and on the loop's clock."""

    def __init__(self, server, rows: np.ndarray, capture_every: int, capture_at: int):
        self.server = server
        self.rows = rows
        self.dispatches: list[Dispatch] = []
        self.current: Dispatch | None = None
        self.started = threading.Event()  # set at the loop's first dispatch
        self.t0 = None
        self.loop_from = None  # index of the loop's first dispatch
        self.every, self.at = capture_every, capture_at
        self._step, self._consume = server.step, server.rings.consume
        server.step = self.step
        server.rings.consume = self.consume

    def step(self, *args, **kwargs):
        t_in = time.monotonic()
        loop = self.server._serve_loop
        d = Dispatch(len(self.dispatches), t_in,
                     skipped=loop.stats["skipped_deadlines"] if loop is not None else 0)
        on_loop = threading.current_thread() is not threading.main_thread()
        if on_loop and self.loop_from is None:
            self.loop_from, self.t0 = d.index, t_in
            self.started.set()
        self.current = d
        out = self._step(*args, **kwargs)
        d.t_out = time.monotonic()
        d.last_step = self.server._last_step
        d.stats = dict(self.server.stats)
        if d.index % self.every == self.at:
            d.smoothed = self.server.analysis_state.x_vqt_smoothed
        self.dispatches.append(d)
        return out

    def consume(self, n, max_lag=-1, out=None):
        t0 = time.monotonic()
        res = self._consume(n, max_lag, out)
        t1 = time.monotonic()
        # the sampled streams' rows, which the comparison aligns with the
        # audio pushed (a backlog beyond max_lag is skipped, not consumed)
        self.current.consumes.append((res[2], t0, t1, res[0][self.rows]))
        return res


def _producer(server, music, lo, hi, first_chunk, rec, period, phase, stop_at, log, errors):
    """Pushes chunk ``first_chunk + n - 1`` of streams ``lo .. hi - 1`` at
    the due time of live chunk n, n = 1, 2, ..., until ``stop_at``."""
    try:
        ids = np.arange(lo, hi, dtype=np.int64)
        rec.started.wait()
        n = 1
        while True:
            due = rec.t0 + n * period - phase * period
            if due > stop_at:
                break
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            t_start = time.monotonic()
            block = music.chunks(ids, first_chunk + n - 1, 1)
            ok = server.push_batch(block, ids)
            log.append((n, due, t_start, time.monotonic()))
            if not ok.all():
                raise RuntimeError(f"push_batch refused chunk {n} of {int((~ok).sum())} streams")
            n += 1
    except BaseException as e:  # surfaced by the main thread
        errors.append(e)


def _consumer(loop, rows, stop, held, errors):
    try:
        seq = 0
        while True:
            item = loop.wait_next(seq, timeout=0.2)
            if item is None:
                if stop.is_set():
                    return
                continue
            seq, outputs, _ = item
            led = outputs.led.cpu().numpy()
            scene = outputs.scene_calmness.cpu().numpy()
            tuning = outputs.tuning_inaccuracy.cpu().numpy()
            held.append((seq, time.monotonic(), led[rows], scene[rows], tuning[rows]))
    except BaseException as e:
        errors.append(e)


def program_params(config: dict):
    from pitchvis_tpu_torch.core.config import VqtParameters, VqtRange

    v = config["vqt"]
    return VqtParameters(
        sr=float(v["sr"]), n_fft=int(v["n_fft"]),
        range=VqtRange(min_freq=float(v["min_freq"]), octaves=int(v["octaves"]),
                       buckets_per_octave=int(v["buckets_per_octave"])),
        sparsity_quantile=float(v["sparsity_quantile"]), quality=float(v["quality"]), gamma=float(v["gamma"]),
    )


def run(cell, seed: int, seconds: float, trace: bool, device, fast: bool, result, compare=True) -> None:
    """One run of a live cell; fills ``result`` (benchmark/run.py::Result)."""
    from pitchvis_tpu_torch.runtime.server import StreamServer

    from .trace import Profiler

    cfg, tr = cell.config, cell.traffic
    params = program_params(cfg)
    sr, fps = params.sr, float(cfg["fps"])
    period = 1.0 / fps
    hop = int(sr / fps)  # the server's own rule: int(sr * hop_seconds)
    n_streams = int(tr["streams"])
    rows = audio.sample_streams(seed, n_streams, int(tr["compare"]["streams"]), tr["music"])
    prefill = int(math.ceil(tr["prefill_seconds"] * fps))
    warmup_slots = int(round(tr["warmup_seconds"] * fps))
    n_live = int(math.ceil((tr["warmup_seconds"] + seconds + tr["drain_seconds"]) * fps)) + 4
    music = audio.make_music(seed, n_streams, prefill + n_live, hop, sr, tr["music"], cfg["vqt"], device)
    music.tracks = music.tracks.cpu()

    outputs_cfg = cfg["outputs"]
    server = StreamServer(
        n_streams, params, path=cfg["path"], fast=fast, hop_seconds=(hop + 0.5) / sr,
        with_led=outputs_cfg["with_led"], with_viewer=outputs_cfg["with_viewer"], fetch=outputs_cfg["fetch"],
        device=device,
    )
    max_lag = server._max_lag / sr
    every = int(tr["compare"]["every"])
    rec = Recorder(server, rows, every, int(np.random.default_rng([seed, 4]).integers(0, every)))
    all_ids = np.arange(n_streams, dtype=np.int64)
    for m in range(prefill):
        if not server.push_batch(music.chunks(all_ids, m, 1), all_ids).all():
            raise RuntimeError("push_batch refused a prefill chunk")
    server.step()  # builds the window on the device from the prefill: the first hop of the cell's shapes
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        if trace:
            Profiler.warm()

    result.host_probe()
    result.shapes["period"] = period
    n_prod = min(int(tr["producers"]), n_streams)
    bounds = np.linspace(0, n_streams, n_prod + 1).astype(np.int64)
    logs = [[] for _ in range(n_prod)]
    errors: list = []
    held: list = []
    stop = threading.Event()
    producers = []
    loop = server.serve(rate_hz=fps, pipelined=True)
    consumer = threading.Thread(target=_consumer, args=(loop, rows, stop, held, errors), daemon=True)
    consumer.start()
    if not rec.started.wait(timeout=60):
        raise RuntimeError("the serve loop did not dispatch")
    w0 = rec.t0 + warmup_slots * period
    w1 = w0 + seconds
    end = w1 + tr["drain_seconds"]
    for k in range(n_prod):
        th = threading.Thread(
            target=_producer,
            args=(server, music, int(bounds[k]), int(bounds[k + 1]), prefill, rec, period,
                  float(tr["phase"]), end, logs[k], errors),
            daemon=True,
        )
        th.start()
        producers.append(th)
    result.window_start = w0
    time.sleep(max(0.0, w0 - time.monotonic()))
    result.host_open()
    profiler = None
    if trace:
        # the window's last seconds; the profiler is stopped, and its
        # events read, only once the loop has stopped (reading them holds
        # the interpreter for seconds), and its trace ends with the window
        time.sleep(max(0.0, max(w0, w1 - tr["trace_seconds"]) - time.monotonic()))
        profiler = Profiler(1, until=w1).__enter__()
    time.sleep(max(0.0, w1 - time.monotonic()))
    result.host_close()
    time.sleep(max(0.0, end - time.monotonic()))
    for th in producers:
        th.join()
    time.sleep(3 * period)  # the last chunks' hops are published
    loop.stop()
    stop.set()
    consumer.join()
    if profiler is not None:
        profiler.__exit__(None, None, None)
    if errors:
        raise RuntimeError("a producer or the consumer failed") from errors[0]
    result.memory_peak()

    disp = rec.dispatches
    in_window = [d for d in disp[rec.loop_from:] if w0 <= d.t_in < w1]
    if profiler is not None:
        result.trace = profiler.trace
        quiet = [d for d in in_window if not (profiler.trace.start - 0.1 <= d.t_in <= profiler.trace.end + 0.5)]
    else:
        quiet = in_window
    # host-clock spans outside the profiled part of the window
    result.spans["dispatch"] = [d.t_out - d.t_in for d in quiet]
    result.spans["consume"] = [c[2] - c[1] for d in quiet for c in d.consumes]
    pushes = [p for log in logs for p in log if w0 <= p[1] < w1]
    trace_span = (profiler.trace.start - 0.1, profiler.trace.end + 0.5) if profiler else (0, 0)
    result.spans["push"] = [p[3] - p[2] for p in pushes if not trace_span[0] <= p[2] <= trace_span[1]]
    lateness = np.array([p[2] - p[1] for p in pushes])
    first, last = in_window[0], in_window[-1]
    slots = seconds * fps
    skipped = last.skipped - first.skipped
    quiet_skipped, quiet_slots = _skipped_outside(in_window, trace_span, fps)
    result.counters.update(
        grid_slots=quiet_slots,
        skipped_deadlines=quiet_skipped,
        hops=last.stats["hops"] - first.stats["hops"],
        frozen=last.stats["frozen"] - first.stats["frozen"],
    )
    if profiler is not None:
        traced = [d for d in in_window if profiler.trace.start <= d.t_in <= profiler.trace.end]
        result.counters["traced_hops"] = sum(
            1 + sum(1 for c in d.consumes[1:] if c[0].any()) for d in traced
        )
        result.host_spans = [(d.t_in, d.t_out, "host dispatch") for d in traced] + [
            (c[1], c[2], "host consume") for d in traced for c in d.consumes
        ]
        result.idle_label = "host waits for the grid"

    if rec.loop_from != 1:
        raise RuntimeError("the loop's first dispatch is not the second of the run")
    n_first = int(math.ceil((w0 - rec.t0) / period + tr["phase"]))
    n_last = int(math.ceil((w1 - rec.t0) / period + tr["phase"])) - 1
    ns = np.arange(n_first, n_last + 1)
    due = rec.t0 + ns * period - tr["phase"] * period
    t_end = max(t for _, t, *_ in held) if held else time.monotonic()
    lat = latencies([[c[0] for c in d.consumes] for d in disp], [(s, t) for s, t, *_ in held], ns, due, t_end)
    failed = int(((lat > max_lag) | ~np.isfinite(lat)).sum())
    result.attempted, result.failed = int(lat.size), failed
    result.e2e["latency_p50_ms"] = float(np.percentile(lat, 50) * 1e3)
    result.e2e["latency_p95_ms"] = float(np.percentile(lat, 95) * 1e3)
    result.note(
        f"generator: {len(pushes)} pushes due in the window, late by p50 {np.percentile(lateness, 50) * 1e3:.3f} ms, "
        f"p95 {np.percentile(lateness, 95) * 1e3:.3f} ms, max {lateness.max() * 1e3:.3f} ms, "
        f"{int((lateness > tr['phase'] * period).sum())} after their slot ({n_prod} producers, {n_streams} streams, "
        f"a hop of {hop} samples every {period * 1e3:.3f} ms)")
    # how late each dispatch of the window began after its grid slot, and
    # the dispatches that froze streams (their chunk was not yet pushed)
    late = np.array([(d.t_in - rec.t0) % period for d in in_window])
    late = np.where(late > 0.9 * period, late - period, late)
    frozen_at = [(d.t_in - rec.t0, int((~d.consumes[0][0]).sum())) for d in in_window if not d.consumes[0][0].all()]
    result.note(
        f"loop: dispatches began after their slot by p50 {np.percentile(late, 50) * 1e3:.3f} ms, "
        f"p95 {np.percentile(late, 95) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} ms; host time of a dispatch "
        f"p50 {np.median([d.t_out - d.t_in for d in in_window]) * 1e3:.3f} ms, "
        f"max {max(d.t_out - d.t_in for d in in_window) * 1e3:.3f} ms; dispatches that froze streams "
        f"(s after t0, streams): {frozen_at[:12]}")
    result.note(
        f"loop: {len(in_window)} dispatches in the window of {slots:.0f} grid slots, {skipped} deadlines skipped, "
        f"{result.counters['frozen']} stream-hops frozen, {result.counters['hops'] - (len(in_window) - 1)} catch-up hops; "
        f"consumer held {sum(1 for s, *_ in held if in_window[0].index <= s <= in_window[-1].index)} hops")

    # the comparison: the reference replays the sampled streams from the
    # prefill to the last dispatch compared
    led_held = {s: (led, sc, tu) for s, _, led, sc, tu in held if first.index <= s <= last.index}
    spectra = {d.index: d.smoothed[torch.from_numpy(rows).to(d.smoothed.device)].cpu()
               for d in in_window if d.smoothed is not None}
    dispatch_log = [(d.t_in, d.t_out, d.last_step, [(adv[rows], bool(adv.any()), data, t0, t1)
                                                     for adv, t0, t1, data in d.consumes]) for d in disp]
    producer_of = np.searchsorted(bounds, rows, side="right") - 1
    push_times = [(np.array([p[2] for p in log]), np.array([p[3] for p in log])) for log in logs]
    pushed = prefill + max(p[0] for log in logs for p in log)
    del server, loop, rec, disp, in_window, quiet
    result.free_device()
    if compare:
        result.readings = _compare(cell, music, rows, prefill, pushed, hop, sr, max_lag, dispatch_log,
                                   [push_times[k] for k in producer_of], led_held, spectra, device)


def latencies(advanced: list, held: list, ns: np.ndarray, due: np.ndarray, t_end: float) -> np.ndarray:
    """(streams, len(ns)) seconds from each live chunk's due time to the
    hold of the first published hop that carries it.

    ``advanced[j]`` lists dispatch j's native consumes, each a (B,) bool
    array of the streams it advanced (a catch-up hop is a second consume);
    live chunk n of a stream is carried by the first dispatch after which
    the stream has advanced n times. ``held`` lists (seq, hold time) of the
    hops the consumer held; publish seq j carries dispatch j's result, and a
    hop the consumer skipped over is held with the next one it took. A
    chunk never held reads ``t_end`` minus its due time."""
    n_disp = len(advanced)
    n_streams = len(advanced[0][0])
    counts = np.zeros(n_streams, np.int64)
    carried = np.empty((n_streams, n_disp), np.int64)
    for j, consumes in enumerate(advanced):
        for adv in consumes:
            counts += adv
        carried[:, j] = counts
    hold = np.full(n_disp + 1, np.inf)
    for seq, t_hold in held:
        hold[seq] = min(hold[seq], t_hold)
    for j in range(n_disp - 1, -1, -1):  # the first hold at or after dispatch j
        hold[j] = min(hold[j], hold[j + 1])
    lat = np.empty((n_streams, len(ns)))
    for i in range(n_streams):
        j = np.searchsorted(carried[i], ns, side="left")
        t = hold[np.minimum(j, n_disp)]
        lat[i] = np.where(np.isfinite(t), t, t_end) - due
    return lat


def _skipped_outside(in_window, span, fps) -> tuple[int, float]:
    """(deadlines skipped, grid slots) between dispatches of the window,
    leaving out the stretches that touch the profiled part."""
    skipped, slots = 0, 0.0
    for a, b in zip(in_window, in_window[1:]):
        if b.t_in < span[0] or a.t_in > span[1]:
            skipped += b.skipped - a.skipped
            slots += (b.t_in - a.t_in) * fps
    return skipped, slots


def _consume_outcome(read: int, head: int, hop: int, lag: int) -> tuple[bool, int, int]:
    """What the native consume does to a stream whose read cursor is at
    ``read`` and whose write head is at ``head`` (samples): (advanced, the
    position it reads ``hop`` samples from, the cursor after). A backlog
    beyond ``lag`` samples is skipped: the cursor jumps to ``head - lag``."""
    pos, avail = read, head - read
    if avail > lag:
        pos, avail = head - lag, lag
    if avail >= hop:
        return True, pos, pos + hop
    return False, pos, pos


def _row_matches(row: np.ndarray, ref: np.ndarray) -> bool:
    """The program's consumed row against the reference's samples: the two
    AGCs (float32 against float64) differ by about 1e-5 of the row."""
    return len(ref) == len(row) and np.abs(row - ref).max() <= 1e-3 * (np.abs(ref).max() + 1e-9)


def _compare(cell, music, rows, prefill, pushed, hop, sr, lag, dispatch_log, push_times, led_held, spectra,
             device) -> dict:
    """Replays the sampled streams from the prefill to the last dispatch
    compared and compares the captured spectra and the held LED blocks.

    What each consume read is worked out from the push log alone: a consume
    during [t0, t1] saw every push of the stream's producer that ended
    before t0, and at most those that began before t1; the native consume's
    rule (``_consume_outcome``) then gives its advance and the samples it
    read. Where a push overlapped the consume, each head it allows is an
    outcome; the program's advance and row are only judged against them.
    A consume that matches none counts in ``ingest_off_count``, and the
    replay goes on from the outcome of the fewest pushes."""
    from .reference.chain import Deployment

    ref = Deployment(cell.config, len(rows), vqt_device=device)
    fl = ref.frame_len
    s_count = len(rows)
    hop_dt = float(np.float32(hop / sr))
    lag_samples = int(round(lag * sr))
    raw = music.chunks(rows, 0, pushed).reshape(s_count, pushed, hop)
    signal = agc_chunks(raw)[0].reshape(s_count, -1)  # the audio as the host AGC leaves it, float64
    # each stream's consumed audio: the window built from the prefill, then
    # each consumed chunk; the window of a hop is its last fl samples
    read = [prefill * hop] * s_count
    consumed = [[signal[i, max(0, read[i] - fl) : read[i]]] for i in range(s_count)]
    consumed = [[np.concatenate([np.zeros(fl - len(c[0])), c[0]])] for c in consumed]
    counts = np.zeros(s_count, np.int64)
    positions, dts, last_hop = [], [], {}
    last = max(list(led_held) + list(spectra))
    off = checked = 0
    prev_step = None
    for j, (t_in, t_out, last_step, consumes) in enumerate(dispatch_log[: last + 1]):
        # the time step is the server's own clock reading, which has to lie
        # inside the harness's bracket of the call
        off += not t_in <= last_step <= t_out
        dt0 = 1.0 / 60.0 if prev_step is None else max(last_step - prev_step, 1e-4)
        prev_step = last_step
        for k, (adv, any_adv, data, t0, t1) in enumerate(consumes):
            if k > 0 and not any_adv:  # a catch-up consume that moved no stream computes no hop
                break
            ref_adv = np.zeros(s_count, bool)
            checked += s_count
            for i in range(s_count):
                starts, ends = push_times[i]
                fewest = prefill + int(np.searchsorted(ends, t0, side="left"))
                most = prefill + int(np.searchsorted(starts, t1, side="left"))
                outcomes = [_consume_outcome(read[i], c * hop, hop, lag_samples) for c in range(fewest, most + 1)]
                match = next((o for o in outcomes if o[0] == adv[i]
                              and (not o[0] or _row_matches(data[i].astype(np.float64), signal[i, o[1] : o[1] + hop]))),
                             None)
                if match is None:
                    off += 1
                    match = outcomes[0]
                ref_adv[i], pos, read[i] = match
                if ref_adv[i]:
                    consumed[i].append(signal[i, pos : pos + hop])
            counts = counts + ref_adv
            positions.append(counts.copy())
            dts.append(np.full(s_count, dt0) if k == 0 else np.where(ref_adv, hop_dt, 0.0))
        last_hop[j] = len(positions) - 1
    streams = [torch.from_numpy(np.concatenate(c)) for c in consumed]
    positions = np.array(positions)
    db = []
    for part in np.array_split(np.arange(len(positions)), max(1, len(positions) // 128)):
        frames = torch.stack([streams[i][c * hop : c * hop + fl] for h in part for i, c in enumerate(positions[h])])
        db.append(ref.vqt.db(frames).reshape(len(part), s_count, -1))
    x_vqt = torch.cat(db)
    dt = torch.from_numpy(np.array(dts)).float()
    keep_disp = sorted(set(led_held) | set(spectra))
    out = ref.run(x_vqt, dt, [last_hop[j] for j in keep_disp])
    at = {j: i for i, j in enumerate(keep_disp)}

    spec_js = sorted(spectra)
    gaps = judge.spectrum_gaps(torch.stack([spectra[j] for j in spec_js]),
                               out["analysis"].x_vqt_smoothed[[at[j] for j in spec_js]])
    led_js = sorted(led_held)
    sel = [at[j] for j in led_js]
    program = {
        "led": np.stack([led_held[j][0] for j in led_js]),
        "analysis.scene_calmness": np.stack([led_held[j][1] for j in led_js]),
        "analysis.tuning_inaccuracy": np.stack([led_held[j][2] for j in led_js]),
    }
    reference = {
        "led": out["led"][sel],
        "analysis.scene_calmness": out["analysis"].scene_calmness[sel],
        "analysis.tuning_inaccuracy": out["analysis"].tuning_inaccuracy[sel],
    }
    by_leaf = {}
    off_outputs = judge.off_rows(program, reference, lead=2, by_leaf=by_leaf)
    leaf_gaps = {}
    values = judge.readings(gaps, off_outputs, judge.output_gaps(program, reference, 2, leaf_gaps))
    values["ingest_off_count"] = off
    values["compared"] = (f"{gaps.size} stream-hops of spectra, {off_outputs.size} of served outputs, {s_count} streams, "
                          f"{checked} stream-consumes; off by leaf {by_leaf}; p75 gap by leaf {leaf_gaps}")
    return values
