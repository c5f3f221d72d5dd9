"""The port's ServeLoop (pitchvis_tpu_torch/runtime/loop.py) on the CPU:
publishing, the pipelined tail, one loop per server, error propagation,
stop from the callback, the sync policies and the throughput and cadenced
modes. Every wait has a timeout, and no assertion depends on wall-clock
rates or on counts of skipped deadlines."""

import threading

import numpy as np
import pytest
import torch

from pitchvis_tpu_torch import ServeLoop, StreamServer

from conftest import SMALL_PARAMS
from torch_port_helpers import to_port

WAIT_S = 60.0
HOP = int(SMALL_PARAMS.sr / 60.0)


def tone(seconds=0.8, bin_=30):
    """A sine on VQT bin ``bin_`` of SMALL_PARAMS."""
    rng = SMALL_PARAMS.range
    f = rng.min_freq * 2.0 ** (bin_ / rng.buckets_per_octave)
    t = np.arange(int(SMALL_PARAMS.sr * seconds)) / SMALL_PARAMS.sr
    return (0.1 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def server(n=2, **kw):
    kw.setdefault("buffer_seconds", 2.0)
    return StreamServer(n, to_port(SMALL_PARAMS), device="cpu", **kw)


@pytest.mark.parametrize("pipelined", [False, True])
def test_publishes_and_detects_tone(pipelined):
    srv = server()
    srv.push(0, tone())
    seen = []
    loop = srv.serve(rate_hz=120.0, pipelined=pipelined, on_outputs=lambda s, o, g: seen.append(s))
    assert isinstance(loop, ServeLoop)
    try:
        first = loop.wait_next(timeout=WAIT_S)
        assert first is not None
        later = loop.wait_next(seq=first[0] + 1, timeout=WAIT_S)
        assert later is not None and later[0] >= first[0] + 2
    finally:
        final = loop.stop()
    assert not loop.running and srv._serve_loop is None
    seq, outputs, gains = final
    peaks0 = np.where(outputs.peaks[0].numpy())[0]
    assert len(peaks0) == 1 and abs(peaks0[0] - 30) <= 1
    assert not outputs.peaks[1].any()
    assert gains[0] > 1.0
    # the pipelined tail is published on stop: no dispatched hop is lost
    assert loop.stats["published"] == loop.stats["hops"]
    assert seen == list(range(1, loop.stats["published"] + 1))
    srv.close()


def test_second_serve_rejected_until_stop():
    srv = server(1)
    loop = srv.serve(rate_hz=60.0)
    with pytest.raises(RuntimeError, match="already serving"):
        srv.serve()
    with pytest.raises(RuntimeError, match="serve loop owns"):
        srv.step()
    loop.stop()
    srv.serve(rate_hz=60.0).stop()  # free to serve again
    srv.close()


def test_loop_error_propagates():
    srv = server(1)
    original = srv.step

    def exploding_step(*a, **kw):
        if srv.stats["hops"] >= 1:
            raise ValueError("injected fault")
        return original(*a, **kw)

    srv.step = exploding_step
    loop = srv.serve(rate_hz=200.0, pipelined=True)
    with pytest.raises(RuntimeError, match="serve loop failed"):
        loop.wait_next(seq=10_000, timeout=WAIT_S)
    with pytest.raises(RuntimeError, match="serve loop failed"):
        loop.stop()
    assert isinstance(loop.error, ValueError)
    # the failed loop's in-flight hop must not leak into the next consumer
    assert srv._pending is None
    srv.step = original
    assert srv.step(pipelined=True) is None
    srv.flush()
    srv.close()


def test_wait_next_unblocks_on_stop():
    srv = server(1)
    loop = srv.serve(rate_hz=200.0, pipelined=False)
    results = []
    th = threading.Thread(target=lambda: results.append(loop.wait_next(seq=10_000_000, timeout=WAIT_S)),
                          daemon=True)
    th.start()
    assert loop.wait_next(timeout=WAIT_S) is not None
    loop.stop()
    th.join(timeout=WAIT_S)
    assert not th.is_alive()
    assert results == [None]
    srv.close()


def test_stop_from_on_outputs_callback():
    srv = server(1)
    holder = {}
    handed_over = threading.Event()

    def cb(seq, outputs, gains):
        if seq >= 3:
            # the loop thread may get here before serve() has returned
            handed_over.wait(WAIT_S)
            holder["loop"].stop()

    loop = srv.serve(rate_hz=200.0, pipelined=False, on_outputs=cb)
    holder["loop"] = loop
    handed_over.set()
    loop._thread.join(timeout=WAIT_S)
    assert not loop.running
    final = loop.stop()
    assert final[0] >= 3 and loop.error is None
    with loop:  # the context manager on a stopped loop is a no-op
        pass
    srv.close()


@pytest.mark.parametrize("sync", ["host", "none", "element"])
def test_sync_policies(sync):
    srv = server(1)
    srv.push(0, tone())
    with srv.serve(rate_hz=120.0, sync=sync) as loop:
        seq, outputs, gains = loop.wait_next(timeout=WAIT_S)
    kind = np.ndarray if sync == "host" else torch.Tensor
    assert isinstance(outputs.x_vqt_smoothed, kind) and isinstance(outputs.peaks, kind)
    assert outputs.x_vqt_smoothed.shape == (1, SMALL_PARAMS.n_buckets)
    assert isinstance(gains, np.ndarray)
    srv.close()


def test_throughput_mode():
    """hops_per_dispatch=k publishes the newest hop of each k-hop dispatch;
    the hop counter advances by k a dispatch."""
    srv = server(2)
    srv.push(0, tone(1.5))
    with srv.serve(rate_hz=240.0, hops_per_dispatch=4) as loop:
        first = loop.wait_next(timeout=WAIT_S)
        assert first is not None
    assert loop.stats["hops"] % 4 == 0 and loop.stats["hops"] >= 4
    assert loop.stats["published"] * 4 == loop.stats["hops"]
    assert first[1].x_vqt_smoothed.shape == (2, SMALL_PARAMS.n_buckets)
    with pytest.raises(ValueError, match="ingest='delta'"):
        server(1, ingest="snapshot").serve(hops_per_dispatch=2)
    srv.close()


@pytest.mark.parametrize("pipelined", [False, True])
def test_cadenced_mode_publishes_every_hop_in_order(pipelined):
    """publish="per_hop" publishes every hop of each dispatch, in order,
    each one equal to the same hop of step_multi(k, per_hop=True) on a twin
    server fed the same audio."""
    k = 3
    audio = tone(0.5)
    srv, twin = server(1), server(1)
    for s in (srv, twin):
        s.push(0, audio)
    seen = []
    with srv.serve(rate_hz=240.0, pipelined=pipelined, hops_per_dispatch=k, publish="per_hop",
                   on_outputs=lambda s, o, g: seen.append((s, o))) as loop:
        assert loop.wait_next(seq=2 * k, timeout=WAIT_S) is not None
    assert [s for s, _ in seen] == list(range(1, len(seen) + 1))
    assert loop.stats["published"] == loop.stats["hops"] == len(seen)
    # the twin's first dispatch, hop by hop (no audio arrives after the
    # warm-up, so every later hop is frozen and the loop's timing does not
    # change what a hop computes)
    want, _ = twin.step_multi(k, per_hop=True)
    for i in range(k):
        assert torch.equal(seen[i][1].x_vqt_smoothed, want[i].x_vqt_smoothed)
    with pytest.raises(ValueError):
        twin.serve(publish="every")
    srv.close()
    twin.close()


def test_control_plane_during_serve():
    """push, reset_stream and retune_analysis from the control thread while
    the loop steps; the loop keeps publishing."""
    srv = server(2)
    srv.push(0, tone())
    srv.push(1, tone(bin_=50))
    with srv.serve(rate_hz=200.0) as loop:
        seq = loop.wait_next(timeout=WAIT_S)[0]
        srv.reset_stream(1)
        srv.push(0, tone(0.05))
        srv.retune_analysis(srv.analysis_params)
        assert loop.wait_next(seq=seq + 2, timeout=WAIT_S) is not None
    assert loop.error is None
    srv.close()
