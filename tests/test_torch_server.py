"""The port's serving runtime (pitchvis_tpu_torch/runtime/) against the JAX
package's on the CPU: the native ring and resampler banks call for call,
StreamServer hop for hop on the same pushes with pinned dt, and the port's
server against itself (step_multi, per_hop, pipelining, delta against
snapshot, resets, rebuild, retune). The port's native library is built by
g++ at first use into build/pitchvis_tpu_torch/."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pitchvis_tpu.runtime import native as jax_native_mod
from pitchvis_tpu.ops.resample import _design_prototype as jax_prototype
from pitchvis_tpu.runtime.server import StreamServer as JaxServer
from pitchvis_tpu_torch import StreamServer
from pitchvis_tpu_torch.core.config import AnalysisParameters
from pitchvis_tpu_torch.models.pitch_mlp import PitchMLP
from pitchvis_tpu_torch.ops.resample import _design_prototype, make_spec
from pitchvis_tpu_torch.parallel.sharding import make_mesh
from pitchvis_tpu_torch.runtime import native

from conftest import SMALL_PARAMS
from torch_port_helpers import jax_native_lib, streams, to_port  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("jax_native_lib")

SR = int(SMALL_PARAMS.sr)
HOP = int(SMALL_PARAMS.sr / 60.0)  # the server's hop at the default hop_seconds
DT = HOP / SMALL_PARAMS.sr
B = 3
HOPS = 22
BURST_AT = 8


def port_server(**kw):
    kw.setdefault("buffer_seconds", 1.0)
    return StreamServer(B, to_port(SMALL_PARAMS), device="cpu", **kw)


def feed(n_hops=HOPS, seed=0):
    """The pushes of one serving run, as a list per hop of (kind, args):
    a 0.5 s warm-up, then per hop one chunk for streams 0 and 1 by
    push_batch and 2 x HOP samples at 44.1 kHz for stream 2 by push(sr=).
    Stream 0's chunk at hop 5 holds a NaN (rejected: the stream underruns
    that hop); stream 1 sends three hops at once at BURST_AT and nothing for
    the two hops after (one catch-up hop drains the backlog); stream 1 is
    silent at hops 14-15."""
    warm = SR // 2
    total = warm + (n_hops + 3) * HOP
    a = streams(2, total, SMALL_PARAMS.sr, seed=seed)
    mic = streams(1, 2 * total, 2 * SMALL_PARAMS.sr, seed=seed + 1)[0]
    plan = [[("batch", a[:, :warm], None), ("mic", mic[: 2 * warm])]]
    pos = warm
    for h in range(n_hops):
        chunk = a[:, pos : pos + HOP].copy()
        if h == 5:
            chunk[0, 17] = np.nan
        if h in (14, 15):
            chunk[1] = 0.0
        steps = []
        if h == BURST_AT:
            steps.append(("batch", a[1:2, pos : pos + 3 * HOP], np.array([1])))
            steps.append(("batch", chunk[:1], np.array([0])))
        elif h in (BURST_AT + 1, BURST_AT + 2):
            steps.append(("batch", chunk[:1], np.array([0])))
        else:
            steps.append(("batch", chunk, None))
        steps.append(("mic", mic[2 * pos : 2 * (pos + HOP)]))
        plan.append(steps)
        pos += HOP
    return plan


def apply(server, steps):
    for kind, *args in steps:
        if kind == "batch":
            samples, ids = args
            server.push_batch(samples, streams=ids)
        else:
            server.push(2, args[0], sr=2 * SR)


def assert_outputs_close(to, jo, what=""):
    """The tolerances of tests/test_torch_pipeline.py::test_hop_matches_jax:
    continuous outputs atol 1e-3 where the peaks agree; returns the number
    of flipped peak bins and the bins compared."""
    jpk = np.asarray(jo.peaks)
    tpk = to.peaks.numpy()
    agree = jpk == tpk
    for name in ("x_vqt_smoothed", "x_vqt_afterglow", "calmness", "peak_center", "peak_size",
                 "pitch_accuracy", "pitch_deviation"):
        np.testing.assert_allclose(getattr(to, name).numpy()[agree], np.asarray(getattr(jo, name))[agree],
                                   atol=1e-3, err_msg=f"{name} {what}")
    for name in ("scene_calmness", "tuning_inaccuracy"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)), atol=1e-3,
                                   err_msg=f"{name} {what}")
    return int((~agree).sum()), agree.size


def assert_equal_outputs(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


# ---------------------------------------------------------------------------
# native banks, call for call
# ---------------------------------------------------------------------------


def test_ring_bank_matches_jax():
    """Every call of the port's NativeRingBank returns what the JAX one
    returns on the same inputs: writes with AGC and without, a batch with a
    rejected row, snapshot, consume (underrun, max_lag skip-ahead, out=),
    snapshot_consume, reset, export/import."""
    rng = np.random.default_rng(3)
    banks = [native.NativeRingBank(4, 1000), jax_native_mod.NativeRingBank(4, 1000)]

    def both(method, *args, **kw):
        got, want = (getattr(b, method)(*args, **kw) for b in banks)
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            np.testing.assert_array_equal(g, w, err_msg=method)
        return got

    for s in range(4):
        both("write", s, (rng.standard_normal(300 + 50 * s) * 0.2).astype(np.float32))
    both("write", 1, (rng.standard_normal(64) * 0.2).astype(np.float32), agc=False)
    batch = (rng.standard_normal((3, 200)) * 0.2).astype(np.float32)
    batch[1, 7] = np.nan
    ok = both("write_batch", np.array([3, 0, 2]), batch)
    assert ok.tolist() == [True, False, True]
    both("snapshot", 256)
    both("snapshot_consume", 128)
    both("write_batch", None, (rng.standard_normal((4, 150)) * 0.2).astype(np.float32))
    both("write", 2, (rng.standard_normal(100) * 0.2).astype(np.float32))
    _, _, adv = both("consume", 120)
    assert adv.all()
    _, _, adv = both("consume", 120)  # 30 left on three streams, 130 on stream 2
    assert adv.tolist() == [False, False, True, False]
    both("write", 0, (rng.standard_normal(900) * 0.2).astype(np.float32))
    out = np.zeros((4, 120), np.float32)
    got = banks[0].consume(120, 300, out=out)
    want = banks[1].consume(120, 300)
    assert got[0] is out
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for s in range(4):
        assert banks[0].written(s) == banks[1].written(s)
        assert banks[0].gain(s) == banks[1].gain(s)
    both("reset", 1)
    both("consume", 50)
    image = both("export_state")
    fresh = [native.NativeRingBank(4, 1000), jax_native_mod.NativeRingBank(4, 1000)]
    for f in fresh:
        f.import_state(*image)
    np.testing.assert_array_equal(fresh[0].snapshot(1000)[0], fresh[1].snapshot(1000)[0])
    np.testing.assert_array_equal(fresh[0].export_state()[1], image[1])
    with pytest.raises(ValueError):
        banks[0].write(4, np.zeros(3, np.float32))
    for b in banks + fresh:
        b.close()


def test_native_build_from_six_processes_at_once(tmp_path):
    """Six processes ask for the native library at once, with an empty
    build directory: each one loads it, and one build lands there (the
    others wait on the lock and find it)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import ctypes, sys\n"
        "from pitchvis_tpu_torch.utils import host_build\n"
        "host_build.BUILD_DIR = sys.argv[1]\n"
        "ctypes.CDLL(host_build.library_path('pitchvis_native')).pv_rb_create\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(6)]
    for proc in procs:
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out
    built = sorted(os.listdir(tmp_path))
    libs = [n for n in built if n.endswith(".so")]
    assert len(libs) == 1 and libs[0].startswith("libpitchvis_native_host_"), built
    assert not any(n.endswith(".tmp") for n in built), built


def test_agc_process_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(2000) * 0.3).astype(np.float32)
    for frozen in (False, True):
        a, b = x.copy(), x.copy()
        ga = native.agc_process(1.3, a, 0.07, 1e-4, frozen)
        gb = jax_native_mod.agc_process(1.3, b, 0.07, 1e-4, frozen)
        assert ga == gb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sr_in", [44100, 48000])
def test_resampler_matches_jax(sr_in):
    """The prototype filter equals the JAX package's, and the native
    resampler bank gives the same samples on ragged chunks."""
    spec = make_spec(sr_in, SR)
    np.testing.assert_array_equal(_design_prototype(spec.l, spec.m, 24), jax_prototype(spec.l, spec.m, 24))
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(9000) * 0.3).astype(np.float32)
    port = native.NativeResamplerBank(2, sr_in, SR)
    ref = jax_native_mod.NativeResamplerBank(2, sr_in, SR)
    cuts = np.cumsum(rng.integers(1, 900, 20))
    for stream in (0, 1):
        for chunk in np.split(x, cuts[cuts < len(x)]):
            np.testing.assert_array_equal(port.process(stream, chunk), ref.process(stream, chunk))
    port.reset(1)
    ref.reset(1)
    np.testing.assert_array_equal(port.process(1, x[:777]), ref.process(1, x[:777]))
    port.close()
    ref.close()


# ---------------------------------------------------------------------------
# the server against the JAX server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ingest", ["delta", "snapshot"])
@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("path", ["time", "pallas"])
def test_server_matches_jax(path, fast, ingest):
    """The same pushes (a NaN chunk, a three-hop burst drained by catch-up
    hops, silence, one 44.1 kHz stream) through both servers, dt pinned:
    gains and stats equal (one native code on both sides), outputs within
    the pipeline test's tolerances, at most 2e-4 of the peak bins flipped."""
    kw = dict(buffer_seconds=1.0, path=path, fast=fast, ingest=ingest)
    jax_srv = JaxServer(B, SMALL_PARAMS, **kw)
    srv = port_server(**{k: v for k, v in kw.items() if k != "buffer_seconds"})
    flips = total = 0
    try:
        for h, steps in enumerate(feed()):
            apply(jax_srv, steps)
            apply(srv, steps)
            if h == 0:
                continue
            jo, jg = jax_srv.step(dt=DT)
            to, tg = srv.step(dt=DT)
            np.testing.assert_array_equal(tg, jg, err_msg=f"gains, hop {h}")
            f, n = assert_outputs_close(to, jo, f"hop {h}")
            flips += f
            total += n
            assert srv.stats == jax_srv.stats, f"hop {h}"
        assert flips <= 2e-4 * total
        assert to.peaks.any()
        if ingest == "delta":
            assert srv.stats["catchup_hops"] == 1 and srv.stats["frozen"] > 0
    finally:
        jax_srv.close()
        srv.close()


# ---------------------------------------------------------------------------
# the server against itself
# ---------------------------------------------------------------------------


def warmed(**kw):
    srv = port_server(**kw)
    for steps in feed(n_hops=0):
        apply(srv, steps)
    srv.step(dt=DT)
    return srv


def hop_chunks(n, seed=7):
    a = streams(B, n * HOP, SMALL_PARAMS.sr, seed=seed)
    return [a[:, i * HOP : (i + 1) * HOP] for i in range(n)]


@pytest.mark.parametrize("per_hop", [False, True])
def test_step_multi_equals_steps(per_hop):
    """step_multi(k) equals k step() calls fed the same audio at audio-clock
    pacing; per_hop=True returns each of those hops."""
    k = 4
    multi, single = warmed(), warmed()
    try:
        chunks = hop_chunks(k)
        for c in chunks:
            multi.push_batch(c)
        singles = []
        for c in chunks:
            single.push_batch(c)
            singles.append(single.step(dt=DT))
        outs, gains = multi.step_multi(k, per_hop=per_hop)
        if per_hop:
            assert len(outs) == k and gains.shape == (k, B)
            for i in range(k):
                assert_equal_outputs(outs[i], singles[i][0])
            # each hop's gains are the ring's when it was consumed: here all
            # k hops were pushed before the first consume
            np.testing.assert_array_equal(gains[-1], singles[-1][1])
        else:
            assert_equal_outputs(outs, singles[-1][0])
            np.testing.assert_array_equal(gains, singles[-1][1])
        assert torch.equal(multi._window, single._window)
        assert multi.stats["hops"] == single.stats["hops"]
    finally:
        multi.close()
        single.close()


def test_pipelined_equals_unpipelined():
    plain, piped = warmed(), warmed()
    try:
        results = []
        for c in hop_chunks(5):
            plain.push_batch(c)
            piped.push_batch(c)
            want = plain.step(dt=DT)
            got = piped.step(pipelined=True, dt=DT)
            results.append((got, want))
        assert results[0][0] is None
        for (got, _), (_, want) in zip(results[1:], results[:-1]):
            assert_equal_outputs(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        tail = piped.flush()
        assert_equal_outputs(tail[0], results[-1][1][0])
        assert piped.flush() is None
    finally:
        plain.close()
        piped.close()


def test_delta_equals_snapshot():
    """Rate-matched pushes: the rolled window equals the re-sent trailing
    window bit for bit, including a stream whose producer stops (freeze)."""
    servers = {ingest: warmed(ingest=ingest) for ingest in ("delta", "snapshot")}
    try:
        for i, c in enumerate(hop_chunks(6)):
            for srv in servers.values():
                srv.push_batch(c if i < 3 else c[:2], streams=None if i < 3 else np.array([0, 1]))
            outs = {k: srv.step(dt=DT) for k, srv in servers.items()}
            assert_equal_outputs(outs["delta"][0], outs["snapshot"][0])
            np.testing.assert_array_equal(outs["delta"][1], outs["snapshot"][1])
    finally:
        for srv in servers.values():
            srv.close()


@pytest.mark.parametrize("mid_flight", [False, True], ids=["between_hops", "mid_flight"])
@pytest.mark.parametrize("ingest", ["delta", "snapshot"])
def test_reset_row_equals_fresh_server(ingest, mid_flight):
    """After reset_stream(1), row 1 equals a fresh server's row on the same
    later audio, also when the reset lands while a hop is in flight (after
    its capture, before its write-back); row 0 keeps its carries."""
    srv = warmed(ingest=ingest)
    fresh = port_server(ingest=ingest)
    try:
        before = srv.analysis_state.x_vqt_smoothed.clone()
        if mid_flight:
            read = "consume" if ingest == "delta" else "snapshot"
            real = getattr(srv.rings, read)

            def racing(*args, **kw):
                setattr(srv.rings, read, real)
                srv.reset_stream(1)
                return real(*args, **kw)

            setattr(srv.rings, read, racing)
            srv.step(dt=DT)
            assert float(srv.analysis_state.x_vqt_smoothed[1].abs().max()) == 0.0
            assert float(srv.analysis_state.x_vqt_smoothed[0].abs().max()) > 0.0
        else:
            srv.reset_stream(1)
            assert float(srv.analysis_state.x_vqt_smoothed[1].abs().max()) == 0.0
            assert torch.equal(srv.analysis_state.x_vqt_smoothed[0], before[0])
            if ingest == "delta":
                assert float(srv._window[1].abs().max()) == 0.0
        # the fresh server's first step materializes its window from the
        # ring, which then holds exactly what the reset row rolled in
        for c in hop_chunks(4, seed=9):
            srv.push_batch(c[1:2], streams=np.array([1]))
            fresh.push_batch(c[1:2], streams=np.array([1]))
            out, gains = srv.step(dt=DT)
            want, want_gains = fresh.step(dt=DT)
            for f in dataclasses.fields(out):
                assert torch.equal(getattr(out, f.name)[1], getattr(want, f.name)[1]), f.name
            assert gains[1] == want_gains[1]
    finally:
        srv.close()
        fresh.close()


def test_rebuild_rematerializes_window():
    """A rebuild invalidates the window; the next step re-materializes it
    from the ring and keeps matching snapshot mode exactly."""
    servers = {ingest: warmed(ingest=ingest) for ingest in ("delta", "snapshot")}
    new = dataclasses.replace(to_port(SMALL_PARAMS), quality=SMALL_PARAMS.quality * 1.1)
    try:
        chunks = hop_chunks(4)
        for i, c in enumerate(chunks):
            if i == 2:
                for srv in servers.values():
                    srv.rebuild(new)
                assert servers["delta"]._window is None
            for srv in servers.values():
                srv.push_batch(c)
            outs = {k: srv.step(dt=DT) for k, srv in servers.items()}
            assert_equal_outputs(outs["delta"][0], outs["snapshot"][0])
        assert servers["delta"].stats["materializations"] == 2
        assert servers["delta"].vqt_params == new
        with pytest.raises(ValueError):
            servers["delta"].rebuild(dataclasses.replace(new, sr=44100.0))
    finally:
        for srv in servers.values():
            srv.close()


def test_retune_analysis_keeps_carries():
    srv = warmed()
    try:
        srv.push_batch(hop_chunks(1)[0])
        srv.step(dt=DT)
        carried = srv.analysis_state
        ap = dataclasses.replace(AnalysisParameters(), note_calmness_smoothing_duration=7.0)
        srv.retune_analysis(ap)
        assert srv.analysis_state is carried and srv._plan.analysis_params == ap
        srv.push_batch(hop_chunks(2)[1])
        out, _ = srv.step(dt=DT)
        assert torch.isfinite(out.calmness).all()
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# options, devices, validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("option", [
    dict(ml_model="PitchMLP"), dict(with_led=True), dict(with_viewer=True), dict(fetch="led"), dict(mesh="cpu x 2"),
])
def test_unported_options_raise(option):
    """Every option of the JAX server is ported now and serves a hop with
    its outputs: the ML stage (ml_model=), the output stages (with_led,
    with_viewer, fetch="led"; tests/test_torch_ml.py and
    tests/test_torch_outputs.py hold them against the JAX server) and mesh=
    (two virtual CPU slots; tests/test_torch_parallel.py holds it against
    the JAX server's mesh)."""
    if "mesh" in option:
        option = dict(mesh=make_mesh(2, device="cpu"))
    if "ml_model" in option:
        option = dict(ml_model=PitchMLP(input_bins=5 * SMALL_PARAMS.n_buckets, mlp_size=16, mlp_layers=1,
                                        device="cpu"))
    srv = StreamServer(2, to_port(SMALL_PARAMS), buffer_seconds=1.0, device="cpu", **option)
    try:
        srv.push_batch(streams(2, int(SMALL_PARAMS.sr * 0.5), SMALL_PARAMS.sr, seed=4))
        out, _ = srv.step(dt=DT)
        if "ml_model" in option:
            # the default history window is the training window, T=5
            assert tuple(out.ml_midi.shape) == (2, 128) and out.led is None
            assert tuple(srv.ml_state.history.shape) == (2, 5, SMALL_PARAMS.n_buckets)
            return
        if "mesh" in option:
            assert out.peaks.devices == (torch.device("cpu"),) * 2 and out.peaks.shape == (2, SMALL_PARAMS.n_buckets)
            return
        assert (out.led is not None) == (option != dict(with_viewer=True))
        if "with_viewer" in option:
            assert out.viewer.balls.position.shape == (2, SMALL_PARAMS.n_buckets, 3)
        if "fetch" in option:
            assert type(out).__name__ == "CompactOutputs" and srv.with_led
    finally:
        srv.close()


def test_validation():
    with pytest.raises(ValueError):
        StreamServer(2, to_port(SMALL_PARAMS), ingest="bulk", device="cpu")
    with pytest.raises(ValueError):
        StreamServer(2, to_port(SMALL_PARAMS), hop_seconds=5.0, buffer_seconds=0.1, device="cpu")
    srv = port_server(ingest="snapshot")
    try:
        with pytest.raises(RuntimeError, match="delta"):
            srv.step_multi(2)
        with pytest.raises(ValueError):
            srv.push_batch(np.zeros((2, 5), np.float32), streams=np.array([0, 3]))
        with pytest.raises(ValueError):
            srv.push_batch(np.zeros(5, np.float32))
    finally:
        srv.close()
