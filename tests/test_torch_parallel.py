"""The port's multi-device layer (pitchvis_tpu_torch/parallel/sharding.py,
StreamServer(mesh=), restore_server(mesh=), the sharded render) against the
JAX package's on the CPU: JAX over make_mesh(8) on its eight virtual CPU
devices (tests/conftest.py), its Pallas kernels in interpret mode; the port
over make_mesh(8, device="cpu"), eight virtual CPU slots running the
kernels' plain versions.

Tolerances: against the JAX package, those of
tests/test_torch_pipeline.py::test_hop_matches_jax (at most 2e-4 of the
peak bins flipped, continuous outputs atol 1e-3 where the peaks agree,
gains and stats equal). Against the port's own unsharded paths: equal
(torch.equal), since every stage computes each row alone, over meshes of
two rows a slot (EQ_SLOTS): at one row the CPU's BLAS computes the VQT's
product by another kernel (a matrix-vector product), which moves the dB
spectra by up to 6e-5; from two rows on the rows' bits do not depend on
the batch (the card's VQT kernel computes each row alone at any count).
"""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pitchvis_tpu.kernel.builder import get_kernel as jax_get_kernel
from pitchvis_tpu.models.pipeline import init_pipeline_state as jax_init_pipeline_state
from pitchvis_tpu.ops.vqt import make_vqt_arrays as jax_make_vqt_arrays
from pitchvis_tpu.parallel import sharding as jsh
from pitchvis_tpu.runtime.server import StreamServer as JaxServer
from pitchvis_tpu_torch import StreamServer, get_kernel, init_pipeline_state, make_vqt_arrays, pipeline_step
from pitchvis_tpu_torch.models import render as tr
from pitchvis_tpu_torch.models.pipeline import pipeline_step_multi
from pitchvis_tpu_torch.ops.vqt import VqtArrays, vqt_db_batch
from pitchvis_tpu_torch.parallel.sharding import (
    Mesh,
    Replicated,
    Sharded,
    gather,
    make_mesh,
    make_multihost_mesh,
    make_sharded_pipeline_step,
    map_shards,
    multihost_stream_sharding,
    no_collectives,
    replicate,
    shard_batch,
    stream_sharding,
)
from pitchvis_tpu_torch.runtime.checkpoint import restore_server, save_server_state

from conftest import SMALL_PARAMS
from test_torch_server import assert_outputs_close
from torch_port_helpers import jax_native_lib, streams, to_port  # noqa: F401 (fixture)

P = to_port(SMALL_PARAMS)
SR = int(SMALL_PARAMS.sr)
HOP = int(SMALL_PARAMS.sr / 60.0)
DT = HOP / SMALL_PARAMS.sr
B = 8
EQ_SLOTS = 4  # two rows a slot: the meshes held to torch.equal


def cpu_mesh(n=8, **kw):
    return make_mesh(n, device="cpu", **kw)


def assert_trees_equal(got, want, what=""):
    """Every tensor leaf of ``got`` (Sharded leaves gathered) equals
    ``want``'s."""
    got = gather(got)
    if want is None or isinstance(want, torch.Tensor):
        assert (got is None and want is None) or torch.equal(got, want), what
        return
    if isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{what}[{i}]")
        return
    for f in dataclasses.fields(want):
        assert_trees_equal(getattr(got, f.name), getattr(want, f.name), f"{what}.{f.name}")


# ---------------------------------------------------------------------------
# meshes, placements, sharded values
# ---------------------------------------------------------------------------


def test_mesh_and_placement():
    """shard_batch splits the rows into one contiguous slice a slot, as the
    JAX package's stream sharding does."""
    mesh = cpu_mesh(4)
    assert mesh.size == 4 and mesh.shape == {"dp": 4} and mesh.axis_names == ("dp",)
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    xs = shard_batch(mesh, x)
    assert isinstance(xs, Sharded) and xs.shape == (8, 16) and len(xs.devices) == 4
    jx = jsh.shard_batch(jsh.make_mesh(4), x)
    assert len(jx.sharding.device_set) == 4
    want = sorted((s.index[0].start, np.asarray(s.data).tolist()) for s in jx.addressable_shards)
    got = [(2 * i, p.numpy().tolist()) for i, p in enumerate(xs.shards)]
    assert got == want
    np.testing.assert_array_equal(np.asarray(xs), x)
    assert torch.equal(xs[5], torch.from_numpy(x[5])) and xs.locate(5) == (2, 1)
    k = shard_batch(mesh, np.zeros((3, 8, 5), np.float32), dim=1)
    assert k.shape == (3, 8, 5) and k[1].shape == (8, 5) and k[1].axis == 0


def test_mesh_validation():
    with pytest.raises(ValueError, match="split evenly"):
        shard_batch(cpu_mesh(4), np.zeros((6, 2), np.float32))
    with pytest.raises(ValueError, match="axis names"):
        Mesh([torch.device("cpu")] * 2, ("hosts", "dp"))
    with pytest.raises(ValueError, match="every mesh axis"):
        stream_sharding(cpu_mesh(2), axis_name="streams")
    assert stream_sharding(cpu_mesh(2, axis_name="streams"), axis_name="streams").mesh.axis_names == ("streams",)
    assert make_mesh(device="cpu").size == 1


def test_replicate():
    mesh = cpu_mesh(4)
    tree = {"w": torch.ones(3, 3)}
    rep = replicate(mesh, tree)
    assert isinstance(rep, Replicated) and rep.devices == mesh.local_devices
    assert torch.equal(rep.on(torch.device("cpu"))["w"], tree["w"])
    jrep = jsh.replicate(jsh.make_mesh(4), {"w": np.ones((3, 3), np.float32)})
    assert len(jrep["w"].sharding.device_set) == len(rep.devices)


def test_sharded_vqt_matches_single_device(small_kernel):
    """The dense VQT over eight slots matches one device and the JAX
    package's sharded VQT."""
    from pitchvis_tpu.ops.vqt import VqtArrays as JaxVqtArrays, vqt_db_batch as jax_vqt_db_batch
    from pitchvis_tpu.utils.signal import create_sines_batch

    x = create_sines_batch(SMALL_PARAMS, [[110.0 * 2 ** (i / 8)] for i in range(8)]).astype(np.float32)
    arrays = VqtArrays.from_kernel(get_kernel(P), device="cpu")
    ref = vqt_db_batch(arrays, torch.from_numpy(x))
    mesh = cpu_mesh()
    out = map_shards(vqt_db_batch, replicate(mesh, arrays), shard_batch(mesh, x))
    assert len(out.devices) == 8
    # the dense path is one product over the batch, and the CPU's BLAS takes
    # another kernel for one row than for eight: the JAX test's own atol
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)
    jmesh = jsh.make_mesh(8)
    jout = jax.jit(jax_vqt_db_batch)(jsh.replicate(jmesh, JaxVqtArrays.from_kernel(small_kernel)),
                                     jsh.shard_batch(jmesh, x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-3)


# ---------------------------------------------------------------------------
# make_sharded_pipeline_step
# ---------------------------------------------------------------------------


def _step_inputs(batch, seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (batch, HOP) if k is None else (k, batch, HOP)
    chunk = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    dt_b = rng.uniform(1 / 70, 1 / 50, batch).astype(np.float32)
    return chunk, dt_b


@pytest.mark.parametrize("per_stream_dt", [False, True], ids=["scalar_dt", "per_stream_dt"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_sharded_pipeline_step_matches_jax_and_unsharded(multi, per_stream_dt):
    """make_sharded_pipeline_step (path="pallas", bf16): outputs stay
    sharded (the hop axis of ``multi`` not split), equal the unsharded
    pipeline_step, and match the JAX package's sharded step over eight
    devices; a per-stream dt splits with the batch."""
    k = 3 if multi else None
    chunk, dt_b = _step_inputs(B, seed=7, k=k)
    dt = dt_b if per_stream_dt else 1.0 / 60.0
    mesh = cpu_mesh(EQ_SLOTS)
    arrays = make_vqt_arrays(get_kernel(P), path="pallas", fast=True, device="cpu")
    state0 = init_pipeline_state(B, P, device="cpu")
    step = make_sharded_pipeline_step(mesh, multi=multi, vqt_params=P, path="pallas")
    state, out = step(replicate(mesh, arrays), shard_batch(mesh, state0), shard_batch(mesh, chunk, dim=1 if multi else 0),
                      dt)
    x_vqt = out.analysis.x_vqt_smoothed
    assert isinstance(x_vqt, Sharded) and len(x_vqt.devices) == EQ_SLOTS and x_vqt.axis == (1 if multi else 0)
    base = pipeline_step_multi if multi else pipeline_step
    ref_state, ref = base(arrays, state0, torch.from_numpy(chunk), torch.from_numpy(dt_b) if per_stream_dt else dt,
                          vqt_params=P, path="pallas")
    assert_trees_equal(state, ref_state, "state")
    assert_trees_equal(out, ref, "outputs")

    jmesh = jsh.make_mesh(8)
    jarrays = jax_make_vqt_arrays(jax_get_kernel(SMALL_PARAMS), path="pallas", fast=True)
    jstep = jsh.make_sharded_pipeline_step(jmesh, multi=multi, vqt_params=SMALL_PARAMS, path="pallas")
    jstate = jax.tree.map(lambda a: jsh.shard_batch(jmesh, np.asarray(a)), jax_init_pipeline_state(B, SMALL_PARAMS))
    jchunk = jax.device_put(chunk, jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(None, "dp"))) \
        if multi else jsh.shard_batch(jmesh, chunk)
    jdt = jsh.shard_batch(jmesh, dt_b) if per_stream_dt else jnp.float32(dt)
    _, jout = jstep(jsh.replicate(jmesh, jarrays), jstate, jchunk, jdt)
    jo, to = (jout, out) if not multi else (jax.tree.map(lambda a: a[-1], jout), None)
    if multi:
        to = type(out.analysis)(**{f.name: getattr(out.analysis, f.name)[k - 1]
                                   for f in dataclasses.fields(out.analysis)})
        flips, total = assert_outputs_close(gather(to), jo.analysis)
    else:
        flips, total = assert_outputs_close(gather(out.analysis), jo.analysis)
    assert flips <= 2e-4 * total


def test_multihost_mesh_on_one_host():
    mesh = make_multihost_mesh(n_devices=4, device="cpu")
    assert mesh.devices.shape == (1, 4) and mesh.axis_names == ("hosts", "dp")
    x = multihost_stream_sharding(mesh).put(np.zeros((16, 8), np.float32))
    assert len(x.devices) == 4 and x.fully_addressable and x.shape == (16, 8)
    jmesh = jsh.make_multihost_mesh()
    assert jmesh.devices.shape[0] == mesh.devices.shape[0] and jmesh.axis_names == mesh.axis_names


# ---------------------------------------------------------------------------
# StreamServer(mesh=)
# ---------------------------------------------------------------------------


def mesh_feed(n_hops, seed=0):
    """The pushes of one serving run over B=8 streams, as a list per hop of
    (ids, samples, mic): a 0.5 s warm-up, then per hop one chunk for every
    stream but 2 by push_batch, and 2 x HOP samples at 44.1 kHz for stream
    2 by push(sr=). Stream 0's chunk at hop 5 holds a NaN; stream 5 sends
    three hops at once at hop 8 and nothing for the two after; stream 3 is
    silent at hops 14-15."""
    warm = SR // 2
    total = warm + (n_hops + 3) * HOP
    a = streams(B, total, SMALL_PARAMS.sr, seed=seed)
    mic = streams(1, 2 * total, 2 * SMALL_PARAMS.sr, seed=seed + 1)[0]
    rest = np.array([s for s in range(B) if s != 2])
    plan = [[(rest, a[rest, :warm]), ("mic", mic[: 2 * warm])]]
    pos = warm
    for h in range(n_hops):
        chunk = a[:, pos : pos + HOP].copy()
        if h == 5:
            chunk[0, 17] = np.nan
        if h in (14, 15):
            chunk[3] = 0.0
        if h == 8:
            steps = [(np.array([5]), a[5:6, pos : pos + 3 * HOP])]
            ids = rest[rest != 5]
        elif h in (9, 10):
            steps, ids = [], rest[rest != 5]
        else:
            steps, ids = [], rest
        steps.append((ids, chunk[ids]))
        steps.append(("mic", mic[2 * pos : 2 * (pos + HOP)]))
        plan.append(steps)
        pos += HOP
    return plan


def mesh_apply(server, steps):
    for ids, samples in steps:
        if isinstance(ids, str):
            server.push(2, samples, sr=2 * SR)
        else:
            server.push_batch(samples, streams=ids)


def port_server(mesh=None, **kw):
    kw.setdefault("buffer_seconds", 1.0)
    return StreamServer(B, P, mesh=mesh, device="cpu", **kw)


@pytest.mark.usefixtures("jax_native_lib")
def test_sharded_server_matches_jax_sharded_server():
    """The same pushes (a NaN chunk, a three-hop burst drained by a catch-up
    hop, silence, one 44.1 kHz stream) through the port's and the JAX
    package's servers over eight devices, dt pinned: gains and stats equal,
    outputs within the pipeline test's tolerances, sharded over eight."""
    kw = dict(buffer_seconds=1.0, path="pallas", fast=True)
    jax_srv = JaxServer(B, SMALL_PARAMS, mesh=jsh.make_mesh(8), **kw)
    srv = port_server(cpu_mesh(), path="pallas", fast=True)
    flips = total = 0
    try:
        for h, steps in enumerate(mesh_feed(20)):
            mesh_apply(jax_srv, steps)
            mesh_apply(srv, steps)
            if h == 0:
                continue
            jo, jg = jax_srv.step(dt=DT)
            to, tg = srv.step(dt=DT)
            np.testing.assert_array_equal(tg, jg, err_msg=f"gains, hop {h}")
            f, n = assert_outputs_close(gather(to), jo, f"hop {h}")
            flips += f
            total += n
            assert srv.stats == jax_srv.stats, f"hop {h}"
        assert flips <= 2e-4 * total
        assert len(to.peaks.devices) == 8 and len(jo.peaks.sharding.device_set) == 8
        assert srv.stats["catchup_hops"] == 1 and srv.stats["frozen"] > 0
    finally:
        jax_srv.close()
        srv.close()


@pytest.mark.parametrize("ingest", ["delta", "snapshot"])
def test_sharded_server_equals_unsharded(ingest):
    """The port's server over a mesh equals its unsharded server hop for
    hop (torch.equal), with the viewer and LED stages, a reset row and the
    NaN / burst / silence feed; every output leaf is sharded."""
    kw = dict(path="pallas", fast=True, ingest=ingest, with_viewer=True, with_led=True)
    sharded, plain = port_server(cpu_mesh(EQ_SLOTS), **kw), port_server(**kw)
    try:
        for h, steps in enumerate(mesh_feed(16, seed=3)):
            for srv in (sharded, plain):
                mesh_apply(srv, steps)
                if h == 9:
                    srv.reset_stream(6)
            if h == 0:
                continue
            (so, sg), (po, pg) = sharded.step(dt=DT), plain.step(dt=DT)
            assert_trees_equal(so, po, f"hop {h}")
            np.testing.assert_array_equal(sg, pg)
        assert isinstance(so.led, Sharded) and len(so.viewer.balls.position.devices) == EQ_SLOTS
        assert sharded.stats == plain.stats
        assert_trees_equal((sharded.analysis_state, sharded.balls_state), (plain.analysis_state, plain.balls_state))
    finally:
        sharded.close()
        plain.close()


def _warm_pair(**kw):
    pair = [port_server(cpu_mesh(EQ_SLOTS), **kw), port_server(**kw)]
    warm = streams(B, SR // 2, SMALL_PARAMS.sr, seed=11)
    for srv in pair:
        srv.push_batch(warm)
        srv.step(dt=DT)
    return pair


@pytest.mark.parametrize("per_hop", [False, True])
def test_sharded_step_multi_with_reset(per_hop):
    """step_multi(4) over the mesh (the staged block's hop axis not split)
    equals the unsharded server's, after a reset of a row in the middle of a
    slot; the reset row is silent."""
    pair = _warm_pair(path="pallas", fast=True)
    try:
        a = streams(B, 4 * HOP, SMALL_PARAMS.sr, seed=12)
        for srv in pair:
            srv.reset_stream(3)
            srv.push_batch(a[[s for s in range(B) if s != 3]], streams=np.array([s for s in range(B) if s != 3]))
            srv.push(3, np.zeros(4 * HOP, np.float32))
        (so, sg), (po, pg) = (srv.step_multi(4, per_hop=per_hop) for srv in pair)
        assert_trees_equal(so, po)
        np.testing.assert_array_equal(sg, pg)
        last = so[-1] if per_hop else so
        assert len(last.x_vqt_smoothed.devices) == EQ_SLOTS
        assert not last.peaks.numpy()[3].any() and last.peaks.numpy().any()
        assert torch.equal(pair[0]._window.cpu(), pair[1]._window)
    finally:
        for srv in pair:
            srv.close()


def test_sharded_reset_mid_flight():
    """A reset that lands while a mesh hop is in flight (after its capture,
    before its write-back) is re-applied to the hop's result in its slot,
    as on one device: the two servers stay equal, row 5 fresh."""
    pair = _warm_pair(path="pallas", fast=True)
    try:
        for srv in pair:
            real = srv.rings.consume

            def racing(*args, _srv=srv, _real=real, **kw):
                _srv.rings.consume = _real
                _srv.reset_stream(5)
                return _real(*args, **kw)

            srv.rings.consume = racing
            srv.push_batch(streams(B, HOP, SMALL_PARAMS.sr, seed=16))
        (so, _), (po, _) = (srv.step(dt=DT) for srv in pair)
        assert_trees_equal(so, po)
        assert_trees_equal(pair[0].analysis_state, pair[1].analysis_state)
        assert float(pair[0].analysis_state.x_vqt_smoothed[5].abs().max()) == 0.0
        assert float(pair[0]._window[5].abs().max()) == 0.0 and float(pair[0]._window[4].abs().max()) > 0.0
    finally:
        for srv in pair:
            srv.close()


def test_sharded_pipelined_flush_and_rebuild():
    """Pipelined steps and flush over the mesh equal the unsharded server's;
    a rebuild replicates the new arrays to every slot and re-materializes
    the sharded window; retune_analysis keeps the carries."""
    from pitchvis_tpu_torch.core.config import AnalysisParameters

    pair = _warm_pair(path="pallas", fast=True)
    try:
        a = streams(B, 6 * HOP, SMALL_PARAMS.sr, seed=13)
        for i in range(6):
            if i == 3:
                new = dataclasses.replace(P, quality=P.quality * 1.1)
                ap = dataclasses.replace(AnalysisParameters(), note_calmness_smoothing_duration=7.0)
                for srv in pair:
                    srv.rebuild(new)
                    srv.retune_analysis(ap)
                assert isinstance(pair[0].arrays, Replicated) and pair[0]._window is None
            for srv in pair:
                srv.push_batch(a[:, i * HOP : (i + 1) * HOP])
            got, want = (srv.step(pipelined=True, dt=DT) for srv in pair)
            if i == 0:
                assert got is None and want is None
                continue
            assert_trees_equal(got[0], want[0], f"hop {i}")
        assert_trees_equal(pair[0].flush()[0], pair[1].flush()[0])
        assert pair[0].stats["materializations"] == 2
    finally:
        for srv in pair:
            srv.close()


def test_sharded_ml_server():
    from pitchvis_tpu_torch.models.pitch_mlp import PitchMLP

    model = PitchMLP(input_bins=5 * SMALL_PARAMS.n_buckets, mlp_size=16, mlp_layers=1, device="cpu")
    pair = _warm_pair(ml_model=model, fetch="led")
    try:
        assert isinstance(pair[0].ml_model, Replicated)
        x = streams(B, HOP, SMALL_PARAMS.sr, seed=14)
        for srv in pair:
            srv.push_batch(x)
        (so, _), (po, _) = (srv.step(dt=DT) for srv in pair)
        assert type(so).__name__ == "CompactOutputs" and isinstance(so.led, Sharded)
        assert_trees_equal(so, po)
        assert_trees_equal(pair[0].ml_state, pair[1].ml_state)
    finally:
        for srv in pair:
            srv.close()


def _tone_server(mesh, tone_rows=range(0, B, 2), seconds=1.2):
    srv = StreamServer(B, P, buffer_seconds=2.0, path="pallas", fast=True, mesh=mesh, device="cpu")
    f = P.range.min_freq * 2.0 ** (30.0 / P.range.buckets_per_octave)
    t = np.arange(int(P.sr * seconds)) / P.sr
    tone = (0.1 * np.sin(2 * np.pi * f * t)).astype(np.float32)
    for s in tone_rows:
        srv.push(s, tone)
    return srv


def _assert_tone_peaks(peaks, lit, dark):
    for s in lit:
        idx = np.where(peaks[s])[0]
        assert len(idx) == 1 and abs(idx[0] - 30) <= 1, (s, idx)
    for s in dark:
        assert not peaks[s].any(), s


def test_sharded_serve_loop():
    """serve() over a mesh server: the loop's sharded hops publish, and a
    reset lands mid-serve."""
    srv = _tone_server(cpu_mesh())
    try:
        with srv.serve(rate_hz=120.0) as loop:
            trip = loop.wait_next(timeout=120.0)
            assert trip is not None
            srv.reset_stream(0)
            assert loop.wait_next(seq=trip[0], timeout=120.0) is not None
        _, out, _ = loop.latest()
        assert len(out.x_vqt_smoothed.devices) == 8
        peaks = out.peaks.numpy()
        assert not peaks[0].any()
        _assert_tone_peaks(peaks, (2, 4, 6), (1, 3, 5, 7))
    finally:
        srv.close()


def test_sharded_cadenced_serve():
    """publish="per_hop" over a mesh: every published hop is a sharded,
    finite slice with the tones' peaks; sync="host" publishes NumPy."""
    srv = _tone_server(cpu_mesh())
    try:
        with srv.serve(rate_hz=240.0, hops_per_dispatch=2, publish="per_hop", sync="host") as loop:
            assert loop.wait_next(seq=3, timeout=240.0) is not None
        assert loop.stats["published"] == loop.stats["hops"]
        _, out, gains = loop.latest()
        assert gains.shape == (B,) and isinstance(out.peaks, np.ndarray)
        assert np.isfinite(out.x_vqt_smoothed).all()
        _assert_tone_peaks(out.peaks, (0, 2, 4, 6), (1, 3, 5, 7))
    finally:
        srv.close()


def test_custom_axis_name_mesh():
    mesh = cpu_mesh(axis_name="streams")
    srv = _tone_server(mesh, tone_rows=range(B))
    try:
        out, _ = srv.step(dt=DT)
        assert len(out.x_vqt_smoothed.devices) == 8
        srv.reset_stream(1)
        out, _ = srv.step(dt=DT)
        assert not out.peaks.numpy()[1].any() and out.peaks.numpy()[0].any()
    finally:
        srv.close()


def test_sharded_snapshot_ingest():
    srv = StreamServer(B, P, buffer_seconds=1.0, path="pallas", fast=True, mesh=cpu_mesh(), ingest="snapshot",
                       device="cpu")
    try:
        f = P.range.min_freq * 2.0 ** (30.0 / P.range.buckets_per_octave)
        t = np.arange(int(P.sr * 0.8)) / P.sr
        srv.push(0, (0.1 * np.sin(2 * np.pi * f * t)).astype(np.float32))
        out, _ = srv.step(dt=DT)
        assert len(out.x_vqt_smoothed.devices) == 8
        assert out.peaks.numpy()[0].any() and np.isfinite(out.x_vqt_smoothed.numpy()).all()
    finally:
        srv.close()


def test_server_mesh_validation():
    with pytest.raises(ValueError, match="divide evenly"):
        StreamServer(6, P, buffer_seconds=1.0, mesh=cpu_mesh(4), device="cpu")


@pytest.mark.parametrize("restore_mesh", [True, False], ids=["onto_mesh", "onto_one_device"])
def test_restore_server_mesh(tmp_path, restore_mesh):
    """A mesh server's checkpoint holds the same files as an unsharded
    server's; restored over a mesh (or without one) it serves on exactly as
    the server that never stopped."""
    pair = _warm_pair(path="pallas", fast=True, with_viewer=True)
    try:
        a = streams(B, 5 * HOP, SMALL_PARAMS.sr, seed=15)
        for srv in pair:
            srv.push_batch(a[:, :HOP])
            srv.step(dt=DT)
        save_server_state(str(tmp_path / "mesh"), pair[0])
        save_server_state(str(tmp_path / "one"), pair[1])
        for name in ("server_analysis_state.npz", "server_balls_state.npz", "server_rings.npz"):
            with np.load(tmp_path / "mesh" / name) as m, np.load(tmp_path / "one" / name) as o:
                assert sorted(m.files) == sorted(o.files)
                for k in m.files:
                    np.testing.assert_array_equal(m[k], o[k], err_msg=f"{name}:{k}")
        restored = restore_server(str(tmp_path / "mesh"), mesh=cpu_mesh(EQ_SLOTS) if restore_mesh else None,
                                  device="cpu")
        try:
            assert isinstance(restored.analysis_state.x_vqt_smoothed, Sharded) == restore_mesh
            for i in range(1, 5):
                for srv in (pair[0], restored):
                    srv.push_batch(a[:, i * HOP : (i + 1) * HOP])
                (want, _), (got, _) = (srv.step(dt=DT) for srv in (pair[0], restored))
                assert_trees_equal(got, gather(want), f"hop {i}")
        finally:
            restored.close()
    finally:
        for srv in pair:
            srv.close()


# ---------------------------------------------------------------------------
# the sharded render
# ---------------------------------------------------------------------------


def _viewer_batch(n_streams, seed):
    from test_torch_render import PARAMS, _balls_for

    from pitchvis_tpu_torch import convert

    balls, bass, a = _balls_for(n_streams, PARAMS.range, seed=seed)
    return (convert.ball_outputs_from_numpy(balls, "cpu"), convert.bass_spiral_outputs_from_numpy(bass, "cpu"),
            torch.from_numpy(a["scene_calmness"]), to_port(PARAMS.range))


def test_sharded_render_matches_single():
    """render_batch on inputs sharded over the slots renders each slice on
    its device into sharded frames equal to the unsharded render."""
    balls, bass, sc, rng = _viewer_batch(8, seed=21)
    cfg = tr.RenderConfig(width=160, height=96, ball_patch=32)
    ref = tr.render_batch(cfg, rng, balls, bass, sc, 1.0)
    mesh = cpu_mesh(EQ_SLOTS)
    out = tr.render_batch(cfg, rng, shard_batch(mesh, balls), shard_batch(mesh, bass), shard_batch(mesh, sc), 1.0)
    assert isinstance(out, Sharded) and len(out.devices) == EQ_SLOTS
    assert torch.equal(out.cpu(), ref)
    scalar = tr.render_batch(cfg, rng, shard_batch(mesh, balls), None, 0.25, 1.0)
    assert torch.equal(scalar.cpu(), tr.render_batch(cfg, rng, balls, None, 0.25, 1.0))


def test_render_streams_of_a_mesh_server():
    """render_streams on a mesh server's viewer outputs takes the rows from
    their slots, in the order asked, equal to the unsharded server's."""
    pair = _warm_pair(path="pallas", fast=True, with_viewer=True)
    try:
        (so, _), (po, _) = (srv.step(dt=DT) for srv in pair)
        cfg = tr.RenderConfig(width=96, height=54, ball_patch=16, max_balls=8)
        for rows in (range(2, 6), [7, 0, 1]):
            got = tr.render_streams(cfg, P.range, so.viewer, so.analysis.scene_calmness, 0.5, streams=rows)
            want = tr.render_streams(cfg, P.range, po.viewer, po.analysis.scene_calmness, 0.5, streams=rows)
            assert isinstance(got, Sharded) and torch.equal(got.cpu(), want), rows
    finally:
        for srv in pair:
            srv.close()


# ---------------------------------------------------------------------------
# no collectives
# ---------------------------------------------------------------------------


def test_hops_call_no_collective():
    """With every torch.distributed collective patched to raise, a hop of
    the sharded server and of the sharded step run through."""
    srv = _tone_server(cpu_mesh(), seconds=0.6)
    mesh = cpu_mesh()
    step = make_sharded_pipeline_step(mesh, vqt_params=P, path="pallas")
    args = (replicate(mesh, make_vqt_arrays(get_kernel(P), path="pallas", device="cpu")),
            shard_batch(mesh, init_pipeline_state(B, P, device="cpu")), shard_batch(mesh, _step_inputs(B, 1)[0]))
    try:
        with no_collectives():
            out, _ = srv.step(dt=DT)
            _, pout = step(*args, DT)
        assert np.isfinite(out.x_vqt_smoothed.numpy()).all() and np.isfinite(pout.x_vqt.numpy()).all()
        assert dist.all_reduce is not None and dist.all_reduce.__name__ == "all_reduce"  # restored
    finally:
        srv.close()


def test_no_collectives_catches_an_all_reduce():
    """The counter-check: in a gloo group of one, the patch turns an
    all_reduce into an error; outside it the all_reduce runs."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        t = torch.ones(3)
        with no_collectives(), pytest.raises(RuntimeError, match="collective all_reduce"):
            dist.all_reduce(t)
        dist.all_reduce(t)
        assert torch.equal(t, torch.ones(3))
        assert make_multihost_mesh(n_devices=2, device="cpu").devices.shape == (1, 2)
    finally:
        dist.destroy_process_group()
