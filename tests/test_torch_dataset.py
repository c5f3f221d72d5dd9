"""The port's training-data path (pitchvis_tpu_torch/train/dataset.py and
device_dataset.py) against the JAX package's, on the CPU at SMALL_TRAIN_PARAMS
(n_fft 8192, 144 bins) with the 3-note MIDI of tests/test_device_dataset.py.

Tolerances:

* note schedules, eviction times and host-side labels: equal;
* the device route's render against the JAX package's compiled render
  (_render_core under jit, as _render_agc_jit runs it): within 1e-6 of the
  signal's peak (what is left is an ulp of sin here and there, and the
  order of the sum over notes); the port writes XLA's rewrites out
  (divisions by constants as products with float32 reciprocals, products
  of constants folded first). JAX's eager render_schedule_device divides by
  sr instead, and differs from its own compiled render by an ulp of t in
  many samples;
* label gains of the device route: rtol 1e-5, on the same side of 0.5;
  spectra within 1e-2 dB where they stand 10 dB over the floor;
* the host route: the same native synthesis and AGC as the JAX package, so
  targets and label gains equal, spectra within 1e-3 dB where they stand 10
  dB over the floor (both float32 VQT products on the CPU, summed in other
  orders).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pitchvis_tpu.ops.vqt import Vqt as JVqt
from pitchvis_tpu.synth.midi import load_midi as j_load_midi
from pitchvis_tpu.synth.midi import write_midi
from pitchvis_tpu.synth.sf2 import write_minimal_sf2
from pitchvis_tpu.train import dataset as jds
from pitchvis_tpu.train import device_dataset as jdd
from pitchvis_tpu_torch.ops.vqt import Vqt as TVqt
from pitchvis_tpu_torch.synth.midi import load_midi as t_load_midi
from pitchvis_tpu_torch.train import dataset as tds
from pitchvis_tpu_torch.train import device_dataset as tdd

from tests.test_synth import SMALL_TRAIN_PARAMS
from torch_port_helpers import jax_native_lib, to_port  # noqa: F401 (fixture)

PARAMS = SMALL_TRAIN_PARAMS
T_PARAMS = to_port(SMALL_TRAIN_PARAMS)
SR = int(PARAMS.sr)
RENDER_REL = 1e-6
GAIN_RTOL = 1e-5
DEVICE_DB_TOL = 1e-2
HOST_DB_TOL = 1e-3


@pytest.fixture(scope="module")
def midi_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mid") / "t.mid")
    write_midi(path, [(0.0, 1.23, 0, 57, 110), (0.51, 0.97, 0, 64, 90), (1.83, 0.77, 1, 45, 100)])
    return path


@pytest.fixture(scope="module")
def vqts():
    return JVqt(PARAMS), TVqt(T_PARAMS, device="cpu")


def _same_schedule(j, t):
    for name in ("t_on", "t_off", "key", "velocity", "harmonics", "attack", "decay", "sustain", "release", "t_cut"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _dense_midi(tmp_path):
    path = str(tmp_path / "dense.mid")
    write_midi(path, [(0.001 * i, 2.5, 0, 20 + i, 100) for i in range(80)])
    return path


def test_schedules_and_labels_equal(midi_path, tmp_path):
    """schedule_from_midi (eviction times of the 64-voice pool included, on a
    file with 80 held notes) and active_keys_at equal the JAX package's."""
    for path, n_secs in ((midi_path, 2.8), (_dense_midi(tmp_path), 3.0)):
        for q in (None, 64 / SR):
            j = jdd.schedule_from_midi(j_load_midi(path), n_secs, quantize_secs=q)
            t = tdd.schedule_from_midi(t_load_midi(path), n_secs, quantize_secs=q)
            _same_schedule(j, t)
        for when in (0.3, 1.0, 1.9, 2.7):
            assert tdd.active_keys_at(t, when, 1.37) == jdd.active_keys_at(j, when, 1.37)
    assert int(np.isfinite(t.t_cut).sum()) == 16


def _jax_compiled_render(sched, n, master_gain=jdd.DEFAULT_MASTER_GAIN):
    core = jax.jit(jdd._render_core, static_argnames=("n_samples", "sr", "master_gain"))
    args = [sched.t_on, sched.t_off, jdd.key_to_freq_array(sched.key), sched.velocity, sched.harmonics,
            sched.attack, sched.decay, sched.sustain, sched.release, sched.t_cut]
    return np.asarray(core(*[jnp.asarray(a) for a in args], n_samples=n, sr=float(SR), master_gain=master_gain))


def test_render_matches_jax_compiled_render(midi_path, tmp_path):
    """render_schedule_device on the 3-note file and on the dense file (16
    voices evicted) within RENDER_REL of the peak of the JAX package's
    compiled render, and the same signal whatever the time blocks."""
    for path, secs in ((midi_path, 2.8), (_dense_midi(tmp_path), 3.0)):
        n = int(SR * secs) // 441 * 441
        j = jdd.schedule_from_midi(j_load_midi(path), n / SR, quantize_secs=64 / SR)
        t = tdd.schedule_from_midi(t_load_midi(path), n / SR, quantize_secs=64 / SR)
        want = _jax_compiled_render(j, n)
        got = tdd.render_schedule_device(t, n, float(SR), device="cpu")
        assert got.dtype == torch.float32 and got.shape == (n,)
        scale = float(np.abs(want).max())
        assert scale > 0.05
        assert float(np.abs(got.numpy() - want).max()) <= RENDER_REL * scale


def test_render_blocks_do_not_change_the_signal(midi_path, monkeypatch):
    n = 2 * SR
    t = tdd.schedule_from_midi(t_load_midi(midi_path), n / SR, quantize_secs=64 / SR)
    whole = tdd.render_schedule_device(t, n, float(SR), device="cpu")
    monkeypatch.setattr(tdd, "RENDER_BLOCK_ELEMENTS", 1000 * len(t) + 7)
    assert torch.equal(tdd.render_schedule_device(t, n, float(SR), device="cpu"), whole)


def test_render_matches_host_synth_and_empty(midi_path):
    """The JAX test's criteria against the host additive synthesizer
    (tests/test_device_dataset.py::TestDeviceRender), and a schedule without
    notes renders silence."""
    from pitchvis_tpu_torch.synth.synthesizer import MidiFileSequencer, Synthesizer

    chunk = 441
    n = int(SR * 2.8) // chunk * chunk
    midi = t_load_midi(midi_path)
    dev = tdd.render_schedule_device(tdd.schedule_from_midi(midi, n / SR, quantize_secs=64 / SR), n, float(SR),
                                     device="cpu").numpy()
    seq = MidiFileSequencer(Synthesizer(SR))
    seq.play(midi)
    host = np.zeros(n, np.float32)
    right = np.zeros(chunk, np.float32)
    for i in range(n // chunk):
        seq.render(host[i * chunk : (i + 1) * chunk], right)
    assert np.abs(dev - host).mean() < 2e-3
    assert np.corrcoef(dev, host)[0, 1] > 0.99
    from pitchvis_tpu_torch.synth.midi import MidiFile

    empty = tdd.schedule_from_midi(MidiFile(events=[], length=0.0), 1.0)
    assert torch.equal(tdd.render_schedule_device(empty, 1024, float(SR), device="cpu"), torch.zeros(1024))


def _labels_close(a, b, rtol):
    assert set(a) == set(b), (a, b)
    for k in a:
        assert (a[k] > 0.5) == (b[k] > 0.5), (k, a[k], b[k])
        assert abs(a[k] - b[k]) <= rtol * max(abs(a[k]), 1e-12), (k, a[k], b[k])


def _spectra_close(a, b, tol):
    strong = a >= 10.0
    if strong.any():
        assert float(np.abs(a[strong] - b[strong]).max()) <= tol


def test_annotate_midi_device_matches_jax_and_host_route(midi_path, vqts):
    """The device route against the JAX package's (labels and spectra), and
    against the port's host route by tests/test_device_dataset.py's
    criteria: the same key sets, labels on the same side of 0.5, strong bins
    within 3 dB."""
    jv, tv = vqts
    want = jdd.annotate_midi_device(j_load_midi(midi_path), jv, PARAMS, max_seconds=2.8)
    got = tdd.annotate_midi_device(t_load_midi(midi_path), tv, T_PARAMS, max_seconds=2.8)
    assert len(got) == len(want) > 0
    for (jk, js), (tk, ts) in zip(want, got):
        _labels_close(jk, tk, GAIN_RTOL)
        _spectra_close(js, ts, DEVICE_DB_TOL)
    host = tds.annotate_midi(t_load_midi(midi_path), tv, T_PARAMS, max_seconds=2.8)
    assert len(host) == len(got)
    for (hk, hs), (dk, dsp) in zip(host, got):
        assert set(hk) == set(dk)
        strong = hs > 10.0
        if strong.any():
            assert np.abs(hs[strong] - dsp[strong]).max() < 3.0
        for k in hk:
            assert (hk[k] > 0.5) == (dk[k] > 0.5), (k, hk[k], dk[k])


def _rows(data, n_buckets):
    return np.asarray(data).reshape(-1, n_buckets + 128)


def test_generate_dataset_device_matches_jax(tmp_path, three_files, capsys):
    """generate_dataset_device on a held note: the rows' targets equal the
    JAX package's, their spectra within DEVICE_DB_TOL, the labelled key's
    energy at its bin (tests/test_device_dataset.py). On three files of
    different lengths with an unparsable one between them (the port's files
    as rows of one zero-padded batch, the JAX package's file by file): the
    same rows, targets equal, spectra within DEVICE_DB_TOL."""
    path = str(tmp_path / "m.mid")
    write_midi(path, [(0.0, 3.0, 0, 57, 110)])
    want = _rows(jdd.generate_dataset_device([path], PARAMS, max_seconds_per_file=2.0), PARAMS.n_buckets)
    out = str(tmp_path / "data.npy")
    got = _rows(tdd.generate_dataset_device([path, str(tmp_path / "missing.mid")], T_PARAMS, out_path=out,
                                            max_seconds_per_file=2.0, device="cpu"), PARAMS.n_buckets)
    np.testing.assert_array_equal(np.load(out).reshape(got.shape), got)
    assert got.shape == want.shape and len(got) >= 2
    np.testing.assert_array_equal(got[:, PARAMS.n_buckets:], want[:, PARAMS.n_buckets:])
    for a, b in zip(want[:, : PARAMS.n_buckets], got[:, : PARAMS.n_buckets]):
        _spectra_close(a, b, DEVICE_DB_TOL)
    labeled = got[got[:, PARAMS.n_buckets + 57] > 0.5]
    assert len(labeled) >= 1 and abs(int(np.argmax(labeled[0, : PARAMS.n_buckets])) - 36) <= 2

    paths, _ = three_files
    want = _rows(jdd.generate_dataset_device(paths, PARAMS, max_seconds_per_file=DATASET_MAX_SECONDS),
                 PARAMS.n_buckets)
    got = _rows(tdd.generate_dataset_device(paths, T_PARAMS, max_seconds_per_file=DATASET_MAX_SECONDS, device="cpu"),
                PARAMS.n_buckets)
    assert capsys.readouterr().out.count(f"failed to parse midi file {paths[1]}") == 2
    assert got.shape == want.shape and len(got) >= 3
    np.testing.assert_array_equal(got[:, PARAMS.n_buckets:], want[:, PARAMS.n_buckets:])
    for a, b in zip(want[:, : PARAMS.n_buckets], got[:, : PARAMS.n_buckets]):
        _spectra_close(a, b, DEVICE_DB_TOL)


@pytest.fixture(scope="module")
def three_files(tmp_path_factory, vqts):
    """Three MIDI files of 0.9, 1.7 and 2.6 s with an unparsable file after
    the first, and the rows of annotate_midi_device file by file (the
    parsable ones, cut at DATASET_MAX_SECONDS)."""
    tmp = tmp_path_factory.mktemp("three")
    paths = []
    for i, secs in enumerate((0.9, 1.7, 2.6)):
        path = str(tmp / f"{i}.mid")
        write_midi(path, [(0.0, secs - 0.1, 0, 50 + 5 * i, 100), (secs / 3, secs / 2, 0, 62 + i, 90)])
        paths.append(path)
        if i == 0:
            bad = tmp / "bad.mid"
            bad.write_bytes(b"not a MIDI file")
            paths.append(str(bad))
    _, tv = vqts
    rows = [tds.generate_data_row(active, spec, PARAMS.n_buckets)
            for path in paths if not path.endswith("bad.mid")
            for active, spec in tdd.annotate_midi_device(t_load_midi(path), tv, T_PARAMS,
                                                         max_seconds=DATASET_MAX_SECONDS)]
    return paths, np.concatenate(rows)


DATASET_MAX_SECONDS = 2.0


@pytest.mark.parametrize(
    "per_launch, batch_samples, calls_want",
    [(2, tdd.BATCH_SAMPLES, [2, 1]), (tdd.CPU_ROWS_PER_LAUNCH, tdd.BATCH_SAMPLES, [3]),
     (tdd.CPU_ROWS_PER_LAUNCH, 1, [1, 1, 1])],
    ids=["two-a-launch", "all-in-one", "each-file-over-the-samples-cap"],
)
def test_generate_dataset_device_batches_files_as_file_by_file(three_files, per_launch, batch_samples, calls_want,
                                                               monkeypatch, capsys):
    """generate_dataset_device on the CPU (the files rendered into the rows
    of zero-padded batches, each batch's AGC in one call) returns the same
    array (np.array_equal) as annotate_midi_device file by file: three files
    of different lengths, the last cut by max_seconds_per_file, an unparsable
    file between them reported and skipped; batches of two rows (two AGC
    calls), one batch of all three (one call), and each file alone when every
    file is over the batch's samples cap (three calls)."""
    from pitchvis_tpu_torch.ops import agc

    paths, want = three_files
    monkeypatch.setattr(tdd, "CPU_ROWS_PER_LAUNCH", per_launch)
    monkeypatch.setattr(tdd, "BATCH_SAMPLES", batch_samples)
    calls = []

    def agc_signal(signal, chunk, params):
        calls.append(signal.shape[0])
        return agc.agc_signal(signal, chunk, params)

    monkeypatch.setattr(tdd, "agc_signal", agc_signal)
    before = agc.signal_launches
    got = tdd.generate_dataset_device(paths, T_PARAMS, max_seconds_per_file=DATASET_MAX_SECONDS, device="cpu")
    assert f"failed to parse midi file {paths[1]}" in capsys.readouterr().out
    assert calls == calls_want  # one call a batch of rows
    assert agc.signal_launches == before  # the plain version launches nothing
    assert got.dtype == np.float32 and len(got) > 0
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "lengths, rows, cap, want",
    [
        ([5, 3, 4, 2, 1], 2, 100, [[5, 3], [4, 2], [1]]),  # the rows cap
        ([5, 3, 4, 2, 1], 8, 12, [[5, 3], [4, 2, 1]]),  # 3 * 5 > 12 ends the first run; 3 * 4 fits
        ([3, 30, 2, 2], 8, 10, [[3], [30], [2, 2]]),  # a file over the cap alone
        ([4, 4, 4], 8, 12, [[4, 4, 4]]),  # exactly at the cap
        ([], 8, 12, []),
    ],
    ids=["rows", "padded-samples", "over-the-cap-alone", "at-the-cap", "no-files"],
)
def test_dataset_batches_cap_rows_and_padded_samples(lengths, rows, cap, want, monkeypatch):
    """_batches cuts the files, in order, into runs of at most ``rows`` files
    whose count times their longest is at most BATCH_SAMPLES; a longer file
    is a run of its own."""
    monkeypatch.setattr(tdd, "BATCH_SAMPLES", cap)
    files = [(f"file {i}", n) for i, n in enumerate(lengths)]
    got = list(tdd._batches(iter(files), rows))
    assert [[n for _, n in b] for b in got] == want
    assert [f for b in got for f in b] == files


def test_generate_dataset_host_matches_jax(midi_path, tmp_path, jax_native_lib):
    """The host route without a font (the additive synthesizer) and with
    one, serially and on 3 threads: targets equal the JAX package's, spectra
    within HOST_DB_TOL; the threads' rows equal the serial rows."""
    sf = str(tmp_path / "f.sf2")
    t = np.arange(400)
    write_minimal_sf2(sf, 0.7 * np.sin(2 * np.pi * t / 50), SR, root_key=69, loop=True)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"{i}.mid")
        write_midi(p, [(0.0, 0.4, 0, 50 + 3 * i, 100), (0.3, 0.5, 0, 62 + i, 90)])
        paths.append(p)
    cases = [dict(paths=[midi_path], max_seconds_per_file=2.0, sound_font_path=None, n_workers=1),
             dict(paths=paths, max_seconds_per_file=1.5, sound_font_path=sf, n_workers=1)]
    for kw in cases:
        kw = dict(kw)
        ps = kw.pop("paths")
        want = _rows(jds.generate_dataset(ps, PARAMS, **kw), PARAMS.n_buckets)
        got = _rows(tds.generate_dataset(ps, T_PARAMS, device="cpu", **kw), PARAMS.n_buckets)
        assert got.shape == want.shape and len(got) > 0
        np.testing.assert_array_equal(got[:, PARAMS.n_buckets:], want[:, PARAMS.n_buckets:])
        for a, b in zip(want[:, : PARAMS.n_buckets], got[:, : PARAMS.n_buckets]):
            _spectra_close(a, b, HOST_DB_TOL)
    parallel = tds.generate_dataset(paths, T_PARAMS, max_seconds_per_file=1.5, sound_font_path=sf, n_workers=3,
                                    device="cpu")
    np.testing.assert_array_equal(parallel.reshape(got.shape), got)


def test_host_route_labels_equal_jax(midi_path, vqts, jax_native_lib):
    """annotate_midi's label snapshots (voices' mix gains times the native
    AGC's gain) equal the JAX package's."""
    jv, tv = vqts
    want = jds.annotate_midi(j_load_midi(midi_path), jv, PARAMS, max_seconds=2.0)
    got = tds.annotate_midi(t_load_midi(midi_path), tv, T_PARAMS, max_seconds=2.0)
    assert [k for k, _ in got] == [k for k, _ in want] and any(k for k, _ in got)


def test_rows_and_augmentation_equal():
    rng = np.random.default_rng(3)
    spec = rng.uniform(0, 40, PARAMS.n_buckets).astype(np.float32)
    keys = {45: 0.9, 57: 0.3, 60: 0.51, 200: 1.0}
    np.testing.assert_array_equal(tds.generate_data_row(keys, spec, PARAMS.n_buckets),
                                  jds.generate_data_row(keys, spec, PARAMS.n_buckets))
    with pytest.raises(ValueError):
        tds.generate_data_row(keys, spec[:-1], PARAMS.n_buckets)
    vqt = rng.uniform(0, 30, 86 * 3).astype(np.float32)
    for active in ({33 + 30: 1.0}, {40: 0.7, 43: 0.2, 90: 1.0}):
        a, b = jds.center_vqt_samples(active, vqt, 3, 7), tds.center_vqt_samples(active, vqt, 3, 7)
        for x, y in zip(a, b):
            assert len(x) == len(y)
            for (u, s), (v, r) in zip(x, y):
                np.testing.assert_array_equal(u, v)
                assert s == r


def test_chunk_grid_equal(vqts):
    jv, tv = vqts
    assert tds._chunk_samples(tv, SR) == jds._chunk_samples(jv, SR)
